"""Span tracing: Chrome-trace-event timelines for the epoch runtime
(PyTorch port of ``repro/obs/trace.py``).

The paper's whole argument is an *accounting* one — V_inf critical-path
overhead (dispatches + readbacks) should be paid once by the whole system —
and the runtime already counts those terms in ``RunStats``/``ChunkSummary``.
This module turns the counters into an observable timeline: a
:class:`SpanTracer` collects Chrome trace events (the ``traceEvents`` JSON
format that chrome://tracing and Perfetto load directly), and every driver
emits spans against it:

* **host drivers** (``HostEngine``, ``EpochMultiplexer``) emit one
  ``epoch`` span per epoch with ``pack`` / ``dispatch`` / ``readback`` /
  ``maps`` child phases — the V_inf terms as visible time, annotated with
  the CEN, dispatch mode, launch width, and lane utilization;
* **resident drivers** (``DeviceEngine``, ``DeviceMultiplexer``, and the
  megakernel path) cannot observe individual epochs without paying the
  readbacks the design exists to avoid, so they emit one ``chunk`` span per
  chunk boundary, reconstructed from the :class:`~repro_torch.core.
  engine.ChunkSummary` deltas (epochs/tasks/holes run inside the chunk), with the
  chunk's single ``readback`` as a child span — the trace makes the ⌈E/K⌉
  readback cadence literally countable;
* device launches (on the card, CUDA graph replays) are additionally
  wrapped in an annotation (:meth:`SpanTracer.annotation`): a
  ``torch.profiler.record_function`` range, and on the card an NVTX range
  of the same name, so a ``torch.profiler`` or Nsight session collected
  alongside shows the reference's names (``trees:epoch_step``,
  ``trees:map{id}``, ``trees:resident_chunk``, ``trees:resident_wave``).

On the card every span and annotation is host code around a step: none
records a CUDA event or runs a tensor operation, so a step captured in a
CUDA graph under a span is the same graph as without one.

Tracing is strictly opt-in: the module-level :data:`NULL_TRACER` is the
default everywhere, its hooks are constant-time no-ops, and driver code
guards argument construction behind ``tracer.enabled`` — the disabled path
adds nothing to the critical path (the zero-retrace and stats-equality
guards run with it in place).
"""
from __future__ import annotations

import contextlib
import json
import time
from typing import Any, Dict, Iterator, List, Optional

import torch


class NullTracer:
    """Disabled tracer: every hook is a constant-time no-op.

    ``span``/``annotation`` return a shared no-op context manager whose
    ``__enter__`` yields a throwaway dict, so call sites can unconditionally
    ``with tracer.span(...) as args: args.update(...)`` — though hot paths
    should still guard on ``tracer.enabled`` to skip building the args.
    """

    enabled = False

    class _NullSpan:
        def __enter__(self) -> Dict[str, Any]:
            return {}

        def __exit__(self, *exc) -> None:
            return None

    _NULL_SPAN = _NullSpan()

    def span(self, name: str, cat: str = "runtime", tid: int = 0,
             **args: Any):
        return self._NULL_SPAN

    def instant(self, name: str, cat: str = "runtime", tid: int = 0,
                **args: Any) -> None:
        return None

    def counter(self, name: str, tid: int = 0, **values: float) -> None:
        return None

    def annotation(self, name: str):
        return contextlib.nullcontext()

    def events_named(self, name: str) -> List[dict]:
        return []


NULL_TRACER = NullTracer()


class SpanTracer(NullTracer):
    """Collects Chrome trace events; write with :meth:`write`.

    Timestamps are microseconds since tracer construction
    (``perf_counter_ns`` based, so spans nest consistently within one
    process).  ``pid`` groups all events into one process track;
    each driver picks a ``tid`` lane via :meth:`thread` so e.g. the host
    epoch loop and the map launcher render as separate rows.
    """

    enabled = True

    def __init__(self, process_name: str = "trees-runtime", pid: int = 1):
        self.pid = pid
        self.events: List[dict] = []
        self._t0 = time.perf_counter_ns()
        self._threads: Dict[int, str] = {}
        self.events.append({
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "ts": 0, "args": {"name": process_name},
        })

    # ------------------------------------------------------------- clock
    def now_us(self) -> float:
        return (time.perf_counter_ns() - self._t0) / 1e3

    # ------------------------------------------------------------ tracks
    def thread(self, tid: int, name: str) -> int:
        """Name a tid lane (idempotent); returns the tid for chaining."""
        if self._threads.get(tid) != name:
            self._threads[tid] = name
            self.events.append({
                "ph": "M", "name": "thread_name", "pid": self.pid,
                "tid": tid, "ts": 0, "args": {"name": name},
            })
        return tid

    # ------------------------------------------------------------- spans
    class _Span:
        """Complete-event ("ph": "X") recorder.

        Yields its mutable ``args`` dict on ``__enter__`` so the caller can
        attach values only known at the end of the phase (lane utilization
        after the readback, chunk deltas after the summary fetch).
        """

        __slots__ = ("_tr", "_name", "_cat", "_tid", "args", "_t0")

        def __init__(self, tr: "SpanTracer", name: str, cat: str, tid: int,
                     args: Dict[str, Any]):
            self._tr = tr
            self._name = name
            self._cat = cat
            self._tid = tid
            self.args = args

        def __enter__(self) -> Dict[str, Any]:
            self._t0 = self._tr.now_us()
            return self.args

        def __exit__(self, *exc) -> None:
            t1 = self._tr.now_us()
            self._tr.events.append({
                "ph": "X", "name": self._name, "cat": self._cat,
                "pid": self._tr.pid, "tid": self._tid,
                "ts": self._t0, "dur": t1 - self._t0,
                "args": self.args,
            })
            return None

    def span(self, name: str, cat: str = "runtime", tid: int = 0,
             **args: Any) -> "SpanTracer._Span":
        """Context manager recording one complete event over its body."""
        return SpanTracer._Span(self, name, cat, tid, args)

    def instant(self, name: str, cat: str = "runtime", tid: int = 0,
                **args: Any) -> None:
        self.events.append({
            "ph": "i", "name": name, "cat": cat, "pid": self.pid,
            "tid": tid, "ts": self.now_us(), "s": "t", "args": args,
        })

    def counter(self, name: str, tid: int = 0, **values: float) -> None:
        """Counter-track sample (renders as a stacked area in Perfetto)."""
        self.events.append({
            "ph": "C", "name": name, "pid": self.pid, "tid": tid,
            "ts": self.now_us(), "args": dict(values),
        })

    def annotation(self, name: str):
        """A ``torch.profiler.record_function`` range over a device launch,
        together with an NVTX range of the same name where CUDA is present,
        so a profile collected alongside shows the same phase names as the
        runtime timeline.  Both are host calls: nothing is enqueued on a
        stream (a CUDA graph captured inside one holds no extra node)."""
        return _Annotation(name)

    # ----------------------------------------------------------- queries
    def events_named(self, name: str, cat: Optional[str] = None
                     ) -> List[dict]:
        """All non-metadata events with this name (tests count readbacks)."""
        return [
            e for e in self.events
            if e.get("name") == name and e["ph"] != "M"
            and (cat is None or e.get("cat") == cat)
        ]

    # ------------------------------------------------------------ output
    def to_dict(self) -> dict:
        return {
            "traceEvents": list(self.events),
            "displayTimeUnit": "ms",
            "otherData": {"producer": "repro_torch.obs.trace"},
        }

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)
            f.write("\n")


class _Annotation:
    __slots__ = ("_name", "_rf", "_nvtx")

    def __init__(self, name: str):
        self._name = name

    def __enter__(self):
        self._rf = torch.profiler.record_function(self._name)
        self._rf.__enter__()
        self._nvtx = torch.cuda.is_available()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self._name)
        return self

    def __exit__(self, *exc) -> None:
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        self._rf.__exit__(*exc)
        return None


# --------------------------------------------------------------------------
# Validation (the tier-1 guard that emitted traces stay loadable)
# --------------------------------------------------------------------------
_REQUIRED_BY_PHASE = {
    "X": ("name", "ts", "dur", "pid", "tid"),
    "i": ("name", "ts", "pid", "tid"),
    "C": ("name", "ts", "pid", "args"),
    "M": ("name", "pid"),
    "B": ("name", "ts", "pid", "tid"),
    "E": ("ts", "pid", "tid"),
}


def validate_chrome_trace(doc: Any) -> List[dict]:
    """Check a parsed trace document is Chrome-trace-event JSON that
    chrome://tracing / Perfetto will load; returns the event list.

    Accepts both container layouts the format allows (a bare event array,
    or an object with ``traceEvents``).  Raises ``ValueError`` on the first
    structural problem — this is the tier-1 test's oracle, so the message
    names the offending event.
    """
    if isinstance(doc, dict):
        events = doc.get("traceEvents")
        if not isinstance(events, list):
            raise ValueError("trace object has no traceEvents list")
    elif isinstance(doc, list):
        events = doc
    else:
        raise ValueError(f"trace document must be dict or list, got "
                         f"{type(doc).__name__}")
    for i, e in enumerate(events):
        if not isinstance(e, dict):
            raise ValueError(f"event {i} is not an object: {e!r}")
        ph = e.get("ph")
        if not isinstance(ph, str) or not ph:
            raise ValueError(f"event {i} has no phase ('ph'): {e!r}")
        for field in _REQUIRED_BY_PHASE.get(ph, ("name",)):
            if field not in e:
                raise ValueError(
                    f"event {i} (ph={ph!r}, name={e.get('name')!r}) "
                    f"missing required field {field!r}"
                )
        if ph == "X" and not isinstance(e["dur"], (int, float)):
            raise ValueError(f"event {i} has non-numeric dur: {e!r}")
    return events


def load_trace(path: str) -> List[dict]:
    """Load + validate a trace file; returns its event list."""
    with open(path) as f:
        return validate_chrome_trace(json.load(f))


def iter_spans(events: List[dict], name: Optional[str] = None,
               cat: Optional[str] = None) -> Iterator[dict]:
    """Complete-event spans, optionally filtered by name/category."""
    for e in events:
        if e.get("ph") != "X":
            continue
        if name is not None and e.get("name") != name:
            continue
        if cat is not None and e.get("cat") != cat:
            continue
        yield e
