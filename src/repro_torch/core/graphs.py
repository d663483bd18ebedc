"""CUDA graphs: the port's counterpart of the reference's compile caches.

The JAX package never runs an epoch step op by op: it jits each step once
per shape key and replays the compiled program (``EpochLoop._step_cache``
and the pass caches, the server's decode step).  Eager PyTorch pays one
host launch per operation instead, 15-25 µs each on the card, which sets
the wall of every host-driven path.  Here a step that keeps coming back
under its key is captured in a ``torch.cuda.CUDAGraph`` and replayed: one
host call per step.

A step given to :func:`run_cached` is a function of no arguments that

  * reads only tensors whose addresses stay fixed from call to call: state
    updated in place, static input buffers filled before each call, and
    the outputs of earlier captured steps;
  * returns a tree (dataclasses, lists, tuples) of the tensors later host
    code or later steps read, plus constants;
  * makes no host synchronisation (``.item()``, ``.cpu()``, a host-to-device
    copy of Python data): capture fails on one, and the error is raised.

:func:`run_cached` chooses from what its cache has seen, a key's uses: the
first :data:`CAPTURE_AT` - 1 run the step eagerly on the current stream
(the call's real work, and the warm-up a capture needs: the kernels are
built and loaded, the allocator's cache is the warm one of the eager
path), so a key used fewer times costs what the eager step costs; the
:data:`CAPTURE_AT`-th captures the step on a side stream
(:func:`capture`) and replays it; every later use replays.  A replay's
results land in buffers allocated before the capture, outside the graph
pool, shaped as the eager uses' results were, so that the pool holds
only what is dead at the graph's end and the graphs of one pool may be
replayed in any order.

Kernel launch counts (the counters registered in ``kernels/counters.py``)
count what runs on the device: a capture adds nothing (it runs nothing),
each replay adds the launches its graph holds.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch


def _counters():
    from ..kernels import counters  # imports (registers) every kernel module

    return counters


_LEAF = object()


def _flatten(x, leaves: List[torch.Tensor]):
    """The tree of ``x`` with each tensor replaced by a leaf marker; the
    tensors are appended to ``leaves`` in order."""
    if torch.is_tensor(x):
        leaves.append(x)
        return _LEAF
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x), {f.name: _flatten(getattr(x, f.name), leaves)
                          for f in dataclasses.fields(x)})
    if isinstance(x, (list, tuple)):
        return (type(x), [_flatten(v, leaves) for v in x])
    return (None, x)


def _rebuild(tree, leaves):
    it = iter(leaves)

    def go(t):
        if t is _LEAF:
            return next(it)
        kind, body = t
        if kind is None:
            return body
        if isinstance(body, dict):
            return kind(**{k: go(v) for k, v in body.items()})
        return kind(go(v) for v in body)

    return go(tree)


# the shape and type of each result tensor of a step, in tree order
Layout = List[Tuple[Tuple[int, ...], torch.dtype]]


# the use of a key that captures its step.  A capture (the recording and
# the graph's instantiation) costs a few eager steps of host time, and a
# replay saves most of one (PERF.md, chip_smoke.py's capture costs): a
# key captured at its second use made runs whose keys come back two to
# four times slower than eager.  Captured at its third, a key has paid
# about the capture's price in eager uses first (rent until the rent paid
# nears the price); a key used less often runs eagerly throughout.
CAPTURE_AT = 3


class Seen:
    """A key run eagerly so far: its uses, and the layout of its results,
    which the result buffers of its capture take."""

    def __init__(self, layout: Layout):
        self.layout = layout
        self.uses = 1


class CapturedStep:
    """One captured step: its graph, the buffers a replay leaves its
    results in (:attr:`result`, the step's tree over them) and the kernel
    launches one replay makes."""

    def __init__(self, graph, result, launches: Dict[str, int]):
        self.graph = graph
        self.result = result
        self.launches = launches

    def replay(self):
        """Replay the graph on the current stream; returns :attr:`result`,
        filled once the stream reaches the replay's end."""
        self.graph.replay()
        _counters().add(self.launches)
        return self.result


def run_eager(fn: Callable[[], Any]) -> Tuple[Any, Layout]:
    """``fn()`` on the current stream; returns ``(result, layout)``."""
    out = fn()
    leaves: List[torch.Tensor] = []
    _flatten(out, leaves)
    return out, [(tuple(t.shape), t.dtype) for t in leaves]


def capture(fn: Callable[[], Any], layout: Layout, pool=None, stream=None,
            buffer: Optional[Callable[[int, Tuple[int, ...], torch.dtype],
                                      torch.Tensor]] = None
            ) -> CapturedStep:
    """Capture ``fn`` in a CUDA graph; nothing runs until a replay.

    ``layout`` is the shapes and types of ``fn``'s result tensors (an
    eager call's, :func:`run_eager`), ``pool`` a graph pool handle shared
    with other captures (``torch.cuda.graph_pool_handle()``; None: the
    graph's own pool), ``stream`` the side stream the capture runs on
    (None: a new one) and ``buffer(i, shape, dtype)`` the result buffer of
    the ``i``-th result tensor (None: a new one; graphs whose results are
    read before the next replay of any of them may share buffers).  The
    buffers are allocated before the capture, outside its pool.  A capture
    that fails raises.
    """
    dev = torch.device("cuda", torch.cuda.current_device())
    outs = [torch.empty(shape, dtype=dtype, device=dev) if buffer is None
            else buffer(i, shape, dtype)
            for i, (shape, dtype) in enumerate(layout)]
    cur = torch.cuda.current_stream()
    side = stream if stream is not None else torch.cuda.Stream()
    graph = torch.cuda.CUDAGraph()
    counters = _counters()
    before = counters.snapshot()
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        graph.capture_begin(pool=pool)
        try:
            got: List[torch.Tensor] = []
            tree = _flatten(fn(), got)
            if [(tuple(t.shape), t.dtype) for t in got] != list(layout):
                raise RuntimeError(
                    "a captured step returned other tensors than its eager "
                    "call")
            for o, t in zip(outs, got):
                o.copy_(t)
            del got
        except BaseException:
            try:
                graph.capture_end()
            except Exception:  # the capture is void; the first error counts
                pass
            raise
        graph.capture_end()
    cur.wait_stream(side)
    after = counters.snapshot()
    delta = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    counters.add(delta, -1)  # the capture ran nothing
    return CapturedStep(graph, _rebuild(tree, outs), delta)


def run_cached(cache: Dict[Any, Any], key, fn: Callable[[], Any], stream,
               pool=None, buffer=None) -> Tuple[Any, bool]:
    """``fn()`` through ``cache[key]``: eagerly at the key's first
    ``CAPTURE_AT - 1`` uses (the entry counts them and records the result
    layout), captured on ``stream`` and replayed at the next, replayed
    after.  Returns ``(result, captured)``, ``captured`` True when this
    call made the key's capture."""
    entry = cache.get(key)
    if isinstance(entry, CapturedStep):
        return entry.replay(), False
    if entry is None or entry.uses + 1 < CAPTURE_AT:
        out, layout = run_eager(fn)
        if entry is None:
            cache[key] = Seen(layout)
        else:
            entry.uses += 1
        return out, False
    step = cache[key] = capture(fn, entry.layout, pool, stream, buffer)
    return step.replay(), True


def pinned_like(t: torch.Tensor) -> torch.Tensor:
    """A page-locked host buffer of ``t``'s shape and type: the target of a
    readback a graph can hold (an asynchronous device-to-host copy)."""
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)


def pool_bytes(pool) -> int:
    """Bytes the caching allocator holds in the segments of graph pool
    ``pool`` (a ``torch.cuda.graph_pool_handle()``)."""
    pid = tuple(pool)
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id", ())) == pid)


def result_bytes(steps) -> int:
    """Bytes of the result buffers of ``steps`` (outside any pool), each
    buffer counted once."""
    leaves: List[torch.Tensor] = []
    for s in steps:
        _flatten(s.result, leaves)
    seen = {t.data_ptr(): t.numel() * t.element_size() for t in leaves}
    return sum(seen.values())
