"""Labeled metrics registry: counters, gauges, histograms for the runtime
(PyTorch port of ``repro/obs/metrics.py``, over the port's
``core.scheduler``).

Prometheus-shaped (families -> labeled children -> samples) but dependency
free: the registry is a plain in-process object, exported as JSONL or
Prometheus text exposition by ``obs/export.py``.  Two feeding paths:

* :class:`MetricsCollector` adapts the existing
  :class:`~repro_torch.core.scheduler.StatsCollector` hook surface — wrap any
  inner collector and every engine hook (epochs, lanes, dispatches,
  transfers, forks, maps, holes) lands both in the inner ``RunStats`` and
  in labeled registry series, including the per-epoch/per-chunk lane
  utilization and hole-fraction histograms no scalar total can express;
* ``JobService`` feeds job *lifecycle* series directly: per-tenant latency
  histograms split into queue-wait vs run time, completion/failure
  counters, and the wave-template cache hit/miss + retrace counters.

Metric names follow one scheme (DESIGN.md §13): ``trees_<noun>_total`` for
counters, ``trees_<noun>`` gauges, ``trees_<noun>_<unit>`` histograms;
label keys are ``driver`` (host/device), ``dispatch`` (masked/compacted/
gather), ``app`` (program name), ``tenant`` (job name).  ``RunStats.
as_dict()`` keys are the shared vocabulary — ``obs.export.export_run_stats``
publishes a finished run's stats under ``trees_run_<key>`` without
re-spelling any name.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
import threading
from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from ..core.scheduler import RunStats, StatsCollector

# default histogram buckets: latencies in seconds (submillisecond epochs up
# to minute-long waves)
LATENCY_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)
# ratios in [0, 1] (lane utilization, hole fraction)
RATIO_BUCKETS = (0.01, 0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8,
                 0.9, 0.95, 0.99, 1.0)


class MetricsError(ValueError):
    pass


class RollingWindow:
    """Bounded recent-value series with O(1) mean.

    The registry's counters/histograms are cumulative, built for export;
    a controller needs the *recent* value of a ratio (frontier fill, hole
    fraction) without differencing registry state, so it reads through
    one of these instead (``control/controller.py`` is the consumer).
    """

    __slots__ = ("_items", "_sum")

    def __init__(self, size: int):
        if size < 1:
            raise MetricsError(f"window size must be >= 1, got {size}")
        self._items: deque = deque(maxlen=size)
        self._sum = 0.0

    def add(self, v: float) -> None:
        if len(self._items) == self._items.maxlen:
            self._sum -= self._items[0]
        self._items.append(float(v))
        self._sum += float(v)

    def mean(self) -> Optional[float]:
        if not self._items:
            return None
        return self._sum / len(self._items)

    def last(self) -> Optional[float]:
        return self._items[-1] if self._items else None

    def __len__(self) -> int:
        return len(self._items)


def _check_labels(labelnames: Tuple[str, ...], labels: Dict[str, str]):
    if tuple(sorted(labels)) != tuple(sorted(labelnames)):
        raise MetricsError(
            f"labels {sorted(labels)} do not match declared label names "
            f"{sorted(labelnames)}"
        )


class Counter:
    """Monotone counter child (one label combination)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise MetricsError(f"counter increment must be >= 0, got {n}")
        self.value += n


class Gauge:
    """Set-to-current-value child."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def max(self, v: float) -> None:
        self.value = max(self.value, float(v))


class Histogram:
    """Cumulative-bucket histogram child (Prometheus semantics)."""

    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets: Sequence[float]):
        self.buckets = tuple(buckets)
        self.counts = [0] * (len(self.buckets) + 1)  # +inf tail
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        self.sum += v
        self.count += 1

    def quantile(self, q: float) -> float:
        """Upper-bound estimate of the q-quantile from the buckets (the
        load-generator benchmarks report p50/p99 from this)."""
        if not 0.0 <= q <= 1.0:
            raise MetricsError(f"quantile must be in [0, 1], got {q}")
        if self.count == 0:
            return math.nan
        target = q * self.count
        seen = 0
        for le, c in zip(self.buckets, self.counts):
            seen += c
            if seen >= target:
                return le
        return math.inf


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


@dataclasses.dataclass
class Family:
    """One metric family: a name + help + kind, children per label set."""

    name: str
    kind: str
    help: str
    labelnames: Tuple[str, ...]
    buckets: Optional[Tuple[float, ...]] = None
    children: Dict[Tuple[str, ...], object] = dataclasses.field(
        default_factory=dict
    )

    def labels(self, **labels: str):
        _check_labels(self.labelnames, labels)
        key = tuple(str(labels[k]) for k in self.labelnames)
        child = self.children.get(key)
        if child is None:
            if self.kind == "histogram":
                child = Histogram(self.buckets or LATENCY_BUCKETS)
            else:
                child = _KINDS[self.kind]()
            self.children[key] = child
        return child

    def items(self) -> Iterable[Tuple[Dict[str, str], object]]:
        for key, child in sorted(self.children.items()):
            yield dict(zip(self.labelnames, key)), child


class MetricsRegistry:
    """Process-local registry of metric families.

    Registration is idempotent per (name, kind, labelnames): engines and
    services re-declare their families freely and share the children.
    Thread-safe registration (benchmark load generators observe from worker
    threads); child mutation is plain (CPython atomic enough for counters,
    and the runtime drivers are single-threaded).
    """

    def __init__(self):
        self._families: Dict[str, Family] = {}
        self._lock = threading.Lock()

    # -------------------------------------------------------- declaration
    def _declare(self, name: str, kind: str, help: str,
                 labels: Sequence[str], buckets=None) -> Family:
        labelnames = tuple(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != labelnames:
                    raise MetricsError(
                        f"metric {name!r} already registered as {fam.kind} "
                        f"with labels {fam.labelnames}, not {kind} with "
                        f"{labelnames}"
                    )
                return fam
            fam = Family(
                name=name, kind=kind, help=help, labelnames=labelnames,
                buckets=tuple(buckets) if buckets else None,
            )
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Family:
        return self._declare(name, "counter", help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Family:
        return self._declare(name, "gauge", help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (), buckets=None) -> Family:
        return self._declare(name, "histogram", help, labels, buckets)

    # ------------------------------------------------------------ reading
    def families(self) -> List[Family]:
        with self._lock:
            return [self._families[k] for k in sorted(self._families)]

    def get(self, name: str) -> Optional[Family]:
        return self._families.get(name)

    def value(self, name: str, **labels: str) -> float:
        """Scalar value of one counter/gauge child (tests/controllers)."""
        fam = self._families[name]
        child = fam.labels(**labels)
        if isinstance(child, Histogram):
            raise MetricsError(
                f"{name!r} is a histogram; read .sum/.count/.quantile"
            )
        return child.value


class MetricsCollector(StatsCollector):
    """StatsCollector adapter feeding a :class:`MetricsRegistry`.

    Wraps an inner collector (``RunStatsCollector`` or ``NullStats``) so
    the engine's existing accounting is untouched; every hook additionally
    lands in labeled registry series.  One instance per run/wave, labels
    fixed at construction: ``driver`` (host/device), ``dispatch``, ``app``.

    The per-event histograms are the part a scalar total cannot express:
    ``trees_lane_utilization`` gets one observation per epoch (host) or per
    chunk (resident — the chunk *is* the finest grain the resident path can
    observe without paying extra readbacks, see DESIGN.md §13), and
    ``trees_hole_fraction`` the matching skipped-lane share.

    ``shard`` (opt-in) adds a shard label to every series — the sharded
    fleet engine gives each shard its own collector so per-shard work
    splits and utilization spread are scrapeable directly (DESIGN.md §15).
    The registry pins labelnames per metric name, so a given registry must
    be fed consistently: all collectors sharded, or none.
    """

    def __init__(self, inner: StatsCollector, registry: MetricsRegistry,
                 driver: str, dispatch: str, app: str,
                 shard: Optional[str] = None):
        self.inner = inner
        self.registry = registry
        self.labels = dict(driver=driver, dispatch=dispatch, app=app)
        lab = ("driver", "dispatch", "app")
        if shard is not None:
            self.labels["shard"] = shard
            lab = lab + ("shard",)
        r = registry
        self._epochs = r.counter(
            "trees_epochs_total", "epochs run (critical-path T_inf)", lab
        ).labels(**self.labels)
        self._tasks = r.counter(
            "trees_tasks_total", "tasks executed (work T_1)", lab
        ).labels(**self.labels)
        self._lanes = r.counter(
            "trees_lanes_total", "lanes launched incl. padding", lab
        ).labels(**self.labels)
        self._dispatches = r.counter(
            "trees_dispatches_total", "host->device launches (V_inf)", lab
        ).labels(**self.labels)
        self._transfers = r.counter(
            "trees_transfers_total", "device->host readbacks (V_inf)", lab
        ).labels(**self.labels)
        self._forks = r.counter(
            "trees_forks_total", "tasks forked", lab
        ).labels(**self.labels)
        self._holes = r.counter(
            "trees_hole_lanes_total",
            "full-span lanes skipped by dense dispatch", lab
        ).labels(**self.labels)
        self._map_launches = r.counter(
            "trees_map_launches_total", "map payload launches", lab
        ).labels(**self.labels)
        self._map_elements = r.counter(
            "trees_map_elements_total", "live map element-lanes", lab
        ).labels(**self.labels)
        self._map_lanes = r.counter(
            "trees_map_lanes_total", "launched map element-lanes", lab
        ).labels(**self.labels)
        self._peak = r.gauge(
            "trees_peak_tv_slots", "peak TV slot cursor", lab
        ).labels(**self.labels)
        self._util = r.histogram(
            "trees_lane_utilization",
            "active/launched lanes per epoch (host) or chunk (resident)",
            lab, buckets=RATIO_BUCKETS,
        ).labels(**self.labels)
        self._hole_frac = r.histogram(
            "trees_hole_fraction",
            "skipped/full-span lanes per epoch (host) or chunk (resident)",
            lab, buckets=RATIO_BUCKETS,
        ).labels(**self.labels)
        self._pending_holes = 0

    # ------------------------------------------------------------- hooks
    def epoch(self, cen: int, n_ranges: int = 1, n: int = 1) -> None:
        self.inner.epoch(cen, n_ranges, n)
        self._epochs.inc(n)

    def lanes(self, n_active: int, launched: int, by_type=None) -> None:
        self.inner.lanes(n_active, launched, by_type)
        self._tasks.inc(n_active)
        self._lanes.inc(launched)
        holes = self._pending_holes
        self._pending_holes = 0
        full = launched + holes
        if full > 0:
            self._util.observe(n_active / full)
            self._hole_frac.observe(holes / full)

    def dispatch(self, n: int = 1) -> None:
        self.inner.dispatch(n)
        self._dispatches.inc(n)

    def transfer(self, n: int = 1) -> None:
        self.inner.transfer(n)
        self._transfers.inc(n)

    def forks(self, n: int) -> None:
        self.inner.forks(n)
        self._forks.inc(n)

    def map_launch(self, elements: int = 0, lanes: int = 0,
                   n: int = 1) -> None:
        self.inner.map_launch(elements, lanes, n)
        self._map_launches.inc(n)
        self._map_elements.inc(elements)
        self._map_lanes.inc(lanes)

    def holes_skipped(self, n: int) -> None:
        # holes are reported just before the matching lanes() call (the
        # drivers keep that order), so the pair folds into one fraction
        # observation per epoch/chunk
        self.inner.holes_skipped(n)
        self._holes.inc(n)
        self._pending_holes += n

    def tv_peak(self, slots: int) -> None:
        self.inner.tv_peak(slots)
        self._peak.max(slots)

    def result(self) -> RunStats:
        return self.inner.result()
