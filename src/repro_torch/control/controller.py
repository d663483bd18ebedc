"""Self-tuning controllers: telemetry in, dispatch/chunk decisions out
(PyTorch port of ``repro/control/controller.py``).

This module closes the runtime's first feedback loop (ROADMAP
"self-tuning runtime", DESIGN.md §14): the §13 telemetry substrate
measures hole fraction, lane utilization and queue heat, and nothing
consumed them until now.  Two independent controllers turn those series
into online decisions:

* :class:`DispatchController` — per fused epoch, pick ``masked`` /
  ``compacted`` / ``gather`` from the observed frontier fill (rolling
  window of ``active / full_span`` readbacks) priced against a
  :class:`CostModel`.  All three modes are bit-identical by construction
  (DESIGN.md §5.4/§11), so the choice only moves *overhead*, never
  results — which is what makes an online controller safe to ship
  inside the epoch loop.
* :class:`ChunkController` — between resident chunks, adapt the epoch
  bound K: widen while no completions surface (each readback that finds
  nothing finished was a wasted device->host sync), shrink when the job
  queue runs hot (``trees_job_queue_wait_seconds`` — a long K starves
  admission at the next boundary).  ``run_chunk``'s epoch bound is a
  dynamic argument of one resident body per (regions, capacity, depth)
  (on the card, of one ``epoch_chunk`` launch), so K adaptation re-enters
  the cached template and never rebuilds it.  It also folds in deadline slack from the admission layer
  (DESIGN.md §16): a tightening nearest deadline shrinks K so the
  boundaries — the only preemption yield points — come sooner.
* :class:`PlacementController` — per submitted job on a sharded fleet,
  pick ``round_robin`` / ``least_loaded`` / ``sticky`` from the observed
  workload mix (structural-type diversity vs per-shard imbalance),
  closing the ROADMAP note that placement policy was still static.

The :class:`CostModel` defaults to the reference's priors (the JAX
package's literals, so that both packages' controllers decide alike from
the same observations); a one-shot :meth:`CostModel.calibrated`
micro-probe measures what this device's epochs actually pay instead —
on the card a graph replay's round trip, the engines' default there —
cached per device in the process (and optionally on disk) so steady
state never pays probing.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ..obs.metrics import RollingWindow

# The reference's priors: the JAX package's CostModel literals (its
# benchmarks/roofline.py describes them as measured on its CPU container).
# They are not a measurement of any card; CostModel.calibrated measures
# the device at hand.
_DISPATCH_LATENCY_S = 40e-6
_TRANSFER_LATENCY_S = 15e-6

# the calibration probe's wider epoch on the card: fib(28)'s capacity,
# the widest frontier the paper's overhead microscope launches (a masked
# fib epoch over 2^21 lanes takes ~0.3 ms of device time, well above a
# graph replay's launch), where the CPU default of 4096 lanes would time
# launches alone
CUDA_PROBE_LANES = 1 << 21
# floor of a measured per-lane cost (it must stay positive).  The
# reference's floor, 1e-10 s, is of the order of what a lane of the
# cheapest epoch costs on an H100, where it could replace the
# measurement by itself
_MIN_LANE_S = 1e-15

AUTO_MODES = ("masked", "compacted", "gather")
RESIDENT_AUTO_MODES = ("masked", "gather")


def _bucket(n: int, minimum: int = 8) -> int:
    """Power-of-2 launch rounding (mirror of scheduler.launch_bucket,
    kept dependency-free so the cost model imports nothing heavy)."""
    if n <= minimum:
        return minimum
    return 1 << (int(n) - 1).bit_length()


# process-wide calibration cache: one probe per device per process
_CALIBRATION_CACHE: Dict[str, "CostModel"] = {}


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Per-epoch critical-path price of each dispatch mode (seconds).

    ``dispatch_s``/``transfer_s`` are the V_inf launch/readback latencies
    (the reference's priors unless calibrated); ``lane_s`` the marginal phase-2/3 cost of one
    launched task lane; ``pack_lane_s`` the per-lane cost of the rank/
    scan pack pass; ``per_type_s`` the per-live-type overhead of the §5.4
    compacted step's dense slices.  With the default symmetric lane
    costs, compacted is dominated by gather (same pack price, extra
    per-type slices) — DESIGN.md §14 spells out when to bias it back in.
    """

    dispatch_s: float = _DISPATCH_LATENCY_S
    transfer_s: float = _TRANSFER_LATENCY_S
    lane_s: float = 60e-9
    pack_lane_s: float = 8e-9
    per_type_s: float = 2e-6
    source: str = "roofline"  # the reference's name for its priors

    # ------------------------------------------------------------ pricing
    def epoch_costs(self, span_bucket: int, fill: float,
                    n_types: int = 1) -> Dict[str, float]:
        """Predicted cost of one fused epoch under each mode.

        ``span_bucket`` is the full-frontier launch width P (what masked
        pays); ``fill`` the predicted active fraction of that span.  The
        gather/compacted prediction launches the rung covering the
        predicted live count, and both pay the extra pack dispatch + count
        readback (DESIGN.md §11: ``2*dispatch + transfer`` vs masked's
        ``dispatch + transfer``).
        """
        P = max(1, int(span_bucket))
        fill = min(1.0, max(0.0, float(fill)))
        pred_active = max(1, int(round(fill * P)))
        dense = _bucket(pred_active)
        masked = self.dispatch_s + self.transfer_s + P * self.lane_s
        pack = self.dispatch_s + self.transfer_s + P * self.pack_lane_s
        gather = masked - (P - min(P, dense)) * self.lane_s + pack
        compacted = gather + max(1, n_types) * self.per_type_s
        return {"masked": masked, "compacted": compacted, "gather": gather}

    # -------------------------------------------------------- calibration
    @classmethod
    def calibrated(cls, capacity: Optional[int] = None, repeats: int = 5,
                   path: Optional[str] = None,
                   device=None) -> "CostModel":
        """One-shot micro-probe of this device's actual constants.

        ``device`` is CUDA unless the caller asks for another (as every
        entry point); the cache key is ``"cpu"`` or ``"cuda:<device
        name>"``.  Measures

        (a) the round trip an epoch pays: on the card the replay of a
            captured small step whose last node copies its result into
            page-locked memory, and the synchronize — what a graphed host
            epoch pays, graphs being the engines' default there; on the
            CPU one small step and its read.  Split 2:1 into dispatch and
            transfer, as the reference splits it;
        (b) the per-lane slope of the engines' own epoch: a masked
            :meth:`~repro_torch.core.engine.EpochLoop.run_epoch` of the
            fib program (the paper's overhead microscope, the cheapest
            real step) with no lane live, timed at two widths,
            ``capacity // 8`` and ``capacity`` lanes: what a hole costs a
            masked epoch, graph replay and readback included;
        (c) the per-lane slope of the gather epoch's pack pass (the
            frontier mask and ``lane_pack``, on the card the port's
            ``type_rank`` kernel) at the same widths.

        ``capacity`` defaults to 4096 on the CPU (the reference's width)
        and to :data:`CUDA_PROBE_LANES` (2^21) on the card, so that the
        wider epoch is well above a launch's time.  Each time is the best
        of ``repeats`` after the key's eager uses (and on the card its
        capture); a per-lane cost is floored at 1e-15 s (the reference's
        1e-10 floor is of the order of a lane's cost on an H100).  The
        result is cached per device for the life of the process — and
        persisted to ``path`` (JSON) when given — so a steady-state
        controller never probes again ("one-shot" is the contract, not a
        rate limit).
        """
        from ..core import graphs as cgraphs
        from ..core.engine import resolve_device

        dev = resolve_device(device)
        cuda = dev.type == "cuda"
        backend = (f"cuda:{torch.cuda.get_device_name(dev)}" if cuda
                   else dev.type)
        cached = _CALIBRATION_CACHE.get(backend)
        if cached is not None:
            return cached
        if path is not None:
            loaded = cls.load(path, backend=backend)
            if loaded is not None:
                _CALIBRATION_CACHE[backend] = loaded
                return loaded
        if capacity is None:
            capacity = CUDA_PROBE_LANES if cuda else 4096

        def _sync():
            if cuda:
                torch.cuda.synchronize(dev)

        def _min_time(fn, *args) -> float:
            fn(*args)  # build and warm outside the timed reps
            _sync()
            best = float("inf")
            for _ in range(repeats):
                t0 = time.perf_counter()
                fn(*args)
                _sync()
                best = min(best, time.perf_counter() - t0)
            return best

        # (a) dispatch + scalar readback round trip
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        if cuda:
            host = cgraphs.pinned_like(zero)

            def small_step():
                zero.add_(1)
                host.copy_(zero, non_blocking=True)
                return ()

            with torch.cuda.device(dev):
                small_step()  # the capture's warm-up
                graph = cgraphs.capture(small_step, [])
            rtt = _min_time(graph.replay)
        else:
            rtt = _min_time(lambda x: (x + 1).numpy(), zero)
        dispatch_s = rtt * (2.0 / 3.0)
        transfer_s = rtt * (1.0 / 3.0)

        # (b), (c): per-lane slopes of a masked epoch and of the pack pass
        lane_s, pack_lane_s = _epoch_slopes(dev, capacity, repeats, _min_time)

        model = cls(dispatch_s=dispatch_s, transfer_s=transfer_s,
                    lane_s=lane_s, pack_lane_s=pack_lane_s,
                    source=f"calibrated:{backend}")
        _CALIBRATION_CACHE[backend] = model
        if path is not None:
            model.save(path, backend=backend)
        return model

    def save(self, path: str, backend: str = "any") -> None:
        payload = dataclasses.asdict(self)
        payload["backend"] = backend
        pathlib.Path(path).write_text(json.dumps(payload, indent=2))

    @classmethod
    def load(cls, path: str, backend: str = "any") -> Optional["CostModel"]:
        p = pathlib.Path(path)
        if not p.exists():
            return None
        try:
            payload = json.loads(p.read_text())
        except (OSError, ValueError):
            return None
        if payload.pop("backend", "any") not in ("any", backend):
            return None
        try:
            return cls(**payload)
        except TypeError:
            return None


def _epoch_slopes(dev, capacity: int, repeats: int,
                  min_time) -> Tuple[float, float]:
    """``(lane_s, pack_lane_s)`` of the fib program between
    ``capacity // 8`` and ``capacity`` lanes, no lane live: the per-lane
    slope of a masked host epoch (a hole costs it what any lane does) and
    of the gather epoch's pack pass.  Each width's epoch and pass is run
    ``CAPTURE_AT - 1`` times before ``min_time``'s untimed call, so on
    the card that call captures its graph and the timed reps replay it,
    as in a warm run (an eager pass at these widths would time its
    launches)."""
    from ..apps import fib
    from ..core import graphs as cgraphs
    from ..core import tvm
    from ..core.engine import EpochLoop, HostEngine, Readback
    from ..core.scheduler import NullStats

    program = fib.PROGRAM
    readback = Readback(HostEngine._pack, HostEngine._unpack,
                        active=lambda fetched: fetched[3])
    loop = EpochLoop(program, "masked")
    # fib(1) in slot 0: a leaf, done in the first epoch
    state = tvm.init_state(program, capacity, fib.initial(1), dev)
    heap = tvm.heap_with_sink(program.init_heap(dev))
    cuda = dev.type == "cuda"
    side = torch.cuda.Stream(dev) if cuda else None
    passes: Dict[int, object] = {}
    epochs, packs = [], []
    for width in (max(64, capacity // 8), capacity):
        start, count, cen = (torch.tensor(v, dtype=torch.int32, device=dev)
                             for v in (0, width, 1))

        def epoch():
            loop.run_epoch(state, heap, 0, width, 1, NullStats(), readback)

        def pack():
            def fn():
                return loop.gather_pass(state, start, count, cen, width)

            if cuda:
                cgraphs.run_cached(passes, width, fn, side)
            else:
                fn()

        for _ in range(cgraphs.CAPTURE_AT - 1):
            epoch()
            pack()
        epochs.append((min_time(epoch), loop.last_span_bucket))
        packs.append((min_time(pack), width))
    return tuple(
        max(_MIN_LANE_S, (t1 - t0) / max(1, p1 - p0))
        for (t0, p0), (t1, p1) in (epochs, packs))


@dataclasses.dataclass(frozen=True)
class Decision:
    """One per-epoch dispatch decision, with its evidence attached.

    ``fill`` is the rolling-window estimate of ``active / full_span``
    (None until the first readback lands); ``hole_fraction`` its
    complement; ``costs`` the model's per-mode price in seconds;
    ``reason`` is "no-data" (cold start -> masked), "cost" (argmin) or
    "hysteresis" (kept the previous mode inside the switching band).
    """

    mode: str
    fill: Optional[float]
    costs: Dict[str, float]
    reason: str
    span_bucket: int

    @property
    def hole_fraction(self) -> Optional[float]:
        return None if self.fill is None else max(0.0, 1.0 - self.fill)


class DispatchController:
    """Per-epoch dispatch selection from observed frontier fill.

    The observation loop is driver-fed: after each epoch readback the
    driver reports ``observe(n_active, full_span_bucket)`` — active lanes
    against the *full* frontier width, not the launched width, so a
    gather epoch that launches a dense rung still measures the true hole
    fraction it is hiding.  ``choose`` then prices the next epoch's
    modes at the rolling fill estimate and picks the argmin, with a
    hysteresis band so marginal cost differences cannot flap the mode
    (every flap risks a fresh graph capture at a new (mode, width)
    key).  Cold start is masked: the cheapest critical path when nothing
    is known, and the mode whose readback seeds the window.
    """

    def __init__(self, cost: Optional[CostModel] = None,
                 modes: Sequence[str] = AUTO_MODES,
                 n_types: int = 1, window: int = 32,
                 hysteresis: float = 0.15,
                 registry=None, driver: str = "host", app: str = "?"):
        for m in modes:
            if m not in AUTO_MODES:
                raise ValueError(f"unknown auto dispatch mode {m!r}")
        self.cost = cost or CostModel()
        self.modes = tuple(modes)
        self.n_types = max(1, int(n_types))
        self.window = RollingWindow(window)
        self.hysteresis = float(hysteresis)
        self.decisions: Dict[str, int] = {m: 0 for m in self.modes}
        self.last_decision: Optional[Decision] = None
        self._last_mode: Optional[str] = None
        self._decided, self._hole_gauge, self._fill_gauge = None, None, None
        if registry is not None:
            self.bind_registry(registry, driver=driver, app=app)

    # ------------------------------------------------------------ metrics
    def bind_registry(self, registry, driver: str = "host",
                      app: str = "?") -> None:
        """Attach a MetricsRegistry: decisions land as labeled counters
        (``trees_controller_decisions_total{mode=...}``) and the observed
        hole fraction as a gauge, so adaptivity is auditable in the same
        export as the series it consumed."""
        fam = registry.counter(
            "trees_controller_decisions_total",
            "dispatch=auto per-epoch mode picks",
            ("driver", "app", "mode"),
        )
        self._decided = {
            m: fam.labels(driver=driver, app=app, mode=m) for m in self.modes
        }
        self._hole_gauge = registry.gauge(
            "trees_controller_hole_fraction",
            "rolling observed hole fraction feeding dispatch=auto",
            ("driver", "app"),
        ).labels(driver=driver, app=app)
        self._fill_gauge = registry.gauge(
            "trees_controller_fill",
            "rolling observed frontier fill feeding dispatch=auto",
            ("driver", "app"),
        ).labels(driver=driver, app=app)

    # -------------------------------------------------------- observation
    def observe(self, n_active: int, full_span: int) -> None:
        """Feed one readback: active lanes vs the full frontier width."""
        if full_span <= 0:
            return
        fill = min(1.0, max(0.0, n_active / full_span))
        self.window.add(fill)
        if self._fill_gauge is not None:
            self._fill_gauge.set(fill)
            self._hole_gauge.set(1.0 - fill)

    # ----------------------------------------------------------- decision
    def choose(self, span_bucket: int) -> Decision:
        fill = self.window.mean()
        if fill is None:
            d = Decision("masked", None, {}, "no-data", span_bucket)
        else:
            costs = self.cost.epoch_costs(span_bucket, fill, self.n_types)
            costs = {m: costs[m] for m in self.modes}
            best = min(costs, key=costs.get)
            mode, reason = best, "cost"
            prev = self._last_mode
            if (prev is not None and prev != best and prev in costs
                    and costs[prev] <= costs[best] * (1.0 + self.hysteresis)):
                mode, reason = prev, "hysteresis"
            d = Decision(mode, fill, costs, reason, span_bucket)
        self._last_mode = d.mode
        self.last_decision = d
        self.decisions[d.mode] = self.decisions.get(d.mode, 0) + 1
        if self._decided is not None and d.mode in self._decided:
            self._decided[d.mode].inc()
        return d

    def choose_resident(self, capacity: int) -> Decision:
        """Pick the mode a resident loop bakes in: masked vs
        gather only (§5.4 compacted stays host-side), decided once per
        template rather than per epoch — the wave-template cache makes the
        choice sticky per wave shape, so identical consecutive waves can
        never rebuild on a flipped decision."""
        saved = self.modes
        try:
            self.modes = tuple(m for m in RESIDENT_AUTO_MODES
                               if m in saved) or RESIDENT_AUTO_MODES
            return self.choose(capacity)
        finally:
            self.modes = saved


class ChunkController:
    """Adaptive resident chunk size K (tentpole decision (b)).

    Policy, evaluated once per chunk boundary — the only place the
    resident path surfaces information without paying an extra readback:

    * **shrink** (halve, floor ``k_min``) when the queue is hot: jobs are
      waiting and the oldest has waited longer than ``hot_wait_s`` (the
      same signal exported as ``trees_job_queue_wait_seconds``) — or the
      nearest outstanding *deadline* is within ``tight_slack_s``
      (DESIGN.md §16: boundaries are the only preemption/admission yield
      points, so a tightening deadline needs them to come sooner).  A
      long K starves admission — completions and free regions only
      surface at boundaries.
    * **widen** (double, cap ``k_max``) while a boundary surfaces no
      completions and nothing is queued: that readback bought nothing,
      so the next chunk should amortize more epochs per sync.
    * otherwise hold: completions are flowing at the current cadence.

    K feeds ``run_chunk``'s dynamic epoch bound, so every value re-enters
    the one resident body per (regions, capacity, depth) — adaptation
    rebuilds nothing by construction, and the flat ``trace_count`` test
    guards it.
    """

    def __init__(self, k_init: int = 1, k_min: int = 1, k_max: int = 4096,
                 hot_wait_s: float = 0.05, tight_slack_s: float = 0.1,
                 registry=None, app: str = "?"):
        if not (1 <= k_min <= k_init <= k_max):
            raise ValueError(
                f"need 1 <= k_min <= k_init <= k_max, got "
                f"{k_min}/{k_init}/{k_max}"
            )
        self.k = int(k_init)
        self.k_min = int(k_min)
        self.k_max = int(k_max)
        self.hot_wait_s = float(hot_wait_s)
        self.tight_slack_s = float(tight_slack_s)
        self.widened = 0
        self.shrunk = 0
        self._k_gauge = self._adapt = None
        if registry is not None:
            self.bind_registry(registry, app=app)

    def bind_registry(self, registry, app: str = "?") -> None:
        self._k_gauge = registry.gauge(
            "trees_controller_chunk_k", "adaptive resident chunk size K",
            ("app",),
        ).labels(app=app)
        self._k_gauge.set(self.k)
        fam = registry.counter(
            "trees_controller_chunk_adaptations_total",
            "chunk=auto boundary decisions", ("app", "action"),
        )
        self._adapt = {a: fam.labels(app=app, action=a)
                       for a in ("widen", "shrink", "hold")}

    def current(self) -> int:
        return self.k

    def observe(self, completions: int, queued: int = 0,
                oldest_wait_s: float = 0.0,
                deadline_slack: float = float("inf")) -> int:
        """Feed one chunk boundary; returns the K for the next chunk.

        ``deadline_slack`` is seconds until the nearest outstanding
        deadline across queued + running jobs (``inf`` when none): within
        ``tight_slack_s`` it counts as hot even with an empty queue, so
        the boundary cadence tightens before the deadline, not after."""
        hot = (
            (queued > 0 and oldest_wait_s >= self.hot_wait_s)
            or deadline_slack <= self.tight_slack_s
        )
        if hot and self.k > self.k_min:
            self.k = max(self.k_min, self.k // 2)
            self.shrunk += 1
            action = "shrink"
        elif completions == 0 and not hot and self.k < self.k_max:
            self.k = min(self.k_max, self.k * 2)
            self.widened += 1
            action = "widen"
        else:
            action = "hold"
        if self._k_gauge is not None:
            self._k_gauge.set(self.k)
            self._adapt[action].inc()
        return self.k


class PlacementController:
    """Pick the fleet placement policy per workload mix (ROADMAP item).

    ``placement="auto"`` on a sharded fleet routes every placement
    decision through here, the way ``dispatch="auto"`` routes launch
    shaping through :class:`DispatchController`.  Placement, like
    dispatch, only moves *overhead* (which shard a job lands on — never
    its results), so an online heuristic is safe:

    * **least_loaded** when the fleet runs *imbalanced*: the observed
      per-shard utilization spread or pending-queue spread exceeds its
      threshold — evening out load beats any affinity.
    * **sticky** when the workload is *type-diverse* and balanced: many
      distinct program structures in the recent submission window means
      type-affinity maximizes region compatibility on each shard (a
      queued job only seats into a structurally-equal region, so mixing
      types across shards strands free regions).
    * **round_robin** otherwise: a homogeneous balanced workload needs
      no signal — rotation is the cheapest fair spread.
    """

    def __init__(self, window: int = 64, spread_hot: float = 0.25,
                 queue_spread_hot: int = 2, diversity_hot: float = 0.5,
                 registry=None, app: str = "?"):
        self.window = int(window)
        self.spread_hot = float(spread_hot)
        self.queue_spread_hot = int(queue_spread_hot)
        self.diversity_hot = float(diversity_hot)
        self._recent_types: list = []
        self._util_spread = 0.0
        self._queue_spread = 0
        self.decisions: Dict[str, int] = {}
        self.last_policy: Optional[str] = None
        self._decided = None
        if registry is not None:
            self.bind_registry(registry, app=app)

    def bind_registry(self, registry, app: str = "?") -> None:
        fam = registry.counter(
            "trees_controller_placement_total",
            "placement=auto per-job policy picks", ("app", "policy"),
        )
        self._decided = {
            p: fam.labels(app=app, policy=p)
            for p in ("round_robin", "least_loaded", "sticky")
        }

    # -------------------------------------------------------- observation
    def observe_job(self, type_key) -> None:
        """Feed one submission's structural type (rolling window)."""
        self._recent_types.append(type_key)
        if len(self._recent_types) > self.window:
            self._recent_types.pop(0)

    def observe_imbalance(self, util_spread: float,
                          queue_spread: int) -> None:
        """Feed one collective boundary's imbalance signals: max-min
        per-shard lane utilization, max-min pending-queue depth."""
        self._util_spread = float(util_spread)
        self._queue_spread = int(queue_spread)

    @property
    def diversity(self) -> float:
        """Distinct structural types per recent submission (0..1)."""
        if not self._recent_types:
            return 0.0
        return len(set(self._recent_types)) / len(self._recent_types)

    # ----------------------------------------------------------- decision
    def choose(self) -> str:
        if (
            self._util_spread > self.spread_hot
            or self._queue_spread > self.queue_spread_hot
        ):
            policy = "least_loaded"
        elif (
            len(self._recent_types) >= 2
            and len(set(self._recent_types)) >= 2
            and self.diversity >= self.diversity_hot
        ):
            policy = "sticky"
        else:
            policy = "round_robin"
        self.last_policy = policy
        self.decisions[policy] = self.decisions.get(policy, 0) + 1
        if self._decided is not None:
            self._decided[policy].inc()
        return policy


# queue-heat probe fed to the chunk controller: (queued, oldest_wait_s)
# with an optional third element, seconds of slack to the nearest
# outstanding deadline (drivers accept both arities)
QueueProbe = Callable[[], Tuple[float, ...]]
