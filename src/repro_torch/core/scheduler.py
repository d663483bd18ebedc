"""Epoch scheduling layer, host half (PyTorch port of
``repro/core/scheduler.py``): phase-1 policy above the TVM substrate.

  * :class:`EpochScheduler` — the host-side join/NDRange stacks with
    same-CEN range coalescing: every range sitting at the current epoch
    number is merged into one dispatch, so the critical-path overhead
    (launch + readback, the V_inf terms) is paid once for the whole system.
  * :class:`DispatchPolicy` — launch-bucket sizing.  ``masked`` pads the
    popped NDRange to a power-of-two bucket and runs every task type
    full-width, masked.  ``compacted`` is the §5.4 contiguity principle:
    active lanes are scattered into dense per-type ranges (the ``type_rank``
    kernel's ``type_pack``) and each type launches as one dense slice sized
    to its own population.  ``gather`` packs every scheduled lane into one
    dense frontier (``kernels.ops.lane_pack``).
  * :class:`MuxPopPolicy` — which tenants' stacks pop into one fused
    global epoch of the job service (``fuse_all``, ``round_robin``,
    ``deepest_first``, with an optional ``gang`` bound).
  * :class:`StatsCollector` — pluggable work/critical-path accounting
    (:class:`RunStats`).
  * :func:`batched_device_stacks` / :func:`batched_device_pop` /
    :func:`batched_device_push` — the same join/NDRange discipline as
    ``[n_regions, depth]`` tensors, for the resident loop (no host
    readback per epoch).

Everything above the device stacks is pure host Python.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

_I32 = torch.int32


# --------------------------------------------------------------------------
# Launch-bucket sizing (dispatch policy)
# --------------------------------------------------------------------------
def launch_bucket(n: int, minimum: int = 8) -> int:
    """Round a launch size up to a power-of-two bucket."""
    p = max(1, minimum)
    while p < n:
        p *= 2
    return p


@dataclasses.dataclass(frozen=True)
class DispatchPolicy:
    """How phase 2 lays tasks into lanes and sizes the launch.

    ``epoch_min_bucket`` sizes the full-NDRange launch (and the compaction
    pass itself); ``type_min_bucket`` sizes each dense per-type slice under
    the compacted dispatch (minimum 1: lane-exact launches).
    """

    name: str
    epoch_min_bucket: int = 8
    type_min_bucket: int = 1

    def epoch_bucket(self, count: int) -> int:
        return launch_bucket(count, self.epoch_min_bucket)

    def type_bucket(self, count: int) -> int:
        if count <= 0:
            return 0
        return launch_bucket(count, self.type_min_bucket)


def size_type_buckets(policy: DispatchPolicy, counts, task_names):
    """Per-type launch plan from the compaction counts readback (§5.4).

    Returns ``(buckets, toffs, launched, by_type)``: the per-type bucket
    tuple, the exclusive per-type offsets into the compaction permutation,
    total lanes launched, and the ``{name: (active, lanes)}`` dict fed to
    ``StatsCollector.lanes``.
    """
    counts = np.asarray(counts)
    buckets = tuple(policy.type_bucket(int(c)) for c in counts)
    toffs = np.zeros_like(counts)
    toffs[1:] = np.cumsum(counts)[:-1]
    by_type = {
        task_names[t]: (int(counts[t]), buckets[t])
        for t in range(len(buckets))
        if buckets[t] > 0
    }
    return buckets, toffs, int(sum(buckets)), by_type


MASKED = DispatchPolicy("masked")
COMPACTED = DispatchPolicy("compacted")
GATHER = DispatchPolicy("gather")
_POLICIES = {p.name: p for p in (MASKED, COMPACTED, GATHER)}


def resolve_policy(dispatch) -> DispatchPolicy:
    if isinstance(dispatch, DispatchPolicy):
        dispatch = dispatch.name
    if dispatch == "auto":
        raise ValueError(
            "dispatch='auto' (the per-epoch dispatch controller) is not "
            "ported yet; choose 'masked', 'compacted' or 'gather'"
        )
    try:
        return _POLICIES[dispatch]
    except KeyError:
        raise ValueError(
            f"unknown dispatch policy {dispatch!r}; "
            f"expected one of {sorted(_POLICIES)}"
        ) from None


# --------------------------------------------------------------------------
# Host-side epoch scheduler (paper phase 1, §5.2.2)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class EpochDispatch:
    """One popped unit of work: every range at epoch number ``cen``."""

    cen: int
    start: int
    count: int
    n_ranges: int = 1  # how many stack ranges were coalesced into this span


class EpochScheduler:
    """Owns the join/NDRange stacks the paper keeps on the CPU (§5.2.2).

    LIFO pop order gives the paper's depth-first epoch order.  With
    ``coalesce=True`` a pop also drains every other stack entry carrying the
    same epoch number and merges the ranges into one covering span — holes
    between ranges hold lanes with different epoch numbers and are filtered
    by the epoch-number (TMS) check.
    """

    def __init__(self, coalesce: bool = True):
        self.coalesce = coalesce
        self._join: List[int] = []
        self._range: List[Tuple[int, int]] = []

    def reset(self, cen: int = 1, start: int = 0, count: int = 1) -> None:
        """Seed task in slot 0, eligible in the first epoch (paper §4.3)."""
        self._join = [cen]
        self._range = [(start, count)]

    def __bool__(self) -> bool:
        return bool(self._join)

    def pop(self) -> EpochDispatch:
        if not self._join:
            raise RuntimeError("scheduler empty — program already drained")
        cen = self._join.pop()
        start, count = self._range.pop()
        lo, hi, n = start, start + count, 1
        if self.coalesce:
            while self._join and self._join[-1] == cen:
                self._join.pop()
                s, c = self._range.pop()
                lo, hi, n = min(lo, s), max(hi, s + c), n + 1
        return EpochDispatch(cen=cen, start=lo, count=hi - lo, n_ranges=n)

    def push_join(self, cen: int, start: int, count: int) -> None:
        """Re-arm the current range: a join continuation runs at the same CEN."""
        self._join.append(cen)
        self._range.append((start, count))

    def push_forked(self, cen: int, base: int, count: int) -> None:
        """Schedule this epoch's forked children (eligible at CEN+1)."""
        if count > 0:
            self._join.append(cen)
            self._range.append((base, count))

    def __len__(self) -> int:
        return len(self._join)

    # -------------------------------------------------- checkpoint support
    def export_stack(self) -> Tuple[np.ndarray, np.ndarray]:
        """Snapshot the stacks bottom-to-top as ``(cens i32[sp],
        ranges i32[sp, 2])`` — the layout of one row of the device stacks,
        so a preempted job's stacks travel in a ``RegionCheckpoint``."""
        cens = np.asarray(self._join, np.int32)
        ranges = (
            np.asarray(self._range, np.int32).reshape(-1, 2)
            if self._range else np.zeros((0, 2), np.int32)
        )
        return cens, ranges

    def load_stack(self, cens, ranges) -> None:
        """Restore a snapshot taken by :meth:`export_stack`: entries are
        bottom-to-top, replacing any current content."""
        self._join = [int(c) for c in np.asarray(cens).reshape(-1)]
        self._range = [
            (int(s), int(c))
            for s, c in np.asarray(ranges).reshape(-1, 2)
        ]


# --------------------------------------------------------------------------
# Multi-stack pop policy (service layer: which jobs fuse into one epoch)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MuxPopPolicy:
    """Which per-job scheduler stacks pop into one fused global epoch.

    The epoch multiplexer keeps one :class:`EpochScheduler` per admitted
    job; each global epoch it selects a *gang* of ready jobs, pops one
    dispatch from each, and fuses them into a single launch + readback.
    ``gang`` bounds the fan-in (0 = unlimited); the name picks the
    selection order when the gang is full:

      * ``fuse_all``      — every ready job, maximal fusion;
      * ``round_robin``   — rotate the starting job each global epoch, so
        a bounded gang shares the fused dispatches fairly;
      * ``deepest_first`` — prefer jobs with the deepest stacks.
    """

    name: str
    gang: int = 0  # max jobs fused per global epoch; 0 = no limit

    def select(self, ready: List[int], depths: List[int],
               rotor: int) -> List[int]:
        """Pick which of the ready job indices pop this global epoch."""
        if self.gang <= 0 or len(ready) <= self.gang:
            return list(ready)
        if self.name == "round_robin":
            k = rotor % len(ready)
            rotated = ready[k:] + ready[:k]
            return rotated[: self.gang]
        if self.name == "deepest_first":
            order = sorted(range(len(ready)), key=lambda i: -depths[i])
            return [ready[i] for i in order[: self.gang]]
        return list(ready)[: self.gang]


FUSE_ALL = MuxPopPolicy("fuse_all")
_MUX_POLICIES = ("fuse_all", "round_robin", "deepest_first")


def resolve_mux_policy(policy, gang: int = 0) -> MuxPopPolicy:
    if isinstance(policy, MuxPopPolicy):
        # an explicitly requested gang bound overrides the instance's
        if gang and gang != policy.gang:
            return dataclasses.replace(policy, gang=gang)
        return policy
    if policy in _MUX_POLICIES:
        return MuxPopPolicy(policy, gang)
    raise ValueError(
        f"unknown mux pop policy {policy!r}; expected one of {_MUX_POLICIES}"
    )


# --------------------------------------------------------------------------
# Stats: work / critical-path accounting (paper §4.4.1)
# --------------------------------------------------------------------------
@dataclasses.dataclass
class RunStats:
    """Work/critical-path accounting in the paper's terms (§4.4.1)."""

    epochs: int = 0                 # critical path length T_inf (in epochs)
    tasks_executed: int = 0         # work T_1 (in tasks)
    lanes_launched: int = 0         # includes padding/invalid lanes
    total_forks: int = 0
    map_launches: int = 0
    map_elements: int = 0           # live map element-lanes (useful work)
    map_lanes_launched: int = 0     # incl. padding to the launch domain
    peak_tv_slots: int = 0          # space (paper §4.4.2)
    dispatches: int = 0             # host->device program launches (V_inf)
    scalar_transfers: int = 0       # device->host readbacks (V_inf)
    ranges_coalesced: int = 0       # extra same-CEN ranges merged into pops
    hole_lanes_skipped: int = 0     # lanes a full-span launch would have paid
    tasks_by_type: Dict[str, int] = dataclasses.field(default_factory=dict)
    lanes_by_type: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def utilization(self) -> float:
        """Active lanes / launched lanes — the SIMT-divergence analogue."""
        return self.tasks_executed / max(1, self.lanes_launched)

    @property
    def map_lanes_wasted(self) -> int:
        """Map element-lanes launched beyond the live domains."""
        return max(0, self.map_lanes_launched - self.map_elements)

    @property
    def map_utilization(self) -> float:
        """Live map elements / launched map lanes (1.0 when no maps ran)."""
        if self.map_lanes_launched <= 0:
            return 1.0
        return self.map_elements / self.map_lanes_launched

    def as_dict(self, derived: bool = True) -> Dict[str, object]:
        """Canonical ``metric name -> value`` view of this run (the same
        names as the JAX reference's ``RunStats.as_dict``)."""
        out: Dict[str, object] = {
            f.name: getattr(self, f.name) for f in dataclasses.fields(self)
        }
        out["tasks_by_type"] = dict(self.tasks_by_type)
        out["lanes_by_type"] = dict(self.lanes_by_type)
        if derived:
            out["utilization"] = self.utilization
            out["map_lanes_wasted"] = self.map_lanes_wasted
            out["map_utilization"] = self.map_utilization
        return out

    def merge(self, s: "RunStats") -> "RunStats":
        """Accumulate another run/wave's stats into this one, in place.

        Counters add; ``peak_tv_slots`` is a high-water mark and takes the
        max; the per-type dicts merge per key.  Returns ``self``.
        """
        for f in dataclasses.fields(self):
            if f.name == "peak_tv_slots":
                self.peak_tv_slots = max(self.peak_tv_slots, s.peak_tv_slots)
            elif f.name in ("tasks_by_type", "lanes_by_type"):
                mine = getattr(self, f.name)
                for k, v in getattr(s, f.name).items():
                    mine[k] = mine.get(k, 0) + v
            else:
                setattr(self, f.name, getattr(self, f.name)
                        + getattr(s, f.name))
        return self


class StatsCollector:
    """No-op base; engines call these hooks, collectors interpret them."""

    def epoch(self, cen: int, n_ranges: int = 1, n: int = 1) -> None:
        pass

    def lanes(self, n_active: int, launched: int,
              by_type: Optional[Dict[str, Tuple[int, int]]] = None) -> None:
        pass

    def dispatch(self, n: int = 1) -> None:
        pass

    def transfer(self, n: int = 1) -> None:
        pass

    def forks(self, n: int) -> None:
        pass

    def map_launch(self, elements: int = 0, lanes: int = 0,
                   n: int = 1) -> None:
        pass

    def holes_skipped(self, n: int) -> None:
        """Lanes a full-span launch would have paid that a dense dispatch
        (the gather frontier) did not launch."""
        pass

    def tv_peak(self, slots: int) -> None:
        pass

    def result(self) -> RunStats:
        return RunStats()


class NullStats(StatsCollector):
    """Counts only what the driver needs for control plus the V_inf terms
    (epochs, dispatches, transfers, map launches) — no per-lane accounting."""

    def __init__(self):
        self._stats = RunStats()

    def epoch(self, cen: int, n_ranges: int = 1, n: int = 1) -> None:
        self._stats.epochs += n

    def dispatch(self, n: int = 1) -> None:
        self._stats.dispatches += n

    def transfer(self, n: int = 1) -> None:
        self._stats.scalar_transfers += n

    def map_launch(self, elements: int = 0, lanes: int = 0,
                   n: int = 1) -> None:
        self._stats.map_launches += n

    def result(self) -> RunStats:
        return self._stats


class RunStatsCollector(NullStats):
    """Full accounting, including per-type occupancy when the dispatch
    policy knows per-type populations (compacted)."""

    def lanes(self, n_active: int, launched: int,
              by_type: Optional[Dict[str, Tuple[int, int]]] = None) -> None:
        s = self._stats
        s.tasks_executed += n_active
        s.lanes_launched += launched
        if by_type:
            for name, (active, lanes) in by_type.items():
                s.tasks_by_type[name] = s.tasks_by_type.get(name, 0) + active
                s.lanes_by_type[name] = s.lanes_by_type.get(name, 0) + lanes

    def epoch(self, cen: int, n_ranges: int = 1, n: int = 1) -> None:
        super().epoch(cen, n_ranges, n)
        self._stats.ranges_coalesced += n_ranges - n

    def forks(self, n: int) -> None:
        self._stats.total_forks += n

    def map_launch(self, elements: int = 0, lanes: int = 0,
                   n: int = 1) -> None:
        super().map_launch(elements, lanes, n)
        self._stats.map_elements += elements
        self._stats.map_lanes_launched += lanes

    def holes_skipped(self, n: int) -> None:
        self._stats.hole_lanes_skipped += n

    def tv_peak(self, slots: int) -> None:
        self._stats.peak_tv_slots = max(self._stats.peak_tv_slots, slots)


# --------------------------------------------------------------------------
# Device-side stacks (the same discipline inside the resident loop)
# --------------------------------------------------------------------------
def batched_device_stacks(n_regions: int, depth: int, device, cens=None,
                          starts=None, counts=None):
    """``[n_regions, depth]`` join/NDRange stacks as device tensors.

    Every region's stack is seeded like :meth:`EpochScheduler.reset`: one
    entry ``(cen, start, count)`` with its stack pointer at 1.  Defaults
    seed region ``j`` with ``(1, 0, 1)``.  Returns ``(jstack i32[J, depth],
    rstack i32[J, depth, 2], sp i32[J])``.
    """
    J = n_regions

    def seed(v, default):
        if v is None:
            return torch.full((J,), default, dtype=_I32, device=device)
        return torch.as_tensor(v, device=device).to(_I32)

    jstack = torch.zeros((J, depth), dtype=_I32, device=device)
    rstack = torch.zeros((J, depth, 2), dtype=_I32, device=device)
    jstack[:, 0] = seed(cens, 1)
    rstack[:, 0, 0] = seed(starts, 0)
    rstack[:, 0, 1] = seed(counts, 1)
    return jstack, rstack, torch.ones((J,), dtype=_I32, device=device)


def batched_device_pop(jstack, rstack, sp):
    """Pop the top entry of every non-empty region stack at once.

    Returns ``(cen, start, count, live, sp')``, all ``[n_regions]``; regions
    with an empty stack report ``live=False`` and zeroed pop values (an
    all-zero range is inert: epoch number 0 matches no valid TV slot).
    The stacks themselves are left as they are.
    """
    J, depth = jstack.shape
    live = sp > 0
    top = (sp - 1).clamp(0, depth - 1).long()
    rows = torch.arange(J, device=sp.device)
    cen = torch.where(live, jstack[rows, top], 0)
    start = torch.where(live, rstack[rows, top, 0], 0)
    count = torch.where(live, rstack[rows, top, 1], 0)
    return cen, start, count, live, sp - live.to(_I32)


def batched_device_push(jstack, rstack, sp, cen, start, count, pred,
                        depth: int):
    """Conditionally push one ``(cen, range)`` entry per region.

    ``cen``/``start``/``count``/``pred`` are ``[n_regions]``.  Updates the
    stacks in place and returns ``(jstack, rstack, sp', overflow)`` where
    ``overflow[j]`` flags a push attempted on a full stack: as in the JAX
    reference the write is clipped to the top row (overwriting it) and the
    caller must fail that region — its schedule is no longer trustworthy.
    """
    J = jstack.shape[0]
    rows = torch.arange(J, device=sp.device)
    overflow = pred & (sp >= depth)
    ssp = sp.clamp(0, depth - 1).long()
    jstack[rows, ssp] = torch.where(pred, cen.to(_I32), jstack[rows, ssp])
    entry = torch.stack([start, count], dim=-1).to(_I32)
    rstack[rows, ssp] = torch.where(pred[:, None], entry, rstack[rows, ssp])
    return jstack, rstack, sp + pred.to(_I32), overflow


def reseed_region_stacks(jstack, rstack, sp, j: int, cen: int = 1,
                         start: int = 0, count: int = 1):
    """Reset region ``j``'s stack row to a fresh seed, in place, leaving
    every other region untouched.

    The chunked resident driver (DESIGN.md §10) uses this between chunks
    to admit a queued tenant into a freed region: the row is cleared and
    seeded like one row of :func:`batched_device_stacks`, and the region's
    stack pointer returns to 1, so the next chunk sees one more live
    region.  Returns ``(jstack, rstack, sp)``.
    """
    jstack[j] = 0
    rstack[j] = 0
    jstack[j, 0] = cen
    rstack[j, 0, 0] = start
    rstack[j, 0, 1] = count
    sp[j] = 1
    return jstack, rstack, sp


def load_region_stacks(jstack, rstack, sp, j: int, cens, ranges):
    """Replace region ``j``'s stack row with a checkpointed stack image,
    in place.

    The multi-entry sibling of :func:`reseed_region_stacks`, used by the
    preemption path (DESIGN.md §16): ``cens`` and ``ranges`` are the job's
    ``sp`` entries, bottom to top (the layout
    :meth:`EpochScheduler.export_stack` emits).  Returns ``(jstack,
    rstack, sp)``.
    """
    cens = np.asarray(cens, np.int32).reshape(-1)
    ranges = np.asarray(ranges, np.int32).reshape(-1, 2)
    n = cens.shape[0]
    depth = jstack.shape[1]
    if n > depth:
        raise ValueError(
            f"checkpointed stack depth {n} exceeds this wave's "
            f"stack_depth {depth}"
        )
    jstack[j] = 0
    rstack[j] = 0
    if n:
        jstack[j, :n] = torch.as_tensor(cens, device=jstack.device)
        rstack[j, :n] = torch.as_tensor(ranges, device=rstack.device)
    sp[j] = n
    return jstack, rstack, sp
