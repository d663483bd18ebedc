"""TREES epoch engines (PyTorch port of ``repro/core/engine.py``).

:class:`EpochLoop` is the driver core: the masked full-width step, the §5.4
compaction pass + dense per-type step, the §11 gather pack + dense
frontier step, the one-epoch driver :meth:`EpochLoop.run_epoch`, and the
resident loop (:meth:`EpochLoop.resident_body`, :meth:`EpochLoop.run_chunk`).
Two engines configure it:

  * :class:`HostEngine` — the paper-faithful CPU/GPU split: the Python host
    performs phase 1 (stack bookkeeping) and reads the end-of-epoch scalars
    — the paper's ``joinScheduled``/``mapScheduled``/``nextFreeCore``
    transfers — once per epoch, while phases 2 and 3 run as tensor code on
    the device.
  * :class:`DeviceEngine` — the resident variant: the stacks are
    ``[1, depth]`` device tensors and every scalar a host loop would read
    per epoch accrues in a :class:`ResidentCarry`, read once per chunk as a
    :class:`ChunkSummary`.  With ``megakernel=True`` a chunk on the card is
    one launch of the hand-written ``epoch_chunk`` kernel
    (``kernels/epoch_megakernel.py``); otherwise, and on the CPU, it is the
    plain loop ``kernels/ref.py::epoch_chunk_ref`` over
    :meth:`EpochLoop.resident_body`, which reads the loop condition and the
    popped range on the host once per epoch (eager PyTorch picks the step
    width there, where the JAX reference ``lax.switch``-es on the device).

PyTorch runs eagerly, so the step builders of the JAX reference are plain
methods here (no jit caches).  The scans on the path run the port's CUDA
kernels on the card (``kernels/ops.py``): fork-slot allocation goes
through ``fork_scan``; the compaction's permutation and the gather pack
are written by the ``type_rank`` kernel (``type_pack``, ``lane_pack``).

Resident counters are native int64 tensors where the JAX carry keeps exact
i32 hi/lo pairs (it runs without x64); decoded, they are the same numbers.

The host steps and :meth:`EpochLoop.run_epoch` also drive fused fleets
(``service/multiplexer.py``): a per-lane CEN vector over the popped
regions and a ``tvm.JobArena``, whose commit allocates through the
``segmented_fork_scan`` kernel on the card.  Idle task types run masked
(no per-type host sync to skip them; the same bits).

Plug points, as in the JAX engine: ``fork_offsets_fn`` replaces
``fork_scan`` in the commit, ``rank_fn`` the rank of the compaction pass
(the permutation is then built from the ranks with torch operations),
``pack_fn`` the gather pack (host pass, resident frontier and resident map
rows).  Unset, each runs the port's kernel as above.

The resident loop runs fleet carries too (a ``tvm.JobArena`` and one
stack row per region, ``service/multiplexer.py``'s ``DeviceMultiplexer``):
every live region's pop is fused into one per-lane CEN vector and
committed with the segmented allocator, the region cursors riding the
carry.  :meth:`EpochLoop.run_chunk` keeps one resident body per
``(n_regions, capacity, depth)`` and counts each build in
``EpochLoop.trace_count`` (the JAX loop's trace counter).

Not ported yet: the sharded fleet chunk (``run_chunk_fleet``,
``fleet_chunk_summaries``), ``dispatch="auto"``, the tracer, the
controller and ``seg_offsets_fn``.  ``donate`` has no meaning here: the
state is updated in place.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import tvm
from .program import InitialTask, Program
from .scheduler import (
    MASKED,
    DispatchPolicy,
    EpochScheduler,
    NullStats,
    RunStats,
    RunStatsCollector,
    StatsCollector,
    batched_device_pop,
    batched_device_push,
    batched_device_stacks,
    launch_bucket,
    resolve_policy,
    size_type_buckets,
)
from ..kernels import ops as kops
from ..kernels import ref as kref

_I32 = torch.int32


class EngineError(RuntimeError):
    pass


_COMPACTED_RESIDENT_MSG = (
    "resident (device) execution supports the 'masked' and 'gather' "
    "dispatches: the on-device loop needs launch shapes fixed at trace "
    "time — gather packs into a fixed-shape in-loop frontier, but "
    "'compacted' sizes per-type launches from runtime populations (use a "
    "host-loop driver for compacted dispatch)"
)


def resolve_device(device=None) -> torch.device:
    """The engine's device: CUDA unless the caller asks for another.

    There is no fallback: asking for CUDA (or nothing) where CUDA is absent
    raises.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def _frontier_mask(state: tvm.TVMState, start: int, count: int, cen,
                   P: int):
    """Per-lane active predicate of a popped NDRange frontier.

    A lane is active when it is inside the popped range, carries a nonzero
    epoch number (0 tags lanes outside every popped range on fused
    frontiers), and TMS-matches (``epoch[slot] == cen``).  ``cen`` is an
    int (solo frontier) or an ``i32[P]`` tensor (one epoch number per
    lane).  This predicate defines which lanes every dispatch mode
    executes.  Returns ``(idx, active, cen_l)``.
    """
    ar = torch.arange(P, dtype=_I32, device=state.device)
    idx = start + ar
    cidx = idx.clamp(0, state.capacity - 1)
    cen_l = torch.as_tensor(cen, dtype=_I32, device=state.device)
    active = (ar < count) & (cen_l > 0) & (state.epoch[cidx] == cen_l)
    return idx, active, cen_l


class MapLauncher:
    """Host-side launcher for scheduled ``map`` payloads (paper §5.2.4).

    Sizes each payload launch to the *live* element domain of its scheduled
    lanes and skips payloads whose lanes all have empty domains.  Reads the
    scheduled lanes' ``argi`` on the host to size the launch, as the JAX
    reference does, and launches the payload over those lanes alone, in
    lane order (the same writes: an unscheduled lane writes nothing; a
    fused fleet's ``P`` spans every tenant's region, and ``[P, D]`` would
    not fit).  The stats count the reference's ``[P, D]`` launch.
    """

    def __init__(self, program: Program):
        self.program = program

    def run(self, map_launches, heap, col: StatsCollector):
        """Launch each scheduled map payload, sized to its live domain."""
        for ml in map_launches:
            rows = torch.nonzero(ml.where).flatten()
            if rows.numel() == 0:
                continue
            argi = ml.argi[rows]
            dom = np.asarray(
                self.program.maps[ml.map_id].domain(argi.cpu().numpy()))
            dmax = int(dom.max())
            if dmax <= 0:
                # every scheduled lane has an empty element domain: a launch
                # would dispatch a wasted payload
                continue
            D = launch_bucket(dmax, minimum=8)
            P = int(ml.where.shape[0])
            heap = tvm.run_map_payload(
                self.program, heap, ml.map_id, ml.where[rows], argi,
                ml.argf[rows], D,
            )
            col.dispatch()
            col.map_launch(int(dom.sum()), P * D)
        return heap


@dataclasses.dataclass
class ResidentCarry:
    """State of the resident loop, threaded from epoch to epoch.

    The TVM + heap (both with their sink rows), the ``[n_regions, depth]``
    scheduler stacks with per-region stack pointers, and device
    accumulators for every scalar a host loop would have read back per
    epoch — the resident "readback policy" is to fetch them once, after the
    chunk.  The fields follow the JAX ``ResidentCarry`` in order; the
    hi/lo pairs there are int64 tensors here, and ``fault`` is the port's
    own (the ``epoch_chunk`` kernel's fault code, 0 = none; the plain loop
    never sets it).
    """

    state: Any         # tvm.TVMState
    heap: Any          # Dict[str, torch.Tensor]
    arena: Any         # tvm.JobArena (fleet) or None (solo)
    jstack: Any        # i32[J, depth]
    rstack: Any        # i32[J, depth, 2]
    sp: Any            # i32[J]   per-region stack pointers
    failed: Any        # bool[J]  region failed (TV or stack overflow)
    failed_stack: Any  # bool[J]  the failure was scheduler stack depth
    n_epochs: Any      # i32[]    global epochs (loop iterations)
    job_epochs: Any    # i32[J]   per-region epochs (== solo epochs)
    job_tasks: Any     # i64[J]   per-region tasks executed (T1)
    job_forks: Any     # i64[J]   per-region total forks
    job_peak: Any      # i32[J]   per-region peak TV cursor
    map_launches: Any  # i32[]    map payload launches
    map_elements: Any  # i64[]    live map element-lanes
    map_lanes: Any     # i64[]    launched element-lanes (lane x domain rung)
    hole_lanes: Any    # i64[]    full-TV lanes the span buckets skipped
    fault: Any         # i32[]    epoch_chunk kernel fault code (0 = none)

    def clone(self) -> "ResidentCarry":
        """A deep copy (the resident loop updates its carry in place)."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor):
                v = v.clone()
            elif isinstance(v, dict):
                v = {k: t.clone() for k, t in v.items()}
            elif dataclasses.is_dataclass(v):  # TVMState, JobArena
                v = type(v)(**{
                    g.name: getattr(v, g.name).clone()
                    for g in dataclasses.fields(v)
                })
            out[f.name] = v
        return ResidentCarry(**out)


_HILO_BASE = 1 << 20  # the JAX carry's split radix: hi * 2^20 + lo


def _hilo_value(acc) -> np.ndarray:
    """Decode the JAX carry's i32 hi/lo pairs (``[..., 2]``) to int64."""
    a = np.asarray(acc).astype(np.int64)
    return a[..., 0] * _HILO_BASE + a[..., 1]


@dataclasses.dataclass(frozen=True)
class ChunkSummary:
    """Host-side snapshot fetched once per chunk boundary (DESIGN.md §10).

    Per-region stack pointers (``sp[j] == 0``: region ``j`` drained),
    failure flags, the per-region accumulators, map-launch volumes — what
    the host needs between chunks, without touching the bulk TV/heap
    state.  ``arena_next`` holds the fleet's region cursors (``None``
    solo).
    """

    n_epochs: int             # global epochs run so far (all chunks)
    sp: np.ndarray            # i32[J] remaining stack entries per region
    failed: np.ndarray        # bool[J] region failed (TV or stack overflow)
    failed_stack: np.ndarray  # bool[J] the failure was scheduler stack depth
    job_epochs: np.ndarray    # i32[J] per-region epochs (== solo epochs)
    job_tasks: np.ndarray     # i64[J] per-region tasks executed (T1)
    job_forks: np.ndarray     # i64[J] per-region total forks
    job_peak: np.ndarray      # i32[J] per-region peak TV cursor
    map_launches: int
    map_elements: int
    map_lanes: int
    hole_lanes: int           # full-TV lanes the live-span buckets skipped
    arena_next: Optional[np.ndarray]  # i32[J] region cursors (fleet only)


def _map_width_ladder(max_domain: int, minimum: int = 8) -> Tuple[int, ...]:
    """Power-of-2 payload widths, capped at ``max_domain``.

    The resident map launcher picks the smallest rung covering the max of
    the scheduled lanes' live domains.  ``minimum`` is clamped when it
    reaches ``max_domain``, so a tiny domain does not degenerate to one
    full-width rung.
    """
    if max_domain <= minimum:
        minimum = max(1, max_domain // 2)
    widths: List[int] = []
    w = minimum
    while w < max_domain:
        widths.append(w)
        w *= 2
    widths.append(max_domain)
    return tuple(widths)


def _span_width_ladder(capacity: int, levels: int = 4,
                       minimum: int = 8) -> Tuple[int, ...]:
    """Live-span launch widths for the resident epoch step.

    A halving ladder from the full TV down ``levels`` rungs: each epoch
    launches at the smallest rung covering the popped range (masked) or
    the pack count (gather); the top rung is the full TV.  ``minimum`` is
    clamped when it reaches ``capacity``.
    """
    if capacity <= minimum:
        minimum = max(1, capacity // 2)
    widths = [int(capacity)]
    w = capacity // 2
    while len(widths) < levels and w >= max(1, minimum):
        widths.append(int(w))
        w //= 2
    return tuple(sorted(widths))


def _rung(widths: Tuple[int, ...], key: int) -> int:
    """The smallest rung ``>= key`` (``searchsorted`` left), clipped to the
    top rung."""
    return widths[min(bisect.bisect_left(widths, key), len(widths) - 1)]


def _fresh_resident_carry(state, heap, arena, jstack, rstack, sp,
                          n_regions: int) -> ResidentCarry:
    dev = jstack.device

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return ResidentCarry(
        state=state, heap=heap, arena=arena,
        jstack=jstack, rstack=rstack, sp=sp,
        failed=z((n_regions,), torch.bool),
        failed_stack=z((n_regions,), torch.bool),
        n_epochs=z((), _I32), job_epochs=z((n_regions,), _I32),
        job_tasks=z((n_regions,), torch.int64),
        job_forks=z((n_regions,), torch.int64),
        job_peak=z((n_regions,), _I32),
        map_launches=z((), _I32), map_elements=z((), torch.int64),
        map_lanes=z((), torch.int64), hole_lanes=z((), torch.int64),
        fault=z((), _I32),
    )


def _resident_cond(carry: ResidentCarry, limit) -> bool:
    """Chunk loop condition: some stack is live and the epoch bound is not
    reached (one host read)."""
    return bool(((carry.sp > 0).any() & (carry.n_epochs < limit)).item())


def _clear_sinks(state: tvm.TVMState, heap) -> None:
    """Zero the sink rows, where the plain loop's dropped scatters land,
    so that a carry's bits do not depend on which dropped write came last
    (the ``epoch_chunk`` kernel drops them and never writes a sink)."""
    for f in dataclasses.fields(state):
        t = getattr(state, f.name)
        if t.dim() > 0:
            t[-1] = 0
    for t in heap.values():
        t[-1] = 0


class EpochLoop:
    """The epoch core: step builders, the one-epoch host driver and the
    resident chunk loop."""

    def __init__(self, program: Program, dispatch: Any = MASKED,
                 megakernel: bool = False, *,
                 rank_fn: Optional[Callable] = None,
                 pack_fn: Optional[Callable] = None,
                 fork_offsets_fn: Optional[Callable] = None,
                 tenants: Optional[List[Any]] = None):
        self.program = program
        # a fused fleet's TenantSlot layout (service/multiplexer.py): the
        # epoch_chunk kernel dispatches each region to its tenant's table
        self.tenants = None if tenants is None else list(tenants)
        self.policy: DispatchPolicy = resolve_policy(dispatch)
        self.task_names = [t.name for t in program.tasks]
        self.maps = MapLauncher(program)
        # plug points (None: the port's kernels through kernels/ops.py)
        self._rank_fn = rank_fn
        self._pack_fn = pack_fn or kops.lane_pack
        self._fork_offsets_fn = fork_offsets_fn
        # resident chunks on the card run as one epoch_chunk kernel launch
        # (kernels/epoch_megakernel.py) instead of the plain loop; the
        # same bits, one launch per chunk (DESIGN.md §12)
        self.megakernel = bool(megakernel)
        # resident bodies per (n_regions, capacity, depth), each build
        # counted: the wave-template cache's zero-rebuild check reads it
        self._resident_cache: Dict[Tuple[int, int, int], Callable] = {}
        self.trace_count = 0
        # the epoch_chunk kernel's table (a fleet: its plan), found once
        self._device_table = None

    # ------------------------------------------------------------ the steps
    # ``cen`` is an int or a per-lane ``i32[P]`` tensor (a fused frontier);
    # ``arena`` is None (solo: one nextFreeCore) or a ``tvm.JobArena``
    # (per-region cursors, the service's fleets).
    def masked_step(self, state, heap, start: int, count: int, cen,
                    P: int, arena=None):
        """Phase 2+3 over the full padded NDRange, every type masked."""
        idx, active, cen_l = _frontier_mask(state, start, count, cen, P)
        per_type, _ = tvm.trace_tasks(self.program, state, heap, idx, active)
        return tvm.commit_epoch(
            self.program, state, heap, idx, active, per_type, cen_l,
            arena=arena, fork_offsets_fn=self._fork_offsets_fn,
        )

    def compact_pass(self, state, start: int, count: int, cen, P: int):
        """Compaction pass: types -> ``(perm, per-type counts)`` (§5.4's
        extra dispatch + transfer, paid to make phase 2 lane-exact)."""
        idx, active, _ = _frontier_mask(state, start, count, cen, P)
        return tvm.compact_types(self.program, state, idx, active,
                                 rank_fn=self._rank_fn,
                                 offsets_fn=self._fork_offsets_fn)

    def compacted_step(self, state, heap, start: int, count: int, cen,
                       perm, toffs, tcounts, buckets: Tuple[int, ...],
                       arena=None):
        """Phase 2 over dense per-type slices, then the shared commit."""
        per_type, idx, active = tvm.trace_tasks_compacted(
            self.program, state, heap, start, count, cen, perm, toffs,
            tcounts, buckets,
        )
        return tvm.commit_epoch(
            self.program, state, heap, idx, active, per_type, cen,
            arena=arena, fork_offsets_fn=self._fork_offsets_fn,
        )

    def gather_pass(self, state, start: int, count: int, cen, P: int):
        """Frontier pack pass: active mask -> ``(perm, count)``."""
        _, active, _ = _frontier_mask(state, start, count, cen, P)
        return self._pack_fn(active)

    def gather_step(self, state, heap, start: int, perm, G: int,
                    arena=None):
        """Phase 2+3 over the packed dense frontier (gather dispatch).

        The frontier holds every active lane of the epoch in increasing
        lane order (the pack is stable), so the fork prefix sum sees exactly
        the masked dispatch's allocation order restricted to the lanes that
        matter.  Each gathered lane's epoch number is read from the TV
        itself (``active`` implies ``epoch[slot] == cen``).
        """
        C = state.capacity
        lanepos = perm[:G]
        valid = lanepos >= 0
        idx = torch.where(valid, start + lanepos, C)
        cen_g = torch.where(valid, state.epoch[idx.clamp(0, C - 1)], 0)
        per_type, _ = tvm.trace_tasks(self.program, state, heap, idx, valid)
        return tvm.commit_epoch(
            self.program, state, heap, idx, valid, per_type, cen_g,
            arena=arena, fork_offsets_fn=self._fork_offsets_fn,
        )

    # ------------------------------------------------- one host-driven epoch
    def run_epoch(self, state, heap, start: int, span: int, cen,
                  col: StatsCollector, readback: Callable, arena=None):
        """One host-driven epoch: optional compaction or gather-pack pass
        (+ its count readback), the phase-2/3 step, then the end-of-epoch
        readback ``readback(summary, state)`` — one host transfer.

        ``cen`` is an int (solo frontier) or an ``i32`` vector of length
        ``span`` (a fused multi-region frontier), padded here to the
        launch bucket with inert zeros and sent to the device once;
        ``arena`` is the fleet's ``tvm.JobArena`` (None: solo).

        Returns ``(state, heap, summary, fetched, map_launches, launched,
        by_type, n_dispatches)``.
        """
        P = self.policy.epoch_bucket(span)
        if np.ndim(cen) != 0:
            cen_np = np.zeros(P, np.int32)
            cen_np[: np.shape(cen)[0]] = np.asarray(cen)
            cen = torch.as_tensor(cen_np, device=state.device)
        dispatches = 1
        by_type = None
        mode = self.policy.name
        if mode == "compacted":
            perm, counts_dev = self.compact_pass(state, start, span, cen, P)
            counts = counts_dev.cpu().numpy().astype(np.int64)
            col.dispatch()
            col.transfer()
            dispatches += 1
            buckets, toffs, launched, by_type = size_type_buckets(
                self.policy, counts, self.task_names
            )
            state, heap, summary, map_launches = self.compacted_step(
                state, heap, start, span, cen, perm, toffs, counts, buckets,
                arena,
            )
        elif mode == "gather":
            perm, count_dev = self.gather_pass(state, start, span, cen, P)
            n_sched = int(count_dev.cpu())
            col.dispatch()
            col.transfer()
            dispatches += 1
            G = self.policy.epoch_bucket(n_sched)
            state, heap, summary, map_launches = self.gather_step(
                state, heap, start, perm, G, arena
            )
            launched = G
            col.holes_skipped(P - G)
        else:
            state, heap, summary, map_launches = self.masked_step(
                state, heap, start, span, cen, P, arena
            )
            launched = P
        fetched = readback(summary, state)
        col.dispatch()
        col.transfer()
        return (
            state, heap, summary, fetched, map_launches, launched, by_type,
            dispatches,
        )


    # --------------------------------------------------------- resident loop
    def resident_body(self, capacity: int, stack_depth: int):
        """Body of the plain resident epoch loop, solo or fleet.

        Pop → step → commit → push → map payloads, with every scalar a host
        loop would read per epoch accrued in the :class:`ResidentCarry`:

          * solo (``carry.arena is None``): the popped range is the step's
            frontier; fleet (a ``tvm.JobArena``): every live region's pop
            is fused into one per-lane CEN vector over the TV (lanes tagged
            by ``arena.slot_job``), committed with the segmented per-region
            allocator, the region cursors (``arena.next``) riding the
            carry;
          * the step launches at the smallest :func:`_span_width_ladder`
            rung covering the popped range (masked; a fleet's window
            ``[st, st + W)`` covers the union span of its popped ranges,
            ``st = clip(lo, 0, capacity - W)``) or the count of the stable
            full-TV pack of the epoch's active lanes (gather; ``pack_fn``,
            by default ``lane_pack``: the ``type_rank`` kernel on the
            card); the skipped lanes accrue in ``hole_lanes``;
          * the join continuation is pushed below this epoch's forked
            range (LIFO, paper §4.3.3), per region; TV (or region)
            overflow or a full stack fails that region alone and zeroes its
            stack pointer;
          * each map payload runs after the commit, over its scheduled
            lanes packed in slot order, at the lane rung × domain rung the
            JAX body launches (``map_lanes``); all-empty domains launch and
            count nothing.

        The carry's tensors are updated in place.  Eager PyTorch needs the
        step width on the host, so each epoch reads the popped range (and
        each map launch its row count and domain max) back once — the
        plain version's cost, not the kernel's.
        """
        if self.policy.name not in ("masked", "gather"):
            raise ValueError(_COMPACTED_RESIDENT_MSG)
        gather = self.policy.name == "gather"
        program = self.program
        span_widths = _span_width_ladder(capacity)

        def run_maps(heap, map_launches, carry):
            map_ct = carry.map_launches
            map_el = carry.map_elements
            map_ln = carry.map_lanes
            for ml in map_launches:
                mt = program.maps[ml.map_id]
                if mt.max_domain <= 0:
                    raise EngineError(
                        f"map '{mt.name}' needs max_domain>0 for resident "
                        "(device) execution"
                    )
                dom = torch.as_tensor(mt.domain(ml.argi)).to(_I32).clamp(
                    0, mt.max_domain)
                live_dom = torch.where(ml.where, dom, 0)
                lperm, lcount = self._pack_fn(ml.where)
                dmax, n_rows = torch.stack(
                    [live_dom.max(), lcount.to(_I32)]).tolist()
                map_el = map_el + live_dom.sum(dtype=torch.int64)
                if dmax <= 0:
                    # every scheduled lane has an empty domain: no launch
                    continue
                D = _rung(_map_width_ladder(mt.max_domain), dmax)
                L = _rung(span_widths, n_rows)
                rows = lperm[:n_rows].long()
                # the packed rows alone: the JAX body's L - n_rows padding
                # rows are invalid and write nothing
                heap = tvm.run_map_payload(
                    program, heap, ml.map_id, ml.where[rows], ml.argi[rows],
                    ml.argf[rows], D,
                )
                map_ct = map_ct + 1
                map_ln = map_ln + L * D
            return heap, map_ct, map_el, map_ln

        def solo_step(state, heap, cen, start, count, live):
            if gather:
                # gather packs over the full TV: the solo popped range
                # becomes a per-lane CEN vector
                lanes = torch.arange(capacity, dtype=_I32,
                                     device=state.device)
                in_pop = live[0] & (lanes >= start[0]) & (
                    lanes < start[0] + count[0])
                step_cen = torch.where(in_pop, cen[0], 0)
                act = (step_cen > 0) & (state.epoch[:capacity] == step_cen)
                perm, width_key = self._pack_fn(act)
            else:
                width_key = torch.where(live[0], count[0], 0)
            lo, ct, scen, key = torch.stack([
                start[0], count[0], torch.where(live[0], cen[0], 0),
                width_key.to(_I32),
            ]).tolist()
            W = _rung(span_widths, key)
            if gather:
                out = self.gather_step(state, heap, 0, perm, W)
            else:
                out = self.masked_step(state, heap, lo, ct, scen, W)
            state, heap, summary, map_launches = out
            job = (summary.join_scheduled.reshape(1),
                   summary.total_forks.reshape(1),
                   state.next_free.reshape(1), summary.overflow.reshape(1),
                   summary.n_active.reshape(1))
            return state, heap, map_launches, W, job

        def fleet_step(state, heap, arena, cen, start, count, live):
            # fuse every live region's pop into one per-lane CEN vector
            # over the TV; the step is then bucketed to the union span of
            # the popped ranges (masked) or the pack count (gather)
            J = arena.n_jobs
            tag = arena.slot_job[:capacity]
            jl = tag.clamp(0, J - 1).long()
            lanes = torch.arange(capacity, dtype=_I32, device=state.device)
            in_pop = ((tag < J) & live[jl] & (lanes >= start[jl])
                      & (lanes < start[jl] + count[jl]))
            step_cen = torch.where(in_pop, cen[jl], 0)
            if gather:
                act = (step_cen > 0) & (state.epoch[:capacity] == step_cen)
                perm, width_key = self._pack_fn(act)
                lo = torch.zeros((), dtype=_I32, device=state.device)
            else:
                span_lo = torch.where(live, start, capacity).min()
                span_hi = torch.where(live, start + count, 0).max()
                lo = span_lo.clamp(0, capacity)
                width_key = (span_hi - lo).clamp(0, capacity)
            lo, key = torch.stack([lo.to(_I32), width_key.to(_I32)]).tolist()
            W = _rung(span_widths, key)
            if gather:
                out = self.gather_step(state, heap, 0, perm, W, arena)
            else:
                # the window stays inside the TV and, W covering the span,
                # still holds every popped range
                st = min(max(lo, 0), capacity - W)
                out = self.masked_step(state, heap, st, W,
                                       step_cen[st:st + W], W, arena)
            state, heap, summary, map_launches = out
            job = (summary.job_join, summary.job_forks, summary.job_next,
                   summary.job_overflow, summary.job_active)
            return state, heap, map_launches, W, job

        def body(carry: ResidentCarry) -> ResidentCarry:
            state, heap, arena = carry.state, carry.heap, carry.arena
            cen, start, count, live, sp = batched_device_pop(
                carry.jstack, carry.rstack, carry.sp
            )
            if arena is None:
                state, heap, map_launches, W, job = solo_step(
                    state, heap, cen, start, count, live)
            else:
                state, heap, map_launches, W, job = fleet_step(
                    state, heap, arena, cen, start, count, live)
            job_join, job_forks, job_next, job_over, job_active = job
            if arena is None:
                job_peak = torch.maximum(carry.job_peak, job_next)
            else:
                job_peak = torch.maximum(carry.job_peak,
                                         job_next - arena.base)
                # the region cursors ride the carry: the device-side
                # counterpart of the host multiplexer's arena.next update
                arena.next.copy_(job_next)
            failed = carry.failed | (live & job_over)
            ok = live & ~failed
            # LIFO push order exactly as the host scheduler (§4.3.3): join
            # continuation below, this epoch's forked range on top
            jstack, rstack, sp, of1 = batched_device_push(
                carry.jstack, carry.rstack, sp, cen, start, count,
                ok & job_join, stack_depth,
            )
            jstack, rstack, sp, of2 = batched_device_push(
                jstack, rstack, sp, cen + 1, job_next - job_forks,
                job_forks, ok & (job_forks > 0), stack_depth,
            )
            failed = failed | of1 | of2
            sp = torch.where(failed, 0, sp)
            heap, map_ct, map_el, map_ln = run_maps(heap, map_launches,
                                                    carry)
            _clear_sinks(state, heap)
            return ResidentCarry(
                state=state, heap=heap, arena=arena,
                jstack=jstack, rstack=rstack, sp=sp, failed=failed,
                failed_stack=carry.failed_stack | of1 | of2,
                n_epochs=carry.n_epochs + 1,
                job_epochs=carry.job_epochs + live.to(_I32),
                job_tasks=carry.job_tasks + job_active.to(torch.int64),
                job_forks=carry.job_forks + job_forks.to(torch.int64),
                job_peak=job_peak,
                map_launches=map_ct, map_elements=map_el, map_lanes=map_ln,
                hole_lanes=carry.hole_lanes + (capacity - W),
                fault=carry.fault,
            )

        return body

    def device_table(self):
        """The ``epoch_chunk`` kernel's device task table for this program
        (or, for a fused fleet, its per-region plan over the tenants'
        tables), found once per loop; raises :class:`EngineError` where
        there is none."""
        from ..kernels import epoch_megakernel as mk

        if self._device_table is not None:
            return self._device_table
        if self.tenants is not None:
            try:
                self._device_table = mk.fleet_plan(self.program,
                                                   self.tenants)
            except ValueError as e:
                raise EngineError(str(e)) from None
            return self._device_table
        table = mk.device_table(self.program)
        if table is None:
            raise EngineError(
                f"program {self.program.name!r} has no device task table "
                "for the epoch_chunk kernel (the kernel holds one for each "
                "program of the registry, checked by task bodies, widths, "
                "heap and captured constants)"
            )
        self._device_table = table
        return table

    def run_chunk(self, carry: ResidentCarry, limit,
                  n_regions: int = 1) -> ResidentCarry:
        """Run the resident loop until every stack drains or the global
        epoch counter reaches ``limit`` — one *chunk* (DESIGN.md §10).

        ``limit`` is dynamic: K=1, K epochs per chunk and the fully
        resident run (``limit`` = the epoch guard) run the same code, and
        on the card the same compiled kernel, which reads ``limit`` on the
        device.  A drained carry (or one already at ``limit``) comes back
        unchanged.  The carry is updated in place and returned.  The
        resident body is built once per ``(n_regions, capacity, depth)``
        and each build adds one to :attr:`trace_count`.

        With ``megakernel=True`` a carry on the card runs through the
        ``epoch_chunk`` kernel (one launch, no host read inside the
        chunk; a fleet carry dispatches each region to its tenant's
        table); a carry on the CPU runs the plain loop either way.
        """
        if carry.sp.shape != (n_regions,):
            raise ValueError(
                f"run_chunk: a carry of {tuple(carry.sp.shape)} stack "
                f"pointers for n_regions={n_regions}")
        capacity = carry.state.capacity
        depth = carry.jstack.shape[1]
        key = (n_regions, capacity, depth)
        body = self._resident_cache.get(key)
        if body is None:
            body = self._resident_cache[key] = self.resident_body(
                capacity, depth)
            self.trace_count += 1
        if self.megakernel:
            from ..kernels import epoch_megakernel as mk

            plan = None
            if carry.state.device.type == "cuda":
                if (carry.arena is None) != (self.tenants is None):
                    raise EngineError(
                        "epoch_chunk: a fleet carry needs the loop's "
                        "tenants (EpochLoop(tenants=...)), a solo carry "
                        "none")
                table = self.device_table()
                plan = table if self.tenants is not None else None
            return mk.epoch_chunk(
                _resident_cond, body, carry, limit, program=self.program,
                gather=self.policy.name == "gather", plan=plan,
            )
        return kref.epoch_chunk_ref(_resident_cond, body, carry, limit)

    def run_resident(self, carry: ResidentCarry, max_epochs: int,
                     n_regions: int = 1) -> ResidentCarry:
        """Run the resident loop to completion: one chunk bounded only by
        the epoch guard — one dispatch for the whole program."""
        return self.run_chunk(carry, max_epochs, n_regions)

    def chunk_summary(self, carry: ResidentCarry) -> ChunkSummary:
        """The chunk-boundary readback: the control and accounting scalars
        gathered into one int64 tensor and brought back in one transfer.
        Raises if the ``epoch_chunk`` kernel reported a fault."""
        fleet = carry.arena is not None
        parts = (carry.n_epochs, carry.sp, carry.failed, carry.failed_stack,
                 carry.job_epochs, carry.job_tasks, carry.job_forks,
                 carry.job_peak) + ((carry.arena.next,) if fleet else ()) + (
                 carry.map_launches, carry.map_elements,
                 carry.map_lanes, carry.hole_lanes, carry.fault)
        flat = torch.cat([p.reshape(-1).to(torch.int64) for p in parts])
        v = flat.cpu().numpy()
        J = carry.sp.shape[0]
        n_per = 8 if fleet else 7
        n_epochs, rest = int(v[0]), v[1:]
        per = [rest[i * J:(i + 1) * J] for i in range(n_per)]
        (m_ct, m_el, m_ln, holes, fault) = (int(x) for x in rest[n_per * J:])
        if fault:
            raise EngineError(
                f"epoch_chunk kernel fault {fault} (1: an epoch's live map "
                "elements exceeded the payload stage; 2: a float add "
                "outside the ordered add)"
            )
        return ChunkSummary(
            n_epochs=n_epochs,
            sp=per[0].astype(np.int32),
            failed=per[1].astype(bool),
            failed_stack=per[2].astype(bool),
            job_epochs=per[3].astype(np.int32),
            job_tasks=per[4],
            job_forks=per[5],
            job_peak=per[6].astype(np.int32),
            map_launches=m_ct, map_elements=m_el, map_lanes=m_ln,
            hole_lanes=holes,
            arena_next=per[7].astype(np.int32) if fleet else None,
        )


class HostEngine:
    """Paper-faithful engine: host drives stacks, device runs bulk epochs.

    ``device=None`` means CUDA (and raises where CUDA is absent); pass
    ``device="cpu"`` to run the plain PyTorch versions on the CPU.

    Hooks, as in the JAX engine: ``fork_offsets_fn(counts) -> (excl,
    total)`` replaces ``fork_scan`` in the commit (and, with ``rank_fn``,
    the type offsets of the compaction pass); ``rank_fn(types, active,
    n_types) -> (rank, counts)`` replaces the compaction's rank and
    ``pack_fn(active) -> (perm, count)`` the gather pack;
    ``stats_factory()`` makes the run's collector; ``coalesce`` goes to
    the :class:`EpochScheduler`.
    """

    def __init__(
        self,
        program: Program,
        capacity: int = 1 << 14,
        collect_stats: bool = True,
        fork_offsets_fn: Optional[Callable] = None,
        dispatch: Any = MASKED,
        coalesce: bool = True,
        rank_fn: Optional[Callable] = None,
        pack_fn: Optional[Callable] = None,
        stats_factory: Optional[Callable[[], StatsCollector]] = None,
        device=None,
    ):
        self.program = program
        self.capacity = capacity
        self.collect_stats = collect_stats
        self.coalesce = coalesce
        self._stats_factory = stats_factory
        self.device = resolve_device(device)
        self.loop = EpochLoop(program, dispatch, rank_fn=rank_fn,
                              pack_fn=pack_fn,
                              fork_offsets_fn=fork_offsets_fn)
        self.policy = self.loop.policy

    def _collector(self) -> StatsCollector:
        if self._stats_factory is not None:
            return self._stats_factory()
        return RunStatsCollector() if self.collect_stats else NullStats()

    @staticmethod
    def _readback(summary: tvm.EpochSummary, state: tvm.TVMState):
        """The paper's end-of-epoch readback: nextFreeCore, joinScheduled,
        mapScheduled (§5.2.4) (+ stats counters): six scalars stacked into
        one int32 tensor and brought back with one transfer."""
        packed = torch.stack([
            summary.total_forks.to(_I32),
            summary.join_scheduled.to(_I32),
            summary.map_scheduled.to(_I32),
            summary.n_active.to(_I32),
            summary.overflow.to(_I32),
            state.next_free.to(_I32),
        ]).cpu().tolist()
        total_forks, join_sched, map_sched, n_active, overflow, nf = packed
        return (total_forks, bool(join_sched), bool(map_sched), n_active,
                bool(overflow), nf)

    def run(
        self,
        initial: InitialTask,
        heap_init: Optional[Dict[str, Any]] = None,
        max_epochs: int = 1 << 20,
    ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, RunStats]:
        """Execute the program to completion.

        Returns (final heap, final TV value array ``[capacity, W]``, stats).
        The TVM halts when the join/NDRange stacks empty (paper §4.3.3).
        """
        program = self.program
        state = tvm.init_state(program, self.capacity, initial, self.device)
        heap = tvm.heap_with_sink(
            program.init_heap(self.device, **(heap_init or {}))
        )
        # phase-1 state owned by the CPU, exactly as in the paper (§5.2.2)
        sched = EpochScheduler(coalesce=self.coalesce)
        sched.reset()
        col = self._collector()
        n_epochs = 0
        while sched:  # termination predicate: host stacks drained
            if n_epochs >= max_epochs:
                raise EngineError(f"exceeded max_epochs={max_epochs}")
            n_epochs += 1
            d = sched.pop()
            (state, heap, _summary, fetched, map_launches, launched,
             by_type, _disp) = self.loop.run_epoch(
                state, heap, d.start, d.count, d.cen, col, self._readback,
            )
            total_forks, join_sched, map_sched, n_active, overflow, nf = (
                fetched
            )
            if overflow:
                raise EngineError(
                    f"task vector overflow: capacity={self.capacity}"
                )
            if join_sched:
                sched.push_join(d.cen, d.start, d.count)
            sched.push_forked(d.cen + 1, nf - total_forks, total_forks)
            if map_sched:
                heap = self.loop.maps.run(map_launches, heap, col)
            col.epoch(d.cen, d.n_ranges)
            col.lanes(n_active, launched, by_type)
            col.forks(total_forks)
            col.tv_peak(nf)
        return tvm.heap_without_sink(heap), state.value[:-1], col.result()


class DeviceEngine:
    """Whole-program engine: stacks and epoch loop without a per-epoch
    host readback — the :class:`EpochLoop` resident configuration with
    ``n_regions=1``.

    Dispatch: ``masked`` (span-ladder launches, §11) or ``gather`` (the
    in-loop dense frontier pack, §12); ``compacted`` stays host-only.
    ``device=None`` means CUDA (and raises where CUDA is absent); pass
    ``device="cpu"`` to run the plain loop on the CPU.  ``megakernel=True``
    runs each chunk on the card as one launch of the ``epoch_chunk``
    kernel, which holds a device task table for fib, bfs, mergesort (map
    and naive), treewalk (post and pre), sssp, nqueens and tsp; on the
    card any other program (fft, matmul, annealing) raises
    :class:`EngineError` (there is no fallback), and on the CPU the flag
    runs the plain loop, as the JAX package's ``"auto"`` does off the TPU.
    """

    def __init__(
        self,
        program: Program,
        capacity: int = 1 << 12,
        stack_depth: int = 1 << 10,
        fork_offsets_fn: Optional[Callable] = None,
        dispatch: Any = MASKED,
        megakernel: bool = False,
        device=None,
    ):
        self.program = program
        self.capacity = capacity
        self.stack_depth = stack_depth
        if resolve_policy(dispatch).name not in ("masked", "gather"):
            raise ValueError(_COMPACTED_RESIDENT_MSG)
        self.device = resolve_device(device)
        self.loop = EpochLoop(program, dispatch, megakernel=megakernel,
                              fork_offsets_fn=fork_offsets_fn)
        self.policy = self.loop.policy
        if self.loop.megakernel and self.device.type == "cuda":
            self.loop.device_table()
            if fork_offsets_fn is not None:
                raise EngineError(
                    "the epoch_chunk kernel allocates fork slots itself: "
                    "fork_offsets_fn needs megakernel=False on the card")

    def initial_carry(self, initial: InitialTask,
                      heap_init: Optional[Dict[str, Any]] = None
                      ) -> ResidentCarry:
        """A fresh solo carry: the seed task in slot 0, one stack entry."""
        program = self.program
        state = tvm.init_state(program, self.capacity, initial, self.device)
        heap = tvm.heap_with_sink(
            program.init_heap(self.device, **(heap_init or {}))
        )
        jstack, rstack, sp = batched_device_stacks(
            1, self.stack_depth, self.device
        )
        return _fresh_resident_carry(state, heap, None, jstack, rstack, sp,
                                     n_regions=1)

    def stats(self, s: ChunkSummary) -> RunStats:
        """``RunStats`` of a finished run from its last chunk summary."""
        stats = RunStats(
            epochs=s.n_epochs, dispatches=1, scalar_transfers=1,
            tasks_executed=int(s.job_tasks[0]),
            lanes_launched=s.n_epochs * self.capacity - s.hole_lanes,
            total_forks=int(s.job_forks[0]),
            map_launches=s.map_launches, map_elements=s.map_elements,
            map_lanes_launched=s.map_lanes,
            hole_lanes_skipped=s.hole_lanes,
        )
        stats.peak_tv_slots = int(s.job_peak[0])
        return stats

    def run(
        self,
        initial: InitialTask,
        heap_init: Optional[Dict[str, Any]] = None,
        max_epochs: int = 1 << 16,
    ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, RunStats]:
        """Execute the program to completion in one chunk.

        Returns (final heap, final TV value array ``[capacity, W]``,
        stats); the chunk summary is the run's one scalar transfer.
        """
        out = self.loop.run_resident(
            self.initial_carry(initial, heap_init), max_epochs, n_regions=1
        )
        s = self.loop.chunk_summary(out)
        if s.failed.any():
            raise EngineError("TV capacity or stack depth exhausted")
        if (s.sp > 0).any():
            raise EngineError(f"exceeded max_epochs={max_epochs}")
        return (tvm.heap_without_sink(out.heap), out.state.value[:-1],
                self.stats(s))
