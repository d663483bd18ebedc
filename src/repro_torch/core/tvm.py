"""Task Vector Machine state + the bulk epoch step (paper §4, §5.1–5.2),
PyTorch port of ``repro/core/tvm.py``.

The Task Vector is stored struct-of-arrays so that every runtime access is
a unit-stride vector load/store (the paper's memory coalescing, §5.1.2).
The Task Mask Stack is replaced, exactly as in the paper, by per-slot Epoch
Numbers (0 = invalid sentinel) plus host-side join/NDRange stacks.

The epoch step implements the paper's three phases:
  phase 1 (setup)    — pop stacks  (engine / scheduler)
  phase 2 (execute)  — every task type runs as one masked dense vector op
  phase 3 (commit)   — prefix-sum fork allocation, TMS update  (this module)

**Sink rows.**  The JAX reference drops unwanted scatter lanes with an
out-of-range index (``mode="drop"``).  Torch has no drop mode: an
out-of-range index raises on the CPU and is a device-side assert on CUDA.
So every TV array and every heap array the TVM touches carries one extra
trailing row, the *sink*: dropped lanes write there, reads clip to the real
rows and never see it, and ``core/convert.py`` and ``HostEngine.run`` strip
it on the way out.  ``TVMState.capacity`` counts real rows only.

**In place.**  Unlike the immutable JAX arrays, :func:`commit_epoch` and
:func:`run_map_payload` update the TV and heap tensors in place (phase 2
only gathers, so every read still sees the pre-epoch snapshot).

**Kernels.**  Fork allocation and the compaction pass call
``kernels/ops.py``: the ``fork_scan``, ``segmented_fork_scan`` and
``type_rank`` CUDA kernels on the card (the compaction's permutation is
``type_rank``'s ``type_pack``), their plain versions on the CPU.
(The JAX ``HostEngine`` and ``EpochMultiplexer`` allocate fork slots with
``jnp.cumsum`` or the jnp segmented reference unless given a hook; the
port routes them through its own kernels — the same functions, so the
same bits.)

**Arena.**  With a :class:`JobArena` (the multi-tenant service) the one
``nextFreeCore`` becomes one cursor per tenant region: fork allocation is
the segmented scan over each lane's region, children past their region's
end drop to the sink row (never into a neighbour), and reclamation runs
per region.  The arena's ``slot_job`` tags the sink row as unowned.

**Dtypes.**  Every slot index, count and scan stays int32, as in the JAX
Task Vector (``torch.arange``, ``cumsum`` and ``sum`` name their dtype).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..kernels import ops as kops
from ..kernels import ref as kref
from .primitives import EpochCtx, MapCtx
from .program import InitialTask, Program, pack_args

_I32 = torch.int32


@dataclasses.dataclass
class TVMState:
    """Struct-of-arrays Task Vector (+ ``nextFreeCore``); row C is the sink."""

    task: torch.Tensor         # i32[C + 1]  task type id
    argi: torch.Tensor         # i32[C + 1, A]
    argf: torch.Tensor         # f32[C + 1, Af]
    epoch: torch.Tensor        # i32[C + 1]  epoch number; 0 = invalid
    value: torch.Tensor        # value_dtype[C + 1, W]  emitted values
    child_base: torch.Tensor   # i32[C + 1]  first child slot
    child_count: torch.Tensor  # i32[C + 1]
    next_free: torch.Tensor    # i32[]  paper's nextFreeCore

    @property
    def capacity(self) -> int:
        return self.task.shape[0] - 1

    @property
    def device(self) -> torch.device:
        return self.task.device


def init_state(program: Program, capacity: int, initial: InitialTask,
               device) -> TVMState:
    """Paper §4.3: seed task in slot 0, eligible in the first epoch (CEN=1)."""
    ai, af = pack_args(program, initial.argi, initial.argf)
    rows = capacity + 1

    def zeros(*shape, dtype=_I32):
        return torch.zeros(shape, dtype=dtype, device=device)

    state = TVMState(
        task=zeros(rows),
        argi=zeros(rows, program.n_arg_i),
        argf=zeros(rows, program.n_arg_f, dtype=torch.float32),
        epoch=zeros(rows),
        value=zeros(rows, program.value_width, dtype=program.value_dtype),
        child_base=zeros(rows),
        child_count=zeros(rows),
        next_free=torch.ones((), dtype=_I32, device=device),
    )
    state.task[0] = program.task_id(initial.task)
    state.argi[0] = torch.as_tensor(ai, device=device)
    state.argf[0] = torch.as_tensor(af, device=device)
    state.epoch[0] = 1
    return state


def heap_with_sink(heap: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Copy user-shaped heap arrays into the TVM's sink-carrying form."""
    return {
        k: torch.cat([v, torch.zeros_like(v[:1])]) for k, v in heap.items()
    }


def heap_without_sink(heap: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v[:-1] for k, v in heap.items()}


@dataclasses.dataclass
class JobArena:
    """Per-job slot regions inside one shared Task Vector (service layer).

    Job ``j`` owns the contiguous slot region ``[base[j], end[j])`` — its
    private Task Vector, laid out exactly as a solo run of capacity
    ``end[j] - base[j]`` shifted by ``base[j]`` — and ``slot_job`` tags
    every TV slot with its region index (``J`` for slots outside every
    region, and for the sink row).  ``next`` is the per-region
    ``nextFreeCore`` cursor (absolute slots).
    """

    slot_job: torch.Tensor  # i32[C + 1] region per slot (J = unowned)
    base: torch.Tensor      # i32[J] region start (inclusive)
    end: torch.Tensor       # i32[J] region end (exclusive)
    next: torch.Tensor      # i32[J] per-region nextFreeCore

    @property
    def n_jobs(self) -> int:
        return self.base.shape[0]


def arena_reset_region(arena: JobArena, j: int, base: int,
                       quota: int) -> JobArena:
    """Re-point region ``j``'s cursors at a freshly reseeded tenant: its
    ``end`` becomes ``base + quota`` and its cursor ``base + 1`` (root slot
    occupied), the solo ``init_state`` layout shifted by ``base``.
    Returns a new arena; the argument is not changed."""
    end = arena.end.clone()
    nxt = arena.next.clone()
    end[j] = base + quota
    nxt[j] = base + 1
    return dataclasses.replace(arena, end=end, next=nxt)


@dataclasses.dataclass(frozen=True)
class EpochSummary:
    """Scalars the CPU reads back at the end of each epoch (paper §5.2.4);
    0-d tensors on the TV's device until the engine's one readback."""

    total_forks: torch.Tensor     # i32[]
    join_scheduled: torch.Tensor  # bool[]
    map_scheduled: torch.Tensor   # bool[]
    n_active: torch.Tensor        # i32[]  (stats: work in tasks, T1)
    overflow: torch.Tensor        # bool[]  TV capacity exhausted


@dataclasses.dataclass(frozen=True)
class MuxEpochSummary:
    """Per-job end-of-epoch scalars for the fused multi-tenant readback.

    The first five fields aggregate like :class:`EpochSummary`; the
    ``job_*`` vectors carry each region's own forks, join flag, active
    lanes, overflow flag and post-commit cursor, so every job's scheduler
    pushes its continuations exactly as a solo engine would.  Tensors on
    the TV's device until the multiplexer's one readback.
    """

    total_forks: torch.Tensor     # i32[]
    join_scheduled: torch.Tensor  # bool[]
    map_scheduled: torch.Tensor   # bool[]
    n_active: torch.Tensor        # i32[]
    overflow: torch.Tensor        # bool[]  any region exhausted
    job_forks: torch.Tensor       # i32[J]  forks allocated per region
    job_join: torch.Tensor        # bool[J] join scheduled per region
    job_active: torch.Tensor      # i32[J]  active lanes per region
    job_overflow: torch.Tensor    # bool[J] region capacity exhausted
    job_next: torch.Tensor        # i32[J]  post-commit region cursors


@dataclasses.dataclass
class MapLaunch:
    """One map site's scheduled lanes, for the payload launch."""

    map_id: int
    where: torch.Tensor  # bool[P]
    argi: torch.Tensor   # i32[P, A]
    argf: torch.Tensor   # f32[P, Af]


def _run_type(program: Program, tid: int, state: TVMState, heap, src):
    """Run task type ``tid`` over the TV rows ``src`` (clipped slots);
    returns the context holding its recorded per-lane effects."""
    ctx = EpochCtx(
        program, state.argi[src], state.argf[src], state.child_base[src],
        state.child_count[src], src, heap, state.value,
    )
    program.tasks[tid].fn(ctx)
    return ctx


def trace_tasks(program: Program, state: TVMState, heap, idx, active):
    """Phase 2: run every task type as one masked dense vector op.

    Baseline "work-together" dispatch: each type executes across all P
    lanes, masked — lane utilization is the divergence term of §4.4.1.
    Returns ``(per_type, cidx)`` with ``per_type`` a list of ``(mask_t,
    effects)``.
    """
    cidx = idx.clamp(0, state.capacity - 1)
    g_task = state.task[cidx]
    return [
        (active & (g_task == tid), _run_type(program, tid, state, heap, cidx))
        for tid in range(len(program.tasks))
    ], cidx


def compact_types(program: Program, state: TVMState, idx, active,
                  rank_fn: Optional[Callable] = None,
                  offsets_fn: Optional[Callable] = None):
    """Compaction stage: scatter active lanes into contiguous per-type ranges.

    Each active lane gets ``dest = type_start[type] + rank`` where ``rank``
    is its stable within-type rank and ``type_start`` the exclusive prefix
    sum of the per-type populations; by default the ``type_rank`` kernel
    writes the permutation itself on the card (``kops.type_pack``).  A
    ``rank_fn(types, active, n_types) -> (rank, counts)`` replaces the
    rank; the permutation is then built here, with ``type_start`` from
    ``offsets_fn(counts) -> (excl, total)`` where one is given.  Returns
    ``(perm, counts)``: ``perm[d]`` is the lane position of the d-th
    compacted lane (-1 beyond the active population), ``counts`` the
    per-type populations.
    """
    n_types = len(program.tasks)
    types = state.task[idx.clamp(0, state.capacity - 1)]
    if rank_fn is None:
        return kops.type_pack(types, active, n_types)
    rank, counts = rank_fn(types, active, n_types)
    counts = counts.to(_I32)
    type_start, _ = (offsets_fn or kref.fork_scan_ref)(counts)
    return kref.type_perm(types, active, rank, type_start), counts


def _scatter_effects(ctx, pos, P: int):
    """Scatter per-lane effects computed at bucket width back to the P
    NDRange lane positions ``pos`` (``P`` = dropped), zeros elsewhere."""

    def back(t: torch.Tensor) -> torch.Tensor:
        if t.dim() == 0:  # a constant (e.g. a fork's task code): no lanes
            return t
        out = torch.zeros((P + 1,) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        out[pos] = t
        return out[:P]

    def site(s):
        return dataclasses.replace(s, **{
            f.name: back(getattr(s, f.name))
            for f in dataclasses.fields(s)
            if isinstance(getattr(s, f.name), torch.Tensor)
        })

    ctx.forks = [site(f) for f in ctx.forks]
    if ctx.join_site is not None:
        ctx.join_site = site(ctx.join_site)
    ctx.emit_where = back(ctx.emit_where)
    ctx.emit_value = back(ctx.emit_value)
    ctx.writes = [site(w) for w in ctx.writes]
    ctx.map_sites = [site(m) for m in ctx.map_sites]
    return ctx


def trace_tasks_compacted(
    program: Program,
    state: TVMState,
    heap,
    start: int,
    count: int,
    cen,
    perm: torch.Tensor,
    type_offsets: Sequence[int],
    type_counts: Sequence[int],
    buckets: Tuple[int, ...],
):
    """Phase 2 under the compacted dispatch: dense per-type slices.

    Each task type with a nonzero launch bucket runs over a contiguous
    slice of the compaction permutation holding only its own lanes, at
    width ``buckets[tid]``; types with no active lane launch nothing.  The
    per-lane effects are scattered back to full NDRange lane positions so
    that :func:`commit_epoch` sees exactly the masked dispatch's per-lane
    layout — fork allocation order, and therefore every result, is
    bit-identical between the two dispatches.  Offsets and counts are host
    ints (the compaction pass's readback).

    Returns ``(per_type, idx, active)`` compatible with :func:`commit_epoch`.
    """
    P = perm.shape[0]
    C = state.capacity
    dev = perm.device
    ar = torch.arange(P, dtype=_I32, device=dev)
    idx = start + ar
    cidx = idx.clamp(0, C - 1)
    active = (ar < count) & (cen > 0) & (state.epoch[cidx] == cen)
    g_task = state.task[cidx]

    perm_p = torch.cat([
        perm, torch.full((max(buckets),), -1, dtype=_I32, device=dev)
    ])
    per_type = []
    for tid, B in enumerate(buckets):
        if B <= 0:
            continue  # no active lanes of this type: no launch at all
        ts = int(type_offsets[tid])
        lanepos = perm_p[ts:ts + B]
        within = torch.arange(B, dtype=_I32, device=dev) < int(type_counts[tid])
        valid = within & (lanepos >= 0)
        src = (start + lanepos).clamp(0, C - 1)
        ctx = _run_type(program, tid, state, heap, src)
        pos = torch.where(valid, lanepos, P)
        per_type.append(
            (active & (g_task == tid), _scatter_effects(ctx, pos, P))
        )
    return per_type, idx, active


def _ordered_add_(arr: torch.Tensor, idx: torch.Tensor,
                  val: torch.Tensor) -> None:
    """``arr[idx] += val`` with each row's terms added one at a time in
    source order, starting from the old value — the CPU ``index_add_``'s
    serial loop, whose rounding the JAX reference's CPU scatter shares.

    A stable sort groups each row's terms in source order; the ``k``-th
    term of every row is then added by one gather/add/store over rows that
    are all distinct, ``k`` = 0, 1, ... up to the longest run.  Writes to
    the sink row are skipped (nothing reads it).
    """
    sink = arr.shape[0] - 1
    keep = torch.nonzero(idx != sink).flatten()
    if keep.numel() == 0:
        return
    sidx, order = torch.sort(idx[keep], stable=True)
    sval = val[keep[order]]
    m = sidx.shape[0]
    pos = torch.arange(m, device=idx.device)
    first = torch.ones(m, dtype=torch.bool, device=idx.device)
    first[1:] = sidx[1:] != sidx[:-1]
    run_start = torch.cummax(torch.where(first, pos, 0), 0).values
    rank = pos - run_start  # the term's place within its row's run
    by_rank = torch.sort(rank, stable=True).indices
    lo = 0
    for c in torch.bincount(rank).tolist():
        sel = by_rank[lo:lo + c]
        rows = sidx[sel]
        arr[rows] = arr[rows] + sval[sel]
        lo += c


def _scatter_heap(arr: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
                  op: str) -> None:
    """``arr[idx] (op)= val`` in place; ``idx`` points dropped lanes at the
    sink row.  ``min``/``max`` include the old value, like the JAX
    ``.at[].min``/``.max``; int ``add`` is exact in any order.  Float
    ``add`` sums each row's terms in source order from the old value on
    every device: the CPU's ``index_add_`` runs a serial loop in that
    order, while CUDA's adds atomically in an order that changes from run
    to run, so on the card the terms go through :func:`_ordered_add_`."""
    if op == "set":
        arr.index_put_((idx,), val)
    elif op == "add":
        if arr.is_floating_point() and arr.device.type != "cpu":
            _ordered_add_(arr, idx, val)
        else:
            arr.index_add_(0, idx, val)
    else:
        full = idx.long().view((-1,) + (1,) * (val.dim() - 1)).expand_as(val)
        arr.scatter_reduce_(0, full, val, "amin" if op == "min" else "amax",
                            include_self=True)


def commit_epoch(
    program: Program,
    state: TVMState,
    heap: Dict[str, torch.Tensor],
    idx: torch.Tensor,
    active: torch.Tensor,
    per_type,
    cen,
    arena: Optional[JobArena] = None,
    fork_offsets_fn: Optional[Callable] = None,
) -> Tuple[TVMState, Dict[str, torch.Tensor], Any, List[MapLaunch]]:
    """Phase 3: prefix-sum fork allocation + TMS (epoch-number) update.

    Fork slots come from ``kernels.ops.fork_offsets`` (the ``fork_scan``
    kernel on CUDA) or ``fork_offsets_fn(counts) -> (excl, total)`` where
    one is given, or with ``arena`` from ``ops.segmented_fork_offsets``
    over each lane's region (the ``segmented_fork_scan`` kernel on CUDA);
    the summary is then a :class:`MuxEpochSummary`.  ``cen`` is an int, an
    ``i32[]`` or a per-lane ``i32[P]`` epoch number.
    Updates ``state`` and ``heap`` in place and returns them.
    """
    C = state.capacity
    P = idx.shape[0]
    dev = idx.device
    cidx = idx.clamp(0, C - 1)
    drop = C  # the sink row

    # ---- per-lane fork counts (disjoint across types) -------------------
    lane_count = torch.zeros((P,), dtype=_I32, device=dev)
    for mask_t, eff in per_type:
        if eff.forks:
            cnt = torch.stack([f.where for f in eff.forks]).sum(
                0, dtype=_I32)
            lane_count = lane_count + torch.where(mask_t, cnt, 0)

    lane_cap = None  # per-lane scatter bound (arena mode only)
    if arena is None:
        offsets = fork_offsets_fn or kops.fork_offsets
        lane_excl, total_forks = offsets(lane_count)
        lane_base = state.next_free + lane_excl
        overflow = (state.next_free + total_forks) > C
    else:
        J = arena.n_jobs
        jl = arena.slot_job[cidx].clamp(0, J - 1)  # region per lane
        # each lane's offset among its own region's forks: the solo scan
        # restricted to that region
        lane_excl, job_forks = kops.segmented_fork_offsets(lane_count, jl, J)
        lane_base = arena.next[jl] + lane_excl
        lane_cap = arena.end[jl]
        job_overflow = (arena.next + job_forks) > arena.end
        total_forks = job_forks.sum(dtype=_I32)
        overflow = job_overflow.any()

    join_any = torch.zeros((), dtype=torch.bool, device=dev)
    lane_join = torch.zeros((P,), dtype=torch.bool, device=dev)
    map_any = torch.zeros((), dtype=torch.bool, device=dev)
    map_launches: List[MapLaunch] = []
    s = state

    for mask_t, eff in per_type:
        # -------- forks: scatter children at contiguous prefix-sum slots,
        # site k of a lane at lane_base + (its fired sites before k);
        # slots past capacity (overflow) drop to the sink like mode="drop",
        # and under an arena so do slots past the lane's region end.  The
        # fired slots are distinct, so the type's sites scatter at once
        # ([S, P], site-major) with the bits of one scatter per site.
        if eff.forks:
            S = len(eff.forks)
            fire = mask_t & torch.stack([f.where for f in eff.forks])
            fired = fire.to(_I32)
            raw = lane_base + (torch.cumsum(fired, 0, dtype=_I32) - fired)
            if lane_cap is None:
                fire = fire & (raw < C)
            else:
                fire = fire & (raw < lane_cap)
            slots = torch.where(fire, raw, drop).reshape(-1)
            s.task[slots] = torch.stack(
                [f.task.expand(P) for f in eff.forks]).reshape(-1)
            s.argi[slots] = torch.stack([f.argi for f in eff.forks]).reshape(
                S * P, -1)
            s.argf[slots] = torch.stack([f.argf for f in eff.forks]).reshape(
                S * P, -1)
            child_cen = cen + 1  # an int, an i32[] or a per-lane i32[P]
            if torch.is_tensor(child_cen) and child_cen.dim() == 1:
                child_cen = child_cen.expand(S, P).reshape(-1)
            s.epoch[slots] = child_cen
            # children's child_base=0 lands before the parents' child_base
            # below (tvm.py:534 before :552); keep that order
            s.child_base[slots] = 0
            s.child_count[slots] = 0

        # -------- join: replace own entry; epoch number stays CEN
        jw = torch.zeros((P,), dtype=torch.bool, device=dev)
        if eff.join_site is not None:
            j = eff.join_site
            jw = mask_t & j.where
            jslots = torch.where(jw, cidx, drop)
            s.task[jslots] = j.task
            s.argi[jslots] = j.argi
            s.argf[jslots] = j.argf
            join_any = join_any | jw.any()
            lane_join = lane_join | jw

        # -------- record children pointers on the (possibly joined) parent
        pslots = torch.where(mask_t, cidx, drop)
        s.child_base[pslots] = lane_base
        s.child_count[pslots] = lane_count

        # -------- emit: store value; entry becomes invalid unless joined
        eslots = torch.where(mask_t & eff.emit_where, cidx, drop)
        s.value[eslots] = eff.emit_value
        s.epoch[torch.where(mask_t & ~jw, cidx, drop)] = 0

        # -------- heap writes (reads saw the pre-epoch snapshot)
        for w in eff.writes:
            arr = heap[w.name]
            n = arr.shape[0] - 1
            fire = mask_t & w.where
            widx = torch.where(fire, w.index.clamp(0, n - 1), n)
            _scatter_heap(arr, widx, w.value, w.op)

        # -------- map scheduling
        for m in eff.map_sites:
            fire = mask_t & m.where
            map_any = map_any | fire.any()
            map_launches.append(
                MapLaunch(map_id=m.map_id, where=fire, argi=m.argi,
                          argf=m.argf)
            )

    # ---- trailing-invalid reclamation (paper §5.3, nextFreeCore decrease)
    iota = torch.arange(C, dtype=_I32, device=dev)
    lv = torch.where(s.epoch[:C] > 0, iota, -1)
    if arena is None:
        s.next_free = torch.minimum(s.next_free + total_forks,
                                    lv.max() + 1)
        summary = EpochSummary(
            total_forks=total_forks,
            join_scheduled=join_any,
            map_scheduled=map_any,
            n_active=active.sum(dtype=_I32),
            overflow=overflow,
        )
        return s, heap, summary, map_launches
    # per-region reclamation: each cursor shrinks to just past its own
    # region's last valid slot, the solo rule shifted by base; slots of no
    # region (tag J) reduce into an extra row that is cut off
    last_valid = torch.full((J + 1,), -1, dtype=_I32, device=dev)
    last_valid.scatter_reduce_(0, arena.slot_job[:C].long(), lv, "amax")
    job_next = torch.minimum(
        arena.next + job_forks,
        torch.maximum(last_valid[:J] + 1, arena.base),
    )
    s.next_free = job_next.max()  # fleet high-water
    per_job = torch.zeros((2, J), dtype=_I32, device=dev).index_add_(
        1, jl, torch.stack([lane_join.to(_I32), active.to(_I32)]))
    summary = MuxEpochSummary(
        total_forks=total_forks,
        join_scheduled=join_any,
        map_scheduled=map_any,
        n_active=active.sum(dtype=_I32),
        overflow=overflow,
        job_forks=job_forks,
        job_join=per_job[0] > 0,
        job_active=per_job[1],
        job_overflow=job_overflow,
        job_next=job_next,
    )
    return s, heap, summary, map_launches


def run_map_payload(
    program: Program,
    heap: Dict[str, torch.Tensor],
    map_id: int,
    where: torch.Tensor,
    argi: torch.Tensor,
    argf: torch.Tensor,
    domain_size: int,
) -> Dict[str, torch.Tensor]:
    """Execute one map site's payload over lanes x dense element domain.

    The paper launches these as a separate data-parallel kernel between
    epochs (§5.2.4).  The JAX reference double-vmaps over lanes x domain;
    here the payload runs once on ``[P, D]`` broadcasts (``eid`` is
    ``i32[1, D]``), and its writes are flattened lane-major, as there.
    Updates ``heap`` in place and returns it.
    """
    mt = program.maps[map_id]
    P = where.shape[0]
    dom = torch.as_tensor(mt.domain(argi)).to(_I32)  # i32[P]
    eid = torch.arange(domain_size, dtype=_I32, device=where.device)[None, :]
    ctx = MapCtx(program, argi, argf, eid, heap)
    mt.fn(ctx)
    lane_on = where[:, None] & (eid < dom[:, None])  # bool[P, D]
    for w in ctx.writes:
        arr = heap[w.name]
        n = arr.shape[0] - 1
        shape = (P, domain_size)
        fire = lane_on & w.where
        widx = torch.where(fire, w.index.clamp(0, n - 1).expand(shape), n)
        val = w.value.expand(shape + tuple(arr.shape[1:]))
        _scatter_heap(arr, widx.reshape(-1),
                      val.reshape((-1,) + tuple(arr.shape[1:])), w.op)
    return heap
