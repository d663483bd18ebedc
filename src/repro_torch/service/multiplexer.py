"""Epoch multiplexer: fused multi-tenant driving over one shared TVM
(PyTorch port of ``repro/service/multiplexer.py``, host half).

The paper's "work-together" principle (§3) says critical-path overhead
should be paid by the entire system at once.  A solo ``HostEngine.run``
pays phase 1 (stack pop + launch) and phase 3 (scalar readback) once per
epoch for one program; N concurrent tenants would pay N times that.  This
module extends work-together across tenants:

* :func:`fuse_programs` builds one fused :class:`Program` from N tenant
  programs — task and map tables concatenate (task ids shifted by a
  per-tenant offset), heap variables are namespaced ``j<k>/name``, and
  every tenant task function runs behind a context shim that translates
  task ids, map ids and heap names back into the tenant's own vocabulary.
  The fused program is an ordinary ``Program``, so the masked, compacted
  and gather dispatches all apply.

* :class:`EpochMultiplexer` runs a wave on the host loop (an
  :class:`~repro_torch.core.engine.EpochLoop` configuration): each global
  epoch it pops every ready job's frontier (``MuxPopPolicy`` selects the
  gang), fuses the popped ranges into one launch with a per-lane
  epoch-number vector, commits through the
  :class:`~repro_torch.core.tvm.JobArena` (the ``segmented_fork_scan``
  kernel on the card), and reads back one
  :class:`~repro_torch.core.tvm.MuxEpochSummary` for the whole fleet as
  one stacked tensor — one transfer per global epoch.  Because the host
  sees every epoch, it supports streaming completion, mid-flight region
  reuse (structurally equal programs, ``Program.structural_hash``), gang
  policies and preemption into a :class:`RegionCheckpoint`.

* :class:`DeviceMultiplexer` is the chunked resident driver (DESIGN.md
  §9–10): the wave runs in the resident loop
  (:meth:`~repro_torch.core.engine.EpochLoop.run_chunk`) with per-region
  stacks (``batched_device_stacks``) and the arena's cursors riding the
  carry, for at most ``chunk`` (K) epochs a chunk; each chunk boundary
  reads one :class:`~repro_torch.core.engine.ChunkSummary`, so a wave of E
  epochs pays ⌈E/K⌉ dispatches and readbacks.  Between chunks the host
  streams completions, reseeds freed regions in the live carry and
  preempts.  On the card a chunk is the plain resident loop (which calls
  the ``segmented_fork_scan`` and ``type_rank`` kernels) or, with
  ``megakernel=True``, one cooperative ``epoch_chunk`` launch over the
  fleet carry.

Per-job results are bit-identical to solo ``HostEngine`` runs with
``capacity=quota`` under both drivers, at every K.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import tvm
from ..core.engine import (
    _COMPACTED_RESIDENT_MSG,
    ChunkSummary,
    EpochLoop,
    _fresh_resident_carry,
    resolve_device,
)
from ..core.program import HeapVar, MapType, Program, TaskType, pack_args
from ..core.scheduler import (
    EpochScheduler,
    NullStats,
    RunStats,
    RunStatsCollector,
    batched_device_stacks,
    load_region_stacks,
    reseed_region_stacks,
    resolve_mux_policy,
    resolve_policy,
)
from .jobs import (
    Job,
    JobFailure,
    JobHandle,
    JobResult,
    JobStats,
    JobStatus,
    RegionCheckpoint,
    check_fleet_dtype,
    validate_job,
)

_I32 = torch.int32


# --------------------------------------------------------------------------
# Tenant context shims: run a tenant task body against the fused program
# --------------------------------------------------------------------------
class _TenantEpochCtx:
    """EpochCtx view in the tenant's own vocabulary.

    Delegates every read and effect to the fused ``EpochCtx``, translating
    task names/ids by the tenant's task-table offset, map names/ids by its
    map-table offset, and heap names by its ``j<k>/`` namespace prefix.
    """

    __slots__ = ("_ctx", "_sub", "_task_off", "_map_off", "_prefix")

    def __init__(self, ctx, sub: Program, task_off: int, map_off: int,
                 prefix: str):
        self._ctx = ctx
        self._sub = sub
        self._task_off = task_off
        self._map_off = map_off
        self._prefix = prefix

    # reads -----------------------------------------------------------------
    def argi(self, k: int):
        return self._ctx.argi(k)

    def argf(self, k: int):
        return self._ctx.argf(k)

    @property
    def slot(self):
        return self._ctx.slot

    @property
    def child_count(self):
        return self._ctx.child_count

    def child_values(self, n: int):
        # the fused value rows cut to the tenant's own width, so a width-w
        # program sees exactly the [P, n, w] a solo run gives it
        return self._ctx.child_values(n)[..., : self._sub.value_width]

    def read(self, name: str, index):
        return self._ctx.read(self._prefix + name, index)

    # effects ---------------------------------------------------------------
    def _code(self, task):
        if isinstance(task, str):
            return self._task_off + self._sub.task_id(task)
        return self._task_off + task

    def fork(self, task, argi=(), argf=(), where=True):
        self._ctx.fork(self._code(task), argi=argi, argf=argf, where=where)

    def join(self, task, argi=(), argf=(), where=True):
        self._ctx.join(self._code(task), argi=argi, argf=argf, where=where)

    def emit(self, value, where=True):
        # the tenant's own value width (the fused width may be larger; a
        # solo run would reject the overflow, so must we).  A per-lane
        # vector is [P, k]; anything of lower rank is one scalar per lane.
        v = torch.as_tensor(value)
        if v.dim() == 2 and v.shape[1] > self._sub.value_width:
            raise ValueError("emit value wider than program.value_width")
        self._ctx.emit(value, where=where)

    def write(self, name: str, index, value, op: str = "set", where=True):
        self._ctx.write(self._prefix + name, index, value, op=op, where=where)

    def map(self, map_fn, argi=(), argf=(), where=True):
        mid = (
            self._sub.map_id(map_fn)
            if isinstance(map_fn, str)
            else int(map_fn)
        )
        self._ctx.map(self._map_off + mid, argi=argi, argf=argf, where=where)


class _TenantMapCtx:
    """MapCtx view with the tenant's heap namespace."""

    __slots__ = ("_ctx", "_prefix")

    def __init__(self, ctx, prefix: str):
        self._ctx = ctx
        self._prefix = prefix

    def argi(self, k: int):
        return self._ctx.argi(k)

    def argf(self, k: int):
        return self._ctx.argf(k)

    @property
    def eid(self):
        return self._ctx.eid

    def read(self, name: str, index):
        return self._ctx.read(self._prefix + name, index)

    def write(self, name: str, index, value, op: str = "set", where=True):
        self._ctx.write(self._prefix + name, index, value, op=op, where=where)


def _wrap_task(fn, sub: Program, task_off: int, map_off: int, prefix: str):
    def wrapped(ctx, _fn=fn):
        _fn(_TenantEpochCtx(ctx, sub, task_off, map_off, prefix))

    return wrapped


def _wrap_map(fn, prefix: str):
    def wrapped(mctx, _fn=fn):
        _fn(_TenantMapCtx(mctx, prefix))

    return wrapped


# --------------------------------------------------------------------------
# Program fusion
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TenantSlot:
    """One tenant's contribution to the fused program, plus its slot region
    in the shared TV.  The region is sized by the job's quota at fuse time;
    a later tenant re-admitted into this region may use less."""

    index: int
    program: Program
    task_offset: int
    map_offset: int
    prefix: str
    base: int
    quota: int

    @property
    def end(self) -> int:
        return self.base + self.quota


def fuse_programs(
    programs: Sequence[Program], quotas: Sequence[int]
) -> Tuple[Program, List[TenantSlot]]:
    """Concatenate N tenant programs into one fused :class:`Program`.

    Argument-register widths and the value width are the fleet maxima (a
    tenant's own args and emits occupy a prefix; the padding columns stay
    zero, so the tenant-visible slice is bit-identical to solo).  The value
    dtype must be uniform across the fleet (:func:`check_fleet_dtype`).
    """
    value_dtype = check_fleet_dtype(programs)
    tasks: List[TaskType] = []
    maps: List[MapType] = []
    heap: List[HeapVar] = []
    slots: List[TenantSlot] = []
    base = 0
    for j, (p, q) in enumerate(zip(programs, quotas)):
        prefix = f"j{j}/"
        slot = TenantSlot(
            index=j, program=p, task_offset=len(tasks),
            map_offset=len(maps), prefix=prefix, base=base, quota=int(q),
        )
        for t in p.tasks:
            tasks.append(
                TaskType(
                    prefix + t.name,
                    _wrap_task(t.fn, p, slot.task_offset, slot.map_offset,
                               prefix),
                )
            )
        for m in p.maps:
            maps.append(
                MapType(
                    prefix + m.name,
                    _wrap_map(m.fn, prefix),
                    domain=m.domain,
                    max_domain=m.max_domain,
                )
            )
        for hv in p.heap:
            heap.append(HeapVar(prefix + hv.name, hv.shape, hv.dtype))
        slots.append(slot)
        base += int(q)

    fused = Program(
        name="mux[" + "+".join(p.name for p in programs) + "]",
        tasks=tuple(tasks),
        n_arg_i=max(p.n_arg_i for p in programs),
        n_arg_f=max(p.n_arg_f for p in programs),
        value_width=max(p.value_width for p in programs),
        value_dtype=value_dtype,
        maps=tuple(maps),
        heap=tuple(heap),
    )
    return fused, slots


# --------------------------------------------------------------------------
# Shared fleet plumbing
# --------------------------------------------------------------------------
@dataclasses.dataclass
class _Region:
    """Runtime state of one slot region: the tenant currently in it (if
    any), its scheduler stacks, and its solo-comparable stats."""

    slot: TenantSlot
    handle: Optional[JobHandle] = None
    sched: Optional[EpochScheduler] = None
    stats: Optional[JobStats] = None
    active_quota: int = 0

    @property
    def running(self) -> bool:
        return (
            self.handle is not None
            and self.handle.status is JobStatus.RUNNING
        )


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class _FleetBase:
    """Shared multi-tenant plumbing: program fusion, the shared TVM state +
    :class:`~repro_torch.core.tvm.JobArena` (both with the trailing sink
    row), per-region bookkeeping, capture/restore, and result extraction.

    Tensors are updated in place (the port's TVM is mutable); results and
    checkpoints are copies.
    """

    def __init__(
        self,
        handles: Sequence[JobHandle],
        capacity: Optional[int] = None,
        coalesce: bool = True,
        collect_stats: bool = True,
        device=None,
        template=None,
    ):
        if not handles:
            raise ValueError(f"{type(self).__name__} needs at least one job")
        # a None handle is a vacant slot region, seated later through the
        # admit path; the fused program then comes from a wave template
        jobs = [h.job for h in handles if h is not None]
        if len(jobs) != len(handles) and template is None:
            raise ValueError(
                "vacant wave slots (handle=None) require a wave template: "
                "the fused program cannot be derived from absent jobs"
            )
        self.device = resolve_device(device)
        quota_total = (
            sum(s.quota for s in template.slots) if template is not None
            else sum(j.quota for j in jobs)
        )
        self.capacity = int(capacity) if capacity else quota_total
        if quota_total > self.capacity:
            raise ValueError(
                f"sum of job quotas ({quota_total}) exceeds TV capacity "
                f"({self.capacity})"
            )
        for j in jobs:
            validate_job(j, self.capacity)
        self.coalesce = coalesce
        if template is not None:
            # wave-template reuse (jobs.py WaveTemplateCache): the members
            # are structurally equal to the template's, so its fused
            # program and loop apply as they are; only runtime state is
            # rebuilt below
            if len(handles) != len(template.slots) or any(
                h is not None and h.job.quota != s.quota
                for h, s in zip(handles, template.slots)
            ):
                raise ValueError(
                    "wave template quota layout does not match the wave"
                )
            self.program = template.program
            self._slots = list(template.slots)
        else:
            self.program, self._slots = fuse_programs(
                [j.program for j in jobs], [j.quota for j in jobs]
            )
        self._col = RunStatsCollector() if collect_stats else NullStats()
        # (region index, handle) pairs whose TV image restores from a
        # RegionCheckpoint once the wave's runtime state exists
        self._restore_pending: List[Tuple[int, JobHandle]] = []
        self._init_fleet(handles)

    def _tenant_heap(self, slot: TenantSlot, heap_init=None):
        """The tenant's heap arrays under its namespace, with sink rows."""
        arrays = slot.program.init_heap(self.device, **dict(heap_init or {}))
        return {slot.prefix + k: v
                for k, v in tvm.heap_with_sink(arrays).items()}

    def _init_fleet(self, handles: Sequence[JobHandle]) -> None:
        """Build the shared TVM state, arena, heap and per-job schedulers."""
        fused, C = self.program, self.capacity
        J = len(self._slots)
        rows = C + 1  # + the sink row
        task = np.zeros(rows, np.int32)
        argi = np.zeros((rows, fused.n_arg_i), np.int32)
        argf = np.zeros((rows, fused.n_arg_f), np.float32)
        epoch = np.zeros(rows, np.int32)
        slot_job = np.full(rows, J, np.int32)  # the sink row is unowned

        self._regions: List[_Region] = []
        self._heap: Dict[str, torch.Tensor] = {}
        for slot, h in zip(self._slots, handles):
            slot_job[slot.base: slot.end] = slot.index
            if h is None or h.checkpoint is not None:
                # a vacant region, or a preempted job resuming in this
                # wave: declared-default heap now (a resuming job's region
                # image restores once the driver's state exists)
                self._heap.update(self._tenant_heap(slot))
                self._regions.append(_Region(slot=slot))
                if h is not None:
                    self._restore_pending.append((slot.index, h))
                continue
            job = h.job
            tid = slot.task_offset + slot.program.task_id(job.initial.task)
            ai, af = pack_args(fused, job.initial.argi, job.initial.argf)
            task[slot.base] = tid
            argi[slot.base] = ai
            argf[slot.base] = af
            epoch[slot.base] = 1
            self._heap.update(self._tenant_heap(slot, job.heap_init))
            sched = EpochScheduler(coalesce=self.coalesce)
            sched.reset(cen=1, start=slot.base, count=1)
            h.mark_running()
            self._regions.append(
                _Region(
                    slot=slot, handle=h, sched=sched, stats=JobStats(),
                    active_quota=job.quota,
                )
            )

        dev = self.device

        def up(a):
            return torch.as_tensor(a, device=dev)

        self._state = tvm.TVMState(
            task=up(task),
            argi=up(argi),
            argf=up(argf),
            epoch=up(epoch),
            value=torch.zeros((rows, fused.value_width),
                              dtype=fused.value_dtype, device=dev),
            child_base=torch.zeros((rows,), dtype=_I32, device=dev),
            child_count=torch.zeros((rows,), dtype=_I32, device=dev),
            next_free=torch.tensor(max(s.base for s in self._slots) + 1,
                                   dtype=_I32, device=dev),
        )
        self._arena = tvm.JobArena(
            slot_job=up(slot_job),
            base=up(np.asarray([s.base for s in self._slots], np.int32)),
            end=up(np.asarray([s.end for s in self._slots], np.int32)),
            next=up(np.asarray([s.base + 1 for s in self._slots], np.int32)),
        )

    @property
    def live(self) -> bool:
        return any(r.running for r in self._regions)

    def stats(self) -> RunStats:
        """Fleet-level stats: V_inf terms counted per fused dispatch."""
        return self._col.result()

    # ------------------------------------------------- streaming admission
    def admit(self, handle: JobHandle) -> bool:
        """Seat a queued (or preempted) job into a freed region, mid-flight.

        A region can be reused by any job whose program is structurally
        equal to the region's fused-in template (``Program.structural_hash``
        — same tables and task bytecode), with a quota up to the region's.
        Returns False when the driver is not admitting now
        (``_admits_midflight``) or no compatible free region exists.
        """
        if not self._admits_midflight():
            return False
        job = handle.job
        for r in self._regions:
            if r.handle is not None:
                continue
            s = r.slot
            if job.quota > s.quota:
                continue
            if s.program is not job.program and (
                s.program.structural_hash() != job.program.structural_hash()
            ):
                continue
            if handle.checkpoint is not None:
                self._restore_region(r, handle)
            else:
                self._seed_region(r, handle)
            return True
        return False

    def _admits_midflight(self) -> bool:
        return True

    def _seed_region(self, r: _Region, handle: JobHandle) -> None:
        raise NotImplementedError

    # --------------------------------------------------------- preemption
    def preempt(self, handle: JobHandle) -> bool:
        """Evict a RUNNING job at the current epoch boundary.

        The job's region — TV rows, tenant heap, arena cursor, stack
        entries, accumulators — lifts into a :class:`RegionCheckpoint` on
        the handle, the region is freed for admission, and the handle
        moves to PREEMPTED.  Re-admitting the handle restores the image and
        the job continues bit-identically to an uninterrupted run.
        Returns False when the driver is not at a yield point
        (``_admits_midflight``: a fully resident wave has none) or the
        handle is not running here.
        """
        if not self._admits_midflight():
            return False
        for j, r in enumerate(self._regions):
            if r.handle is handle and r.running:
                cp = self._capture_region(j)
                self._release(j)
                self._vacate(j)
                handle.mark_preempted(cp)
                return True
        return False

    def running_handles(self) -> List[JobHandle]:
        """The handles currently seated in this wave's regions."""
        return [r.handle for r in self._regions if r.running]

    def _capture_region(self, j: int) -> RegionCheckpoint:
        raise NotImplementedError

    def _restore_region(self, r: _Region, handle: JobHandle) -> None:
        raise NotImplementedError

    def _vacate(self, j: int) -> None:
        """Driver-specific cleanup after a region's tenant was captured
        (the host driver needs none: with its scheduler gone, no pop ever
        reaches the stale TV content)."""

    def _capture_tv(self, r: _Region):
        """The TVM half of a capture: the job's TV rows (task codes
        relative to the slot's task offset, ``child_base`` relative to the
        region base; lanes never written stored as zeros), its tenant heap
        (namespace and sink row stripped), and the arena cursor offset.
        Host numpy copies."""
        s = r.slot
        sub = s.program
        q = r.active_quota
        tgt = slice(s.base, s.base + q)
        st = self._state
        epoch = _host(st.epoch[tgt])
        task = _host(st.task[tgt])
        child_count = _host(st.child_count[tgt])
        child_base = _host(st.child_base[tgt])
        tv = {
            "epoch": epoch.copy(),
            "task_rel": np.where(
                epoch > 0, task - s.task_offset, 0
            ).astype(np.int32),
            "argi": _host(st.argi[tgt, : sub.n_arg_i]).copy(),
            "argf": _host(st.argf[tgt, : sub.n_arg_f]).copy(),
            "value": _host(st.value[tgt, : sub.value_width]).copy(),
            "child_count": child_count.copy(),
            "child_base_rel": np.where(
                child_count > 0, child_base - s.base, 0
            ).astype(np.int32),
        }
        heap = {hv.name: _host(self._heap[s.prefix + hv.name][:-1]).copy()
                for hv in sub.heap}
        next_off = int(self._arena.next[s.index]) - s.base
        return tv, heap, next_off

    def _clear_region(self, slot: TenantSlot) -> None:
        st = self._state
        sl = slice(slot.base, slot.end)
        for f in dataclasses.fields(st):
            t = getattr(st, f.name)
            if t.dim() > 0:
                t[sl] = 0

    def _restore_state(self, slot: TenantSlot, cp: RegionCheckpoint) -> None:
        """The TVM half of a restore, in place: clear the slot region and
        write the checkpoint image shifted to this slot's base and task
        offset, padded to the fused program's argument and value widths."""
        st = self._state
        self._clear_region(slot)
        tgt = slice(slot.base, slot.base + cp.quota)
        dev = self.device
        epoch = cp.tv["epoch"]
        task = np.where(epoch > 0, cp.tv["task_rel"] + slot.task_offset, 0)
        cb = np.where(cp.tv["child_count"] > 0,
                      cp.tv["child_base_rel"] + slot.base, 0)
        st.task[tgt] = torch.as_tensor(task.astype(np.int32), device=dev)
        st.epoch[tgt] = torch.as_tensor(epoch, device=dev)
        st.child_base[tgt] = torch.as_tensor(cb.astype(np.int32), device=dev)
        st.child_count[tgt] = torch.as_tensor(cp.tv["child_count"],
                                              device=dev)
        for name in ("argi", "argf", "value"):
            img = cp.tv[name]
            getattr(st, name)[tgt, : img.shape[1]] = torch.as_tensor(
                img, device=dev)

    def _seed_state(self, slot: TenantSlot, job: Job) -> None:
        """Clear a freed slot region and seed the new tenant's root task,
        in place."""
        st = self._state
        self._clear_region(slot)
        ai, af = pack_args(self.program, job.initial.argi, job.initial.argf)
        st.task[slot.base] = slot.task_offset + slot.program.task_id(
            job.initial.task)
        st.argi[slot.base] = torch.as_tensor(ai, device=self.device)
        st.argf[slot.base] = torch.as_tensor(af, device=self.device)
        st.epoch[slot.base] = 1

    # ------------------------------------------------- completion / release
    def _finalize(self, j: int) -> JobHandle:
        """Extract the region's solo-equivalent result; free the region."""
        r = self._regions[j]
        s = r.slot
        sub = s.program
        value = self._state.value[
            s.base: s.base + r.active_quota, : sub.value_width
        ].clone()
        heap = {
            hv.name: self._heap[s.prefix + hv.name][:-1].clone()
            for hv in sub.heap
        }
        r.handle.result = JobResult(heap=heap, value=value, stats=r.stats)
        r.handle.status = JobStatus.DONE
        r.handle.mark_finished()
        return self._release(j)

    def _fail(self, j: int, reason: Optional[str] = None) -> JobHandle:
        r = self._regions[j]
        r.handle.error = JobFailure(
            reason
            or f"job {r.handle.job.name!r} overflowed its region: "
               f"quota={r.active_quota}"
        )
        r.handle.status = JobStatus.FAILED
        r.handle.mark_finished()
        return self._release(j)

    def _release(self, j: int) -> JobHandle:
        r = self._regions[j]
        h = r.handle
        r.handle = None
        r.sched = None
        r.stats = None
        r.active_quota = 0
        return h


# --------------------------------------------------------------------------
# The host-loop multiplexer
# --------------------------------------------------------------------------
class EpochMultiplexer(_FleetBase):
    """Co-schedule a fleet of jobs inside one shared TVM (host loop).

    Each global epoch: select a gang of ready jobs (``pop_policy``), pop
    one dispatch from each job's own scheduler, fuse the ranges into a
    single launch over their covering span with a per-lane epoch-number
    vector (lanes outside every popped range carry 0 and stay inactive),
    commit with the :class:`~repro_torch.core.tvm.JobArena` segmented
    allocator, and read back one fused summary.  Dispatch + readback are
    counted once per global epoch — the fleet's V_inf — while each job's
    scheduler sees exactly the solo sequence of pops and pushes.

    ``device=None`` means CUDA (and raises where CUDA is absent).
    """

    def __init__(
        self,
        handles: Sequence[JobHandle],
        capacity: Optional[int] = None,
        dispatch: Any = "masked",
        coalesce: bool = True,
        pop_policy: Any = "fuse_all",
        gang: int = 0,
        collect_stats: bool = True,
        device=None,
    ):
        super().__init__(
            handles, capacity=capacity, coalesce=coalesce,
            collect_stats=collect_stats, device=device,
        )
        self.pop_policy = resolve_mux_policy(pop_policy, gang)
        self._loop = EpochLoop(self.program, dispatch)
        self.policy = self._loop.policy
        self._rotor = 0
        self._global_epochs = 0
        # resume preempted members now that the runtime state exists
        for j, h in self._restore_pending:
            self._restore_region(self._regions[j], h)
        self._restore_pending = []

    @staticmethod
    def _readback(summary: tvm.MuxEpochSummary, state):
        """One fused readback for the whole fleet: the five per-job vectors
        and the map flag stacked into one int32 tensor, one transfer."""
        J = summary.job_forks.shape[0]
        v = torch.cat([
            summary.job_forks.to(_I32), summary.job_join.to(_I32),
            summary.job_active.to(_I32), summary.job_overflow.to(_I32),
            summary.job_next.to(_I32),
            summary.map_scheduled.to(_I32).reshape(1),
        ]).cpu().numpy()
        return (v[:J], v[J:2 * J] > 0, v[2 * J:3 * J], v[3 * J:4 * J] > 0,
                v[4 * J:5 * J], bool(v[5 * J]))

    # ------------------------------------------------------------ stepping
    def step(self) -> List[JobHandle]:
        """Run one fused global epoch; return handles that completed."""
        ready = [
            j for j, r in enumerate(self._regions) if r.running and r.sched
        ]
        if not ready:
            return []
        depths = [len(self._regions[j].sched) for j in ready]
        chosen = self.pop_policy.select(ready, depths, self._rotor)
        self._rotor += 1
        self._global_epochs += 1
        col = self._col

        pops = {j: self._regions[j].sched.pop() for j in chosen}
        lo = min(d.start for d in pops.values())
        hi = max(d.start + d.count for d in pops.values())
        cen_np = np.zeros(hi - lo, np.int32)
        for d in pops.values():
            cen_np[d.start - lo: d.start - lo + d.count] = d.cen

        (self._state, self._heap, summary, fetched, map_launches,
         launched, by_type, shared_dispatches) = self._loop.run_epoch(
            self._state, self._heap, lo, hi - lo, cen_np, col,
            self._readback, arena=self._arena,
        )
        job_forks, job_join, job_active, job_overflow, job_next, \
            map_sched = fetched
        # the region cursors advance on the device; only the readback copy
        # above crosses to the host
        self._arena = dataclasses.replace(self._arena, next=summary.job_next)

        done: List[JobHandle] = []
        for j in chosen:
            r = self._regions[j]
            d = pops[j]
            if bool(job_overflow[j]):
                done.append(self._fail(j))
                continue
            if bool(job_join[j]):
                r.sched.push_join(d.cen, d.start, d.count)
            forks = int(job_forks[j])
            r.sched.push_forked(d.cen + 1, int(job_next[j]) - forks, forks)
            st = r.stats
            st.epochs += 1
            st.tasks_executed += int(job_active[j])
            st.total_forks += forks
            st.peak_tv_slots = max(
                st.peak_tv_slots, int(job_next[j]) - r.slot.base
            )
            st.shared_dispatches += shared_dispatches
            st.shared_transfers += shared_dispatches

        if map_sched:
            self._heap = self._loop.maps.run(map_launches, self._heap, col)

        col.epoch(self._global_epochs,
                  sum(d.n_ranges for d in pops.values()))
        col.lanes(int(job_active.sum()), launched, by_type)
        col.forks(int(job_forks.sum()))
        col.tv_peak(int(job_next.max()))

        for j in chosen:
            r = self._regions[j]
            if r.running and not r.sched:
                done.append(self._finalize(j))
        return done

    def run(self, max_epochs: int = 1 << 20) -> List[JobHandle]:
        """Drive every admitted job to completion; return finished handles."""
        out: List[JobHandle] = []
        while self.live:
            if self._global_epochs >= max_epochs:
                raise RuntimeError(f"exceeded max_epochs={max_epochs}")
            out.extend(self.step())
        return out

    # ------------------------------------------------- streaming admission
    def _seed_region(self, r: _Region, handle: JobHandle) -> None:
        """Clear a freed region and seed the new tenant's root task."""
        job = handle.job
        s = r.slot
        self._seed_state(s, job)
        self._arena = tvm.arena_reset_region(
            self._arena, s.index, s.base, job.quota
        )
        self._heap.update(self._tenant_heap(s, job.heap_init))
        sched = EpochScheduler(coalesce=self.coalesce)
        sched.reset(cen=1, start=s.base, count=1)
        r.handle = handle
        r.sched = sched
        r.stats = JobStats()
        r.active_quota = job.quota
        handle.mark_running()

    # --------------------------------------------------------- preemption
    def _capture_region(self, j: int) -> RegionCheckpoint:
        r = self._regions[j]
        tv, heap, next_off = self._capture_tv(r)
        cens, ranges = r.sched.export_stack()
        ranges = ranges.copy()
        if ranges.size:
            ranges[:, 0] -= r.slot.base
        st = dataclasses.replace(r.stats)
        return RegionCheckpoint(
            structural_hash=r.slot.program.structural_hash(),
            quota=r.active_quota,
            tv=tv, heap=heap, arena_next_off=next_off,
            sp=len(cens), jstack=cens, rstack=ranges,
            job_epochs=st.epochs, job_tasks=st.tasks_executed,
            job_forks=st.total_forks, job_peak=st.peak_tv_slots,
            stats=st,
        )

    def _restore_region(self, r: _Region, handle: JobHandle) -> None:
        """Seat a preempted job's checkpoint into a freed region: the TV
        image shifts to this region's base and offsets, the arena cursor
        resumes where it left off, and the scheduler stacks reload."""
        cp = handle.checkpoint
        s = r.slot
        self._restore_state(s, cp)
        arena = tvm.arena_reset_region(self._arena, s.index, s.base, cp.quota)
        arena.next[s.index] = s.base + cp.arena_next_off
        self._arena = arena
        self._heap.update({
            s.prefix + k: v
            for k, v in tvm.heap_with_sink({
                k: torch.as_tensor(v, device=self.device)
                for k, v in cp.heap.items()
            }).items()
        })
        sched = EpochScheduler(coalesce=self.coalesce)
        ranges = np.asarray(cp.rstack, np.int32).reshape(-1, 2).copy()
        if ranges.size:
            ranges[:, 0] += s.base
        sched.load_stack(cp.jstack, ranges)
        r.handle = handle
        r.sched = sched
        r.stats = (
            cp.stats if cp.stats is not None
            else JobStats(
                epochs=cp.job_epochs, tasks_executed=cp.job_tasks,
                total_forks=cp.job_forks, peak_tv_slots=cp.job_peak,
            )
        )
        r.active_quota = cp.quota
        handle.checkpoint = None
        handle.mark_running()


# --------------------------------------------------------------------------
# The chunked resident driver
# --------------------------------------------------------------------------
class _ChunkLedger:
    """Fleet totals already credited to the stats collector.

    Each chunk boundary accounts only its delta against these, so
    re-reading the carry's monotone accumulators never double-counts and
    an empty trailing chunk credits nothing.  A region's entries change
    with the carry's when it is reseeded or restored.
    """

    def __init__(self, n_regions: int):
        self.epochs = 0
        self.job_epochs = np.zeros(n_regions, np.int64)
        self.job_tasks = np.zeros(n_regions, np.int64)
        self.job_forks = np.zeros(n_regions, np.int64)
        self.map_launches = 0
        self.map_elements = 0
        self.map_lanes = 0
        self.hole_lanes = 0


def check_resident_options(dispatch: Any, chunk: Any):
    """The options of a resident wave, checked here for
    :class:`DeviceMultiplexer` and ``JobService(engine="device")`` alike:
    the masked or gather dispatch (compacted sizes its launches from
    runtime populations) and a chunk of K >= 1 epochs, or None for a fully
    resident wave (``"auto"``, the chunk controller, is ROADMAP item 8).
    Returns the dispatch policy."""
    policy = resolve_policy(dispatch)
    if policy.name not in ("masked", "gather"):
        raise ValueError(_COMPACTED_RESIDENT_MSG)
    if chunk == "auto":
        raise NotImplementedError(
            "chunk='auto' (the chunk controller) is not ported to the "
            "PyTorch package yet (ROADMAP item 8)")
    if isinstance(chunk, str) or (chunk is not None and chunk < 1):
        raise ValueError(
            "chunk must be >= 1 epoch, or None for a fully resident "
            f"wave; got {chunk!r}"
        )
    return policy


class DeviceMultiplexer(_FleetBase):
    """Chunked device-resident wave execution (DESIGN.md §9–10).

    The admitted fleet runs in the resident loop — per-region stacks on
    the device, the :class:`~repro_torch.core.tvm.JobArena` cursors and
    per-region reclamation riding the carry, every region's pop fused
    into one per-lane epoch-number vector per epoch — for at most
    ``chunk`` (K) epochs a call.  Each chunk boundary reads one
    :class:`~repro_torch.core.engine.ChunkSummary`; between chunks the host
    streams the completions of drained regions, reseeds freed regions in
    the live carry (``admit``: a structurally equal queued job, nothing
    rebuilt) and preempts.  ``chunk=None`` runs the whole wave as one
    chunk and is closed to admission and preemption.

    Masked and gather dispatches only (``compacted`` raises, as in the
    reference); every live region pops each global epoch.  On the card a
    chunk is the plain loop, whose steps call the ``segmented_fork_scan``
    and ``type_rank`` kernels, or with ``megakernel=True`` one
    cooperative ``epoch_chunk`` launch (a wave whose tenant mix the kernel
    does not instantiate raises).  A job overflowing its region (quota or
    stack depth) fails alone, mid-chunk.  Per-job results are bit-identical
    to solo runs at every K.  ``template`` reuses a
    :class:`~repro_torch.service.jobs.WaveTemplate`'s fused program, slots
    and loop.  ``device=None`` means CUDA (and raises where CUDA is
    absent).
    """

    def __init__(
        self,
        handles: Sequence[JobHandle],
        capacity: Optional[int] = None,
        dispatch: Any = "masked",
        stack_depth: int = 1 << 10,
        chunk: Any = None,
        collect_stats: bool = True,
        template=None,
        megakernel: bool = False,
        device=None,
    ):
        super().__init__(
            handles, capacity=capacity, collect_stats=collect_stats,
            device=device, template=template,
        )
        policy = check_resident_options(dispatch, chunk)
        self.stack_depth = stack_depth
        self.chunk = chunk
        if template is not None:
            if template.loop.policy.name != policy.name:
                raise ValueError(
                    "wave template was built with dispatch "
                    f"{template.loop.policy.name!r} but this wave asks for "
                    f"{policy.name!r} (key on dispatch when caching "
                    "templates)"
                )
            if template.loop.megakernel != bool(megakernel):
                raise ValueError(
                    "wave template was built with megakernel="
                    f"{template.loop.megakernel} but this wave asks for "
                    f"megakernel={bool(megakernel)} (key on megakernel "
                    "when caching templates)"
                )
            self._loop: EpochLoop = template.loop
        else:
            self._loop = EpochLoop(self.program, dispatch,
                                   megakernel=megakernel,
                                   tenants=self._slots)
        self.policy = self._loop.policy
        if self._loop.megakernel and self.device.type == "cuda":
            self._loop.device_table()  # no instantiated tenant mix: raise
        self._carry = None
        self._ledger = _ChunkLedger(len(self._slots))

    @property
    def loop(self) -> EpochLoop:
        """The driver core (owner of the resident bodies)."""
        return self._loop

    @property
    def slots(self):
        """Fuse-time slot layout (for wave-template capture)."""
        return self._slots

    # ------------------------------------------------------------ driving
    def _ensure_carry(self) -> None:
        """Build the resident carry on first use: a seated region's stack
        gets its seed entry (sp=1), a vacant one starts empty (sp=0)."""
        if self._carry is not None:
            return
        J = len(self._slots)
        jstack, rstack, sp = batched_device_stacks(
            J, self.stack_depth, self.device,
            cens=np.ones(J, np.int32),
            starts=np.asarray([s.base for s in self._slots], np.int32),
            counts=np.ones(J, np.int32),
        )
        seated = torch.as_tensor(
            [r.handle is not None for r in self._regions], device=self.device)
        sp = sp * seated.to(_I32)
        self._carry = _fresh_resident_carry(
            self._state, self._heap, self._arena, jstack, rstack, sp,
            n_regions=J,
        )

    def _chunk_limit(self, max_epochs: int) -> int:
        """This chunk's epoch bound: the guard for a fully resident wave,
        else the ledger's epoch watermark plus K."""
        if self.chunk is None:
            return max_epochs
        return min(max_epochs, self._ledger.epochs + self.chunk)

    def _attach_carry(self, carry) -> None:
        """Adopt a post-chunk carry (the same tensors, updated in place):
        the shared plumbing reads the wave state through these."""
        self._carry = carry
        self._state, self._heap, self._arena = (
            carry.state, carry.heap, carry.arena
        )

    def step(self, max_epochs: int = 1 << 20) -> List[JobHandle]:
        """Run one chunk — at most ``chunk`` epochs (the whole wave when
        ``chunk`` is None) — then surface every region that drained or
        failed.  Once nothing is live, calls are no-ops that touch neither
        the device nor the stats."""
        if self._restore_pending:
            # wave members resuming from preemption: build the carry, then
            # write each checkpoint image into its region
            self._ensure_carry()
            for j, h in self._restore_pending:
                self._restore_region(self._regions[j], h)
            self._restore_pending = []
        riders = [j for j, r in enumerate(self._regions) if r.running]
        if not riders:
            return []
        self._ensure_carry()
        carry = self._loop.run_chunk(
            self._carry, self._chunk_limit(max_epochs),
            n_regions=len(self._slots))
        self._attach_carry(carry)
        s = self._loop.chunk_summary(carry)
        self._account(s, riders)
        return self._settle(s, riders, max_epochs)

    def run(self, max_epochs: int = 1 << 20) -> List[JobHandle]:
        """Drive the wave to completion, chunk by chunk."""
        out: List[JobHandle] = []
        while self.live:
            out.extend(self.step(max_epochs=max_epochs))
        return out

    # --------------------------------------------------------- accounting
    def _account(self, s: ChunkSummary, riders: List[int]) -> None:
        """Credit this chunk's delta to the fleet collector and to every
        region that rode the chunk."""
        col = self._col
        col.dispatch()
        col.transfer()
        for j in riders:
            self._regions[j].stats.shared_dispatches += 1
            self._regions[j].stats.shared_transfers += 1
        led = self._ledger
        d_epochs = s.n_epochs - led.epochs
        d_holes = s.hole_lanes - led.hole_lanes
        if d_epochs > 0:
            # every global epoch fused all regions live then; the task
            # steps were span-bucketed, so launched lanes are the full-TV
            # total minus the hole lanes (reported first, as the host
            # gather path does)
            col.epoch(
                s.n_epochs,
                n_ranges=int((s.job_epochs - led.job_epochs).sum()),
                n=d_epochs,
            )
            col.holes_skipped(d_holes)
            col.lanes(int((s.job_tasks - led.job_tasks).sum()),
                      d_epochs * self.capacity - d_holes, None)
            col.forks(int((s.job_forks - led.job_forks).sum()))
        bases = np.asarray([sl.base for sl in self._slots])
        col.tv_peak(int((s.job_peak + bases).max()))
        d_maps = s.map_launches - led.map_launches
        if d_maps > 0:
            col.map_launch(
                s.map_elements - led.map_elements,
                s.map_lanes - led.map_lanes, n=d_maps,
            )
        led.epochs = s.n_epochs
        led.job_epochs = s.job_epochs.astype(np.int64)
        led.job_tasks = s.job_tasks.astype(np.int64)
        led.job_forks = s.job_forks.astype(np.int64)
        led.map_launches = s.map_launches
        led.map_elements = s.map_elements
        led.map_lanes = s.map_lanes
        led.hole_lanes = s.hole_lanes

    def _settle(self, s: ChunkSummary, riders: List[int],
                max_epochs: int) -> List[JobHandle]:
        """Surface every rider whose region drained, failed, or hit the
        epoch guard; the others stay RUNNING for the next chunk."""
        done: List[JobHandle] = []
        for j in riders:
            r = self._regions[j]
            # a region still holding stack entries at the guard fails, so
            # the wave always resolves every handle
            timed_out = bool(s.sp[j] > 0) and s.n_epochs >= max_epochs
            if s.sp[j] > 0 and not timed_out:
                continue
            st = r.stats
            st.epochs = int(s.job_epochs[j])
            st.tasks_executed = int(s.job_tasks[j])
            st.total_forks = int(s.job_forks[j])
            st.peak_tv_slots = int(s.job_peak[j])
            if bool(s.failed[j]) or timed_out:
                if timed_out:
                    reason = f"exceeded max_epochs={max_epochs}"
                elif bool(s.failed_stack[j]):
                    reason = (
                        f"job {r.handle.job.name!r} exhausted the resident "
                        f"scheduler stack: stack_depth={self.stack_depth}"
                    )
                else:
                    reason = None  # TV region overflow: the default message
                done.append(self._fail(j, reason=reason))
            else:
                done.append(self._finalize(j))
        return done

    # ------------------------------------------------- streaming admission
    def _admits_midflight(self) -> bool:
        # a fully resident wave (chunk=None) is closed: the host sees no
        # freed region until the whole wave drains
        return self.chunk is not None and self._carry is not None and self.live

    def _reset_region_carry(self, j: int, end: int, nxt: int,
                            acc=(0, 0, 0, 0)) -> None:
        """Point region ``j``'s arena cursors and accumulator rows (epochs,
        tasks, forks, peak) at a newly seated tenant, in the live carry
        and the ledger alike."""
        c = self._carry
        c.arena.end[j] = end
        c.arena.next[j] = nxt
        c.failed[j] = False
        c.failed_stack[j] = False
        for t, v in zip((c.job_epochs, c.job_tasks, c.job_forks,
                         c.job_peak), acc):
            t[j] = v
        led = self._ledger
        led.job_epochs[j], led.job_tasks[j], led.job_forks[j] = acc[:3]

    def _seed_region(self, r: _Region, handle: JobHandle) -> None:
        """Reseed a freed region in the live carry between chunks: TV
        slots, tenant heap, arena cursors, its stack row and accumulators;
        the next chunk sees one more live region."""
        job = handle.job
        s = r.slot
        self._seed_state(s, job)
        self._heap.update(self._tenant_heap(s, job.heap_init))
        self._reset_region_carry(s.index, s.base + job.quota, s.base + 1)
        reseed_region_stacks(self._carry.jstack, self._carry.rstack,
                             self._carry.sp, s.index, cen=1, start=s.base,
                             count=1)
        r.handle = handle
        r.sched = None
        r.stats = JobStats()
        r.active_quota = job.quota
        handle.mark_running()

    # --------------------------------------------------------- preemption
    def _capture_region(self, j: int) -> RegionCheckpoint:
        """Lift region ``j`` off the live carry at a chunk boundary: TV
        image, heap and arena cursor (``_capture_tv``), its stack row
        (starts region-relative) and its accumulators."""
        r = self._regions[j]
        tv, heap, next_off = self._capture_tv(r)
        c = self._carry
        epochs, tasks, forks, peak, sp = (int(v) for v in torch.stack([
            c.job_epochs[j].to(torch.int64), c.job_tasks[j],
            c.job_forks[j], c.job_peak[j].to(torch.int64),
            c.sp[j].to(torch.int64)]).tolist())
        jst = _host(c.jstack[j, :sp]).astype(np.int32)
        rst = _host(c.rstack[j, :sp]).astype(np.int32).copy()
        if rst.size:
            rst[:, 0] -= r.slot.base
        st = dataclasses.replace(
            r.stats, epochs=epochs, tasks_executed=tasks,
            total_forks=forks, peak_tv_slots=peak,
        )
        return RegionCheckpoint(
            structural_hash=r.slot.program.structural_hash(),
            quota=r.active_quota,
            tv=tv, heap=heap, arena_next_off=next_off,
            sp=sp, jstack=jst, rstack=rst,
            job_epochs=epochs, job_tasks=tasks,
            job_forks=forks, job_peak=peak,
            stats=st,
        )

    def _vacate(self, j: int) -> None:
        # sp = 0 makes the region inert: nothing pops it, so its stale TV
        # content is unreachable.  Its accumulator rows still match the
        # ledger, so chunk deltas stay zero until a reseed or restore.
        self._carry.sp[j] = 0

    def _restore_region(self, r: _Region, handle: JobHandle) -> None:
        """Write a checkpoint image into a freed region of the live carry
        (the dual of ``_seed_region``): TV, heap, arena cursor, the whole
        stack row, and the accumulators, with the ledger rows set to match
        so the next chunk credits only new work."""
        cp = handle.checkpoint
        s = r.slot
        self._restore_state(s, cp)
        self._heap.update({
            s.prefix + k: v
            for k, v in tvm.heap_with_sink({
                k: torch.as_tensor(v, device=self.device)
                for k, v in cp.heap.items()
            }).items()
        })
        self._reset_region_carry(
            s.index, s.base + cp.quota, s.base + cp.arena_next_off,
            (cp.job_epochs, cp.job_tasks, cp.job_forks, cp.job_peak))
        ranges = np.asarray(cp.rstack, np.int32).reshape(-1, 2).copy()
        if ranges.size:
            ranges[:, 0] += s.base
        load_region_stacks(self._carry.jstack, self._carry.rstack,
                           self._carry.sp, s.index, cp.jstack, ranges)
        r.handle = handle
        r.sched = None
        r.stats = (
            cp.stats if cp.stats is not None
            else JobStats(
                epochs=cp.job_epochs, tasks_executed=cp.job_tasks,
                total_forks=cp.job_forks, peak_tv_slots=cp.job_peak,
            )
        )
        r.active_quota = cp.quota
        handle.checkpoint = None
        handle.mark_running()
