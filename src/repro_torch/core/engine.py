"""TREES epoch engine, host half (PyTorch port of ``repro/core/engine.py``).

:class:`EpochLoop` is the driver core: the masked full-width step, the §5.4
compaction pass + dense per-type step, and the §11 gather pack + dense
frontier step, plus the one-epoch driver :meth:`EpochLoop.run_epoch`.
:class:`HostEngine` is the paper-faithful CPU/GPU split: the Python host
performs phase 1 (stack bookkeeping) and reads the end-of-epoch scalars —
the paper's ``joinScheduled``/``mapScheduled``/``nextFreeCore`` transfers —
once per epoch, while phases 2 and 3 run as tensor code on the device.

PyTorch runs eagerly, so the step builders of the JAX reference are plain
methods here (no jit caches).  The scans on the path run the port's CUDA
kernels on the card (``kernels/ops.py``): fork-slot allocation and the
compaction offsets go through ``fork_scan``, the compaction rank and the
gather pack through ``type_rank``.

Not ported yet: the resident ``DeviceEngine``, ``dispatch="auto"``, the
tracer, the controller, and the JAX engine's plug points for other scan
implementations (``fork_offsets_fn``/``rank_fn``/``pack_fn``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

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
    launch_bucket,
    resolve_policy,
    size_type_buckets,
)
from ..kernels import ops as kops

_I32 = torch.int32


class EngineError(RuntimeError):
    pass


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


def _frontier_mask(state: tvm.TVMState, start: int, count: int, cen: int,
                   P: int):
    """Per-lane active predicate of a popped NDRange frontier.

    A lane is active when it is inside the popped range, carries a nonzero
    epoch number, and TMS-matches (``epoch[slot] == cen``).  This predicate
    defines which lanes every dispatch mode executes.  Returns ``(idx,
    active, cen_l)``.
    """
    ar = torch.arange(P, dtype=_I32, device=state.device)
    idx = start + ar
    cidx = idx.clamp(0, state.capacity - 1)
    cen_l = torch.tensor(cen, dtype=_I32, device=state.device)
    active = (ar < count) & (cen_l > 0) & (state.epoch[cidx] == cen_l)
    return idx, active, cen_l


class MapLauncher:
    """Host-side launcher for scheduled ``map`` payloads (paper §5.2.4).

    Sizes each payload launch to the *live* element domain of its scheduled
    lanes and skips payloads whose lanes all have empty domains.  Reads each
    launch's ``where`` and ``argi`` on the host, as the JAX reference does.
    """

    def __init__(self, program: Program):
        self.program = program

    def run(self, map_launches, heap, col: StatsCollector):
        """Launch each scheduled map payload, sized to its live domain."""
        for ml in map_launches:
            where = ml.where.cpu().numpy()
            if not where.any():
                continue
            argi = ml.argi.cpu().numpy()
            dom = np.asarray(self.program.maps[ml.map_id].domain(argi))
            dmax = int(dom[where].max()) if dom[where].size else 0
            if dmax <= 0:
                # every scheduled lane has an empty element domain: a launch
                # would dispatch a wasted payload
                continue
            D = launch_bucket(dmax, minimum=8)
            P = int(where.shape[0])
            heap = tvm.run_map_payload(
                self.program, heap, ml.map_id, ml.where, ml.argi, ml.argf, D
            )
            col.dispatch()
            col.map_launch(int(dom[where].sum()), P * D)
        return heap


class EpochLoop:
    """The host-driven epoch core: step builders and the one-epoch driver."""

    def __init__(self, program: Program, dispatch: Any = MASKED):
        self.program = program
        self.policy: DispatchPolicy = resolve_policy(dispatch)
        self.task_names = [t.name for t in program.tasks]
        self.maps = MapLauncher(program)

    # ------------------------------------------------------------ the steps
    def masked_step(self, state, heap, start: int, count: int, cen: int,
                    P: int):
        """Phase 2+3 over the full padded NDRange, every type masked."""
        idx, active, cen_l = _frontier_mask(state, start, count, cen, P)
        per_type, _ = tvm.trace_tasks(self.program, state, heap, idx, active)
        return tvm.commit_epoch(
            self.program, state, heap, idx, active, per_type, cen_l
        )

    def compact_pass(self, state, start: int, count: int, cen: int, P: int):
        """Compaction pass: types -> ``(perm, per-type counts)`` (§5.4's
        extra dispatch + transfer, paid to make phase 2 lane-exact)."""
        idx, active, _ = _frontier_mask(state, start, count, cen, P)
        return tvm.compact_types(self.program, state, idx, active)

    def compacted_step(self, state, heap, start: int, count: int, cen: int,
                       perm, toffs, tcounts, buckets: Tuple[int, ...]):
        """Phase 2 over dense per-type slices, then the shared commit."""
        per_type, idx, active = tvm.trace_tasks_compacted(
            self.program, state, heap, start, count, cen, perm, toffs,
            tcounts, buckets,
        )
        return tvm.commit_epoch(
            self.program, state, heap, idx, active, per_type, cen
        )

    def gather_pass(self, state, start: int, count: int, cen: int, P: int):
        """Frontier pack pass: active mask -> ``(perm, count)``."""
        _, active, _ = _frontier_mask(state, start, count, cen, P)
        return kops.lane_pack(active)

    def gather_step(self, state, heap, start: int, perm, G: int):
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
            self.program, state, heap, idx, valid, per_type, cen_g
        )

    # ------------------------------------------------- one host-driven epoch
    def run_epoch(self, state, heap, start: int, span: int, cen: int,
                  col: StatsCollector, readback: Callable):
        """One host-driven epoch: optional compaction or gather-pack pass
        (+ its count readback), the phase-2/3 step, then the end-of-epoch
        readback ``readback(summary, state)`` — one host transfer.

        Returns ``(state, heap, summary, fetched, map_launches, launched,
        by_type, n_dispatches)``.
        """
        P = self.policy.epoch_bucket(span)
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
                state, heap, start, span, cen, perm, toffs, counts, buckets
            )
        elif mode == "gather":
            perm, count_dev = self.gather_pass(state, start, span, cen, P)
            n_sched = int(count_dev.cpu())
            col.dispatch()
            col.transfer()
            dispatches += 1
            G = self.policy.epoch_bucket(n_sched)
            state, heap, summary, map_launches = self.gather_step(
                state, heap, start, perm, G
            )
            launched = G
            col.holes_skipped(P - G)
        else:
            state, heap, summary, map_launches = self.masked_step(
                state, heap, start, span, cen, P
            )
            launched = P
        fetched = readback(summary, state)
        col.dispatch()
        col.transfer()
        return (
            state, heap, summary, fetched, map_launches, launched, by_type,
            dispatches,
        )


class HostEngine:
    """Paper-faithful engine: host drives stacks, device runs bulk epochs.

    ``device=None`` means CUDA (and raises where CUDA is absent); pass
    ``device="cpu"`` to run the plain PyTorch versions on the CPU.
    """

    def __init__(
        self,
        program: Program,
        capacity: int = 1 << 14,
        collect_stats: bool = True,
        dispatch: Any = MASKED,
        device=None,
    ):
        self.program = program
        self.capacity = capacity
        self.collect_stats = collect_stats
        self.device = resolve_device(device)
        self.loop = EpochLoop(program, dispatch)
        self.policy = self.loop.policy

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
        sched = EpochScheduler()
        sched.reset()
        col = RunStatsCollector() if self.collect_stats else NullStats()
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
