"""Sequential reference interpreter for TVM programs (the runtime's oracle),
PyTorch port of ``repro/core/interp.py``.

Implements the abstract TVM of paper §4 directly, one lane at a time — no
vectorization, no padding, no buckets — and runs the very same task
functions through the port's own ``EpochCtx``/``MapCtx`` at one lane (a
map element is one lane of one element), on CPU tensors.  The bookkeeping
(task vector, epoch numbers, stacks) lives in numpy.  The vectorized
engines must produce identical heaps and identical emitted values.

It also returns the *ideal* work/critical-path numbers (T1 = total tasks,
T_inf = number of epochs), which ``analysis.py`` compares against engine
stats to isolate the runtime overheads V1 / V_inf.

Every read sees the pre-epoch heap (one snapshot per epoch: phase 2 only
records effects), the commit runs in slot order, each map call reads the
heap as it stood before that call, and trailing invalid slots are
reclaimed after every epoch — as in the JAX oracle.  The heap and value
arrays the contexts see carry the port's trailing sink row, which nothing
here writes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .primitives import EpochCtx, MapCtx
from .program import InitialTask, Program, pack_args

_I32 = torch.int32


@dataclasses.dataclass
class OracleStats:
    epochs: int = 0          # T_inf in epochs
    tasks_executed: int = 0  # T_1 in tasks
    total_forks: int = 0
    map_elements: int = 0
    peak_tv_slots: int = 0


def _apply(heap: Dict[str, torch.Tensor], w) -> None:
    """Commit one recorded single-lane heap write."""
    if not bool(w.where):
        return
    arr = heap[w.name]
    i = int(np.clip(int(w.index), 0, arr.shape[0] - 2))
    v = w.value.reshape(arr.shape[1:])
    if w.op == "set":
        arr[i] = v
    elif w.op == "add":
        arr[i] = arr[i] + v
    elif w.op == "min":
        arr[i] = torch.minimum(arr[i], v)
    elif w.op == "max":
        arr[i] = torch.maximum(arr[i], v)


def run_oracle(
    program: Program,
    initial: InitialTask,
    heap_init: Optional[Dict[str, Any]] = None,
    capacity: int = 1 << 14,
    max_epochs: int = 1 << 20,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, OracleStats]:
    """Run the TVM semantics sequentially; returns ``(heap, values,
    stats)`` as CPU tensors (``values`` is ``[capacity, value_width]``)."""
    cpu = torch.device("cpu")
    heap = {
        k: torch.cat([v, torch.zeros_like(v[:1])])  # + the sink row
        for k, v in program.init_heap(cpu, **(heap_init or {})).items()
    }

    task = np.zeros(capacity, np.int64)
    argi = np.zeros((capacity, program.n_arg_i), np.int64)
    argf = np.zeros((capacity, program.n_arg_f), np.float32)
    epoch = np.zeros(capacity, np.int64)
    value = torch.zeros((capacity + 1, program.value_width),
                        dtype=program.value_dtype)
    child_base = np.zeros(capacity, np.int64)
    child_count = np.zeros(capacity, np.int64)

    ai, af = pack_args(program, initial.argi, initial.argf)
    task[0] = program.task_id(initial.task)
    argi[0] = ai
    argf[0] = af
    epoch[0] = 1
    next_free = 1

    join_stack = [1]
    range_stack = [(0, 1)]
    stats = OracleStats(peak_tv_slots=1)

    def lane(x, dtype):
        return torch.as_tensor(np.asarray(x)[None], dtype=dtype)

    while join_stack:
        if stats.epochs >= max_epochs:
            raise RuntimeError("oracle exceeded max_epochs")
        cen = join_stack.pop()
        start, count = range_stack.pop()
        stats.epochs += 1

        # ---- phase 2: execute each active lane sequentially -------------
        snapshot = {k: v.clone() for k, v in heap.items()}  # pre-epoch
        values = value.clone()
        effects = []
        for slot in range(start, start + count):
            if epoch[slot] != cen:
                continue
            ctx = EpochCtx(
                program, lane(argi[slot], _I32), lane(argf[slot],
                                                      torch.float32),
                lane(child_base[slot], _I32), lane(child_count[slot], _I32),
                lane(slot, _I32), snapshot, values,
            )
            program.tasks[int(task[slot])].fn(ctx)
            effects.append((slot, ctx))
            stats.tasks_executed += 1

        # ---- phase 3: commit in slot order ------------------------------
        old_next_free = next_free
        join_sched = False
        map_calls: List[Tuple[int, torch.Tensor, torch.Tensor]] = []
        heap_writes = []
        for slot, ctx in effects:
            my_children = 0
            for f in ctx.forks:
                if not bool(f.where):
                    continue
                s = next_free
                if s >= capacity:
                    raise RuntimeError("oracle TV overflow")
                task[s] = int(f.task.reshape(-1)[0])
                argi[s] = f.argi[0].numpy()
                argf[s] = f.argf[0].numpy()
                epoch[s] = cen + 1
                child_base[s] = 0
                child_count[s] = 0
                next_free += 1
                my_children += 1
                stats.total_forks += 1
            child_base[slot] = next_free - my_children
            child_count[slot] = my_children
            j = ctx.join_site
            joined = j is not None and bool(j.where)
            if joined:
                task[slot] = int(j.task.reshape(-1)[0])
                argi[slot] = j.argi[0].numpy()
                argf[slot] = j.argf[0].numpy()
                join_sched = True
            if bool(ctx.emit_where):
                value[slot] = ctx.emit_value[0]
            if not joined:
                epoch[slot] = 0
            heap_writes.extend(ctx.writes)
            for m in ctx.map_sites:
                if bool(m.where):
                    map_calls.append((m.map_id, m.argi, m.argf))

        for w in heap_writes:
            _apply(heap, w)

        # ---- map payloads (between epochs, paper §5.2.4) -----------------
        for mid, mai, maf in map_calls:
            mt = program.maps[mid]
            dom = int(np.asarray(mt.domain(mai.numpy())).reshape(-1)[0])
            before = {k: v.clone() for k, v in heap.items()}
            writes = []
            for eid in range(dom):
                mctx = MapCtx(program, mai, maf,
                              torch.full((1, 1), eid, dtype=_I32), before)
                mt.fn(mctx)
                writes.extend(mctx.writes)
                stats.map_elements += 1
            for w in writes:
                _apply(heap, w)

        # ---- TMS update ---------------------------------------------------
        if join_sched:
            join_stack.append(cen)
            range_stack.append((start, count))
        if next_free > old_next_free:
            join_stack.append(cen + 1)
            range_stack.append((old_next_free, next_free - old_next_free))
        stats.peak_tv_slots = max(stats.peak_tv_slots, next_free)
        # trailing-invalid reclamation
        valid = np.nonzero(epoch > 0)[0]
        next_free = int(valid[-1]) + 1 if valid.size else 0

    return ({k: v[:-1] for k, v in heap.items()}, value[:-1], stats)
