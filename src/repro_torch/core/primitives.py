"""The TVM primitives — fork / join / emit / map — as an effect API over
lane vectors (PyTorch port).

Task functions receive an :class:`EpochCtx` and *record* effects; the engine
commits them in bulk at the end of the epoch (paper §4.3.3 / §5.2.4).  This
record-then-commit split is what lets TREES replace the GPU's per-thread
atomics with one cooperative prefix-sum allocation per epoch.

Unlike the JAX reference, whose context is per lane and vmapped, one context
here covers all P lanes of a launch: reads return ``[P]`` tensors, and every
``where=`` predicate is a per-lane ``bool[P]`` (or a scalar, broadcast).
The predicates default to True; they are the lane-level predication that
replaces SIMT divergence.

Heap arrays seen by a context carry one trailing *sink* row (see
``core/tvm.py``): reads clip to the real rows and never see it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

_WRITE_OPS = ("set", "add", "min", "max")


def _on(x, device, dtype=None) -> torch.Tensor:
    """``torch.as_tensor(x, dtype, device)``, a Python or numpy scalar
    filled on the device instead of copied from the host: a step captured
    in a CUDA graph cannot make a host-to-device copy (the same values)."""
    if isinstance(x, bool):
        inferred = torch.bool
    elif isinstance(x, int):
        inferred = torch.int64
    elif isinstance(x, float):
        inferred = torch.get_default_dtype()
    elif isinstance(x, np.generic):
        inferred = torch.from_numpy(np.asarray(x)).dtype
        x = x.item()
    else:
        return torch.as_tensor(x, dtype=dtype, device=device)
    return torch.full((), x, dtype=dtype or inferred, device=device)


@dataclasses.dataclass
class ForkSite:
    where: torch.Tensor  # bool[P]
    task: torch.Tensor   # i32[] or i32[P]
    argi: torch.Tensor   # i32[P, A]
    argf: torch.Tensor   # f32[P, Af]


@dataclasses.dataclass
class WriteSite:
    name: str
    index: torch.Tensor  # i32, lane-shaped
    value: torch.Tensor  # heap dtype, lane-shaped (+ the heap's trailing dims)
    op: str
    where: torch.Tensor  # bool, lane-shaped


@dataclasses.dataclass
class MapSite:
    where: torch.Tensor  # bool[P]
    map_id: int
    argi: torch.Tensor   # i32[P, A]
    argf: torch.Tensor   # f32[P, Af]


def heap_read(arr: torch.Tensor, index) -> torch.Tensor:
    """Gather ``arr[clip(index)]`` from a sink-carrying heap array.

    Always a copy: indexing with a 0-d tensor would return a *view*, and
    the commit's in-place heap writes would then show through it, where
    the reference reads the pre-epoch snapshot.
    """
    idx = _on(index, arr.device, torch.int32)
    flat = idx.reshape(-1).clamp(0, arr.shape[0] - 2)
    return arr.index_select(0, flat).reshape(idx.shape + arr.shape[1:])


def _check_op(op: str) -> None:
    if op not in _WRITE_OPS:
        raise ValueError(f"op must be one of {_WRITE_OPS}")


class EpochCtx:
    """All P lanes of one task type during epoch phase 2.

    The engine constructs it over the launch's gathered TV rows, runs the
    task function once, then reads the recorded effects back out.
    """

    def __init__(
        self,
        program,
        argi: torch.Tensor,
        argf: torch.Tensor,
        child_base: torch.Tensor,
        child_count: torch.Tensor,
        slot: torch.Tensor,
        heap: Dict[str, torch.Tensor],
        values: torch.Tensor,
    ):
        self._program = program
        self._argi = argi
        self._argf = argf
        self._child_base = child_base
        self._child_count = child_count
        self._slot = slot
        self._heap = heap
        self._values = values  # value_dtype[C + 1, W] (row C: sink)
        self._P = argi.shape[0]
        self._device = argi.device
        # recorded effects
        self.forks: List[ForkSite] = []
        self.join_site: Optional[ForkSite] = None
        self.emit_where = torch.zeros(self._P, dtype=torch.bool,
                                      device=self._device)
        self.emit_value = torch.zeros(
            (self._P, program.value_width), dtype=program.value_dtype,
            device=self._device,
        )
        self.writes: List[WriteSite] = []
        self.map_sites: List[MapSite] = []

    # ------------------------------------------------------------- reads
    def argi(self, k: int) -> torch.Tensor:
        """k-th integer argument of every lane, ``i32[P]``."""
        return self._argi[:, k]

    def argf(self, k: int) -> torch.Tensor:
        """k-th float argument of every lane, ``f32[P]``."""
        return self._argf[:, k]

    @property
    def slot(self) -> torch.Tensor:
        """Each lane's TV slot index (its abstract core id)."""
        return self._slot

    @property
    def child_count(self) -> torch.Tensor:
        """Number of children forked by each lane's predecessor (joins)."""
        return self._child_count

    def child_values(self, n: int) -> torch.Tensor:
        """Values emitted by up to ``n`` children, ``[P, n, value_width]``.

        Children of one task are contiguous (prefix-sum allocation preserves
        the paper's contiguity invariant), starting at ``child_base``.
        Entries >= child_count are zero.
        """
        ar = torch.arange(n, dtype=torch.int32, device=self._device)
        cap = self._values.shape[0] - 1
        idx = (self._child_base[:, None] + ar).clamp(0, cap - 1)
        vals = self._values[idx]
        mask = (ar < self._child_count[:, None])[..., None]
        return torch.where(mask, vals, torch.zeros_like(vals))

    def read(self, name: str, index) -> torch.Tensor:
        """Gather ``heap[name][index]`` (pre-epoch snapshot), per lane."""
        return heap_read(self._heap[name], index)

    # ----------------------------------------------------------- effects
    def fork(self, task: Any, argi=(), argf=(), where=True) -> None:
        """Spawn ``task(argi, argf)`` on the lanes where ``where`` holds;
        eligible from the *next* epoch."""
        self.forks.append(self._site(task, argi, argf, where))

    def join(self, task: Any, argi=(), argf=(), where=True) -> None:
        """Replace each lane's task with ``task``, to run after all of its
        forks finish."""
        if self.join_site is not None:
            raise ValueError("at most one join per task body (paper §4.3.2)")
        self.join_site = self._site(task, argi, argf, where)

    def emit(self, value, where=True) -> None:
        """Return a value to the parent waiting to join each lane.

        ``value`` is one scalar per lane (``[P]`` or a scalar) or a per-lane
        vector ``[P, k]`` with ``k <= value_width``, zero-padded.
        """
        W = self._program.value_width
        v = _on(value, self._device).to(
            self._program.value_dtype
        )
        if v.dim() == 0:
            v = v.expand(self._P)
        if v.dim() == 1:
            v = v[:, None]
        if v.shape[1] > W:
            raise ValueError("emit value wider than program.value_width")
        if v.shape[1] < W:
            pad = torch.zeros((self._P, W), dtype=v.dtype, device=v.device)
            pad[:, : v.shape[1]] = v
            v = pad
        w = self._lanes(where, torch.bool)
        self.emit_value = torch.where(w[:, None], v, self.emit_value)
        self.emit_where = self.emit_where | w

    def write(self, name: str, index, value, op: str = "set",
              where=True) -> None:
        """Scatter ``heap[name][index] (op)= value`` at end of epoch.

        ``add``/``min``/``max`` are conflict-safe; ``set`` with conflicting
        indices has an unspecified winner (same as the paper's data races).
        """
        _check_op(op)
        arr = self._heap[name]
        val = _on(value, self._device).to(arr.dtype)
        self.writes.append(
            WriteSite(
                name=name,
                index=self._lanes(index, torch.int32),
                value=val.expand((self._P,) + tuple(arr.shape[1:])),
                op=op,
                where=self._lanes(where, torch.bool),
            )
        )

    def map(self, map_fn: Any, argi=(), argf=(), where=True) -> None:
        """Schedule a data-parallel payload to run before the next epoch."""
        mid = (
            self._program.map_id(map_fn)
            if isinstance(map_fn, str)
            else int(map_fn)
        )
        self.map_sites.append(
            MapSite(
                where=self._lanes(where, torch.bool),
                map_id=mid,
                argi=self._pack(argi, self._program.n_arg_i, torch.int32),
                argf=self._pack(argf, self._program.n_arg_f, torch.float32),
            )
        )

    # ----------------------------------------------------------- helpers
    def _lanes(self, x, dtype) -> torch.Tensor:
        t = _on(x, self._device).to(dtype)
        return t.expand(self._P) if t.dim() == 0 else t

    def _pack(self, args, width: int, dtype) -> torch.Tensor:
        a = torch.zeros((self._P, width), dtype=dtype, device=self._device)
        for k, v in enumerate(args):
            a[:, k] = self._lanes(v, dtype)
        return a

    def _site(self, task, argi, argf, where) -> ForkSite:
        if isinstance(task, str):
            task = self._program.task_id(task)
        return ForkSite(
            where=self._lanes(where, torch.bool),
            task=_on(task, self._device).to(torch.int32),
            argi=self._pack(argi, self._program.n_arg_i, torch.int32),
            argf=self._pack(argf, self._program.n_arg_f, torch.float32),
        )


class MapCtx:
    """Lanes x elements view of a data-parallel ``map`` payload.

    The payload runs over a dense index domain ``[0, D)``: ``eid`` is the
    ``i32[1, D]`` element index and each ``argi(k)`` an ``i32[P, 1]``
    column, so task code broadcasts to ``[P, D]`` (the JAX reference's
    double vmap over lanes x domain, written out).  Reads snapshot the
    pre-map heap; writes commit in bulk.
    """

    def __init__(self, program, argi, argf, eid, heap):
        self._program = program
        self._argi = argi
        self._argf = argf
        self._eid = eid
        self._heap = heap
        self.writes: List[WriteSite] = []

    def argi(self, k: int) -> torch.Tensor:
        return self._argi[:, k:k + 1]

    def argf(self, k: int) -> torch.Tensor:
        return self._argf[:, k:k + 1]

    @property
    def eid(self) -> torch.Tensor:
        return self._eid

    def read(self, name: str, index) -> torch.Tensor:
        return heap_read(self._heap[name], index)

    def write(self, name: str, index, value, op: str = "set",
              where=True) -> None:
        _check_op(op)
        arr = self._heap[name]
        dev = arr.device
        self.writes.append(
            WriteSite(
                name=name,
                index=_on(index, dev).to(torch.int32),
                value=_on(value, dev).to(arr.dtype),
                op=op,
                where=_on(where, dev).to(torch.bool),
            )
        )
