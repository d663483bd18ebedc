"""Task-program definition for the TVM / TREES runtime (PyTorch port).

A *program* is a set of task functions written against the
:class:`~repro_torch.core.primitives.EpochCtx` effect API.  Task functions
are written over **lane vectors**: every ``ctx.argi(k)`` is an ``i32[P]``
tensor holding that argument for all P lanes of the epoch's launch, so a
task *type* runs as one dense, masked vector operation with no vmap — the
analogue of the paper's SIMT "work-together" execution.

Key restrictions (they are what make bulk epoch execution possible):
  * task bodies are straight-line tensor code; data-dependent branching is
    expressed with per-lane ``where=`` predicates on the effect calls
    (fork/join/emit/map/write), never Python ``if`` on tensor values;
  * each task type has a *static* number of fork sites / write sites; which
    ones actually fire is decided by the predicates;
  * integer args live in ``argi`` (int32), float args in ``argf`` (float32);
    emitted values are a fixed-width vector of the program's
    ``value_dtype``.  Integer arithmetic stays int32 and wraps like the
    int32 Task Vector of the JAX reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Sequence

import numpy as np
import torch

TaskFn = Callable[["EpochCtx"], None]  # noqa: F821  (EpochCtx in primitives)
MapFn = Callable[["MapCtx"], None]  # noqa: F821


@dataclasses.dataclass(frozen=True)
class TaskType:
    """One entry in the program's task-function table."""

    name: str
    fn: TaskFn


@dataclasses.dataclass(frozen=True)
class MapType:
    """A data-parallel ``map`` payload (paper §4.2).

    ``domain`` maps the scheduling lanes' integer args (``i32[P, A]``, a
    tensor on the device or a numpy array on the host) to the number of
    data-parallel elements each lane's payload covers.  The host engine
    sizes the payload launch from it (the analogue of the paper's
    separately launched map kernel NDRange).
    """

    name: str
    fn: MapFn
    domain: Callable[[Any], Any]
    max_domain: int = 0


@dataclasses.dataclass(frozen=True)
class HeapVar:
    """A named global array tasks may read (gather) and write (scatter)."""

    name: str
    shape: tuple
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class Program:
    """A TVM task-parallel program.

    Attributes:
      name: program name (used in stats).
      tasks: task-function table; the task *type id* is the index here.
      n_arg_i / n_arg_f: width of the integer / float argument registers.
      value_width / value_dtype: shape and torch dtype of the per-task
        ``emit`` value.
      maps: optional table of data-parallel map payloads.
      heap: declarations of the global arrays.
    """

    name: str
    tasks: Sequence[TaskType]
    n_arg_i: int = 2
    n_arg_f: int = 0
    value_width: int = 1
    value_dtype: torch.dtype = torch.int32
    maps: Sequence[MapType] = ()
    heap: Sequence[HeapVar] = ()

    def task_id(self, name: str) -> int:
        for i, t in enumerate(self.tasks):
            if t.name == name:
                return i
        raise KeyError(name)

    def map_id(self, name: str) -> int:
        for i, m in enumerate(self.maps):
            if m.name == name:
                return i
        raise KeyError(name)

    def init_heap(self, device, **overrides: Any) -> Dict[str, torch.Tensor]:
        """Fresh heap arrays on ``device`` (zeros unless overridden)."""
        out: Dict[str, torch.Tensor] = {}
        for hv in self.heap:
            if hv.name in overrides:
                arr = torch.as_tensor(
                    overrides[hv.name], dtype=hv.dtype, device=device
                ).clone()
                if tuple(arr.shape) != tuple(hv.shape):
                    raise ValueError(
                        f"heap var {hv.name}: expected shape {hv.shape}, "
                        f"got {tuple(arr.shape)}"
                    )
            else:
                arr = torch.zeros(hv.shape, dtype=hv.dtype, device=device)
            out[hv.name] = arr
        unknown = set(overrides) - {hv.name for hv in self.heap}
        if unknown:
            raise KeyError(f"unknown heap overrides: {sorted(unknown)}")
        return out


@dataclasses.dataclass(frozen=True)
class InitialTask:
    """The seed task placed in TV slot 0 (paper §4.3: initial state)."""

    task: str
    argi: Sequence[int] = ()
    argf: Sequence[float] = ()


def pack_args(program: Program, argi: Sequence[int], argf: Sequence[float]):
    ai = np.zeros(program.n_arg_i, np.int32)
    ai[: len(argi)] = list(argi)
    af = np.zeros(program.n_arg_f, np.float32)
    af[: len(argf)] = list(argf)
    return ai, af
