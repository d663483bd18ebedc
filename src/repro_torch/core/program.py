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
import hashlib
import types
from typing import Any, Callable, Dict, Sequence

import numpy as np
import torch

_MAX_DEPTH = 16  # reference hops before fingerprints truncate to <deep>


def _code_fingerprint(code, g: Dict[str, Any], h, seen, depth: int) -> None:
    """Fingerprint a code object against globals namespace ``g``: bytecode,
    constants (nested code objects recurse against the same globals),
    referenced names, and the resolved values of those names."""
    if depth > _MAX_DEPTH:
        h.update(b"<deep>")
        return
    h.update(b"code")
    h.update(code.co_code)
    for c in code.co_consts:
        if isinstance(c, types.CodeType):
            _code_fingerprint(c, g, h, seen, depth + 1)
        else:
            _fingerprint(c, h, seen, depth + 1)
    h.update(repr(code.co_names).encode())
    for name in code.co_names:
        if name in g:
            h.update(name.encode())
            _fingerprint(g[name], h, seen, depth + 1)


def _fingerprint(obj: Any, h, seen: Dict[int, int], depth: int = 0) -> None:
    """Feed a structural fingerprint of ``obj`` into hash ``h``.

    Functions fingerprint as bytecode + constants + captured closure values
    + the resolved globals they reference (recursing into helpers), never
    as object identity, so two functions built independently by the same
    construction path fingerprint equal.  Tensors and arrays fingerprint by
    dtype, shape and bytes; torch dtypes by name.  Depth-bounded and
    cycle-safe: a function met again hashes as its position in the walk.
    The same walk as the JAX package's ``Program.structural_hash``; the
    digests of the two packages are not comparable.
    """
    if depth > _MAX_DEPTH:
        h.update(b"<deep>")
        return
    if isinstance(obj, types.FunctionType):
        if id(obj) in seen:
            h.update(f"<ref:{seen[id(obj)]}>".encode())
            return
        seen[id(obj)] = len(seen)
        h.update(b"fn")
        _code_fingerprint(obj.__code__, obj.__globals__, h, seen, depth)
        for cell in obj.__closure__ or ():
            try:
                _fingerprint(cell.cell_contents, h, seen, depth + 1)
            except ValueError:  # empty cell
                h.update(b"<empty-cell>")
        for d in obj.__defaults__ or ():
            _fingerprint(d, h, seen, depth + 1)
        for k in sorted(obj.__kwdefaults__ or {}):
            h.update(k.encode())
            _fingerprint(obj.__kwdefaults__[k], h, seen, depth + 1)
        return
    if isinstance(obj, types.CodeType):
        _code_fingerprint(obj, {}, h, seen, depth)
        return
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        arr = (obj.detach().cpu().numpy() if isinstance(obj, torch.Tensor)
               else obj)
        h.update(f"arr{arr.dtype}{arr.shape}".encode())
        h.update(np.ascontiguousarray(arr).tobytes())
        return
    if isinstance(obj, (torch.dtype, torch.device)):
        h.update(repr(obj).encode())
        return
    if isinstance(obj, (tuple, list)):
        h.update(f"seq{len(obj)}".encode())
        for x in obj:
            _fingerprint(x, h, seen, depth + 1)
        return
    if isinstance(obj, (set, frozenset)):
        h.update(f"set{len(obj)}".encode())
        for x in sorted(obj, key=repr):
            _fingerprint(x, h, seen, depth + 1)
        return
    if isinstance(obj, dict):
        h.update(f"map{len(obj)}".encode())
        for k in sorted(obj, key=repr):
            h.update(repr(k).encode())
            _fingerprint(obj[k], h, seen, depth + 1)
        return
    if isinstance(obj, types.ModuleType):
        h.update(f"mod:{obj.__name__}".encode())
        return
    if isinstance(obj, types.MethodType):
        h.update(b"method")
        _fingerprint(obj.__func__, h, seen, depth + 1)
        _fingerprint(obj.__self__, h, seen, depth + 1)
        return
    if obj is None or isinstance(
        obj, (bool, int, float, complex, str, bytes, np.generic)
    ):
        h.update(repr(obj).encode())
        return
    # other objects (partials, callable instances, ...): the qualified type
    # name — never the identity or address — plus inspectable state
    t = type(obj)
    h.update(f"<{t.__module__}.{t.__qualname__}>".encode())
    fn = getattr(obj, "func", None)  # functools.partial and friends
    if callable(fn):
        _fingerprint(fn, h, seen, depth + 1)
        _fingerprint(getattr(obj, "args", ()), h, seen, depth + 1)
        _fingerprint(getattr(obj, "keywords", {}) or {}, h, seen, depth + 1)
        return
    inst = getattr(obj, "__dict__", None)
    if isinstance(inst, dict) and inst:
        _fingerprint(inst, h, seen, depth + 1)
    call = getattr(t, "__call__", None)
    if isinstance(call, types.FunctionType):
        _fingerprint(call, h, seen, depth + 1)

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

    def structural_hash(self) -> str:
        """Hash of the program's *structure*, ignoring its display name.

        Covers the task/map/heap tables (names, order), register widths,
        value shape/dtype, and the fingerprint of every task, map and
        domain function (bytecode + captured constants, :func:`_fingerprint`)
        — everything that determines phase 2.  Two programs built
        independently by the same construction path hash equal, so the job
        service can reseed a freed region with any same-shape tenant.
        Cached after the first call.
        """
        cached = getattr(self, "_structural_hash_cache", None)
        if cached is not None:
            return cached
        h = hashlib.sha256()
        seen: Dict[int, int] = {}
        h.update(
            f"w{self.n_arg_i},{self.n_arg_f},{self.value_width},"
            f"{self.value_dtype}".encode()
        )
        for t in self.tasks:
            h.update(f"task:{t.name}".encode())
            _fingerprint(t.fn, h, seen)
        for m in self.maps:
            h.update(f"map:{m.name},{m.max_domain}".encode())
            _fingerprint(m.fn, h, seen)
            _fingerprint(m.domain, h, seen)
        for hv in self.heap:
            h.update(f"heap:{hv.name},{tuple(hv.shape)},{hv.dtype}".encode())
        digest = h.hexdigest()
        object.__setattr__(self, "_structural_hash_cache", digest)
        return digest

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
