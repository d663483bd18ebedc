"""The resident epoch loop as one hand-written CUDA kernel launch per chunk.

``epoch_chunk`` replaces the Pallas TPU kernel of the same name in
``repro/kernels/epoch_megakernel.py``: one K-epoch chunk of the resident
loop — ``while cond(carry, limit): carry = body(carry)`` — with the
:class:`~repro_torch.core.engine.ResidentCarry` updated in place and the
chunk bound read on the device.  The CUDA C++ lives in
``csrc/epoch_megakernel.cu``; its header says what bounds the kernel and
how it keeps the plain loop's bits.

The launch is cooperative: one persistent grid of :func:`grid` CTAs (the
card's SMs times the CTAs an SM holds), all resident, with grid barriers
on words of a scratch (:func:`coop_scratch_words`) that the launch clears
on the stream.  Each epoch starts at a barrier of the whole grid; a popped
range wider than one CTA is split into contiguous blocks over the first
CTAs, which cross about four barriers of their own, and a narrower one
runs on CTA 0 alone; map payloads run at the next epoch's start over the
whole grid (two grid barriers a launch).  What bounds it is that
serial chain of barriers and CTA 0's one-thread pop and push, not bytes:
``chip_smoke.py`` times the barrier (:func:`grid_sync_bench`) and counts
the chunk's barriers (``launch(..., stats=)``).  A refused cooperative
launch raises; there is no single-CTA fallback.

The Pallas kernel runs whatever traced body it is given.  A CUDA kernel
cannot run a Python task body, so the kernel holds the program-independent
phases and each supported program's task bodies are ``__device__``
functions in the source: its *device task table*.  :func:`device_table`
maps a :class:`~repro_torch.core.program.Program` to its table by checking
the task names and functions, argument and value widths, the heap
variables (names, dtypes, shapes), the maps and the constants a body
captured from its ``make_program`` (``inspect.getclosurevars``: treewalk's
``order``, fft's ``n``, and the constants the launch hands the kernel in
its ``consts``: nqueens' and tsp's ``n``, annealing's ``n_bits``,
``n_steps`` and ``n_chains``, matmul's ``n`` and ``block``) — not only the
program's name.  Every program of the registry has a table: fib, bfs,
mergesort (map and naive variants), treewalk (post- and pre-order), sssp,
nqueens, tsp, annealing, fft and matmul.  matmul's map adds floats into
``C``: the kernel applies those in stage order with the ordered add of
``csrc/ordered_add.cuh`` (the ``ordered_add`` kernel's algorithm), for
which :func:`launch` allocates the ``oa_*`` scratch.  What the kernel does
not run yet is a fleet carry (several regions of the job service).

:func:`epoch_chunk` dispatches on the carry's device: on the CPU it runs
the plain loop ``ref.epoch_chunk_ref`` (as the JAX package's ``"auto"``
does off the TPU); on the card it launches the kernel, and raises where the
program has no table or the launch fails — there is no fallback.  Each
launch adds one to ``LAUNCHES["epoch_chunk"]``.  Nothing here compiles or
loads at import time.
"""
from __future__ import annotations

import ctypes
import dataclasses
import inspect
import numbers
import pathlib
import threading
from typing import Callable, Dict, Optional, Tuple

import torch

from . import nvcc, ref

SOURCE = (pathlib.Path(__file__).resolve().parent / "csrc"
          / "epoch_megakernel.cu")

# the argument layout of trees_epoch_chunk (enum Ptr / enum Int in SOURCE)
MAX_SPAN, MAX_MAPS, MAX_MAP_WIDTHS, MAX_HEAP, MAX_CONSTS = 8, 4, 40, 8, 4
_PTRS = (
    "task", "argi", "argf", "epoch", "value", "child_base", "child_count",
    "next_free", "jstack", "rstack", "sp", "failed", "failed_stack",
    "n_epochs", "job_epochs", "job_tasks", "job_forks", "job_peak",
    "map_launches", "map_elements", "map_lanes", "hole_lanes", "fault",
    "limit", "lane_cnt", "lane_excl", "lane_flags", "emit_stage", "wr_idx",
    "wr_val", "wr_meta", "map_argi", "map_argf", "map_pre", "st_idx",
    "st_val", "st_meta", "coop", "stats", "oa_cnt", "oa_off", "oa_long",
    "oa_run", "oa_tot",
) + tuple(f"heap{v}" for v in range(MAX_HEAP))
_N_INTS = (4 + MAX_SPAN + 2 + 2 * MAX_HEAP + 1
           + MAX_MAPS * (2 + MAX_MAP_WIDTHS) + 5 + MAX_CONSTS)
# the cooperative scratch (csrc: kCoopHeader, kCtaWords, kMaxGrid): the
# barrier counters, the popped range with the pending map launches and the
# reclamation words by epoch parity, then one record of totals per CTA
COOP_HEADER_WORDS, COOP_CTA_WORDS, MAX_GRID = 23, 10, 1024
# stats a launch may add to: narrow epochs, wide epochs, grid barriers,
# group barriers, and the grid barriers of deep reclamation searches and of
# ordered float adds (both counted in grid_barriers too)
STATS = ("narrow_epochs", "wide_epochs", "grid_barriers", "group_barriers",
         "search_barriers", "ordered_barriers")
# the ordered add's stage positions are int32, and its merges add two
ORDERED_MAX_STAGE = 2**30

LAUNCHES: Dict[str, int] = {"epoch_chunk": 0}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()

_DTYPE_CODE = {torch.int32: 0, torch.float32: 1}


def reset_launches() -> None:
    LAUNCHES["epoch_chunk"] = 0


def coop_scratch_words(grid: int) -> int:
    """uint64 words of cooperative scratch a grid of ``grid`` CTAs takes."""
    if not 1 <= grid <= MAX_GRID:
        raise ValueError(f"epoch_chunk: a grid of {grid} CTAs (1..{MAX_GRID})")
    return COOP_HEADER_WORDS + COOP_CTA_WORDS * grid


def build(ptxas_info: bool = False) -> Tuple[pathlib.Path, str]:
    """Compile the source unless its library exists (``nvcc.build``)."""
    return nvcc.build(SOURCE, ptxas_info)


# --------------------------------------------------------------------------
# Device task tables
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DeviceTable:
    """What the kernel's compiled task bodies for one program assume.

    ``tasks``/``maps`` are ``(name, module, qualname)`` of the Python
    functions the ``__device__`` bodies were written from; ``heap`` the
    heap variables' ``(name, dtype)`` in program order; ``shapes_ok``
    checks the heap shapes, map domains and captured constants against
    each other and the kernel's limits; ``stage`` bounds the live map
    elements of one epoch (the payload stage the wrapper allocates; the
    kernel reports a fault beyond it); ``consts`` gives the constants the
    bodies read from the launch (at most ``MAX_CONSTS``).
    """

    app_id: int                  # the device table's index in SOURCE
    tasks: Tuple[Tuple[str, str, str], ...]
    maps: Tuple[Tuple[str, str, str], ...]
    n_arg_i: int
    n_arg_f: int
    value_width: int
    value_dtype: torch.dtype
    heap: Tuple[Tuple[str, torch.dtype], ...]
    shapes_ok: Callable
    stage: Callable = lambda program: 0
    consts: Callable = lambda program: ()


def _shapes(program):
    return {hv.name: tuple(hv.shape) for hv in program.heap}


def _closure(fn, name: str):
    """The value ``fn`` captured as ``name`` from the ``make_program`` call
    that made it (None if it captured no such name)."""
    if not callable(fn):
        return None
    return inspect.getclosurevars(fn).nonlocals.get(name)


def _captured(program, task: str, name: str):
    """What task ``task``'s function captured as ``name``."""
    return _closure(program.tasks[program.task_id(task)].fn, name)


def _int(v) -> Optional[int]:
    return int(v) if isinstance(v, numbers.Integral) else None


def _captured_int(program, task: str, name: str) -> Optional[int]:
    return _int(_captured(program, task, name))


def _bfs_shapes(program) -> bool:
    sh = _shapes(program)
    n = sh["dist"][0]
    return sh["adj_off"] == (n + 1,) and len(sh["adj"]) == 1


def _sssp_shapes(program) -> bool:
    sh = _shapes(program)
    n = sh["dist"][0]
    return sh["adj_off"] == (n + 1,) and sh["wgt"] == sh["adj"]


def _msort_shapes(program, use_map: bool) -> bool:
    # naive: the kernel's merge forks at one site per element of inp, so
    # the n the merge body captured must be inp's length
    sh = _shapes(program)
    n = sh["inp"][0]
    return (n > 0 and n & (n - 1) == 0 and sh["src"] == (2 * n,)
            and (program.maps[0].max_domain == n if use_map
                 else _captured(program, "merge", "n") == n))


def _tree_shapes(order: str):
    def ok(program) -> bool:
        sh = _shapes(program)
        n = sh["left"][0]
        return (sh["right"] == sh["visit_epoch"] == (n,)
                and sh["visit_clock"] == (1,)
                and _captured(program, "walk", "order") == order)
    return ok


# the largest n whose shift amounts (nqueens: up to 2n - 1) stay below 32
# and whose full tour mask (tsp: (1 << n) - 1) fits in int32
NQUEENS_MAX_N, TSP_MAX_N = 16, 31


def _nqueens_shapes(program) -> bool:
    n = _captured_int(program, "place", "n")
    return (n is not None and 1 <= n <= NQUEENS_MAX_N
            and _shapes(program)["count"] == (1,))


def _tsp_shapes(program) -> bool:
    # n twice: the closure's, which the kernel reads, and sqrt(len(dist))
    n, sh = _captured_int(program, "extend", "n"), _shapes(program)
    return (n is not None and 1 <= n <= TSP_MAX_N
            and sh["dist"] == (n * n,) and sh["best"] == (1,))


# annealing's energy reads n_bits bits of the state (apps/annealing.py:
# n_bits <= 16)
ANNEALING_MAX_BITS = 16


def _annealing_consts(program):
    return (_captured_int(program, "step", "n_bits"),
            _captured_int(program, "step", "n_steps"),
            _captured_int(program, "seed", "n_chains"))


def _annealing_shapes(program) -> bool:
    nb, ns, nc = _annealing_consts(program)
    sh = _shapes(program)
    return (None not in (nb, ns, nc) and 1 <= nb <= ANNEALING_MAX_BITS
            and ns >= 1 and 0 <= nc < 2**31 and sh["Q"] == (nb * nb,)
            and sh["best"] == (1,))


def _fft_n(program) -> Optional[int]:
    # the fft body reads n through its level-buffer helper `_buf`
    return _int(_closure(_captured(program, "fft", "_buf"), "n"))


def _fft_shapes(program) -> bool:
    n, sh = _fft_n(program), _shapes(program)
    return (n is not None and n >= 2 and n & (n - 1) == 0
            and sh["xr"] == sh["xi"] == (n,)
            and sh["re"] == sh["im"] == (2 * n,)
            and program.maps[0].max_domain == n // 2)


def _matmul_consts(program):
    fn = program.maps[0].fn
    return _int(_closure(fn, "n")), _int(_closure(fn, "block"))


def _matmul_stage(program) -> int:
    # every leaf runs in one epoch: (n / block)^3 leaves of block^2
    n, block = _matmul_consts(program)
    return n**3 // block


def _matmul_shapes(program) -> bool:
    # n twice: the block product's closure, which the kernel reads, and
    # sqrt(len(A)); block in both bodies
    (n, block), sh = _matmul_consts(program), _shapes(program)
    if None in (n, block) or block < 2 or n % block:
        return False
    nb = n // block
    return (nb & (nb - 1) == 0
            and _captured_int(program, "mm", "block") == block
            and sh["A"] == sh["B"] == sh["C"] == (n * n,)
            and program.maps[0].max_domain == block * block)


_APPS = "repro_torch.apps."
_I32, _F32 = torch.int32, torch.float32
_MSORT_TASKS = (
    ("msort", _APPS + "mergesort", "make_program.<locals>._msort"),
    ("merge", _APPS + "mergesort", "make_program.<locals>._merge"),
)
_MSORT_HEAP = (("inp", _F32), ("src", _F32))
_WALK = ("walk", _APPS + "treewalk", "make_program.<locals>._walk")
_TREE_HEAP = (("left", _I32), ("right", _I32), ("visit_epoch", _I32),
              ("visit_clock", _I32))
# app_id is the index of the table's App in the source's with_app
TABLES: Tuple[DeviceTable, ...] = (
    DeviceTable(
        app_id=0,
        tasks=(("fib", _APPS + "fib", "_fib"),
               ("fibsum", _APPS + "fib", "_fibsum")),
        maps=(), n_arg_i=1, n_arg_f=0, value_width=1,
        value_dtype=_I32, heap=(),
        shapes_ok=lambda program: True,
    ),
    DeviceTable(
        app_id=1,
        tasks=(("visit", _APPS + "bfs", "make_program.<locals>._visit"),),
        maps=(), n_arg_i=3, n_arg_f=0, value_width=1, value_dtype=_I32,
        heap=(("adj_off", _I32), ("adj", _I32), ("dist", _I32)),
        shapes_ok=_bfs_shapes,
    ),
    DeviceTable(
        app_id=2,
        tasks=_MSORT_TASKS,
        maps=(("place", _APPS + "mergesort",
               "make_program.<locals>._place"),),
        n_arg_i=4, n_arg_f=0, value_width=1, value_dtype=_I32,
        heap=_MSORT_HEAP,
        shapes_ok=lambda program: _msort_shapes(program, use_map=True),
        # the merges of one epoch share a level and cover [0, n) at most
        # once, so an epoch's live map elements are at most n = max_domain
        stage=lambda program: program.maps[0].max_domain,
    ),
    DeviceTable(
        app_id=3,
        tasks=(_WALK, ("visit_after", _APPS + "treewalk",
                       "make_program.<locals>._visit_after")),
        maps=(), n_arg_i=1, n_arg_f=0, value_width=1, value_dtype=_I32,
        heap=_TREE_HEAP, shapes_ok=_tree_shapes("post"),
    ),
    DeviceTable(
        app_id=4,
        tasks=(_WALK,),
        maps=(), n_arg_i=1, n_arg_f=0, value_width=1, value_dtype=_I32,
        heap=_TREE_HEAP, shapes_ok=_tree_shapes("pre"),
    ),
    DeviceTable(
        app_id=5,
        tasks=(("relax", _APPS + "sssp", "make_program.<locals>._relax"),),
        maps=(), n_arg_i=2, n_arg_f=1, value_width=1, value_dtype=_I32,
        heap=(("adj_off", _I32), ("adj", _I32), ("wgt", _F32),
              ("dist", _F32)),
        shapes_ok=_sssp_shapes,
    ),
    DeviceTable(
        app_id=6,
        tasks=(("place", _APPS + "nqueens",
                "make_program.<locals>._place"),),
        maps=(), n_arg_i=4, n_arg_f=0, value_width=1, value_dtype=_I32,
        heap=(("count", _I32),),
        shapes_ok=_nqueens_shapes,
        consts=lambda program: (_captured_int(program, "place", "n"),),
    ),
    DeviceTable(
        app_id=7,
        tasks=(("extend", _APPS + "tsp", "make_program.<locals>._extend"),),
        maps=(), n_arg_i=3, n_arg_f=0, value_width=1, value_dtype=_I32,
        heap=(("dist", _I32), ("best", _I32)),
        shapes_ok=_tsp_shapes,
        consts=lambda program: (_captured_int(program, "extend", "n"),),
    ),
    DeviceTable(
        app_id=8,
        tasks=_MSORT_TASKS + (
            ("place1", _APPS + "mergesort",
             "make_program.<locals>._place1"),),
        maps=(), n_arg_i=4, n_arg_f=0, value_width=1, value_dtype=_I32,
        heap=_MSORT_HEAP,
        shapes_ok=lambda program: _msort_shapes(program, use_map=False),
    ),
    DeviceTable(
        app_id=9,
        tasks=(("seed", _APPS + "annealing", "make_program.<locals>._seed"),
               ("step", _APPS + "annealing", "make_program.<locals>._step")),
        maps=(), n_arg_i=3, n_arg_f=0, value_width=1, value_dtype=_I32,
        heap=(("Q", _I32), ("best", _I32)),
        shapes_ok=_annealing_shapes,
        consts=_annealing_consts,
    ),
    DeviceTable(
        app_id=10,
        tasks=(("fft", _APPS + "fft", "make_program.<locals>._fft"),
               ("combine", _APPS + "fft", "make_program.<locals>._combine")),
        maps=(("butterfly", _APPS + "fft",
               "make_program.<locals>._butterfly"),),
        n_arg_i=5, n_arg_f=0, value_width=1, value_dtype=_I32,
        heap=(("xr", _F32), ("xi", _F32), ("re", _F32), ("im", _F32)),
        shapes_ok=_fft_shapes,
        # the combines of one epoch share a level: n / 2 butterflies
        stage=lambda program: program.maps[0].max_domain,
    ),
    DeviceTable(
        app_id=11,
        tasks=(("mm", _APPS + "matmul", "make_program.<locals>._mm"),),
        maps=(("block_mm", _APPS + "matmul",
               "make_program.<locals>._block_mm"),),
        n_arg_i=4, n_arg_f=0, value_width=1, value_dtype=_I32,
        heap=(("A", _F32), ("B", _F32), ("C", _F32)),
        shapes_ok=_matmul_shapes,
        stage=_matmul_stage,
        consts=_matmul_consts,
    ),
)


def _fn_key(fn) -> Tuple[str, str]:
    return getattr(fn, "__module__", ""), getattr(fn, "__qualname__", "")


def device_table(program) -> Optional[DeviceTable]:
    """The device task table the kernel holds for ``program``, or None."""
    for t in TABLES:
        if (
            tuple((tt.name,) + _fn_key(tt.fn) for tt in program.tasks)
            == t.tasks
            and tuple((m.name,) + _fn_key(m.fn) for m in program.maps)
            == t.maps
            and (program.n_arg_i, program.n_arg_f, program.value_width)
            == (t.n_arg_i, t.n_arg_f, t.value_width)
            and program.value_dtype == t.value_dtype
            and tuple((hv.name, hv.dtype) for hv in program.heap) == t.heap
            and all(len(hv.shape) == 1 for hv in program.heap)
            and t.shapes_ok(program)
        ):
            return t
    return None


# --------------------------------------------------------------------------
# The launch
# --------------------------------------------------------------------------
def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.trees_epoch_chunk.argtypes = [i, p, i, p, i, p]
            lib.trees_epoch_chunk.restype = i
            lib.trees_epoch_app_info.argtypes = [i, p]
            lib.trees_epoch_app_info.restype = i
            lib.trees_epoch_ptr_count.restype = i
            lib.trees_epoch_int_count.restype = i
            lib.trees_epoch_grid.argtypes = [i]
            lib.trees_epoch_grid.restype = i
            lib.trees_epoch_coop_words.argtypes = [i]
            lib.trees_epoch_coop_words.restype = ctypes.c_longlong
            lib.trees_grid_sync_bench.argtypes = [i, i, p, p]
            lib.trees_grid_sync_bench.restype = i
            if (lib.trees_epoch_ptr_count() != len(_PTRS)
                    or lib.trees_epoch_int_count() != _N_INTS):
                raise RuntimeError(
                    "epoch_megakernel: the library disagrees on the "
                    "argument layout"
                )
            _lib = lib
        return _lib


def grid(app_id: int, device=None) -> int:
    """CTAs of the cooperative grid of device table ``app_id`` on
    ``device``: SMs x the CTAs an SM holds (builds the library)."""
    with torch.cuda.device(device):
        g = _load().trees_epoch_grid(app_id)
    if g < 1:
        raise RuntimeError(
            f"epoch_chunk: no cooperative grid on this device (error {-g})")
    return g


def grid_sync_bench(n: int, grid_ctas: int, device=None) -> None:
    """Launch an empty cooperative kernel of ``grid_ctas`` CTAs that
    crosses ``n`` grid barriers, on the current stream (the barrier's
    cost, for ``chip_smoke.py``)."""
    lib = _load()
    dev = torch.device("cuda") if device is None else torch.device(device)
    scratch = torch.empty((1,), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.trees_grid_sync_bench(
            grid_ctas, n, ctypes.c_void_p(scratch.data_ptr()),
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"grid_sync_bench: CUDA launch failed with "
                           f"error {err}")


def app_info(app_id: int) -> Dict[str, int]:
    """The compiled table's constants (builds the library);
    ``ordered_var`` is the heap variable its maps' float adds go to
    through the ordered add, or -1."""
    out = (ctypes.c_int * 8)()
    if _load().trees_epoch_app_info(app_id, out) != 0:
        raise ValueError(f"epoch_megakernel: no device table {app_id}")
    keys = ("types", "arg_i", "arg_f", "value_width", "writes",
            "map_launches", "map_writes", "ordered_var")
    return dict(zip(keys, out))


def _check(name: str, t: torch.Tensor, dtype, shape, dev) -> None:
    if t.device != dev:
        raise ValueError(f"epoch_chunk: {name} is on {t.device}, not {dev}")
    if t.dtype != dtype:
        raise TypeError(f"epoch_chunk: {name} has dtype {t.dtype}, "
                        f"expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"epoch_chunk: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"epoch_chunk: {name} is not contiguous")


def launch(program, carry, limit, *, gather: bool,
           stats: Optional[torch.Tensor] = None):
    """One chunk of ``carry`` on the card: a memset of the cooperative
    scratch and one cooperative kernel launch.

    ``carry`` is a solo ``ResidentCarry`` on a CUDA device; ``limit`` an
    int or an ``i32`` tensor (the epoch bound, read on the device).
    ``stats``, if given, is an ``i64[5]`` on the carry's device to which
    the kernel adds the chunk's :data:`STATS`.  Updates the carry in place
    and returns it; raises if the program has no device table, the carry
    does not fit it, or the launch fails.
    """
    from ..core.engine import _map_width_ladder, _span_width_ladder

    table = device_table(program)
    if table is None:
        raise ValueError(
            f"epoch_chunk: program {program.name!r} has no device task table"
        )
    if carry.arena is not None or carry.sp.shape != (1,):
        raise ValueError("epoch_chunk: the kernel runs solo carries only")
    st = carry.state
    dev = st.task.device
    if dev.type != "cuda":
        raise ValueError(f"epoch_chunk: expects a CUDA carry, got {dev}")
    lib = _load()
    info = app_info(table.app_id)
    C = st.capacity
    A, Af, VW = program.n_arg_i, program.n_arg_f, program.value_width
    depth = carry.jstack.shape[1]
    i32, i64 = torch.int32, torch.int64
    for name, t, dtype, shape in (
        ("task", st.task, i32, (C + 1,)),
        ("argi", st.argi, i32, (C + 1, A)),
        ("argf", st.argf, torch.float32, (C + 1, Af)),
        ("epoch", st.epoch, i32, (C + 1,)),
        ("value", st.value, program.value_dtype, (C + 1, VW)),
        ("child_base", st.child_base, i32, (C + 1,)),
        ("child_count", st.child_count, i32, (C + 1,)),
        ("next_free", st.next_free, i32, ()),
        ("jstack", carry.jstack, i32, (1, depth)),
        ("rstack", carry.rstack, i32, (1, depth, 2)),
        ("sp", carry.sp, i32, (1,)),
        ("failed", carry.failed, torch.bool, (1,)),
        ("failed_stack", carry.failed_stack, torch.bool, (1,)),
        ("n_epochs", carry.n_epochs, i32, ()),
        ("job_epochs", carry.job_epochs, i32, (1,)),
        ("job_tasks", carry.job_tasks, i64, (1,)),
        ("job_forks", carry.job_forks, i64, (1,)),
        ("job_peak", carry.job_peak, i32, (1,)),
        ("map_launches", carry.map_launches, i32, ()),
        ("map_elements", carry.map_elements, i64, ()),
        ("map_lanes", carry.map_lanes, i64, ()),
        ("hole_lanes", carry.hole_lanes, i64, ()),
        ("fault", carry.fault, i32, ()),
    ):
        _check(name, t, dtype, shape, dev)
    heap = [carry.heap[hv.name] for hv in program.heap]
    for hv, t in zip(program.heap, heap):
        _check(f"heap[{hv.name}]", t, hv.dtype, (hv.shape[0] + 1,), dev)

    # scratch and the bound are freed on return while the kernel may still
    # run: the caching allocator hands their memory only to later work on
    # this stream, which runs after the kernel
    def empty(n, dtype=i32):
        return torch.empty((max(1, n),), dtype=dtype, device=dev)

    S = int(table.stage(program))
    scratch = dict(
        lane_cnt=empty(C), lane_excl=empty(C), lane_flags=empty(C),
        emit_stage=empty(C * VW),
        wr_idx=empty(info["writes"] * C), wr_val=empty(info["writes"] * C),
        wr_meta=empty(info["writes"] * C),
        map_argi=empty(info["map_launches"] * C * A),
        map_argf=empty(info["map_launches"] * C * Af, torch.float32),
        map_pre=empty(info["map_launches"] * C, i64),
        st_idx=empty(info["map_writes"] * S), st_val=empty(info["map_writes"] * S),
        st_meta=empty(info["map_writes"] * S),
    )
    # the ordered add's: counts, cursors and the long-run count (and its
    # copy) cleared here, the kernel clearing them after each use; offsets
    # and long cells per cell of the added variable; two position buffers
    # of the stage's size; one total per CTA
    N = 0
    if info["ordered_var"] >= 0:
        N = program.heap[info["ordered_var"]].shape[0]
        if S >= ORDERED_MAX_STAGE:
            raise ValueError(f"epoch_chunk: a stage of {S} elements "
                             f"(the ordered add takes < {ORDERED_MAX_STAGE})")
    scratch.update(
        oa_cnt=torch.zeros((2 * N + 2,), dtype=i32, device=dev),
        oa_off=empty(N), oa_long=empty(N), oa_run=empty(2 * S if N else 0),
        oa_tot=empty(MAX_GRID if N else 0),
    )
    G = grid(table.app_id, dev)
    coop_words = coop_scratch_words(G)
    scratch["coop"] = empty(coop_words, i64)
    if stats is not None:
        _check("stats", stats, i64, (len(STATS),), dev)
        scratch["stats"] = stats
    if isinstance(limit, torch.Tensor):
        lim = limit.to(device=dev, dtype=i32).reshape(1)
    else:
        lim = torch.full((1,), int(limit), dtype=i32, device=dev)
    tensors = dict(
        task=st.task, argi=st.argi, argf=st.argf, epoch=st.epoch,
        value=st.value, child_base=st.child_base,
        child_count=st.child_count, next_free=st.next_free,
        jstack=carry.jstack, rstack=carry.rstack, sp=carry.sp,
        failed=carry.failed, failed_stack=carry.failed_stack,
        n_epochs=carry.n_epochs, job_epochs=carry.job_epochs,
        job_tasks=carry.job_tasks, job_forks=carry.job_forks,
        job_peak=carry.job_peak, map_launches=carry.map_launches,
        map_elements=carry.map_elements, map_lanes=carry.map_lanes,
        hole_lanes=carry.hole_lanes, fault=carry.fault, limit=lim,
        **scratch,
    )
    for v, t in enumerate(heap):
        tensors[f"heap{v}"] = t
    ptrs = (ctypes.c_uint64 * len(_PTRS))(*[
        tensors[k].data_ptr() if k in tensors else 0 for k in _PTRS
    ])

    span = _span_width_ladder(C)
    if len(span) > MAX_SPAN or len(heap) > MAX_HEAP \
            or len(program.maps) > MAX_MAPS:
        raise ValueError("epoch_chunk: the carry exceeds the kernel's tables")
    ints = [C, depth, int(bool(gather)), len(span)]
    ints += list(span) + [0] * (MAX_SPAN - len(span))
    ints += [S, len(heap)]
    ints += [hv.shape[0] for hv in program.heap] + [0] * (MAX_HEAP - len(heap))
    ints += [_DTYPE_CODE[hv.dtype] for hv in program.heap]
    ints += [0] * (MAX_HEAP - len(heap))
    ints += [len(program.maps)]
    for m in range(MAX_MAPS):
        if m < len(program.maps):
            mt = program.maps[m]
            w = _map_width_ladder(mt.max_domain)
            if mt.max_domain <= 0 or len(w) > MAX_MAP_WIDTHS:
                raise ValueError(f"epoch_chunk: map {mt.name!r} needs "
                                 "0 < max_domain < 2^40")
            ints += [mt.max_domain, len(w)]
            ints += list(w) + [0] * (MAX_MAP_WIDTHS - len(w))
        else:
            ints += [0] * (2 + MAX_MAP_WIDTHS)
    consts = [int(c) for c in table.consts(program)]
    if len(consts) > MAX_CONSTS:
        raise ValueError("epoch_chunk: the table has too many constants")
    ints += [A, Af, VW, G, coop_words] + consts
    ints += [0] * (MAX_CONSTS - len(consts))
    assert len(ints) == _N_INTS
    ints_c = (ctypes.c_int64 * _N_INTS)(*ints)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.trees_epoch_chunk(
            table.app_id, ptrs, len(_PTRS), ints_c, _N_INTS,
            ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"epoch_chunk: the cooperative launch of {G} "
                           f"CTAs failed with CUDA error {err}")
    LAUNCHES["epoch_chunk"] += 1
    return carry


def epoch_chunk(cond_fn, body_fn, carry, limit, *, program, gather: bool):
    """Run one resident chunk: ``while cond_fn(carry, limit): body_fn``.

    A carry on the CPU runs the plain loop (``ref.epoch_chunk_ref``); a
    carry on the card runs :func:`launch` — one kernel launch, with
    ``cond_fn``/``body_fn`` compiled in as the kernel's own phases and
    ``program``'s device task table.
    """
    if carry.state.task.device.type == "cpu":
        return ref.epoch_chunk_ref(cond_fn, body_fn, carry, limit)
    return launch(program, carry, limit, gather=gather)
