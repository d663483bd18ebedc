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
which :func:`launch` allocates the ``oa_*`` scratch.

A fleet carry (the job service's ``DeviceMultiplexer``: a ``JobArena``
and one stack row per region) runs through the fleet kernel, instantiated
over the set of tables in :data:`FLEET_SETS` (those of the registry
fleets ``fib_fleet``, ``mixed3`` and ``mixed4``): :func:`fleet_plan` gives
each region its tenant's table, task offset, map launches, heap variables
and slot region, and a wave whose tables lie in no instantiated set
raises.

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
import functools
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
MAX_SPAN, MAX_MAPS, MAX_MAP_WIDTHS, MAX_HEAP, MAX_CONSTS = 8, 4, 40, 16, 4
_PTRS = (
    "task", "argi", "argf", "epoch", "value", "child_base", "child_count",
    "next_free", "jstack", "rstack", "sp", "failed", "failed_stack",
    "n_epochs", "job_epochs", "job_tasks", "job_forks", "job_peak",
    "map_launches", "map_elements", "map_lanes", "hole_lanes", "fault",
    "limit", "lane_cnt", "lane_excl", "lane_flags", "emit_stage", "wr_idx",
    "wr_val", "wr_meta", "map_argi", "map_argf", "map_pre", "st_idx",
    "st_val", "st_meta", "coop", "stats", "oa_cnt", "oa_off", "oa_long",
    "oa_run", "oa_tot", "arena_end", "arena_next",
) + tuple(f"heap{v}" for v in range(MAX_HEAP))
_N_INTS = (4 + MAX_SPAN + 2 + 2 * MAX_HEAP + 1
           + MAX_MAPS * (2 + MAX_MAP_WIDTHS) + 5 + MAX_CONSTS)
# trees_fleet_chunk's regions (enum FleetInt / RegionInt in SOURCE): the
# set, J and the map launches, then per region its table's place in the
# set, task offset, first map launch, first heap variable and count, first
# map and count, slot region [base, end) and constants; then each map
# launch's region
MAX_JOBS = 8
_R_INTS = 9 + MAX_CONSTS
_N_FLEET_INTS = 3 + MAX_JOBS * _R_INTS + MAX_MAPS
# the fleet kernel's instantiations, in the order of with_fleet in SOURCE:
# one, the device tables (app_id) of the registry fleets fib_fleet, mixed3
# and mixed4 (fib, treewalk post, bfs, mergesort); a wave's tables must
# lie in one of them
FLEET_SETS: Tuple[Tuple[int, ...], ...] = ((0, 3, 1, 2),)
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


@dataclasses.dataclass(frozen=True)
class FleetPlan:
    """How the fleet kernel runs a fused fleet: the instantiated set of
    tables (``FLEET_SETS[set_id]``), each region's table and its
    ``trees_fleet_chunk`` row (the table's place in the set, the tenant's
    task offset, first map launch, first heap variable and count, first
    map and count, slot region and constants), the region of each map
    launch, and the map stage the fleet needs."""

    set_id: int
    tables: Tuple[DeviceTable, ...]
    regions: Tuple[Tuple[int, ...], ...]
    map_owner: Tuple[int, ...]
    stage: int

    def ints(self) -> list:
        """The launch's ``fleet`` array (enum FleetInt in SOURCE)."""
        out = [self.set_id, len(self.regions), len(self.map_owner)]
        for r in range(MAX_JOBS):
            out += list(self.regions[r]) if r < len(self.regions) \
                else [0] * _R_INTS
        out += list(self.map_owner) + [0] * (MAX_MAPS - len(self.map_owner))
        assert len(out) == _N_FLEET_INTS
        return out


def fleet_plan(program, tenants) -> FleetPlan:
    """The fleet kernel's plan for the fused ``program`` of ``tenants``
    (the ``TenantSlot`` layout of ``service/multiplexer.py``): each
    tenant's device table, checked as :func:`device_table` checks a solo
    program, and the first instantiated set that holds them all.  Raises
    ``ValueError`` where a tenant has no table, the tables lie in no
    instantiated set (``FLEET_SETS``), or the fleet exceeds the kernel's
    limits (``MAX_JOBS`` regions, ``MAX_MAPS`` map launches, ``MAX_HEAP``
    heap variables, one-word values)."""
    if not 1 <= len(tenants) <= MAX_JOBS:
        raise ValueError(f"epoch_chunk: a fleet of {len(tenants)} regions "
                         f"(the kernel takes 1..{MAX_JOBS})")
    tables = []
    for slot in tenants:
        t = device_table(slot.program)
        if t is None:
            raise ValueError(
                f"epoch_chunk: fleet tenant {slot.program.name!r} (region "
                f"{slot.index}) has no device task table")
        tables.append(t)
    ids = {t.app_id for t in tables}
    set_id = next((k for k, st in enumerate(FLEET_SETS) if ids <= set(st)),
                  None)
    if set_id is None:
        raise ValueError(
            "epoch_chunk: no fleet kernel is instantiated for the tenant "
            f"tables {sorted(ids)} (instantiated sets: {FLEET_SETS}; "
            "ROADMAP lists the mixes still to instantiate)")
    if program.value_width != 1 or len(program.heap) > MAX_HEAP:
        raise ValueError("epoch_chunk: a fleet needs one-word values and at "
                         f"most {MAX_HEAP} heap variables")
    regions, owner = [], []
    heap_base = 0
    for j, (slot, t) in enumerate(zip(tenants, tables)):
        sub = slot.program
        names = [hv.name for hv in program.heap[heap_base:
                                                heap_base + len(sub.heap)]]
        if names != [slot.prefix + hv.name for hv in sub.heap] or \
                slot.index != j:
            raise ValueError("epoch_chunk: the fused program's layout does "
                             "not match its tenants")
        consts = [int(c) for c in t.consts(sub)]
        # every table's maps are launched from one site each
        regions.append((
            FLEET_SETS[set_id].index(t.app_id), slot.task_offset,
            len(owner), heap_base, len(sub.heap), slot.map_offset,
            len(sub.maps), slot.base, slot.end,
            *consts, *[0] * (MAX_CONSTS - len(consts)),
        ))
        owner += [j] * len(t.maps)
        heap_base += len(sub.heap)
    if len(owner) > MAX_MAPS:
        raise ValueError(f"epoch_chunk: a fleet of {len(owner)} map launches "
                         f"(the kernel takes {MAX_MAPS})")
    stage = max(int(t.stage(slot.program))
                for slot, t in zip(tenants, tables))
    return FleetPlan(set_id=set_id, tables=tuple(tables),
                     regions=tuple(regions), map_owner=tuple(owner),
                     stage=stage)


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
            lib.trees_fleet_chunk.argtypes = [i, p, i, p, i, p, i, p]
            lib.trees_fleet_chunk.restype = i
            lib.trees_fleet_grid.argtypes = [i]
            lib.trees_fleet_grid.restype = i
            lib.trees_fleet_coop_words.argtypes = [i]
            lib.trees_fleet_coop_words.restype = ctypes.c_longlong
            lib.trees_fleet_int_count.restype = i
            lib.trees_fleet_max_jobs.restype = i
            if (lib.trees_epoch_ptr_count() != len(_PTRS)
                    or lib.trees_epoch_int_count() != _N_INTS
                    or lib.trees_fleet_int_count() != _N_FLEET_INTS
                    or lib.trees_fleet_max_jobs() != MAX_JOBS):
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


def fleet_grid(set_id: int, device=None) -> int:
    """CTAs of the cooperative grid of the fleet kernel of
    ``FLEET_SETS[set_id]`` on ``device`` (builds the library)."""
    with torch.cuda.device(device):
        g = _load().trees_fleet_grid(set_id)
    if g < 1:
        raise RuntimeError(
            f"epoch_chunk: no cooperative fleet grid on this device "
            f"(error {-g})")
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


@functools.lru_cache(maxsize=None)
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
           stats: Optional[torch.Tensor] = None,
           plan: Optional[FleetPlan] = None):
    """One chunk of ``carry`` on the card: a memset of the cooperative
    scratch and one cooperative kernel launch.

    ``carry`` is a ``ResidentCarry`` on a CUDA device: solo, run through
    ``program``'s device table, or a fleet (a ``JobArena`` and one stack row
    per region), run through the fleet kernel of ``plan`` (the
    :func:`fleet_plan` of the fused ``program``'s tenants, which
    ``EpochLoop`` keeps).  ``limit`` is an int or an ``i32`` tensor (the
    epoch bound, read on the device).
    ``stats``, if given, is an ``i64[6]`` on the carry's device to which
    the kernel adds the chunk's :data:`STATS`.  Updates the carry in place
    and returns it; raises if a program has no device table, the carry
    does not fit it, or the launch fails.
    """
    from ..core.engine import _map_width_ladder, _span_width_ladder

    fleet = carry.arena is not None
    if fleet:
        if plan is None:
            raise ValueError("epoch_chunk: a fleet carry needs its plan "
                             "(fleet_plan)")
        J = len(plan.regions)
        tables = plan.tables
        S, consts = plan.stage, []
    else:
        table = device_table(program)
        if table is None:
            raise ValueError(f"epoch_chunk: program {program.name!r} has no "
                             "device task table")
        if carry.sp.shape != (1,):
            raise ValueError("epoch_chunk: a carry without an arena has one "
                             "region")
        J = 1
        tables = (table,)
        S = int(table.stage(program))
        consts = [int(c) for c in table.consts(program)]
    st = carry.state
    dev = st.task.device
    if dev.type != "cuda":
        raise ValueError(f"epoch_chunk: expects a CUDA carry, got {dev}")
    lib = _load()
    infos = [app_info(t.app_id) for t in tables]
    C = st.capacity
    A, Af, VW = program.n_arg_i, program.n_arg_f, program.value_width
    depth = carry.jstack.shape[1]
    i32, i64 = torch.int32, torch.int64
    checks = [
        ("task", st.task, i32, (C + 1,)),
        ("argi", st.argi, i32, (C + 1, A)),
        ("argf", st.argf, torch.float32, (C + 1, Af)),
        ("epoch", st.epoch, i32, (C + 1,)),
        ("value", st.value, program.value_dtype, (C + 1, VW)),
        ("child_base", st.child_base, i32, (C + 1,)),
        ("child_count", st.child_count, i32, (C + 1,)),
        ("next_free", st.next_free, i32, ()),
        ("jstack", carry.jstack, i32, (J, depth)),
        ("rstack", carry.rstack, i32, (J, depth, 2)),
        ("sp", carry.sp, i32, (J,)),
        ("failed", carry.failed, torch.bool, (J,)),
        ("failed_stack", carry.failed_stack, torch.bool, (J,)),
        ("n_epochs", carry.n_epochs, i32, ()),
        ("job_epochs", carry.job_epochs, i32, (J,)),
        ("job_tasks", carry.job_tasks, i64, (J,)),
        ("job_forks", carry.job_forks, i64, (J,)),
        ("job_peak", carry.job_peak, i32, (J,)),
        ("map_launches", carry.map_launches, i32, ()),
        ("map_elements", carry.map_elements, i64, ()),
        ("map_lanes", carry.map_lanes, i64, ()),
        ("hole_lanes", carry.hole_lanes, i64, ()),
        ("fault", carry.fault, i32, ()),
    ]
    if fleet:
        checks += [("arena.end", carry.arena.end, i32, (J,)),
                   ("arena.next", carry.arena.next, i32, (J,))]
    for name, t, dtype, shape in checks:
        _check(name, t, dtype, shape, dev)
    heap = [carry.heap[hv.name] for hv in program.heap]
    for hv, t in zip(program.heap, heap):
        _check(f"heap[{hv.name}]", t, hv.dtype, (hv.shape[0] + 1,), dev)

    # scratch and the bound are freed on return while the kernel may still
    # run: the caching allocator hands their memory only to later work on
    # this stream, which runs after the kernel
    def empty(n, dtype=i32):
        return torch.empty((max(1, n),), dtype=dtype, device=dev)

    writes = max(i["writes"] for i in infos)
    n_launch = sum(i["map_launches"] for i in infos)
    map_writes = max(i["map_writes"] for i in infos)
    scratch = dict(
        lane_cnt=empty(C), lane_excl=empty(C), lane_flags=empty(C),
        emit_stage=empty(C * VW),
        wr_idx=empty(writes * C), wr_val=empty(writes * C),
        wr_meta=empty(writes * C),
        map_argi=empty(n_launch * C * A),
        map_argf=empty(n_launch * C * Af, torch.float32),
        map_pre=empty(n_launch * C, i64),
        st_idx=empty(map_writes * S), st_val=empty(map_writes * S),
        st_meta=empty(map_writes * S),
    )
    # the ordered add's (solo tables with kOrderedMapAdd; no fleet set has
    # one): counts, cursors and the long-run count (and its copy) cleared
    # here, the kernel clearing them after each use; offsets and long cells
    # per cell of the added variable; two position buffers of the stage's
    # size; one total per CTA
    N = 0
    if not fleet and infos[0]["ordered_var"] >= 0:
        N = program.heap[infos[0]["ordered_var"]].shape[0]
        if S >= ORDERED_MAX_STAGE:
            raise ValueError(f"epoch_chunk: a stage of {S} elements "
                             f"(the ordered add takes < {ORDERED_MAX_STAGE})")
    scratch.update(
        oa_cnt=torch.zeros((2 * N + 2,), dtype=i32, device=dev),
        oa_off=empty(N), oa_long=empty(N), oa_run=empty(2 * S if N else 0),
        oa_tot=empty(MAX_GRID if N else 0),
    )
    if fleet:
        G = fleet_grid(plan.set_id, dev)
        coop_words = int(lib.trees_fleet_coop_words(G))
        scratch.update(arena_end=carry.arena.end,
                       arena_next=carry.arena.next)
    else:
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
    if len(consts) > MAX_CONSTS:
        raise ValueError("epoch_chunk: the table has too many constants")
    ints += [A, Af, VW, G, coop_words] + consts
    ints += [0] * (MAX_CONSTS - len(consts))
    assert len(ints) == _N_INTS
    ints_c = (ctypes.c_int64 * _N_INTS)(*ints)
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        if fleet:
            fleet_c = (ctypes.c_int64 * _N_FLEET_INTS)(*plan.ints())
            err = lib.trees_fleet_chunk(
                plan.set_id, ptrs, len(_PTRS), ints_c, _N_INTS, fleet_c,
                _N_FLEET_INTS, stream)
        else:
            err = lib.trees_epoch_chunk(
                table.app_id, ptrs, len(_PTRS), ints_c, _N_INTS, stream)
    if err != 0:
        raise RuntimeError(f"epoch_chunk: the cooperative launch of {G} "
                           f"CTAs failed with CUDA error {err}")
    LAUNCHES["epoch_chunk"] += 1
    return carry


def epoch_chunk(cond_fn, body_fn, carry, limit, *, program, gather: bool,
                plan: Optional[FleetPlan] = None):
    """Run one resident chunk: ``while cond_fn(carry, limit): body_fn``.

    A carry on the CPU runs the plain loop (``ref.epoch_chunk_ref``); a
    carry on the card runs :func:`launch` — one kernel launch, with
    ``cond_fn``/``body_fn`` compiled in as the kernel's own phases and
    ``program``'s device task table (a fleet carry: its tenants' tables,
    ``plan``).
    """
    if carry.state.task.device.type == "cpu":
        return ref.epoch_chunk_ref(cond_fn, body_fn, carry, limit)
    return launch(program, carry, limit, gather=gather, plan=plan)
