"""Hand-written CUDA kernels for fork-slot allocation and type compaction.

``fork_scan``, ``segmented_fork_scan`` and ``type_rank`` replace the Pallas
TPU kernels of the same names in ``repro/kernels/fork_compact.py``; the
CUDA C++ lives in ``csrc/fork_compact.cu`` (its header says what bounds
them and what the TPU's sequential-grid carry became on the card).
``lane_pack`` and ``type_pack`` are ``type_rank`` writing the packs its
callers build from the rank (the gather dispatch's frontier, the compacted
dispatch's permutation), so they count as its launches.

All three scans are one pass with a decoupled look-back: a memset of their
scratch and one launch (``type_pack`` adds a second, scattering launch).

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface at first use (``kernels/nvcc.py``) and loaded with
``ctypes``.  Nothing here compiles or loads at import time.

Each wrapper checks device, dtype, contiguity and length, allocates the
outputs and scratch with ``torch.empty``, launches on the current stream,
raises if the launch reported an error, and adds one to its entry of
:data:`LAUNCHES`.  The wrappers take CUDA tensors only: the CPU path of
the port is ``kernels/ops.py``, which sends CPU tensors to ``ref.py``.
"""
from __future__ import annotations

import ctypes
import pathlib
import threading
from typing import Dict, Optional, Tuple

import torch

from . import nvcc

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "fork_compact.cu"
BUILD_DIR = nvcc.BUILD_DIR

# launches of each kernel since the last reset (one per wrapper call)
LAUNCHES: Dict[str, int] = {
    "fork_scan": 0, "segmented_fork_scan": 0, "type_rank": 0,
}

# segmented_fork_scan's tiles and segment groups (kSegTile, kSegGroup in
# SOURCE); type_rank's tiles (kRankTile; its groups are SEG_GROUP types)
SEG_TILE = 2048
SEG_GROUP = 32
TYPE_TILE = 2048

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _lookback_words(n: int, k: int, tile: int) -> int:
    """uint64 words of look-back scratch for ``n`` lanes in tiles of
    ``tile`` and ``k`` segments or types: a tile counter per group of
    ``SEG_GROUP`` and one status word per (group, tile, member of the
    group's width, ``min(k, SEG_GROUP)`` rounded up to a power of two)."""
    groups = -(-k // SEG_GROUP)
    tiles = max(1, -(-n // tile))
    width = 1
    while width < min(k, SEG_GROUP):
        width *= 2
    return groups + groups * tiles * width


def seg_scan_scratch_words(n: int, n_segs: int) -> int:
    """uint64 words of scratch ``segmented_fork_scan`` takes for ``n`` lanes
    and ``n_segs`` segments (tiles of ``SEG_TILE``)."""
    if n_segs < 1:
        raise ValueError(f"segmented_fork_scan: n_segs={n_segs} < 1")
    return _lookback_words(n, n_segs, SEG_TILE)


def type_rank_scratch_words(n: int, n_types: int) -> int:
    """uint64 words of scratch ``type_rank``, ``lane_pack`` and
    ``type_pack`` take for ``n`` lanes and ``n_types`` types (tiles of
    ``TYPE_TILE``)."""
    if n_types < 1:
        raise ValueError(f"type_rank: n_types={n_types} < 1")
    return _lookback_words(n, n_types, TYPE_TILE)


def _type_work(n: int, n_types: int, device, with_perm: bool):
    """The one buffer of a type entry: the scratch, the counts
    (``n_types`` int32, whole words) and, for a pack, the permutation
    (``n`` int32), laid out as ``trees_type_rank_work_words`` in SOURCE
    says.  One memset on the card clears what the kernel does not write.
    Returns ``(work, counts, perm)``, the last two int32 views into
    ``work`` (``perm`` None without one)."""
    words = type_rank_scratch_words(n, n_types)
    cwords = (n_types + 1) // 2
    pwords = (n + 1) // 2 if with_perm else 0
    work = torch.empty((words + cwords + pwords,), dtype=torch.int64,
                       device=device)
    flat = work.view(torch.int32)
    counts = flat[2 * words:2 * words + n_types]
    perm = None
    if with_perm:
        start = 2 * (words + cwords)
        perm = flat[start:start + n]
    return work, counts, perm


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def library_path() -> pathlib.Path:
    """Where the built library for the current source and flags lives."""
    return nvcc.library_path(SOURCE)


def build(ptxas_info: bool = False) -> Tuple[pathlib.Path, str]:
    """Compile the source unless its library exists (``nvcc.build``)."""
    return nvcc.build(SOURCE, ptxas_info)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.trees_fork_scan.argtypes = [p, p, p, p, i, p]
            lib.trees_fork_scan.restype = i
            lib.trees_segmented_fork_scan.argtypes = [
                p, p, p, p, p, ctypes.c_longlong, i, i, p]
            lib.trees_segmented_fork_scan.restype = i
            lib.trees_segmented_fork_scan_scratch_words.argtypes = [i, i]
            lib.trees_segmented_fork_scan_scratch_words.restype = (
                ctypes.c_longlong)
            ll = ctypes.c_longlong
            lib.trees_type_rank.argtypes = [p, p, p, p, ll, i, i, p]
            lib.trees_type_rank.restype = i
            lib.trees_lane_pack.argtypes = [p, p, ll, i, p]
            lib.trees_lane_pack.restype = i
            lib.trees_type_pack.argtypes = [p, p, p, ll, i, i, p]
            lib.trees_type_pack.restype = i
            lib.trees_type_rank_scratch_words.argtypes = [i, i]
            lib.trees_type_rank_scratch_words.restype = ll
            lib.trees_fork_scan_scratch_words.argtypes = [i]
            lib.trees_fork_scan_scratch_words.restype = i
            _lib = lib
        return _lib


def _check_lanes(name: str, x: torch.Tensor, dtypes) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name}: expects a CUDA tensor, got {x.device}")
    if x.dtype not in dtypes:
        raise TypeError(f"{name}: expects dtype in {dtypes}, got {x.dtype}")
    if x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"{name}: expects a contiguous 1-D tensor")
    if x.shape[0] >= 2**31:
        raise ValueError(f"{name}: at most 2^31 - 1 lanes")


def _ptr(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def fork_scan(counts: torch.Tensor):
    """Exclusive prefix sum + total of an ``i32[C]`` CUDA tensor.

    Returns ``(offsets i32[C], total i32[])``, both on the card.  The
    scratch (the look-back's tile counter and status words) comes from
    ``torch.empty``; the launch sequence clears it on the stream, so the
    call may be captured in a CUDA graph and replayed.
    """
    _check_lanes("fork_scan", counts, (torch.int32,))
    lib = _load()
    n = counts.shape[0]
    offs = torch.empty_like(counts)
    total = torch.empty((1,), dtype=torch.int32, device=counts.device)
    scratch = torch.empty((lib.trees_fork_scan_scratch_words(n),),
                          dtype=torch.int64, device=counts.device)
    with torch.cuda.device(counts.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.trees_fork_scan(
            _ptr(counts), _ptr(offs), _ptr(total), _ptr(scratch), n,
            ctypes.c_void_p(stream),
        )
    _raise_on(err, "fork_scan")
    LAUNCHES["fork_scan"] += 1
    return offs, total[0]


def segmented_fork_scan(counts: torch.Tensor, seg: torch.Tensor,
                        n_segs: int):
    """Per-segment exclusive prefix sum + per-segment totals.

    ``counts`` and ``seg`` are ``i32[C]`` on the card, ``n_segs >= 1``.
    Lane ``i``'s offset is the sum of ``counts[k]`` over ``k < i`` with
    ``seg[k] == seg[i]``; lanes of a segment need not be contiguous, and
    ids outside ``[0, n_segs)`` add nothing and read 0.  Returns
    ``(offsets i32[C], totals i32[n_segs])``, sums wrapping like int32.
    The scratch (tile counters and status words, sized by
    :func:`seg_scan_scratch_words`) comes from ``torch.empty``; the launch
    sequence clears it on the stream, so the call may be captured in a
    CUDA graph and replayed.
    """
    _check_lanes("segmented_fork_scan", counts, (torch.int32,))
    _check_lanes("segmented_fork_scan", seg, (torch.int32,))
    if seg.shape[0] != counts.shape[0]:
        raise ValueError(
            "segmented_fork_scan: counts and seg differ in length")
    if n_segs < 1:
        raise ValueError(f"segmented_fork_scan: n_segs={n_segs} < 1")
    lib = _load()
    n = counts.shape[0]
    offs = torch.empty_like(counts)
    totals = torch.empty((n_segs,), dtype=torch.int32, device=counts.device)
    words = seg_scan_scratch_words(n, n_segs)
    scratch = torch.empty((words,), dtype=torch.int64, device=counts.device)
    with torch.cuda.device(counts.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.trees_segmented_fork_scan(
            _ptr(counts), _ptr(seg), _ptr(offs), _ptr(totals), _ptr(scratch),
            words, n, n_segs, ctypes.c_void_p(stream),
        )
    _raise_on(err, "segmented_fork_scan")
    LAUNCHES["segmented_fork_scan"] += 1
    return offs, totals


def _check_types(name: str, types: torch.Tensor, active: torch.Tensor,
                 n_types: int) -> None:
    _check_lanes(name, types, (torch.int32,))
    _check_lanes(name, active, (torch.bool, torch.uint8))
    if active.shape[0] != types.shape[0]:
        raise ValueError(f"{name}: types and active differ in length")
    if n_types < 1:
        raise ValueError(f"{name}: n_types={n_types} < 1")


def type_rank(types: torch.Tensor, active: torch.Tensor, n_types: int):
    """Stable within-type rank of each active lane + per-type counts.

    ``types`` is ``i32[C]``, ``active`` ``bool[C]`` (or ``u8[C]``, nonzero
    is active), both on the card; ``n_types >= 1``.  Returns ``(rank
    i32[C], counts i32[n_types])``: rank -1 for an inactive lane, 0 for an
    active lane whose type lies outside ``[0, n_types)``, sums wrapping
    like int32.  One memset of the scratch (``counts`` shares it) and one
    launch, so the call may be captured in a CUDA graph and replayed.
    """
    _check_types("type_rank", types, active, n_types)
    lib = _load()
    n = types.shape[0]
    rank = torch.empty_like(types)
    work, counts, _ = _type_work(n, n_types, types.device, False)
    with torch.cuda.device(types.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.trees_type_rank(
            _ptr(types), _ptr(active), _ptr(rank), _ptr(work),
            work.shape[0], n, n_types, ctypes.c_void_p(stream),
        )
    _raise_on(err, "type_rank")
    LAUNCHES["type_rank"] += 1
    return rank, counts


def lane_pack(active: torch.Tensor):
    """Stable frontier pack of the active lanes: ``type_rank`` with one
    type, reading ``active`` alone.

    ``active`` is ``bool[P]`` (or ``u8[P]``) on the card.  Returns ``(perm
    i32[P], count i32[])``: ``perm[d]`` is the d-th active lane, -1 for
    ``d >= count``.  One memset (of the scratch and the count) and one
    launch, which writes all of ``perm``, its -1 tail too.
    """
    _check_lanes("lane_pack", active, (torch.bool, torch.uint8))
    lib = _load()
    n = active.shape[0]
    work, counts, perm = _type_work(n, 1, active.device, True)
    with torch.cuda.device(active.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.trees_lane_pack(_ptr(active), _ptr(work), work.shape[0], n,
                                  ctypes.c_void_p(stream))
    _raise_on(err, "lane_pack")
    LAUNCHES["type_rank"] += 1
    return perm, counts[0]


def type_pack(types: torch.Tensor, active: torch.Tensor, n_types: int):
    """The compaction's permutation: active lanes grouped by type, stable.

    Each active lane of type ``t`` goes to ``type_start[t] + rank``, with
    ``rank`` its ``type_rank`` and ``type_start`` the exclusive scan of
    the counts.  ``types`` ``i32[C]`` and ``active`` ``bool[C]`` (or
    ``u8[C]``) on the card; active lanes must carry a type in ``[0,
    n_types)`` (one outside is left out of ``perm``).  Returns ``(perm
    i32[C], counts i32[n_types])``, ``perm`` -1 past the active lanes.
    One memset and two launches (the pass, then the scatter that needs
    every tile's counts; up to 32 types it writes all of ``perm``).
    """
    _check_types("type_pack", types, active, n_types)
    lib = _load()
    n = types.shape[0]
    work, counts, perm = _type_work(n, n_types, types.device, True)
    with torch.cuda.device(types.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.trees_type_pack(
            _ptr(types), _ptr(active), _ptr(work), work.shape[0], n,
            n_types, ctypes.c_void_p(stream),
        )
    _raise_on(err, "type_pack")
    LAUNCHES["type_rank"] += 1
    return perm, counts
