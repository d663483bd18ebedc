"""Hand-written CUDA kernel for the ordered float scatter-add.

``ordered_add_(arr, idx, val)`` is ``arr[idx] += val`` with each cell's
terms added one at a time in source order from its old value: the bits of
the CPU's ``index_add_`` (a serial loop), which CUDA's atomic
``index_add_`` does not keep.  ``core/tvm.py::_scatter_heap`` calls it for
a float ``add`` on the card (through ``kernels/ops.py``).  It replaces no
TPU kernel; the CUDA C++ lives in ``csrc/ordered_add.cu`` over the device
routines of ``csrc/ordered_add.cuh``, which the ``epoch_chunk`` kernel
runs inside its chunk for matmul's map payload.  The plain version is
``ref.ordered_add_ref``.

A call is two memsets and five launches on the current stream: count
(after clearing its counters), the counts' exclusive scan
(``fork_compact.fork_scan``, a memset and a launch), place, and the sums
of the short and the long runs.  Scratch comes from ``torch.empty``, every
size from the tensors' shapes, so the call reads nothing back and a CUDA
graph may replay it.  Each call that launches adds one to
``LAUNCHES["ordered_add"]`` (and one to ``fork_compact``'s ``fork_scan``).

The source is compiled with ``nvcc`` for ``sm_90a`` at first use
(``kernels/nvcc.py``) and loaded with ``ctypes``.  Nothing here compiles or
loads at import time.
"""
from __future__ import annotations

import ctypes
import math
import pathlib
import threading
from typing import Dict, Optional, Tuple

import torch

from . import counters, fork_compact, nvcc

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "ordered_add.cu"
# positions are int32 in the kernel, and its merge passes add two of them
MAX_TERMS = 2**30

LAUNCHES: Dict[str, int] = counters.register({"ordered_add": 0})

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def reset_launches() -> None:
    LAUNCHES["ordered_add"] = 0


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
            lib.trees_ordered_add_scratch_words.argtypes = [i, i]
            lib.trees_ordered_add_scratch_words.restype = ctypes.c_longlong
            lib.trees_ordered_add_count.argtypes = [p, i, i, i, p, p]
            lib.trees_ordered_add_count.restype = i
            lib.trees_ordered_add_apply.argtypes = [p, p, i, p, i, i, i, p,
                                                    p, p]
            lib.trees_ordered_add_apply.restype = i
            _lib = lib
        return _lib


def _ptr(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())


def check(arr: torch.Tensor, idx: torch.Tensor, val: torch.Tensor) -> None:
    """Raise unless the kernel takes these tensors: ``arr`` float32, rows
    of any trailing shape, the last row the sink; ``idx`` int32 or int64,
    one index a term; ``val`` float32, one ``arr`` row a term; all on one
    CUDA device, ``arr`` contiguous."""
    if arr.dtype != torch.float32 or val.dtype != torch.float32:
        raise TypeError(f"ordered_add: expects float32 arr and val, got "
                        f"{arr.dtype} and {val.dtype}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"ordered_add: expects int32 or int64 idx, got "
                        f"{idx.dtype}")
    if not (arr.is_cuda and idx.device == arr.device
            and val.device == arr.device):
        raise ValueError(f"ordered_add: expects tensors on one CUDA device, "
                         f"got {arr.device}, {idx.device}, {val.device}")
    if arr.dim() < 1 or not 1 <= arr.shape[0] < 2**31:
        raise ValueError(f"ordered_add: arr of shape {tuple(arr.shape)}")
    if not arr.is_contiguous():
        raise ValueError("ordered_add: arr is not contiguous")
    if idx.dim() != 1 or tuple(val.shape) != (idx.shape[0],) + tuple(
            arr.shape[1:]):
        raise ValueError(f"ordered_add: idx {tuple(idx.shape)} and val "
                         f"{tuple(val.shape)} do not fit arr "
                         f"{tuple(arr.shape)}")
    if idx.shape[0] >= MAX_TERMS:
        raise ValueError(f"ordered_add: at most {MAX_TERMS - 1} terms")


def ordered_add_(arr: torch.Tensor, idx: torch.Tensor,
                 val: torch.Tensor) -> torch.Tensor:
    """``arr[idx] += val`` in place on the card, each cell's terms added
    in source order from its old value; terms aimed at the sink row (the
    last) or outside the rows before it add nothing.  Returns ``arr``."""
    check(arr, idx, val)
    rows, terms = arr.shape[0], idx.shape[0]
    width = math.prod(arr.shape[1:])
    if terms == 0 or rows == 1 or width == 0:
        return arr
    lib = _load()
    idx = idx.contiguous()
    val = val.contiguous()
    idx64 = int(idx.dtype == torch.int64)
    scratch = torch.empty(
        (lib.trees_ordered_add_scratch_words(rows, terms),),
        dtype=torch.int32, device=arr.device)
    with torch.cuda.device(arr.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        err = lib.trees_ordered_add_count(_ptr(idx), idx64, terms, rows,
                                          _ptr(scratch), stream)
        if err != 0:
            raise RuntimeError(f"ordered_add: CUDA launch failed with "
                               f"error {err}")
        off, _ = fork_compact.fork_scan(scratch[:rows])
        err = lib.trees_ordered_add_apply(
            _ptr(arr), _ptr(val), width, _ptr(idx), idx64, terms, rows,
            _ptr(scratch), _ptr(off), stream)
    if err != 0:
        raise RuntimeError(f"ordered_add: CUDA launch failed with error "
                           f"{err}")
    LAUNCHES["ordered_add"] += 1
    return arr
