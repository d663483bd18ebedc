"""Hand-written CUDA kernel for the Mamba-2 chunked SSD scan.

``ssd_scan`` replaces the Pallas TPU kernel of the same name in
``repro/kernels/ssd_scan.py``; the CUDA C++ lives in ``csrc/ssd_scan.cu``
(its header says what bounds it and how it is laid out).  Two designs,
chosen by :func:`pick_design` from dtype and shape alone: bfloat16 with P
and N multiples of 16 (mamba2, hymba) takes the tensor-core design (a
launch for G = C B^T per sequence and chunk, then the scan's products on
the tensor cores over a cp.async ring: wgmma at P = 64 with N a multiple
of 64, mma.sync otherwise); float32, and bfloat16 at P or N = 8, the
CUDA-core design.  The plain versions are ``ref.ssd_chunked`` and
``ref.ssd_scan_ref`` (``ref.ssd_chunked_tc`` repeats the tensor-core
design's rounding); ``kernels/ops.py`` sends CPU tensors there.

The source is compiled with ``nvcc`` for ``sm_90a`` at first use
(``kernels/nvcc.py``) and loaded with ``ctypes``.  Nothing here compiles or
loads at import time.
"""
from __future__ import annotations

import ctypes
import pathlib
import threading
from typing import Dict, Optional, Tuple

import torch

from . import nvcc
from .flash_attention import DTYPES

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"
HEAD_DIMS = (8, 16, 32, 64)           # P
STATE_DIMS = (8, 16, 32, 64, 128)     # N
DESIGNS = {"cuda_core": 0, "tensor_core": 1}

# launches of the kernel since the last reset (one per wrapper call)
LAUNCHES: Dict[str, int] = {"ssd_scan": 0}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def reset_launches() -> None:
    LAUNCHES["ssd_scan"] = 0


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
            lib.trees_ssd_scan.argtypes = [
                i, i, p, p, p, p, p, p, p, p, p, i, i, i, i, i, p, p]
            lib.trees_ssd_scan.restype = i
            lib.trees_ssd_chunk.argtypes = []
            lib.trees_ssd_chunk.restype = i
            _lib = lib
        return _lib


def pick_design(dtype: torch.dtype, P: int, N: int) -> str:
    """The kernel's design for these inputs, a pure function of dtype and
    shape (needs no card): ``"tensor_core"`` for bfloat16 with P and N
    multiples of 16, else ``"cuda_core"`` (float32 stays exact to 1e-4,
    which TF32 would not)."""
    if dtype == torch.bfloat16 and P % 16 == 0 and N % 16 == 0:
        return "tensor_core"
    return "cuda_core"


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor,
             h0: Optional[torch.Tensor] = None,
             design: Optional[str] = None):
    """Mamba-2 SSD scan over a batch of sequences: x (Bt, S, H, P), dt
    (Bt, S, H), A f32[H], B and C (Bt, S, N), h0 f32 (Bt, H, P, N) or None
    -> (y (Bt, S, H, P) in x's dtype, h (Bt, H, P, N) float32).

    The same function as ``ref.ssd_chunked`` (sums in another order, in
    chunks of 64 steps where the plain version takes 128, and in the
    tensor-core design with the bf16 operands of ``ref.ssd_chunked_tc``).
    x, dt, B and C share one dtype, float32 or bfloat16, and may be strided
    views whose last axis is contiguous (x, B and C as slices of the SSM
    block's conv output are read in place); A and h0 must be contiguous.
    ``design`` (default :func:`pick_design`) may name ``"cuda_core"`` for
    any input, to time that design beside the other.
    """
    ins = (x, dt, A, B, C) + (() if h0 is None else (h0,))
    if not all(t.is_cuda and t.device == x.device for t in ins):
        raise ValueError("ssd_scan: expects CUDA tensors on one device")
    if x.dtype not in DTYPES or any(t.dtype != x.dtype for t in (dt, B, C)):
        raise TypeError(f"ssd_scan: x, dt, B and C must share a dtype in "
                        f"{tuple(DTYPES)}, got {x.dtype}/{dt.dtype}/"
                        f"{B.dtype}/{C.dtype}")
    if A.dtype != torch.float32 or (h0 is not None
                                    and h0.dtype != torch.float32):
        raise TypeError("ssd_scan: A and h0 must be float32")
    if x.dim() != 4:
        raise ValueError("ssd_scan: expects x (Bt, S, H, P)")
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    if dt.shape != (Bt, S, H) or A.shape != (H,) or B.dim() != 3 \
            or B.shape != (Bt, S, N) or C.shape != B.shape \
            or (h0 is not None and h0.shape != (Bt, H, P, N)):
        raise ValueError(
            f"ssd_scan: shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, A "
            f"{tuple(A.shape)}, B {tuple(B.shape)}, C {tuple(C.shape)}"
            f"{'' if h0 is None else f', h0 {tuple(h0.shape)}'} do not match")
    if P not in HEAD_DIMS or N not in STATE_DIMS:
        raise ValueError(f"ssd_scan: head dim {P} not in {HEAD_DIMS} or "
                         f"state dim {N} not in {STATE_DIMS}")
    if Bt > 65535:
        raise ValueError("ssd_scan: at most 65535 sequences")
    if x.stride(-1) != 1 or B.stride(-1) != 1 or C.stride(-1) != 1:
        raise ValueError("ssd_scan: the last axes of x, B and C must be "
                         "contiguous")
    if not A.is_contiguous() or (h0 is not None and not h0.is_contiguous()):
        raise ValueError("ssd_scan: A and h0 must be contiguous")
    if design is None:
        design = pick_design(x.dtype, P, N)
    elif design not in DESIGNS or (design == "tensor_core" and
                                   pick_design(x.dtype, P, N) != design):
        raise ValueError(f"ssd_scan: design {design!r} does not take "
                         f"{x.dtype} at P={P}, N={N}")
    y = torch.empty((Bt, S, H, P), dtype=x.dtype, device=x.device)
    h = torch.empty((Bt, H, P, N), dtype=torch.float32, device=x.device)
    if Bt == 0 or H == 0:
        return y, h
    strides = (ctypes.c_longlong * 10)(*x.stride()[:3], *dt.stride(),
                                       *B.stride()[:2], *C.stride()[:2])
    lib = _load()
    gram = None
    if design == "tensor_core":  # G = C B^T per sequence and chunk, float32
        T = lib.trees_ssd_chunk()
        gram = torch.empty((max(1, Bt * -(-S // T) * T * T),),
                           dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.trees_ssd_scan(
            DTYPES[x.dtype], DESIGNS[design], x.data_ptr(), dt.data_ptr(),
            A.data_ptr(), B.data_ptr(), C.data_ptr(),
            None if h0 is None else h0.data_ptr(), y.data_ptr(),
            h.data_ptr(), None if gram is None else gram.data_ptr(), Bt, S,
            H, P, N, strides, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"ssd_scan: CUDA launch failed with error {err}")
    LAUNCHES["ssd_scan"] += 1
    return y, h
