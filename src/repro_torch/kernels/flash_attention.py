"""Hand-written CUDA kernel for blockwise (flash) grouped-query attention.

``flash_attention`` replaces the Pallas TPU kernel ``mha_flash`` of
``repro/kernels/flash_attention.py``; the CUDA C++ lives in
``csrc/flash_attention.cu`` (its header says what bounds it and how it is
laid out).  Three designs, by type and head dim: bfloat16 at D = 64 and 128
(the serving path's prefill) takes Hopper's ``wgmma`` fed by TMA in a
persistent kernel; bfloat16 at D = 16 and 32 takes ``mma.sync`` tiles fed
by a ``cp.async`` ring; float32 takes the CUDA-core kernel, which keeps
float32 products exact to 1e-5.  The plain versions are ``ref.mha_ref`` and
``ref.mha_blockwise``; ``kernels/ops.py`` sends CPU tensors there.

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

from . import counters, nvcc

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / \
    "flash_attention.cu"

# launches of the kernel since the last reset (one per wrapper call)
LAUNCHES: Dict[str, int] = counters.register({"flash_attention": 0})
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def reset_launches() -> None:
    LAUNCHES["flash_attention"] = 0


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
            lib.trees_flash_attention.argtypes = [
                i, p, p, p, p, i, i, i, i, i, i, p, ctypes.c_float, i, i, i,
                p]
            lib.trees_flash_attention.restype = i
            _lib = lib
        return _lib


def check_shape(Hq: int, Hkv: int, D: int) -> None:
    """Raise ``ValueError`` unless the kernel takes these heads and head
    dim: any GQA group (``Hq`` a multiple of ``Hkv``), D in
    :data:`HEAD_DIMS`.  Needs no card."""
    if Hkv <= 0 or Hq % Hkv:
        raise ValueError(f"flash_attention: {Hq} q heads over {Hkv} kv "
                         "heads (GQA needs Hq a multiple of Hkv)")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")


def check_strided(name: str, x: torch.Tensor) -> None:
    """The kernels read 16-byte vectors along D: D contiguous, every other
    stride a multiple of 8 elements, the data 16-byte aligned."""
    if x.stride(-1) != 1 or any(s % 8 for s in x.stride()[:-1]) \
            or x.data_ptr() % 16:
        raise ValueError(
            f"{name}: expects a view with D contiguous, other strides "
            f"multiples of 8 and 16-byte aligned data, got strides "
            f"{x.stride()}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None,
                    q_offset: int = 0, window: int = 0) -> torch.Tensor:
    """GQA attention (B, Hq, Sq, D) x (B, Hkv, Skv, D) -> (B, Hq, Sq, D).

    The same function as ``ref.mha_ref`` (masked scores take -1e30 rather
    than -inf, so a row with no visible key reads 0, not NaN), computed in
    float32 and returned in q's dtype (float32 or bfloat16).  ``q_offset``
    places query i at position ``q_offset + i`` for the causal mask;
    ``window > 0`` keeps keys with ``qpos - kpos < window``.

    Strided inputs: q, k and v may be any views whose D axis is contiguous
    (see :func:`check_strided`), such as the transposes of the attention
    block's projections; no copy is made.  The result is a (B, Hq, Sq, D)
    view of a contiguous (B, Sq, Hq, D) tensor, so transposing it back to
    the block's layout is free.
    """
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention: expects CUDA tensors")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must share a dtype in "
                        f"{tuple(DTYPES)}, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("flash_attention: expects q (B,Hq,Sq,D) and k, v "
                         "(B,Hkv,Skv,D)")
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)} and "
                         f"{tuple(k.shape)} do not match")
    check_shape(Hq, Hkv, D)
    if max(B, Hq) > 65535:
        raise ValueError("flash_attention: at most 65535 sequences and heads")
    for name, x in (("q", q), ("k", k), ("v", v)):
        check_strided(f"flash_attention {name}", x)
    scale = (D ** -0.5) if scale is None else scale
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    lib = _load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.trees_flash_attention(
            DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), B, Hq, Hkv, Sq, Skv, D, strides, float(scale),
            int(bool(causal)), int(q_offset), int(window),
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"flash_attention: CUDA launch failed with error {err}")
    LAUNCHES["flash_attention"] += 1
    return out
