"""Hand-written CUDA kernel for one-token GQA decode over a ragged cache.

``decode_attention`` replaces the Pallas TPU kernel of the same name in
``repro/kernels/decode_attention.py``; the CUDA C++ lives in
``csrc/decode_attention.cu`` (its header says what bounds it and how it is
laid out): split-K over the cache rows, each split's rows streamed through
a ``cp.async`` ring, then a second launch that merges the splits.  The
plain version is ``ref.decode_attention_ref``, and
``ref.decode_attention_split_ref`` computes the same split partials and
merge; ``kernels/ops.py`` sends CPU tensors to the first.

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
from .flash_attention import DTYPES, HEAD_DIMS, check_strided

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / \
    "decode_attention.cu"
MAX_GROUP = 8  # q heads per kv head the kernel is built for: 1..8
SPLIT_ROWS = 256  # cache rows per split, up to MAX_SPLITS splits
MAX_SPLITS = 64

# launches of the kernel since the last reset (one per wrapper call)
LAUNCHES: Dict[str, int] = {"decode_attention": 0}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def reset_launches() -> None:
    LAUNCHES["decode_attention"] = 0


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
            lib.trees_decode_attention.argtypes = [
                i, p, p, p, p, p, p, i, i, i, i, i, i, i, p, ctypes.c_float,
                i, p]
            lib.trees_decode_attention.restype = i
            _lib = lib
        return _lib


def check_shape(Hq: int, Hkv: int, D: int) -> None:
    """Raise ``ValueError`` unless the kernel takes these heads and head
    dim: a group ``Hq / Hkv`` of 1 to :data:`MAX_GROUP`, D in
    :data:`HEAD_DIMS`.  Needs no card."""
    if Hkv <= 0 or Hq % Hkv or not 1 <= Hq // Hkv <= MAX_GROUP:
        raise ValueError(f"decode_attention: {Hq} q heads over {Hkv} kv "
                         f"heads is not a group of 1 to {MAX_GROUP}")
    if D not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {D} not in {HEAD_DIMS}")


def split_rows(S: int) -> int:
    """Cache rows per split, from the cache's row count alone (the lengths
    stay on the card): :data:`SPLIT_ROWS`, or a multiple of it that keeps
    the splits at most :data:`MAX_SPLITS`."""
    return SPLIT_ROWS * max(1, -(-S // (SPLIT_ROWS * MAX_SPLITS)))


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor,
                     scale: Optional[float] = None,
                     window: int = 0) -> torch.Tensor:
    """One-token GQA decode: q (B, Hq, D), caches (B, Hkv, S, D), lengths
    i32[B] -> (B, Hq, D) in q's dtype.

    The same function as ``ref.decode_attention_ref``: row j of sequence b
    is read when ``j < lengths[b]`` (a length above S reads all S rows) and,
    with a window, when ``j >= lengths[b] - window``; a sequence with no
    visible row reads 0 (the plain version gives NaN).  q must be
    contiguous; the caches may be any views whose D axis is contiguous
    (``flash_attention.check_strided``), such as one layer of the stacked
    cache, and are read in place.
    """
    if not (q.is_cuda and k_cache.is_cuda and v_cache.is_cuda
            and lengths.is_cuda):
        raise ValueError("decode_attention: expects CUDA tensors")
    if q.dtype not in DTYPES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise TypeError(f"decode_attention: q and caches must share a dtype "
                        f"in {tuple(DTYPES)}")
    if lengths.dtype != torch.int32 or not lengths.is_contiguous():
        raise TypeError("decode_attention: lengths must be contiguous int32")
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError("decode_attention: expects q (B,Hq,D) and caches "
                         "(B,Hkv,S,D)")
    B, Hq, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != B or k_cache.shape[3] != D \
            or lengths.shape != (B,):
        raise ValueError(f"decode_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(lengths.shape)} "
                         "do not match")
    check_shape(Hq, Hkv, D)
    group = Hq // Hkv
    if max(B, Hkv) > 65535:
        raise ValueError("decode_attention: at most 65535 sequences and heads")
    if not q.is_contiguous() or q.data_ptr() % 16:
        raise ValueError("decode_attention: q must be contiguous and aligned")
    check_strided("decode_attention k_cache", k_cache)
    check_strided("decode_attention v_cache", v_cache)
    scale = (D ** -0.5) if scale is None else scale
    out = torch.empty_like(q)
    split = split_rows(S)
    n_split = max(1, -(-S // split))
    # per split: m and l for each q row of the group, then acc[group][D]
    part = torch.empty((B * Hkv * n_split * group * (D + 2),),
                       dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 6)(*k_cache.stride()[:3],
                                      *v_cache.stride()[:3])
    lib = _load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.trees_decode_attention(
            DTYPES[q.dtype], q.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            part.data_ptr(), B, Hkv, group, S, D, split, n_split, strides,
            float(scale), int(window), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"decode_attention: CUDA launch failed with error {err}")
    LAUNCHES["decode_attention"] += 1
    return out
