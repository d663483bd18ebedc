"""Hand-written CUDA kernels for blockwise (flash) grouped-query attention,
forward and backward.

``flash_attention`` replaces the Pallas TPU kernel ``mha_flash`` of
``repro/kernels/flash_attention.py``; the CUDA C++ lives in
``csrc/flash_attention.cu`` (its header says what bounds it and how it is
laid out).  Three designs, by type and head dim: bfloat16 at D = 64 and 128
(the serving path's prefill) takes Hopper's ``wgmma`` fed by TMA in a
persistent kernel; bfloat16 at D = 16 and 32 takes ``mma.sync`` tiles fed
by a ``cp.async`` ring; float32 takes the CUDA-core kernel, which keeps
float32 products exact to 1e-5.  On request (``return_lse``) each design
also writes the float32 log-sum-exp of every row's scaled scores, which
the backward reads.  The plain versions are ``ref.mha_ref`` and
``ref.mha_blockwise``; ``kernels/ops.py`` sends CPU tensors there.

``flash_attention_bwd`` is the gradient, port-only: the reference has no
Pallas backward (XLA differentiates its plain attention), and the card
needs a gradient through this forward.  ``csrc/flash_attention_bwd.cu``
runs three launches, deterministic, with no float atomics: a pre-pass
δ = rowsum(dO ∘ O); a dK/dV kernel, one CTA per (batch, kv head, key
tile) looping over the group's query heads and query tiles, recomputing
P = exp(S - lse); a dQ kernel, one CTA per (batch, q head, query tile)
looping over the key tiles.  bfloat16 runs ``mma.sync`` tensor cores
(float32 accumulators, P and dS rounded to bf16 as the products' A
operands), float32 the CUDA cores.  Its plain version is
``ref.mha_backward_ref``.  :class:`FlashAttention` is the
``torch.autograd.Function`` over the two, which ``ops.attention`` takes on
the card where a gradient is wanted.

The sources are compiled with ``nvcc`` for ``sm_90a`` at first use
(``kernels/nvcc.py``) and loaded with ``ctypes``.  Nothing here compiles
or loads at import time.
"""
from __future__ import annotations

import ctypes
import pathlib
import threading
from typing import Dict, Optional, Tuple

import torch

from . import counters, nvcc

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "flash_attention.cu"
SOURCE_BWD = CSRC / "flash_attention_bwd.cu"

# launches since the last reset: the forward kernel (one per wrapper call)
# and the backward's kernels (three per wrapper call: δ, dK/dV, dQ)
LAUNCHES: Dict[str, int] = counters.register(
    {"flash_attention": 0, "flash_attention_bwd": 0})
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
BWD_LAUNCHES = 3

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build(ptxas_info: bool = False) -> Tuple[pathlib.Path, str]:
    """Compile the forward's source unless its library exists
    (``nvcc.build``)."""
    return nvcc.build(SOURCE, ptxas_info)


def build_bwd(ptxas_info: bool = False) -> Tuple[pathlib.Path, str]:
    """Compile the backward's source unless its library exists."""
    return nvcc.build(SOURCE_BWD, ptxas_info)


def _load(which: str = "fwd") -> ctypes.CDLL:
    with _lock:
        if which not in _libs:
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            if which == "fwd":
                lib = ctypes.CDLL(str(build()[0]))
                lib.trees_flash_attention.argtypes = [
                    i, p, p, p, p, i, i, i, i, i, i, p, f, i, i, i, p, p]
                lib.trees_flash_attention.restype = i
            else:
                lib = ctypes.CDLL(str(build_bwd()[0]))
                lib.trees_flash_attention_bwd.argtypes = [
                    i, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, p, f,
                    i, i, i, p]
                lib.trees_flash_attention_bwd.restype = i
            _libs[which] = lib
        return _libs[which]


def check_shape(Hq: int, Hkv: int, D: int) -> None:
    """Raise ``ValueError`` unless the kernel takes these heads and head
    dim: any GQA group (``Hq`` a multiple of ``Hkv``), D in
    :data:`HEAD_DIMS`.  Needs no card."""
    if Hkv <= 0 or Hq % Hkv:
        raise ValueError(f"flash_attention: {Hq} q heads over {Hkv} kv "
                         "heads (GQA needs Hq a multiple of Hkv)")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")


def strided_ok(x: torch.Tensor) -> bool:
    """Whether the kernels read ``x`` in place: D contiguous, every other
    stride a multiple of 8 elements, the data 16-byte aligned."""
    return x.stride(-1) == 1 and not any(s % 8 for s in x.stride()[:-1]) \
        and not x.data_ptr() % 16


def check_strided(name: str, x: torch.Tensor) -> None:
    """The kernels read 16-byte vectors along D (:func:`strided_ok`)."""
    if not strided_ok(x):
        raise ValueError(
            f"{name}: expects a view with D contiguous, other strides "
            f"multiples of 8 and 16-byte aligned data, got strides "
            f"{x.stride()}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None,
                    q_offset: int = 0, window: int = 0,
                    return_lse: bool = False):
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
    the block's layout is free.  With ``return_lse`` also returns the
    float32 log-sum-exp of each row's scaled scores, (B, Hq, Sq).
    """
    B, Hq, Sq, D, Hkv, Skv = _check_inputs("flash_attention", q, k, v)
    scale = (D ** -0.5) if scale is None else scale
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32,
                      device=q.device) if return_lse else None
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    lib = _load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.trees_flash_attention(
            DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), B, Hq, Hkv, Sq, Skv, D, strides, float(scale),
            int(bool(causal)), int(q_offset), int(window),
            None if lse is None else lse.data_ptr(),
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"flash_attention: CUDA launch failed with error {err}")
    LAUNCHES["flash_attention"] += 1
    return (out, lse) if return_lse else out


def _check_inputs(what: str, q, k, v):
    """Raise unless q, k, v are CUDA tensors the kernels take; returns
    (B, Hq, Sq, D, Hkv, Skv)."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError(f"{what}: expects CUDA tensors")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what}: q, k, v must share a dtype in "
                        f"{tuple(DTYPES)}, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{what}: expects q (B,Hq,Sq,D) and k, v "
                         "(B,Hkv,Skv,D)")
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"{what}: shapes {tuple(q.shape)} and "
                         f"{tuple(k.shape)} do not match")
    check_shape(Hq, Hkv, D)
    if max(B, Hq) > 65535:
        raise ValueError(f"{what}: at most 65535 sequences and heads")
    for name, x in (("q", q), ("k", k), ("v", v)):
        check_strided(f"{what} {name}", x)
    return B, Hq, Sq, D, Hkv, Skv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        causal: bool = True, scale: Optional[float] = None,
                        q_offset: int = 0, window: int = 0):
    """The gradient of :func:`flash_attention` at (q, k, v) from its output
    ``o``, its ``lse`` (float32 (B, Hq, Sq)) and the output's gradient
    ``do``: ``(dq, dk, dv)`` in the inputs' dtype, views of contiguous
    (B, S, H, D) tensors as the forward's output is.  The same function as
    ``ref.mha_backward_ref``; three launches (module docstring)."""
    B, Hq, Sq, D, Hkv, Skv = _check_inputs("flash_attention_bwd", q, k, v)
    for name, x in (("o", o), ("do", do)):
        if x.shape != q.shape or x.dtype != q.dtype or not x.is_cuda:
            raise ValueError(f"flash_attention_bwd: {name} must match q, "
                             f"got {x.dtype}{tuple(x.shape)}")
        check_strided(f"flash_attention_bwd {name}", x)
    if lse.shape != (B, Hq, Sq) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError("flash_attention_bwd: lse must be a contiguous "
                         f"float32 {(B, Hq, Sq)}")
    scale = (D ** -0.5) if scale is None else scale
    delta = torch.empty_like(lse)
    dq = torch.empty((B, Sq, Hq, D), dtype=q.dtype,
                     device=q.device).transpose(1, 2)
    dk, dv = (torch.empty((B, Skv, Hkv, D), dtype=q.dtype,
                          device=q.device).transpose(1, 2) for _ in range(2))
    strides = (ctypes.c_longlong * 24)(
        *(s for x in (q, k, v, o, do, dq, dk, dv) for s in x.stride()[:3]))
    lib = _load("bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.trees_flash_attention_bwd(
            DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Hq, Hkv, Sq, Skv,
            D, strides, float(scale), int(bool(causal)), int(q_offset),
            int(window), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"flash_attention_bwd: CUDA launch failed with error {err}")
    LAUNCHES["flash_attention_bwd"] += BWD_LAUNCHES
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """:func:`flash_attention` with :func:`flash_attention_bwd` as its
    gradient: saves q, k, v, the output and its lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal=True, scale=None, q_offset=0,
                window=0):
        out, lse = flash_attention(q, k, v, causal=causal, scale=scale,
                                   q_offset=q_offset, window=window,
                                   return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, scale, q_offset, window)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        causal, scale, q_offset, window = ctx.args
        if not strided_ok(do):  # an expanded or permuted gradient
            do = do.contiguous()
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, lse, do, causal=causal, scale=scale,
            q_offset=q_offset, window=window)
        return dq, dk, dv, None, None, None, None
