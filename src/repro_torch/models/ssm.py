"""Mamba-2 (SSD) block: fused zxbcdt projection, short causal conv, SSD scan
(``ops.ssd``: the ``ssd_scan`` kernel on the card), gated output projection
(a copy of ``repro/models/ssm.py``).

Decode keeps O(1) state per sequence: a (d_conv-1)-deep conv window and the
(H, P, N) SSM state.  The reference's decode returns a new window and state;
the port writes both into the cache in place (``apply_ssm_decode``), as the
attention block writes its K/V rows.

The roundings follow the reference, since in bfloat16 they decide the
values: the depthwise conv is a left-to-right sum of K products in the
compute dtype before a float32 silu; ``dt`` is a float32 softplus cast to
the compute dtype before the scan (decode keeps it in float32); the scan's
y comes back in x's dtype before the ``d_skip`` term and the silu gate;
A = -exp(a_log) is float32.  Matmul weights and ``conv_w`` are stored in the
compute dtype (``common.storage_dtype``); ``a_log``, ``dt_bias`` and
``d_skip`` stay float32 and are cast at use.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F

from ..core.engine import resolve_device
from ..kernels import ops
from .common import ModelConfig, ParamScope


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)
    return s, di, nh, s.d_state, s.headdim, s.d_conv


def init_ssm(s_: ParamScope, cfg: ModelConfig):
    s, di, nh, N, P, K = _dims(cfg)
    d = cfg.d_model
    L = cfg.n_layers
    # fused input projection: [z (gate), x, B, C, dt]
    s_.add("w_in_zx", (L, d, 2 * di))
    s_.add("w_in_bc", (L, d, 2 * N))
    s_.add("w_in_dt", (L, d, nh))
    s_.add("conv_w", (L, K, di + 2 * N))
    s_.add("a_log", (L, nh), init="zeros")
    s_.add("dt_bias", (L, nh), init="zeros")
    s_.add("d_skip", (L, nh), init="ones")
    s_.add("w_out", (L, di, d))


def _split_proj(p: Mapping, prefix: str, cfg: ModelConfig, u):
    """u (B, S, d) -> z, x, bc, dt_raw (pre-conv, pre-activation)."""
    di = _dims(cfg)[1]
    zx = u @ p[f"{prefix}/w_in_zx"]
    bc = u @ p[f"{prefix}/w_in_bc"]
    dt_raw = u @ p[f"{prefix}/w_in_dt"]
    return zx[..., :di], zx[..., di:], bc, dt_raw


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (= logaddexp(x, 0)) in the same form."""
    return x.clamp(min=0) + torch.log1p(torch.exp(-x.abs()))


def _dt_and_decay(p: Mapping, prefix: str, dt_raw: torch.Tensor):
    """Float32 step sizes softplus(dt_raw + dt_bias) and A = -exp(a_log)."""
    dt = _softplus(dt_raw.float() + p[f"{prefix}/dt_bias"].float())
    return dt, -torch.exp(p[f"{prefix}/a_log"].float())


def _gate_out(p: Mapping, prefix: str, cfg: ModelConfig, y, xh, z):
    """y + x * d_skip, gated by silu(z), through the output projection."""
    dt_ = cfg.compute_dtype
    y = y + xh * p[f"{prefix}/d_skip"].to(dt_)[:, None]
    y = y.reshape(*z.shape)
    y = y * F.silu(z.float()).to(dt_)
    return y @ p[f"{prefix}/w_out"]


def apply_ssm(p: Mapping, prefix: str, cfg: ModelConfig, u: torch.Tensor,
              return_state: bool = False):
    """Training / prefill path.  u: (B, S, d) -> (B, S, d).  With
    ``return_state`` also returns (ssm_state (B, nh, P, N) float32,
    conv_tail (B, K-1, di+2N)) for the cache handoff to decode; like the
    reference, both come from the end of the (padded) sequence."""
    s, di, nh, N, P, K = _dims(cfg)
    dt_ = cfg.compute_dtype
    B_, S, _ = u.shape
    z, x, bc, dt_raw = _split_proj(p, prefix, cfg, u)

    # depthwise causal conv over [x, B, C]: a left-to-right sum of K
    # products in the compute dtype, as the reference's Python ``sum``
    xbc = torch.cat([x, bc], -1)
    w = p[f"{prefix}/conv_w"]  # (K, di+2N)
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    conv = pad[:, :S] * w[0]
    for i in range(1, K):
        conv = conv + pad[:, i:i + S] * w[i]
    conv = F.silu(conv.float()).to(dt_)
    # strided views of the conv output: the kernel reads them in place
    xh = conv[..., :di].reshape(B_, S, nh, P)
    Bm, Cm = conv[..., di:di + N], conv[..., di + N:]

    dt, A = _dt_and_decay(p, prefix, dt_raw)  # (B, S, nh), (nh,)
    y, hfinal = ops.ssd(xh, dt.to(dt_), A, Bm, Cm)
    out = _gate_out(p, prefix, cfg, y, xh, z)
    if return_state:
        return out, hfinal, pad[:, S:S + K - 1].clone()
    return out


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype,
                   device=None) -> Dict[str, torch.Tensor]:
    """One SSM layer group's cache on ``device`` (None: CUDA, raising where
    it is absent): the conv window in ``dtype``, the state in float32."""
    device = resolve_device(device)
    s, di, nh, N, P, K = _dims(cfg)
    return dict(
        conv=torch.zeros((batch, K - 1, di + 2 * N), dtype=dtype,
                         device=device),
        state=torch.zeros((batch, nh, P, N), dtype=torch.float32,
                          device=device),
    )


def apply_ssm_decode(p: Mapping, prefix: str, cfg: ModelConfig,
                     u: torch.Tensor, conv_cache: torch.Tensor,
                     state: torch.Tensor) -> torch.Tensor:
    """Single-token decode, the SSD recurrence directly: u (B, 1, d) ->
    (B, 1, d).  ``conv_cache`` (B, K-1, di+2N) and ``state`` (B, nh, P, N)
    float32 are one layer's cache entries, advanced in place."""
    s, di, nh, N, P, K = _dims(cfg)
    dt_ = cfg.compute_dtype
    B_ = u.shape[0]
    z, x, bc, dt_raw = _split_proj(p, prefix, cfg, u)

    xbc = torch.cat([x, bc], -1)[:, 0]                      # (B, di+2N)
    hist = torch.cat([conv_cache, xbc[:, None]], 1)         # (B, K, di+2N)
    conv = (hist * p[f"{prefix}/conv_w"][None]).sum(1)
    conv = F.silu(conv.float()).to(dt_)
    xh = conv[:, :di].reshape(B_, nh, P)
    Bm, Cm = conv[:, di:di + N], conv[:, di + N:]

    dt, A = _dt_and_decay(p, prefix, dt_raw[:, 0])          # (B, nh), (nh,)
    decay = torch.exp(A[None] * dt)[..., None, None]        # (B, nh, 1, 1)
    upd = (dt[..., None] * xh)[..., None] * Bm[:, None, None, :]
    new_state = decay * state + upd                         # (B, nh, P, N)
    y = torch.einsum("bhpn,bn->bhp", new_state, Cm.float()).to(dt_)
    out = _gate_out(p, prefix, cfg, y, xh, z)
    conv_cache.copy_(hist[:, 1:])
    state.copy_(new_state)
    return out
