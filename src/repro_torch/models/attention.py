"""GQA attention block: the prefill path (``ops.attention``: the
``flash_attention`` kernel on the card), the decode path (ragged KV-cache
update + ``ops.gqa_decode``: the ``decode_attention`` kernel), self- or
cross-attention (keys and values from an encoder's output), sliding-window
and QK-norm options, head padding (a copy of ``repro/models/attention.py``).

The decode path writes the cache in place (the reference builds a new one
functionally; the contents are the same).  JAX drops a scatter whose index
is out of range, and the reference relies on it: every slot's length grows
by one each epoch, idle slots included, so an idle slot's write position
passes ``max_len``.  Torch raises on such an index, so the port keeps the
old row wherever ``lengths >= max_len`` — the same cache.
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch

from ..kernels import ops
from .common import ModelConfig, ParamScope, mm_weight
from .layers import rope


def init_attn(s: ParamScope, cfg: ModelConfig,
              n_layers: Optional[int] = None, cross: bool = False):
    """The projections of self- or cross-attention: the same parameters
    (``cross`` changes only where K/V come from at apply time)."""
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    hq, hkv = cfg.n_heads_padded, cfg.n_kv_heads_padded
    L = cfg.n_layers if n_layers is None else n_layers
    s.add("wq", (L, d, hq * hd))
    s.add("wk", (L, d, hkv * hd))
    s.add("wv", (L, d, hkv * hd))
    s.add("wo", (L, hq * hd, d))
    if cfg.qk_norm:
        s.add("q_scale", (L, hd), init="ones")
        s.add("k_scale", (L, hd), init="ones")


def _qk_norm(x, scale):
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-6)
    return (y * scale.float()).to(x.dtype)


def _head_mask(cfg: ModelConfig, x):
    """Zero padded q heads (axis -2) so head padding is
    function-preserving."""
    hq = cfg.n_heads_padded
    if hq == cfg.n_heads:
        return x
    mask = (torch.arange(hq, device=x.device) < cfg.n_heads).to(x.dtype)
    return x * mask[..., None]


def _project_qkv(p: Mapping, prefix: str, cfg: ModelConfig, xq, xkv,
                 positions_q, positions_kv, use_rope: bool):
    hd = cfg.resolved_head_dim
    hq, hkv = cfg.n_heads_padded, cfg.n_kv_heads_padded
    q = (xq @ mm_weight(p, f"{prefix}/wq", cfg)).reshape(
        *xq.shape[:-1], hq, hd)
    k = (xkv @ mm_weight(p, f"{prefix}/wk", cfg)).reshape(
        *xkv.shape[:-1], hkv, hd)
    v = (xkv @ mm_weight(p, f"{prefix}/wv", cfg)).reshape(
        *xkv.shape[:-1], hkv, hd)
    if cfg.qk_norm:
        q = _qk_norm(q, p[f"{prefix}/q_scale"])
        k = _qk_norm(k, p[f"{prefix}/k_scale"])
    if use_rope:
        q = rope(q, positions_q, cfg.rope_theta)
        k = rope(k, positions_kv, cfg.rope_theta)
    return q, k, v


def apply_attn(p: Mapping, prefix: str, cfg: ModelConfig, x: torch.Tensor,
               causal: bool = True, window: int = 0, use_rope: bool = True,
               kv_source: Optional[torch.Tensor] = None,
               return_kv: bool = False):
    """Training / prefill attention over x (B, S, d); keys and values from
    ``kv_source`` (B, Skv, d) for cross-attention, else from x.  With
    ``return_kv`` also returns the rotary-applied (k, v) in cache layout
    (B, Hkv, Skv, hd), as transposed views."""
    B, S, _ = x.shape
    xkv = x if kv_source is None else kv_source
    Skv = xkv.shape[1]
    pos_q = torch.arange(S, device=x.device).expand(B, S)
    pos_kv = torch.arange(Skv, device=x.device).expand(B, Skv)
    q, k, v = _project_qkv(p, prefix, cfg, x, xkv, pos_q, pos_kv, use_rope)
    # (B, H, S, hd) views; the kernel reads them through their strides
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    out = ops.attention(q, k, v, causal=causal, window=window)
    out = _head_mask(cfg, out.transpose(1, 2))  # (B, S, H, hd)
    proj = out.reshape(B, S, -1) @ mm_weight(p, f"{prefix}/wo", cfg)
    if return_kv:
        return proj, (k, v)
    return proj


def write_cache_row(cache: torch.Tensor, lengths: torch.Tensor,
                    new: torch.Tensor) -> None:
    """``cache[b, :, lengths[b]] = new[b]`` in place for every b, keeping
    the old row where ``lengths[b]`` is past the cache (JAX's dropped
    out-of-range write).  cache (B, Hkv, S, hd), new (B, Hkv, hd)."""
    B, _, S, _ = cache.shape
    bidx = torch.arange(B, device=cache.device)
    pos = lengths.clamp(max=S - 1).long()
    keep = (lengths >= S)[:, None, None]
    old = cache[bidx, :, pos]
    cache[bidx, :, pos] = torch.where(keep, old, new.to(cache.dtype))


def apply_attn_decode(p: Mapping, prefix: str, cfg: ModelConfig,
                      x: torch.Tensor, cache_k: torch.Tensor,
                      cache_v: torch.Tensor, lengths: torch.Tensor,
                      window: int = 0, use_rope: bool = True,
                      cross: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode over x (B, 1, d) and one layer's cache
    (B, Hkv, S, hd), written in place.  Returns (out (B, 1, d), cache_k,
    cache_v).

    For cross-attention (``cross=True``) the cache holds the encoder's
    precomputed K/V and is not written; only q is projected (no rotary),
    and ``lengths`` is the encoder length."""
    B = x.shape[0]
    if cross:
        hd, hq = cfg.resolved_head_dim, cfg.n_heads_padded
        q = (x @ mm_weight(p, f"{prefix}/wq", cfg)).reshape(
            B, 1, hq, hd)
        if cfg.qk_norm:
            q = _qk_norm(q, p[f"{prefix}/q_scale"])
        att_len = lengths
    else:
        pos = lengths[:, None]  # (B, 1) absolute position of the new token
        q, k, v = _project_qkv(p, prefix, cfg, x, x, pos, pos, use_rope)
        write_cache_row(cache_k, lengths, k[:, 0])
        write_cache_row(cache_v, lengths, v[:, 0])
        att_len = lengths + 1
    out = ops.gqa_decode(q[:, 0], cache_k, cache_v, att_len, window=window)
    out = _head_mask(cfg, out)
    out = out.reshape(B, 1, -1)
    return out @ mm_weight(p, f"{prefix}/wo", cfg), cache_k, cache_v
