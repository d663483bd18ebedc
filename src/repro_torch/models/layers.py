"""Primitive layers: norms, rotary embedding, SwiGLU MLP, embeddings.

A copy of ``repro/models/layers.py`` on torch tensors.  The apply functions
take a parameter mapping (a layer's ``ParameterDict``, or the model for the
top-level names) and a prefix, as the reference does; matmul weights are
already stored in the compute dtype (``common.storage_dtype``), so the
reference's cast at each use is the identity here (``mm_weight``; a
model built to train stores float32 and casts).
"""
from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from .common import ModelConfig, ParamScope, mm_weight


# ------------------------------------------------------------------ norms
def init_norm(s: ParamScope, cfg: ModelConfig, layered: bool = True):
    lead = (cfg.n_layers,) if layered else ()
    s.add("scale", lead + (cfg.d_model,), init="ones")
    if cfg.norm == "ln":
        s.add("bias", lead + (cfg.d_model,), init="zeros")


def apply_norm(p: Mapping, prefix: str, cfg: ModelConfig, x):
    """RMSNorm (or LayerNorm) in float32, cast to the compute dtype."""
    xf = x.float()
    if cfg.norm == "ln":
        xf = xf - xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + 1e-6)
    y = y * p[f"{prefix}/scale"].float()
    if cfg.norm == "ln":
        y = y + p[f"{prefix}/bias"].float()
    return y.to(cfg.compute_dtype)


# ----------------------------------------------------------------- rotary
def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (
        -torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., :, None].float() * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat(
        [xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1
    ).to(x.dtype)


# ------------------------------------------------------------------- MLP
def init_mlp(s: ParamScope, cfg: ModelConfig, d_ff: int = 0):
    d, L = cfg.d_model, cfg.n_layers
    f = d_ff or cfg.d_ff
    s.add("w_gate", (L, d, f))
    s.add("w_up", (L, d, f))
    s.add("w_down", (L, f, d))


def apply_mlp(p: Mapping, prefix: str, cfg: ModelConfig, x):
    """SwiGLU: silu in float32, cast, then the product in the compute
    dtype, as the reference does."""
    g = x @ mm_weight(p, f"{prefix}/w_gate", cfg)
    u = x @ mm_weight(p, f"{prefix}/w_up", cfg)
    h = F.silu(g.float()).to(cfg.compute_dtype) * u
    return h @ mm_weight(p, f"{prefix}/w_down", cfg)


# ------------------------------------------------------------- embeddings
def init_embeddings(s: ParamScope, cfg: ModelConfig):
    vp, d = cfg.vocab_padded, cfg.d_model
    s.add("tok_embed", (vp, d), scale=0.02)
    if not cfg.tie_embeddings:
        s.add("unembed", (d, vp))


def embed_tokens(p: Mapping, cfg: ModelConfig, tokens):
    return p["embed/tok_embed"][tokens].to(cfg.compute_dtype)


def logits_fn(p: Mapping, cfg: ModelConfig, x):
    """x (..., d) -> float32 logits (..., vocab_padded); padded entries
    masked with -1e30."""
    if cfg.tie_embeddings:
        w = mm_weight(p, "embed/tok_embed", cfg).T
    else:
        w = mm_weight(p, "embed/unembed", cfg)
    logits = (x @ w).float()
    vp, v = cfg.vocab_padded, cfg.vocab
    if vp != v:
        logits[..., v:] = -1e30
    return logits
