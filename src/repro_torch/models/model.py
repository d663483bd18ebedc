"""Model assembly: the decoder-only model with attn | ssm | hybrid blocks
(dense GQA attention, the Mamba-2 block, or both in parallel) and a dense
(SwiGLU) or parallel MLP, prefill over ragged prompts, and a single-token
decode step over a ragged cache (a copy of ``repro/models/model.py``).

The reference scans the layer stack over stacked per-layer parameters; the
port keeps one ``ParameterDict`` per layer in an ``nn.ModuleList`` and
loops over it in Python.  The MoE and encoder-decoder branches raise
``NotImplementedError`` naming their ROADMAP items; ``loss_fn``,
``chunked_xent`` and ``encode`` wait for the training and encoder slices.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn

from ..core.engine import resolve_device
from .attention import apply_attn, apply_attn_decode, init_attn
from .common import ModelConfig, Params, Value
from .layers import (
    apply_mlp,
    apply_norm,
    embed_tokens,
    init_embeddings,
    init_mlp,
    init_norm,
    logits_fn,
)
from .ssm import apply_ssm, apply_ssm_decode, init_ssm, init_ssm_cache

_MOE_MSG = "MoE layers are not ported yet (ROADMAP item 11, models/moe.py)"
_ENC_MSG = ("the encoder-decoder path is not ported yet (ROADMAP item 11: "
            "encode, cross-attention)")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the parts of the reference's model this port lacks."""
    if cfg.block not in ("attn", "ssm", "hybrid"):
        raise ValueError(f"unknown block type {cfg.block!r}")
    if cfg.moe is not None:
        raise NotImplementedError(_MOE_MSG)
    if cfg.encdec:
        raise NotImplementedError(_ENC_MSG)


# ------------------------------------------------------------------ model
def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Model(nn.Module):
    """A model's parameters under the reference's names.

    ``model["embed/tok_embed"]`` and ``model["final_norm/scale"]`` are the
    top-level tensors; ``model.layers[i]["attn/wq"]`` is layer i's slice of
    the reference's stacked ``layers/attn/wq``.
    """

    def __init__(self, cfg: ModelConfig, values: Mapping[str, Value]):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        pre = "layers/"
        self.top = nn.ParameterDict({
            k: _frozen(v) for k, v in values.items() if not k.startswith(pre)
        })
        layered = {k[len(pre):]: v for k, v in values.items()
                   if k.startswith(pre)}
        for k, v in layered.items():
            if len(v) != cfg.n_layers:
                raise ValueError(f"layers/{k}: {len(v)} layers, config has "
                                 f"{cfg.n_layers}")
        self.layers = nn.ModuleList(
            nn.ParameterDict({k: _frozen(v[i]) for k, v in layered.items()})
            for i in range(cfg.n_layers)
        )

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.top[name]

    @property
    def device(self) -> torch.device:
        return self.top["embed/tok_embed"].device


def init_model(cfg: ModelConfig, seed: int = 0, device=None) -> Model:
    """Random weights drawn on ``device`` (None: CUDA, raising where it is
    absent) from ``torch.Generator(seed)``, under the reference's init rule
    (``common.Params``), one tensor at a time and stored in their final
    dtypes."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    pb = Params(cfg, gen)
    init_embeddings(pb.scope("embed"), cfg)
    lyr = pb.scope("layers")
    if cfg.block in ("attn", "hybrid"):
        init_attn(lyr.scope("attn"), cfg)
    if cfg.block in ("ssm", "hybrid"):
        init_ssm(lyr.scope("ssm"), cfg)
    init_norm(lyr.scope("norm1"), cfg)
    has_ffn = _has_ffn(cfg)
    if has_ffn and not cfg.parallel_block:
        init_norm(lyr.scope("norm2"), cfg)
    if has_ffn:
        init_mlp(lyr.scope("mlp"), cfg)
    init_norm(pb.scope("final_norm"), cfg, layered=False)
    return Model(cfg, pb.values)


def _layer_windows(cfg: ModelConfig) -> List[int]:
    """Per-layer attention window (0 = full/global)."""
    L = cfg.n_layers
    if cfg.sliding_window <= 0:
        return [0] * L
    return [0 if cfg.global_layer_every > 0 and i % cfg.global_layer_every
            == 0 else cfg.sliding_window for i in range(L)]


def _has_ffn(cfg: ModelConfig) -> bool:
    return cfg.d_ff > 0 and cfg.block != "ssm"


# ---------------------------------------------------------------- forward
def _mix(cfg: ModelConfig, a: Optional[torch.Tensor],
         y: Optional[torch.Tensor]) -> torch.Tensor:
    """The token mixer's output: attention, SSM, or for a hybrid block
    0.5 * (attention + SSM)."""
    if cfg.block == "hybrid":
        return 0.5 * (a + y)
    return a if y is None else y


def _ffn(cfg: ModelConfig, p: Mapping, x: torch.Tensor, h: torch.Tensor,
         mix: torch.Tensor) -> torch.Tensor:
    """x + mix, then the MLP: in parallel on the shared norm (command-r),
    or after its own norm."""
    if cfg.parallel_block and cfg.d_ff > 0:
        return x + (mix + apply_mlp(p, "mlp", cfg, h))  # mixer ∥ mlp
    x = x + mix
    if _has_ffn(cfg):
        h2 = apply_norm(p, "norm2", cfg, x)
        x = x + apply_mlp(p, "mlp", cfg, h2)
    return x


def _decoder_layer(cfg: ModelConfig, p: Mapping, x: torch.Tensor,
                   window: int, collect_kv: bool = False
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (x', kv) — kv nonempty only when collect_kv: the layer's
    ``k``, ``v`` (attention) and ``ssm_state``, ``ssm_conv`` (SSM)."""
    kv: Dict[str, torch.Tensor] = {}
    h = apply_norm(p, "norm1", cfg, x)
    a = y = None
    if cfg.block in ("attn", "hybrid"):
        if collect_kv:
            a, (kv["k"], kv["v"]) = apply_attn(
                p, "attn", cfg, h, causal=True, window=window,
                return_kv=True)
        else:
            a = apply_attn(p, "attn", cfg, h, causal=True, window=window)
    if cfg.block in ("ssm", "hybrid"):
        if collect_kv:
            y, kv["ssm_state"], kv["ssm_conv"] = apply_ssm(
                p, "ssm", cfg, h, return_state=True)
        else:
            y = apply_ssm(p, "ssm", cfg, h)
    return _ffn(cfg, p, x, h, _mix(cfg, a, y)), kv


def forward(params: Model, cfg: ModelConfig, tokens: torch.Tensor,
            enc_frames=None, collect_kv: bool = False):
    """Token ids (B, S) -> final hidden states (B, S, d), plus the summed
    MoE aux loss (0: no MoE).  With ``collect_kv`` also returns the
    per-layer cache entries ``{"k": [L x (B, Hkv, S, hd)], "v": ...,
    "ssm_state": [L x (B, nh, P, N)], "ssm_conv": ...}`` (those of the
    block type) for the prefill -> decode handoff."""
    if enc_frames is not None:
        raise NotImplementedError(_ENC_MSG)
    x = embed_tokens(params, cfg, tokens)
    kvs: Dict[str, List[torch.Tensor]] = {}
    for p, win in zip(params.layers, _layer_windows(cfg)):
        x, kv = _decoder_layer(cfg, p, x, win, collect_kv)
        for name, t in kv.items():
            kvs.setdefault(name, []).append(t)
    x = apply_norm(params, "final_norm", cfg, x)
    aux = torch.zeros((), device=x.device)
    if collect_kv:
        return x, aux, kvs
    return x, aux


def prefill(params: Model, cfg: ModelConfig, tokens: torch.Tensor,
            max_len: Optional[int] = None, enc_frames=None,
            last_positions: Optional[torch.Tensor] = None,
            cache: Optional[Dict[str, torch.Tensor]] = None,
            slots: Optional[torch.Tensor] = None):
    """Serving prefill: run the prompts (B, S), return (last-token logits
    (B, Vp) float32, decode cache).

    Without ``cache`` a fresh cache is returned, its K/V padded with zeros
    to ``max_len`` rows as the reference's.  With ``cache`` and ``slots``
    (i64[B]) each layer's K/V is written straight into those slots' rows
    of ``cache`` (rows past S zeroed: the same contents as the reference's
    padded copy scattered into the slots, without the padded copy), each
    layer's SSM state and conv window overwrite those slots' whole, and
    their lengths are set.  Ragged right-padded prompts: pass
    ``last_positions`` (= prompt_len - 1); pad rows past a request's
    length are never read back (decode masks by length).  The SSM state
    and conv window, as in the reference, are those at the end of the
    padded bucket: a short prompt's state has scanned its pad tokens."""
    B, S = tokens.shape
    if cache is None:
        cache = init_cache(cfg, B, max_len or S, device=tokens.device)
        slots = torch.arange(B, device=tokens.device)
    elif slots is None:
        raise ValueError("prefill into a cache needs the slots to fill")
    if "k" in cache and cache["k"].shape[3] < S:
        raise ValueError(f"prompt bucket {S} exceeds the cache's "
                         f"{cache['k'].shape[3]} rows")
    x, _, kvs = forward(params, cfg, tokens, collect_kv=True)
    for name, per_layer in kvs.items():
        for c, new in zip(cache[name], per_layer):
            if name in ("k", "v"):
                rows = torch.zeros((B,) + c.shape[1:], dtype=c.dtype,
                                   device=c.device)
                rows[:, :, :S] = new
                c[slots] = rows
            else:
                c[slots] = new
    del kvs
    if last_positions is None:
        last = x[:, -1]
        cache["lengths"][slots] = S
    else:
        last = x[torch.arange(B, device=x.device), last_positions.long()]
        cache["lengths"][slots] = last_positions.to(torch.int32) + 1
    return logits_fn(params, cfg, last), cache


# ----------------------------------------------------------------- decode
def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device=None) -> Dict[str, torch.Tensor]:
    """Ragged decode cache for all layers: ``lengths`` i32[batch]; for
    attention ``k``, ``v`` of shape (L, batch, Hkv, max_len, hd); for the
    SSM ``ssm_conv`` (L, batch, K-1, di+2N) in ``dtype`` and ``ssm_state``
    (L, batch, nh, P, N) float32, on ``device`` (None: CUDA, raising where
    it is absent)."""
    check_supported(cfg)
    device = resolve_device(device)
    dtype = dtype or cfg.compute_dtype
    L = cfg.n_layers
    cache = {
        "lengths": torch.zeros((batch,), dtype=torch.int32, device=device)}
    if cfg.block in ("attn", "hybrid"):
        shape = (L, batch, cfg.n_kv_heads_padded, max_len,
                 cfg.resolved_head_dim)
        cache["k"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=device)
    if cfg.block in ("ssm", "hybrid"):
        s = init_ssm_cache(cfg, batch, dtype, device)
        cache["ssm_conv"] = s["conv"].new_zeros((L,) + s["conv"].shape)
        cache["ssm_state"] = s["state"].new_zeros((L,) + s["state"].shape)
    return cache


def decode_step(params: Model, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step for the whole batch: tokens (B, 1) -> (logits
    (B, Vp) float32, cache).  The K/V rows, SSM states and conv windows
    are written into ``cache`` in place, for every slot, idle ones too, as
    the reference does, and ``lengths`` is advanced by one for every slot
    in place; the returned dict is ``cache``.  The step reads and writes
    no tensor but ``tokens``, the parameters and the cache, so a CUDA
    graph of it replays over a fixed token buffer (``EpochServer``)."""
    x = embed_tokens(params, cfg, tokens)
    lengths = cache["lengths"]
    for i, (p, win) in enumerate(zip(params.layers, _layer_windows(cfg))):
        hn = apply_norm(p, "norm1", cfg, x)
        a = y = None
        if cfg.block in ("attn", "hybrid"):
            a, _, _ = apply_attn_decode(p, "attn", cfg, hn, cache["k"][i],
                                        cache["v"][i], lengths, window=win)
        if cfg.block in ("ssm", "hybrid"):
            y = apply_ssm_decode(p, "ssm", cfg, hn, cache["ssm_conv"][i],
                                 cache["ssm_state"][i])
        x = _ffn(cfg, p, x, hn, _mix(cfg, a, y))
    x = apply_norm(params, "final_norm", cfg, x)
    logits = logits_fn(params, cfg, x[:, 0])
    lengths.add_(1)
    return logits, cache
