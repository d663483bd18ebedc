"""Model assembly: the decoder-only or encoder-decoder transformer with
attn | ssm | hybrid blocks (dense GQA attention, the Mamba-2 block, or both
in parallel), a dense (SwiGLU), parallel or MoE FFN, prefill over ragged
prompts, and a single-token decode step over a ragged cache (a copy of
``repro/models/model.py``), and the training loss (``loss_fn``,
``chunked_xent``).

The reference scans the layer stack over stacked per-layer parameters; the
port keeps one ``ParameterDict`` per layer (and per encoder layer) in an
``nn.ModuleList`` and loops over it in Python.  A serving model's
parameters are frozen and its matmul weights stored in the compute dtype;
a model built to train (``init_model(..., trainable=True)``,
``core.convert.params_from_numpy(..., trainable=True)``) keeps them in the
parameter dtype with ``requires_grad``, and ``forward`` recomputes each
layer in the backward pass under ``cfg.remat``, as the reference's
``jax.checkpoint`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as tcp

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
from .moe import apply_moe, init_moe
from .ssm import apply_ssm, apply_ssm_decode, init_ssm, init_ssm_cache


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a block type the reference's model lacks."""
    if cfg.block not in ("attn", "ssm", "hybrid"):
        raise ValueError(f"unknown block type {cfg.block!r}")


# ------------------------------------------------------------------ model
STACKS = ("layers/", "encoder/")  # the reference's stacked prefixes


def _param(t: torch.Tensor, trainable: bool) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=trainable)


def _per_layer(values: Mapping[str, Value], pre: str, n: int,
               trainable: bool) -> nn.ModuleList:
    """One ``ParameterDict`` per layer from the stacked ``{pre}...``
    entries of ``values`` (each a list of ``n`` tensors)."""
    stacked = {k[len(pre):]: v for k, v in values.items() if k.startswith(pre)}
    for k, v in stacked.items():
        if len(v) != n:
            raise ValueError(f"{pre}{k}: {len(v)} layers, config has {n}")
    return nn.ModuleList(
        nn.ParameterDict({k: _param(v[i], trainable)
                          for k, v in stacked.items()})
        for i in range(n))


class Model(nn.Module):
    """A model's parameters under the reference's names.

    ``model["embed/tok_embed"]`` and ``model["final_norm/scale"]`` are the
    top-level tensors (``enc_pos_embed`` and ``enc_final_norm/*`` too);
    ``model.layers[i]["attn/wq"]`` is layer i's slice of the reference's
    stacked ``layers/attn/wq``, and ``model.encoder[i]["attn/wq"]`` encoder
    layer i's of ``encoder/attn/wq`` (no encoder layers without
    ``cfg.encdec``).  ``trainable`` parameters require grad; a serving
    model's are frozen.
    """

    def __init__(self, cfg: ModelConfig, values: Mapping[str, Value],
                 trainable: bool = False):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.top = nn.ParameterDict({
            k: _param(v, trainable) for k, v in values.items()
            if not k.startswith(STACKS)})
        self.layers = _per_layer(values, "layers/", cfg.n_layers, trainable)
        self.encoder = _per_layer(
            values, "encoder/", cfg.n_encoder_layers if cfg.encdec else 0,
            trainable)

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.top[name]

    def named_leaves(self) -> List[Tuple[str, nn.Parameter, bool]]:
        """``(name, parameter, per-layer)`` in the reference's key order:
        its parameter dict flattened by sorted name (as a JAX pytree is),
        a stacked name's layers in layer order.  Layer ``i`` of the
        reference's ``layers/attn/wq`` is named ``layers/attn/wq[i]``."""
        entries = [(k, None, p) for k, p in self.top.items()]
        for pre, mods in (("layers/", self.layers),
                          ("encoder/", self.encoder)):
            for i, mod in enumerate(mods):
                entries += [(pre + k, i, p) for k, p in mod.items()]
        entries.sort(key=lambda e: (e[0], -1 if e[1] is None else e[1]))
        return [(k if i is None else f"{k}[{i}]", p, i is not None)
                for k, i, p in entries]

    @property
    def device(self) -> torch.device:
        return self.top["embed/tok_embed"].device


def init_model(cfg: ModelConfig, seed: int = 0, device=None,
               trainable: bool = False) -> Model:
    """Random weights drawn on ``device`` (None: CUDA, raising where it is
    absent) from ``torch.Generator(seed)``, under the reference's init rule
    (``common.Params``), one tensor at a time and stored in their final
    dtypes: a serving model's matmul weights in the compute dtype, a
    ``trainable`` model's parameters all in the parameter dtype."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    pb = Params(cfg, gen, trainable)
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
    if cfg.moe is not None:
        init_moe(lyr.scope("moe"), cfg)
    elif has_ffn:
        init_mlp(lyr.scope("mlp"), cfg)
    if cfg.encdec:
        enc = pb.scope("encoder")
        init_attn(enc.scope("attn"), cfg, n_layers=cfg.n_encoder_layers)
        # the encoder's stacks need its own layer count
        ecfg = dataclasses.replace(cfg, n_layers=cfg.n_encoder_layers)
        init_mlp(enc.scope("mlp"), ecfg)
        init_norm(enc.scope("norm1"), ecfg)
        init_norm(enc.scope("norm2"), ecfg)
        init_norm(pb.scope("enc_final_norm"), cfg, layered=False)
        pb.add("enc_pos_embed", (cfg.encoder_len, cfg.d_model), scale=0.02)
        init_attn(lyr.scope("cross"), cfg, cross=True)
        init_norm(lyr.scope("norm_cross"), cfg)
    init_norm(pb.scope("final_norm"), cfg, layered=False)
    return Model(cfg, pb.values, trainable)


def _layer_windows(cfg: ModelConfig) -> List[int]:
    """Per-layer attention window (0 = full/global)."""
    L = cfg.n_layers
    if cfg.sliding_window <= 0:
        return [0] * L
    return [0 if cfg.global_layer_every > 0 and i % cfg.global_layer_every
            == 0 else cfg.sliding_window for i in range(L)]


def _has_ffn(cfg: ModelConfig) -> bool:
    return cfg.moe is not None or (cfg.d_ff > 0 and cfg.block != "ssm")


# ---------------------------------------------------------------- forward
def _mix(cfg: ModelConfig, a: Optional[torch.Tensor],
         y: Optional[torch.Tensor]) -> torch.Tensor:
    """The token mixer's output: attention, SSM, or for a hybrid block
    0.5 * (attention + SSM)."""
    if cfg.block == "hybrid":
        return 0.5 * (a + y)
    return a if y is None else y


def _ffn(cfg: ModelConfig, p: Mapping, x: torch.Tensor, h: torch.Tensor,
         mix: torch.Tensor, cross=None
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x + mix, then the cross-attention step (``cross``: the normed
    stream -> its attention output) and the FFN: the MLP in parallel on the
    shared norm (command-r), or the MoE or MLP after its own norm.
    Returns (x', the MoE's aux loss or None)."""
    if cfg.parallel_block and cfg.moe is None and cfg.d_ff > 0:
        return x + (mix + apply_mlp(p, "mlp", cfg, h)), None  # mixer ∥ mlp
    x = x + mix
    if cross is not None:
        x = x + cross(apply_norm(p, "norm_cross", cfg, x))
    aux = None
    if cfg.moe is not None:
        y, aux = apply_moe(p, "moe", cfg, apply_norm(p, "norm2", cfg, x))
        x = x + y
    elif _has_ffn(cfg):
        h2 = apply_norm(p, "norm2", cfg, x)
        x = x + apply_mlp(p, "mlp", cfg, h2)
    return x, aux


def _decoder_layer(cfg: ModelConfig, p: Mapping, x: torch.Tensor,
                   window: int, enc_out: Optional[torch.Tensor],
                   collect_kv: bool = False
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                              Dict[str, torch.Tensor]]:
    """Returns (x', aux or None, kv) — kv nonempty only when collect_kv:
    the layer's ``k``, ``v`` (attention) and ``ssm_state``, ``ssm_conv``
    (SSM)."""
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
    cross = None
    if cfg.encdec and enc_out is not None:
        def cross(hc):
            return apply_attn(p, "cross", cfg, hc, causal=False,
                              use_rope=False, kv_source=enc_out)
    x, aux = _ffn(cfg, p, x, h, _mix(cfg, a, y), cross)
    return x, aux, kv


def encode(params: Model, cfg: ModelConfig,
           frames: torch.Tensor) -> torch.Tensor:
    """Whisper-style encoder over precomputed frame embeddings (stub
    frontend): frames (B, T_enc, d) -> (B, T_enc, d) in the compute
    dtype."""
    dt = cfg.compute_dtype
    x = frames.to(dt) + params["enc_pos_embed"].to(dt)[None]
    for p in params.encoder:
        a = apply_norm(p, "norm1", cfg, x)
        x = x + apply_attn(p, "attn", cfg, a, causal=False, use_rope=False)
        m = apply_norm(p, "norm2", cfg, x)
        x = x + apply_mlp(p, "mlp", cfg, m)
    return apply_norm(params, "enc_final_norm", cfg, x)


def _encoder_out(params: Model, cfg: ModelConfig,
                 enc_frames) -> Optional[torch.Tensor]:
    if not cfg.encdec:
        return None
    if enc_frames is None:
        raise ValueError("an encoder-decoder model needs encoder frames")
    return encode(params, cfg, enc_frames)


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.checkpoint_dots``: keep the products'
    outputs, recompute the rest."""
    return (tcp.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else tcp.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ModelConfig, layer, p: Dict[str, torch.Tensor]):
    """``layer`` recomputed in the backward pass as the reference's
    ``jax.checkpoint`` of its scan body: ``cfg.remat`` "full" saves
    nothing of the layer but its input, "none" runs it plainly, any other
    value (the reference's "dots") keeps the matrix products' outputs
    (a selective checkpoint saving ``aten.mm``/``bmm``).  Where no
    gradient is taken (grad disabled, or none of the layer's parameters
    ``p`` requires one, as a serving model's) the layer runs plainly."""
    if (cfg.remat == "none" or not torch.is_grad_enabled()
            or not any(t.requires_grad for t in p.values())):
        return layer
    kw = {}
    if cfg.remat != "full":
        kw["context_fn"] = lambda: tcp.create_selective_checkpoint_contexts(
            _save_dots)
    return lambda *a: tcp.checkpoint(layer, *a, use_reentrant=False, **kw)


def _forward(params: Model, cfg: ModelConfig, tokens: torch.Tensor,
             enc_out: Optional[torch.Tensor], collect_kv: bool,
             remat: bool = False):
    x = embed_tokens(params, cfg, tokens)
    kvs: Dict[str, List[torch.Tensor]] = {}
    aux = torch.zeros((), device=x.device)
    for p, win in zip(params.layers, _layer_windows(cfg)):
        if remat and not collect_kv:
            def layer(h, p=p, win=win):
                h, a, _ = _decoder_layer(cfg, p, h, win, enc_out)
                return h, a
            x, layer_aux = _remat(cfg, layer, p)(x)
            kv = {}
        else:
            x, layer_aux, kv = _decoder_layer(cfg, p, x, win, enc_out,
                                              collect_kv)
        if layer_aux is not None:
            aux = aux + layer_aux
        for name, t in kv.items():
            kvs.setdefault(name, []).append(t)
    return apply_norm(params, "final_norm", cfg, x), aux, kvs


def forward(params: Model, cfg: ModelConfig, tokens: torch.Tensor,
            enc_frames=None, remat: bool = True, collect_kv: bool = False):
    """Token ids (B, S) -> final hidden states (B, S, d), plus the MoE aux
    losses summed over the layers (float32; 0 without MoE).  An
    encoder-decoder model needs ``enc_frames`` (B, T_enc, d), which the
    encoder runs over first.  ``remat`` recomputes each decoder layer in
    the backward pass under ``cfg.remat`` (never with ``collect_kv``, as
    in the reference).  With ``collect_kv`` also returns the per-layer
    cache entries ``{"k": [L x (B, Hkv, S, hd)], "v": ...,
    "ssm_state": [L x (B, nh, P, N)], "ssm_conv": ...}`` (those of the
    block type) for the prefill -> decode handoff."""
    enc_out = _encoder_out(params, cfg, enc_frames)
    x, aux, kvs = _forward(params, cfg, tokens, enc_out, collect_kv, remat)
    if collect_kv:
        return x, aux, kvs
    return x, aux


def build_cross_cache(params: Model, cfg: ModelConfig, enc_out: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-layer cross-attention K/V from the encoder output (B, T_enc, d):
    (L, B, Hkv, T_enc, hd) each, written layer by layer."""
    B, T = enc_out.shape[:2]
    hd, hkv = cfg.resolved_head_dim, cfg.n_kv_heads_padded
    ks, vs = (enc_out.new_empty((cfg.n_layers, B, hkv, T, hd))
              for _ in range(2))
    for p, k, v in zip(params.layers, ks, vs):
        k.copy_((enc_out @ p["cross/wk"]).reshape(B, T, hkv, hd)
                .transpose(1, 2))
        v.copy_((enc_out @ p["cross/wv"]).reshape(B, T, hkv, hd)
                .transpose(1, 2))
    return ks, vs


# ------------------------------------------------------------------- loss
def chunked_xent(params: Model, cfg: ModelConfig, hidden: torch.Tensor,
                 labels: torch.Tensor, chunk: int = 512
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean cross-entropy over the labels >= 0 without materialising
    (B, S, V) logits: sequence chunks of ``min(chunk, S)`` (labels padded
    with -1), each chunk's float32 logits, ``logsumexp`` less the picked
    logit (labels clipped for the gather), summed in the reference's chunk
    order.  Returns (total / max(count, 1), count)."""
    B, S, d = hidden.shape
    chunk = min(chunk, S)
    pad = (-S) % chunk
    hp = F.pad(hidden, (0, 0, 0, pad))
    lp = F.pad(labels, (0, pad), value=-1)
    tot = torch.zeros((), device=hidden.device)
    cnt = torch.zeros((), device=hidden.device)
    for c0 in range(0, S + pad, chunk):
        h, y = hp[:, c0:c0 + chunk], lp[:, c0:c0 + chunk]
        logits = logits_fn(params, cfg, h)  # (B, c, Vp) float32
        lse = torch.logsumexp(logits, dim=-1)
        yc = y.clamp(0, cfg.vocab_padded - 1).long()
        picked = torch.gather(logits, -1, yc[..., None])[..., 0]
        valid = (y >= 0).float()
        tot = tot + ((lse - picked) * valid).sum()
        cnt = cnt + valid.sum()
    return tot / torch.clamp(cnt, min=1.0), cnt


def loss_fn(params: Model, cfg: ModelConfig, batch: Mapping[str, torch.Tensor],
            aux_weight: float = 0.01):
    """(xent + aux_weight * aux, {"xent", "aux", "n_tokens"}) of a batch
    ``{"tokens": (B, S), "labels": (B, S), "enc_frames": ...}``, the
    layers under ``cfg.remat``."""
    hidden, aux = forward(params, cfg, batch["tokens"],
                          enc_frames=batch.get("enc_frames"))
    loss, n_tok = chunked_xent(params, cfg, hidden, batch["labels"])
    total = loss + aux_weight * aux
    return total, dict(xent=loss, aux=aux, n_tokens=n_tok)


def prefill(params: Model, cfg: ModelConfig, tokens: torch.Tensor,
            max_len: Optional[int] = None, enc_frames=None,
            last_positions: Optional[torch.Tensor] = None,
            cache: Optional[Dict[str, torch.Tensor]] = None,
            slots: Optional[torch.Tensor] = None):
    """Serving prefill: run the prompts (B, S), return (last-token logits
    (B, Vp) float32, decode cache).

    Without ``cache`` a fresh cache is returned, its K/V padded with zeros
    to ``max_len`` rows as the reference's, and for an encoder-decoder
    model its ``enc_out`` and cross-attention ``cross_k``, ``cross_v`` from
    ``enc_frames``.  With ``cache`` and ``slots`` (i64[B]) each layer's K/V
    is written straight into those slots' rows of ``cache`` (rows past S
    zeroed: the same contents as the reference's padded copy scattered
    into the slots, without the padded copy), each layer's SSM state and
    conv window overwrite those slots' whole, and their lengths are set;
    the cross entries are left as they are (the server builds them once,
    and the reference's server keeps its own over what its prefill
    builds).  The encoder runs once, over ``enc_frames``.  Ragged
    right-padded prompts: pass ``last_positions`` (= prompt_len - 1); pad
    rows past a request's length are never read back (decode masks by
    length).  The SSM state and conv window, as in the reference, are
    those at the end of the padded bucket: a short prompt's state has
    scanned its pad tokens."""
    B, S = tokens.shape
    enc_out = _encoder_out(params, cfg, enc_frames)
    if cache is None:
        cache = init_cache(cfg, B, max_len or S, device=tokens.device)
        slots = torch.arange(B, device=tokens.device)
        if enc_out is not None:
            cache["enc_out"] = enc_out
            cache["cross_k"], cache["cross_v"] = build_cross_cache(
                params, cfg, enc_out)
    elif slots is None:
        raise ValueError("prefill into a cache needs the slots to fill")
    if "k" in cache and cache["k"].shape[3] < S:
        raise ValueError(f"prompt bucket {S} exceeds the cache's "
                         f"{cache['k'].shape[3]} rows")
    x, _, kvs = _forward(params, cfg, tokens, enc_out, collect_kv=True)
    del enc_out
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
    (L, batch, nh, P, N) float32; for an encoder-decoder model ``enc_out``
    (batch, T_enc, d) and the cross-attention ``cross_k``, ``cross_v``
    (L, batch, Hkv, T_enc, hd), on ``device`` (None: CUDA, raising where
    it is absent)."""
    check_supported(cfg)
    device = resolve_device(device)
    dtype = dtype or cfg.compute_dtype
    L = cfg.n_layers
    hd, hkv = cfg.resolved_head_dim, cfg.n_kv_heads_padded
    cache = {
        "lengths": torch.zeros((batch,), dtype=torch.int32, device=device)}
    if cfg.block in ("attn", "hybrid"):
        shape = (L, batch, hkv, max_len, hd)
        cache["k"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=device)
    if cfg.block in ("ssm", "hybrid"):
        s = init_ssm_cache(cfg, batch, dtype, device)
        cache["ssm_conv"] = s["conv"].new_zeros((L,) + s["conv"].shape)
        cache["ssm_state"] = s["state"].new_zeros((L,) + s["state"].shape)
    if cfg.encdec:
        T = cfg.encoder_len
        cache["enc_out"] = torch.zeros((batch, T, cfg.d_model), dtype=dtype,
                                       device=device)
        # cross-attention K/V, computed once per request from enc_out
        shape = (L, batch, hkv, T, hd)
        cache["cross_k"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["cross_v"] = torch.zeros(shape, dtype=dtype, device=device)
    return cache


def decode_step(params: Model, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step for the whole batch: tokens (B, 1) -> (logits
    (B, Vp) float32, cache).  The K/V rows, SSM states and conv windows
    are written into ``cache`` in place, for every slot, idle ones too, as
    the reference does, and ``lengths`` is advanced by one for every slot
    in place; the returned dict is ``cache``.  Cross-attention reads the
    cache's ``cross_k``, ``cross_v`` over the encoder's ``encoder_len``
    rows.  The step reads and writes no tensor but ``tokens``, the
    parameters and the cache, so a CUDA graph of it replays over a fixed
    token buffer (``EpochServer``)."""
    x = embed_tokens(params, cfg, tokens)
    lengths = cache["lengths"]
    cross_on = cfg.encdec and "enc_out" in cache
    if cross_on:
        enc_lens = torch.full_like(lengths, cfg.encoder_len)
    for i, (p, win) in enumerate(zip(params.layers, _layer_windows(cfg))):
        hn = apply_norm(p, "norm1", cfg, x)
        a = y = None
        if cfg.block in ("attn", "hybrid"):
            a, _, _ = apply_attn_decode(p, "attn", cfg, hn, cache["k"][i],
                                        cache["v"][i], lengths, window=win)
        if cfg.block in ("ssm", "hybrid"):
            y = apply_ssm_decode(p, "ssm", cfg, hn, cache["ssm_conv"][i],
                                 cache["ssm_state"][i])
        cross = None
        if cross_on:
            def cross(hc, p=p, i=i):
                return apply_attn_decode(
                    p, "cross", cfg, hc, cache["cross_k"][i],
                    cache["cross_v"][i], enc_lens, use_rope=False,
                    cross=True)[0]
        x, _ = _ffn(cfg, p, x, hn, _mix(cfg, a, y), cross)
    x = apply_norm(params, "final_norm", cfg, x)
    logits = logits_fn(params, cfg, x[:, 0])
    lengths.add_(1)
    return logits, cache
