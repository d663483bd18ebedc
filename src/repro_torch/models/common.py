"""Model configuration and the parameter builder.

A copy of the configuration half of ``repro/models/common.py`` with torch
dtypes.  The sharding half (``ShardingRules``, ``constrain``, the unroll
context) is left out: ``constrain`` is a no-op outside a mesh, and the mesh
belongs to the sharded fleet (ROADMAP item 9).

:class:`Params` draws every parameter from a ``torch.Generator`` under the
reference's rule (``Params.add``: a normal with std ``shape[0] ** -0.5``,
where ``shape[0]`` of a stacked layer weight is ``n_layers``), one tensor at
a time, and stores each matmul weight in the compute dtype at once, so a
full-width serving model never holds a float32 copy of its weights.
Storing the cast is exact: the reference casts the float32 weight to the
compute dtype at each use, the same round-to-nearest-even conversion.  A
model built to train keeps its parameters in the parameter dtype and casts
them at each use (:func:`mm_weight`), as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import torch


# ----------------------------------------------------------------- configs
@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    dispatch: str = "sort"     # sort (contiguity compaction) | cumsum (GShard)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    headdim: int = 64
    expand: int = 2
    d_conv: int = 4

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.headdim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                      # 0 -> d_model // n_heads
    block: str = "attn"                    # attn | ssm | hybrid
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encdec: bool = False                   # whisper-style encoder-decoder
    n_encoder_layers: int = 0
    encoder_len: int = 1500                # whisper audio frames
    sliding_window: int = 0                # 0 = full attention
    global_layer_every: int = 0            # hymba: every k-th layer is global
    parallel_block: bool = False           # command-r: attn ∥ mlp
    qk_norm: bool = False                  # chameleon
    tie_embeddings: bool = False
    norm: str = "rms"                      # rms | ln
    rope_theta: float = 10000.0
    frontend: str = "none"                 # none | audio | vq
    max_seq_len: int = 8192
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    remat: str = "full"                    # full | dots | none
    # ---- physical padding (set by finalize()) ----
    pad_heads_to: int = 1
    pad_vocab_to: int = 256

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_heads_padded(self) -> int:
        return _round_up(self.n_heads, self.pad_heads_to)

    @property
    def n_kv_heads_padded(self) -> int:
        """KV heads padded to the TP degree; padded q heads are
        output-masked, so padding preserves the function."""
        kv = _round_up(self.n_kv_heads, self.pad_heads_to)
        assert self.n_heads_padded % kv == 0, (
            f"padded heads {self.n_heads_padded} not divisible by "
            f"padded kv heads {kv}"
        )
        return kv

    @property
    def vocab_padded(self) -> int:
        return _round_up(self.vocab, self.pad_vocab_to)

    @property
    def sub_quadratic(self) -> bool:
        """True if long-context decode is O(1)/O(window) per token."""
        return self.block in ("ssm", "hybrid") or self.sliding_window > 0

    def n_params(self) -> int:
        """Logical (unpadded) parameter count for MODEL_FLOPS."""
        d, v, L = self.d_model, self.vocab, self.n_layers
        hd = self.resolved_head_dim
        attn = d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads \
            + hd * self.n_heads * d
        if self.moe:
            mlp = 3 * d * self.moe.d_ff_expert * (
                self.moe.n_experts + self.moe.n_shared_experts
            ) + d * self.moe.n_experts
        else:
            mlp = 3 * d * self.d_ff
        if self.block == "ssm":
            s = self.ssm
            di = s.d_inner(d)
            attn = 0
            mlp = d * (2 * di + 2 * s.d_state + s.n_heads(d)) + di * d \
                + s.d_conv * (di + 2 * s.d_state)
        elif self.block == "hybrid":
            s = self.ssm
            di = s.d_inner(d)
            mlp += d * (2 * di + 2 * s.d_state + s.n_heads(d)) + di * d
        body = L * (attn + mlp + 2 * d)
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.encdec:
            enc_attn = 4 * d * hd * self.n_heads
            body += self.n_encoder_layers * (enc_attn + 3 * d * self.d_ff)
            body += L * (enc_attn + 2 * d)  # cross-attention
        return body + emb


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def finalize(cfg: ModelConfig, model_axis_size: int) -> ModelConfig:
    """Pad head/vocab dims for a given tensor-parallel degree."""
    return dataclasses.replace(
        cfg,
        pad_heads_to=model_axis_size,
        pad_vocab_to=max(256, model_axis_size),
    )


def storage_dtype(cfg: ModelConfig, per_layer_ndim: int,
                  trainable: bool = False) -> torch.dtype:
    """Matmul weights (2-D per layer) in the compute dtype, norm scales in
    the parameter dtype; a model built to train keeps every parameter in
    the parameter dtype, as the reference does."""
    if trainable or per_layer_ndim < 2:
        return cfg.param_dtype
    return cfg.compute_dtype


def mm_weight(p, name: str, cfg: ModelConfig) -> torch.Tensor:
    """A matmul weight in the compute dtype: the reference's cast at each
    use, the identity where it is stored so (a serving model); a trainable
    model's float32 weight is cast here, and its gradient flows back
    through the cast."""
    return p[name].to(cfg.compute_dtype)


# ------------------------------------------------------------- parameters
Value = Union[torch.Tensor, List[torch.Tensor]]


class Params:
    """Draws a model's parameters on the generator's device, one tensor at
    a time.

    Names follow the reference (``embed/tok_embed``, ``layers/attn/wq``).
    A ``layers/...`` (or ``encoder/...``) entry of shape ``(L, ...)`` is
    drawn as ``L`` separate tensors of shape ``(...)`` (the port keeps one
    module per layer), each with the stacked weight's std ``L ** -0.5``.
    """

    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 trainable: bool = False):
        self.cfg = cfg
        self.gen = generator
        self.device = generator.device
        self.trainable = trainable
        self.values: Dict[str, Value] = {}

    def _draw(self, shape: Tuple[int, ...], init: str, std: float):
        dt = self.cfg.param_dtype
        if init == "normal":
            v = torch.randn(shape, generator=self.gen, device=self.device,
                            dtype=dt) * std
        elif init == "zeros":
            v = torch.zeros(shape, device=self.device, dtype=dt)
        elif init == "ones":
            v = torch.ones(shape, device=self.device, dtype=dt)
        else:
            raise ValueError(init)
        return v.to(storage_dtype(self.cfg, len(shape), self.trainable))

    def add(self, name: str, shape: Tuple[int, ...], init: str = "normal",
            scale: Optional[float] = None) -> Value:
        std = scale if scale is not None else (
            shape[0] ** -0.5 if shape else 1.0)
        if name.startswith(("layers/", "encoder/")):
            v: Value = [self._draw(tuple(shape[1:]), init, std)
                        for _ in range(shape[0])]
        else:
            v = self._draw(tuple(shape), init, std)
        self.values[name] = v
        return v

    def scope(self, name: str) -> "ParamScope":
        return ParamScope(self, name)


class ParamScope:
    def __init__(self, params: Params, prefix: str):
        self._p = params
        self._prefix = prefix

    def add(self, name: str, *a, **kw):
        return self._p.add(f"{self._prefix}/{name}", *a, **kw)

    def scope(self, name: str) -> "ParamScope":
        return ParamScope(self._p, f"{self._prefix}/{name}")
