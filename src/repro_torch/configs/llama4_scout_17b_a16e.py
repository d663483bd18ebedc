"""Llama-4-Scout-17B-16E backbone: MoE 16 experts top-1 + shared expert,
early fusion (VQ/image frontend STUB: tokens are ordinary vocab ids)
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]."""
import dataclasses

from ..models.common import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    head_dim=128,
    moe=MoEConfig(n_experts=16, top_k=1, d_ff_expert=8192, n_shared_experts=1),
    frontend="vq",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=64, vocab=256,
        moe=MoEConfig(n_experts=4, top_k=1, d_ff_expert=64, n_shared_experts=1),
        max_seq_len=128,
    )
