"""Granite-3.0-1B-A400M: MoE 32 experts top-8, GQA
[hf:ibm-granite/granite-3.0-1b-a400m-base]."""
import dataclasses

from ..models.common import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    head_dim=64,
    moe=MoEConfig(n_experts=32, top_k=8, d_ff_expert=512),
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=64, vocab=256, moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64),
        max_seq_len=128,
    )
