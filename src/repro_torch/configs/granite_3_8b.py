"""Granite-3.0-8B: dense GQA decoder [hf:ibm-granite/granite-3.0-2b-base]."""
import dataclasses

from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12800,
    vocab=49155,
    head_dim=128,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=250, max_seq_len=128,
    )
