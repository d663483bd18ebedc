"""Command-R-35B: GQA, no-bias, parallel attn/FFN blocks, tied embeddings
[hf:CohereForAI/c4ai-command-r-v01; unverified]."""
import dataclasses

from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab=256000,
    head_dim=128,
    parallel_block=True,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, max_seq_len=128,
    )
