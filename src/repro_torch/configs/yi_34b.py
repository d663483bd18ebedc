"""Yi-34B: dense llama-arch GQA decoder [arXiv:2403.04652; hf]."""
import dataclasses

from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64000,
    head_dim=128,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, max_seq_len=128,
    )
