"""DeepSeek-67B: dense llama-arch GQA decoder [arXiv:2401.02954; hf]."""
import dataclasses

from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab=102400,
    head_dim=128,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=160, vocab=256, max_seq_len=128,
    )
