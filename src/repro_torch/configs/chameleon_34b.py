"""Chameleon-34B: early-fusion VLM decoder with QK-norm; VQ image tokens are
ordinary vocab ids (frontend STUB) [arXiv:2405.09818; unverified]."""
import dataclasses

from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab=65536,
    head_dim=128,
    qk_norm=True,
    frontend="vq",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, max_seq_len=128,
    )
