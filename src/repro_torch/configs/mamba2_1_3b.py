"""Mamba2-1.3B: attention-free SSD decoder [arXiv:2405.21060; unverified].
The paper's scheduling technique applies at the serving layer; attention
sharding is N/A (attention-free) — noted in DESIGN.md §Arch-applicability."""
import dataclasses

from ..models.common import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    n_layers=48,
    d_model=2048,
    n_heads=64,            # = d_inner/headdim; attention unused (block=ssm)
    n_kv_heads=64,
    d_ff=0,
    vocab=50280,
    head_dim=64,
    block="ssm",
    ssm=SSMConfig(d_state=128, headdim=64, expand=2),
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        vocab=256, ssm=SSMConfig(d_state=16, headdim=8, expand=2),
        max_seq_len=128,
    )
