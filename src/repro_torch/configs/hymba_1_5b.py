"""Hymba-1.5B: hybrid parallel attention+SSM heads per layer, sliding-window
attention with periodic global layers [arXiv:2411.13676; hf]."""
import dataclasses

from ..models.common import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab=32001,
    head_dim=64,
    block="hybrid",
    ssm=SSMConfig(d_state=16, headdim=64, expand=2),
    sliding_window=2048,
    global_layer_every=16,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, ssm=SSMConfig(d_state=8, headdim=8, expand=2),
        sliding_window=32, global_layer_every=2, max_seq_len=128,
    )
