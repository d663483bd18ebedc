"""Whisper-large-v3 backbone: encoder-decoder, LayerNorm, MHA (kv=q=20).
The conv/audio frontend is a STUB: input_specs() provides precomputed frame
embeddings (B, 1500, d) [arXiv:2212.04356; unverified]."""
import dataclasses

from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    n_layers=32,
    n_encoder_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51866,
    head_dim=64,
    encdec=True,
    encoder_len=1500,
    norm="ln",
    frontend="audio",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, n_encoder_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, vocab=256, encoder_len=16,
        max_seq_len=128,
    )
