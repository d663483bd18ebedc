"""Architecture registry: one module per architecture (dense attention,
MoE, encoder-decoder, the Mamba-2 SSM and the attention ∥ SSM hybrid),
plus the input-shape table and per-cell skip rules (a copy of
``repro/configs/__init__.py``)."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional

from ..models.common import ModelConfig

ARCH_IDS = (
    "yi_34b",
    "deepseek_67b",
    "granite_3_8b",
    "command_r_35b",
    "whisper_large_v3",
    "mamba2_1_3b",
    "granite_moe_1b_a400m",
    "llama4_scout_17b_a16e",
    "hymba_1_5b",
    "chameleon_34b",
)

def normalize(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def _module(arch: str):
    return importlib.import_module(f".{normalize(arch)}", __package__)


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    """Small same-family config for CPU smoke tests."""
    return _module(arch).reduced()


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str        # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    s.name: s
    for s in (
        ShapeSpec("train_4k", "train", 4096, 256),
        ShapeSpec("prefill_32k", "prefill", 32768, 32),
        ShapeSpec("decode_32k", "decode", 32768, 128),
        ShapeSpec("long_500k", "decode", 524288, 1),
    )
}


def skip_reason(cfg: ModelConfig, shape: ShapeSpec) -> Optional[str]:
    """Per-spec skip rules; None = run the cell."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return "full quadratic attention; long_500k needs sub-quadratic"
    return None
