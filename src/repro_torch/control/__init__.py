"""Self-tuning controllers (DESIGN.md §14; PyTorch port of
``repro.control``): telemetry -> policy -> dispatch."""
from .controller import (
    AUTO_MODES,
    RESIDENT_AUTO_MODES,
    ChunkController,
    CostModel,
    Decision,
    DispatchController,
    RollingWindow,
)

__all__ = [
    "AUTO_MODES",
    "RESIDENT_AUTO_MODES",
    "ChunkController",
    "CostModel",
    "Decision",
    "DispatchController",
    "RollingWindow",
]
