# Data substrate: the deterministic synthetic token pipeline (step-indexed,
# so a restart replays exactly), sequence packing, placement on the device.
from .pipeline import PackedDataset, SyntheticLM, place_batch  # noqa: F401
