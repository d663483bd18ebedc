# Distributed execution (PyTorch port of ``repro.distributed``): the sharded
# TVM fleet (DESIGN.md §15).  Gradient compression and the GPipe pipeline
# belong to training, which is not ported.
from .fleet import PLACEMENTS, ShardedFleet, ShardWave  # noqa: F401
