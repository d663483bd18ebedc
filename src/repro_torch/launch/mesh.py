"""The sharded fleet's device layout (PyTorch port of the fleet half of
``repro/launch/mesh.py``).

:func:`make_fleet_mesh` says where a fleet of P shards runs.  The port has
the single-device form: every shard's carry on one device, each shard's
chunk launched in turn (``EpochLoop.run_chunk_fleet``).  The multi-device
form, shard ``p`` on ``cuda:p``, is not ported: where it would apply (P or
more CUDA devices attached) this raises rather than quietly running the
single-device form.  The reference's ``fleet_shard_map`` has no
counterpart; the launch loop of ``run_chunk_fleet`` takes its place.  The
production-mesh half of the reference's module (``make_production_mesh``,
the sharding rules) belongs to training, which is not ported.
"""
from __future__ import annotations

import torch


def make_fleet_mesh(shards: int):
    """``None`` (the single-device form) at one shard, or where fewer than
    ``shards`` CUDA devices are attached; raises ``ValueError`` below one
    shard and ``NotImplementedError`` where the multi-device form would
    apply."""
    if shards < 1:
        raise ValueError(f"a fleet needs >= 1 shard, got {shards}")
    if shards == 1 or torch.cuda.device_count() < shards:
        return None
    raise NotImplementedError(
        f"a fleet of {shards} shards on {torch.cuda.device_count()} CUDA "
        "devices: the multi-device form (shard p on cuda:p) is not ported "
        "to the PyTorch package yet (ROADMAP item 9)")
