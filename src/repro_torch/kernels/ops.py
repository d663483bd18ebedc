"""Public wrappers around the port's kernels, dispatched on the tensor.

A CPU tensor takes the plain PyTorch version in ``ref.py``; a CUDA tensor
launches the hand-written kernel in ``fork_compact.py``, which raises if it
cannot build or launch — there is no fallback from the card to the plain
version.  The choice follows the tensor's device alone.
"""
from __future__ import annotations

import torch

from . import fork_compact, ref


def fork_offsets(counts: torch.Tensor):
    """Exclusive prefix-sum fork allocation: ``(offsets i32[C], total)``."""
    if counts.device.type == "cpu":
        return ref.fork_scan_ref(counts)
    return fork_compact.fork_scan(counts)


def segmented_fork_offsets(counts: torch.Tensor, seg: torch.Tensor,
                           n_segs: int):
    """Per-region exclusive fork allocation (the ``JobArena`` segmented
    scan): ``(offsets i32[C], per-region totals i32[n_segs])``.

    ``seg`` tags each lane with its TV region; each region's forks get
    contiguous offsets among that region's own counts, so the service's
    multi-tenant commit stays bit-identical to the solo scan per region.
    """
    if counts.device.type == "cpu":
        return ref.segmented_fork_scan_ref(counts, seg, n_segs)
    return fork_compact.segmented_fork_scan(counts, seg, n_segs)


def type_rank(types: torch.Tensor, active: torch.Tensor, n_types: int):
    """Stable within-type rank of each active lane + per-type counts.

    The engine's type-compaction stage (§5.4 contiguity): ``dest =
    type_start[type] + rank`` scatters same-type tasks into dense ranges so
    each type executes as one coherent launch.
    """
    if types.device.type == "cpu":
        return ref.type_rank_ref(types, active, n_types)
    return fork_compact.type_rank(types, active, n_types)


def lane_pack(active: torch.Tensor):
    """Stable frontier pack of the scheduled lanes (gather dispatch).

    ``perm[d]`` is the lane position of the d-th scheduled lane (-1 beyond
    the scheduled population) and ``count`` the scheduled population.  On
    the card it rides the ``type_rank`` kernel with a single type
    (rank-among-active is exactly a one-type stable rank), then scatters
    the rank into the permutation in torch.
    """
    if active.device.type == "cpu":
        return ref.lane_pack_ref(active)
    P = active.shape[0]
    rank, counts = fork_compact.type_rank(
        torch.zeros((P,), dtype=torch.int32, device=active.device),
        active, 1,
    )
    return ref.rank_to_perm(rank, active), counts[0]
