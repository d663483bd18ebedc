"""Public wrappers around the port's kernels, dispatched on the tensor.

A CPU tensor takes the plain PyTorch version in ``ref.py``; a CUDA tensor
launches the hand-written kernel (``fork_compact.py``, ``flash_attention.py``,
``decode_attention.py``, ``ssd_scan.py``), which raises if it cannot build or launch — there
is no fallback from the card to the plain version.  The choice follows the
tensor's device alone.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import decode_attention, flash_attention, fork_compact, ref, ssd_scan


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
    the card the ``type_rank`` kernel's one-type pass writes the pack
    itself, reading ``active`` alone (rank-among-active is exactly a
    one-type stable rank, and the rank is the destination).
    """
    if active.device.type == "cpu":
        return ref.lane_pack_ref(active)
    return fork_compact.lane_pack(active)


def type_pack(types: torch.Tensor, active: torch.Tensor, n_types: int):
    """The compaction stage's permutation: ``(perm i32[C], counts
    i32[n_types])``, each active lane at ``type_start[type] + rank``.

    On the card the ``type_rank`` kernel writes it (a pass and a scatter
    launch); active lanes must carry a type in ``[0, n_types)``.
    """
    if types.device.type == "cpu":
        return ref.type_pack_ref(types, active, n_types)
    return fork_compact.type_pack(types, active, n_types)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, scale: Optional[float] = None,
              q_offset: int = 0, window: int = 0) -> torch.Tensor:
    """GQA attention (B, Hq, Sq, D) x (B, Hkv, Skv, D) -> (B, Hq, Sq, D).

    On the CPU the plain version switches to the blockwise online-softmax
    form beyond 1024 keys, as the reference's does; on the card it is the
    ``flash_attention`` kernel.
    """
    if q.device.type == "cpu":
        if k.shape[2] > 1024:
            return ref.mha_blockwise(q, k, v, causal=causal, scale=scale,
                                     q_offset=q_offset, window=window,
                                     block_k=512)
        return ref.mha_ref(q, k, v, causal=causal, scale=scale,
                           q_offset=q_offset, window=window)
    return flash_attention.flash_attention(q, k, v, causal=causal,
                                           scale=scale, q_offset=q_offset,
                                           window=window)


def gqa_decode(q: torch.Tensor, k_cache: torch.Tensor,
               v_cache: torch.Tensor, lengths: torch.Tensor,
               scale: Optional[float] = None,
               window: int = 0) -> torch.Tensor:
    """Single-token decode attention over a ragged KV cache."""
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k_cache, v_cache, lengths,
                                        scale=scale, window=window)
    return decode_attention.decode_attention(q, k_cache, v_cache, lengths,
                                             scale=scale, window=window)


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, h0: Optional[torch.Tensor] = None):
    """Mamba-2 SSD scan over a batch of sequences: x (Bt, S, H, P), dt
    (Bt, S, H), A (H,), B and C (Bt, S, N), h0 (Bt, H, P, N) or None ->
    (y in x's dtype, final state float32).

    On the CPU the chunked plain version (chunks of 128, as the reference's
    ``ops.ssd`` takes there); on the card the ``ssd_scan`` kernel.
    """
    if x.device.type == "cpu":
        return ref.ssd_chunked(x, dt, A, B, C, h0=h0)
    return ssd_scan.ssd_scan(x, dt, A, B, C, h0=h0)
