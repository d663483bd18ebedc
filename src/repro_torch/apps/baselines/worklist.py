"""Hand-coded worklist BFS / SSSP — a port of the LonestarGPU benchmarks.

The Lonestar kernels use input/output worklists with an atomically bumped
tail pointer and relaunch until the output list is empty (paper §6.3).  The
dense equivalent of a push worklist is a frontier mask with edge-parallel
relaxation and a segment-min scatter (``scatter_reduce_("amin")``); the
host reads a single "anything relaxed?" scalar per round — the analogue of
Lonestar's one-int transfer per kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core.engine import resolve_device
from ..bfs import INF
from ..sssp import INF_F


def _edge_src(adj_off: np.ndarray) -> np.ndarray:
    deg = np.diff(adj_off)
    return np.repeat(np.arange(len(deg)), deg).astype(np.int64)


def _segment_min(n: int, fill, dst: torch.Tensor, cand: torch.Tensor):
    out = torch.full((n,), fill, dtype=cand.dtype, device=cand.device)
    return out.scatter_reduce_(0, dst, cand, "amin", include_self=True)


def bfs_worklist(adj_off, adj, src: int, n: int, device=None):
    """Returns ``(dist i32[n], rounds)``.  One round of launches and one
    scalar readback per BFS level."""
    dev = resolve_device(device)
    edge_src = torch.as_tensor(_edge_src(adj_off), device=dev)
    dst = torch.as_tensor(np.asarray(adj), device=dev).long()
    dist = torch.full((n,), int(INF), dtype=torch.int32, device=dev)
    dist[src] = 0
    frontier = torch.zeros((n,), dtype=torch.bool, device=dev)
    frontier[src] = True
    d = 0
    while True:
        cand = torch.where(frontier[edge_src], d + 1, int(INF)).to(torch.int32)
        relaxed = _segment_min(n, int(INF), dst, cand)
        new_dist = torch.minimum(dist, relaxed)
        frontier = new_dist < dist
        dist = new_dist
        d += 1
        if not bool(frontier.any()):  # the single-int host transfer
            return dist, d


def sssp_worklist(adj_off, adj, wgt, src: int, n: int, device=None):
    """Bellman-Ford rounds over the dense edge list (Lonestar-style).
    Returns ``(dist f32[n], rounds)``."""
    dev = resolve_device(device)
    edge_src = torch.as_tensor(_edge_src(adj_off), device=dev)
    dst = torch.as_tensor(np.asarray(adj), device=dev).long()
    w = torch.as_tensor(np.asarray(wgt, np.float32), device=dev)
    dist = torch.full((n,), float(INF_F), dtype=torch.float32, device=dev)
    dist[src] = 0.0
    rounds = 0
    while True:
        cand = dist[edge_src] + w
        relaxed = _segment_min(n, float(INF_F), dst, cand)
        new_dist = torch.minimum(dist, relaxed)
        more = bool((new_dist < dist).any())
        dist = new_dist
        rounds += 1
        if not more:
            return dist, rounds
