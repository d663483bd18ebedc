"""Task-parallel BFS (paper §6.3, Fig. 7 — Lonestar comparison).

Graph is CSR in the heap (``adj_off``, ``adj``).  A ``visit(v, d, chunk)``
task claims vertex ``v`` at depth ``d`` by a scatter-min on ``dist`` and
expands its out-edges in chunks of ``CHUNK`` static fork sites (variable
out-degree -> static site count, the TVM requirement), plus one site that
forks the next chunk: 9 fork sites.  Duplicate visits are filtered against
the pre-epoch ``dist`` snapshot; the min-write makes them harmless.

The input generator and the sequential reference are this package's own
copies of the JAX reference's, so the same seed gives the same graph.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.program import HeapVar, InitialTask, Program, TaskType
from .registry import AppCase, register_case

INF = np.int32(2**30)
CHUNK = 8


def make_program(n_nodes: int, n_edges: int) -> Program:
    def _visit(ctx):
        v, d, chunk = ctx.argi(0), ctx.argi(1), ctx.argi(2)
        off = ctx.read("adj_off", v)
        deg = ctx.read("adj_off", v + 1) - off
        first = chunk == 0
        improve = d < ctx.read("dist", v)
        live = ~first | improve  # where(first, improve, True)
        ctx.write("dist", v, d, op="min", where=first & improve)
        base = chunk * CHUNK
        for i in range(CHUNK):
            e = base + i
            u = ctx.read("adj", off + e)
            stale = ctx.read("dist", u) <= d + 1
            ctx.fork(
                "visit", argi=(u, d + 1, 0),
                where=live & (e < deg) & ~stale,
            )
        ctx.fork(
            "visit", argi=(v, d, chunk + 1),
            where=live & (base + CHUNK < deg),
        )

    return Program(
        name="bfs",
        tasks=(TaskType("visit", _visit),),
        n_arg_i=3,
        heap=(
            HeapVar("adj_off", (n_nodes + 1,), torch.int32),
            HeapVar("adj", (max(n_edges, 1),), torch.int32),
            HeapVar("dist", (n_nodes,), torch.int32),
        ),
    )


def initial(src: int = 0) -> InitialTask:
    return InitialTask(task="visit", argi=(src, 0, 0))


def random_graph(n: int, avg_degree: int = 4, seed: int = 0):
    """Random directed graph in CSR, guaranteed weakly reachable-ish."""
    rng = np.random.RandomState(seed)
    dst = [rng.randint(0, n, size=rng.poisson(avg_degree)) for _ in range(n)]
    # add a random spanning path so most nodes are reachable from 0
    perm = rng.permutation(n)
    for i in range(n - 1):
        dst[perm[i]] = np.append(dst[perm[i]], perm[i + 1])
    dst[0] = np.append(dst[0], perm[0])
    deg = np.array([len(d) for d in dst])
    adj_off = np.zeros(n + 1, np.int32)
    adj_off[1:] = np.cumsum(deg)
    adj = np.concatenate(dst).astype(np.int32) if deg.sum() else np.zeros(1, np.int32)
    return adj_off, adj


def heap_init(adj_off, adj, n: int):
    dist = np.full(n, INF, np.int32)
    return dict(adj_off=adj_off, adj=adj, dist=dist)


def bfs_reference(adj_off, adj, src: int, n: int) -> np.ndarray:
    """Sequential CPU BFS (the paper's CPU comparison point)."""
    dist = np.full(n, INF, np.int64)
    dist[src] = 0
    q = [src]
    while q:
        nxt = []
        for v in q:
            for e in range(adj_off[v], adj_off[v + 1]):
                u = adj[e]
                if dist[u] > dist[v] + 1:
                    dist[u] = dist[v] + 1
                    nxt.append(u)
        q = nxt
    return dist.astype(np.int32)


@register_case("bfs")
def case() -> AppCase:
    n = 64
    adj_off, adj = random_graph(n, avg_degree=4, seed=0)
    return AppCase(
        name="bfs",
        program=make_program(n, len(adj)),
        initial=initial(0),
        heap_init=heap_init(adj_off, adj, n),
        capacity=1 << 14,
    )
