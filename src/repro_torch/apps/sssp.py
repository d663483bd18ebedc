"""Task-parallel single-source shortest paths (paper §6.3, Fig. 8).

Same chunked-expansion structure as BFS, with float tentative distances in
``argf`` and edge weights in the heap — the relax-with-min-write formulation
the LonestarGPU ``sssp`` worklist uses.  ``argf`` rides every fork, commit,
pack and the resident carry as the TV's float argument register.

The weight generator and the sequential Dijkstra reference are this
package's own copies of the JAX reference's (``random_graph`` is the port's
``bfs`` generator), so the same seeds give the same weighted graph.
"""
from __future__ import annotations

import heapq

import numpy as np
import torch

from ..core.program import HeapVar, InitialTask, Program, TaskType
from .bfs import random_graph  # noqa: F401  (re-exported)
from .registry import AppCase, register_case

INF_F = np.float32(3.0e38)
CHUNK = 8


def make_program(n_nodes: int, n_edges: int) -> Program:
    def _relax(ctx):
        v, chunk = ctx.argi(0), ctx.argi(1)
        d = ctx.argf(0)
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
            nd = d + ctx.read("wgt", off + e)
            stale = ctx.read("dist", u) <= nd
            ctx.fork(
                "relax", argi=(u, 0), argf=(nd,),
                where=live & (e < deg) & ~stale,
            )
        ctx.fork(
            "relax", argi=(v, chunk + 1), argf=(d,),
            where=live & (base + CHUNK < deg),
        )

    return Program(
        name="sssp",
        tasks=(TaskType("relax", _relax),),
        n_arg_i=2,
        n_arg_f=1,
        heap=(
            HeapVar("adj_off", (n_nodes + 1,), torch.int32),
            HeapVar("adj", (max(n_edges, 1),), torch.int32),
            HeapVar("wgt", (max(n_edges, 1),), torch.float32),
            HeapVar("dist", (n_nodes,), torch.float32),
        ),
    )


def initial(src: int = 0) -> InitialTask:
    return InitialTask(task="relax", argi=(src, 0), argf=(0.0,))


def random_weights(n_edges: int, seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    return rng.uniform(0.1, 10.0, size=max(n_edges, 1)).astype(np.float32)


def heap_init(adj_off, adj, wgt, n: int):
    dist = np.full(n, INF_F, np.float32)
    return dict(adj_off=adj_off, adj=adj, wgt=wgt, dist=dist)


def sssp_reference(adj_off, adj, wgt, src: int, n: int) -> np.ndarray:
    """Sequential Dijkstra (CPU comparison point)."""
    dist = np.full(n, np.float64(INF_F))
    dist[src] = 0.0
    pq = [(0.0, src)]
    while pq:
        d, v = heapq.heappop(pq)
        if d > dist[v]:
            continue
        for e in range(adj_off[v], adj_off[v + 1]):
            u, nd = adj[e], d + wgt[e]
            if nd < dist[u]:
                dist[u] = nd
                heapq.heappush(pq, (nd, u))
    return dist.astype(np.float32)


@register_case("sssp")
def case() -> AppCase:
    n = 48
    adj_off, adj = random_graph(n, avg_degree=4, seed=7)
    wgt = random_weights(len(adj), seed=2)
    return AppCase(
        name="sssp",
        program=make_program(n, len(adj)),
        initial=initial(0),
        heap_init=heap_init(adj_off, adj, wgt, n),
        capacity=1 << 14,
    )
