"""Task-parallel traveling salesman (exact, branch-and-bound-lite) — from
the paper's programmability study (§6.5).

Each task extends a partial tour by one unvisited city (N static fork
sites); complete tours scatter-min into the best-cost cell.  Pruning
against the pre-epoch best bound trims subtrees — the data-driven
irregularity TREES is built for (subtree sizes are unknowable upfront; the
epoch engine load-balances them for free).

Distances are fixed-point (×1024) int32 so min-scatters stay exact.  The
instance generator, the greedy bound and the brute-force reference are
this package's own copies of the JAX reference's, so the same seed gives
the same instance.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from ..core.program import HeapVar, InitialTask, Program, TaskType
from .registry import AppCase, register_case

SCALE = 1024


def make_program(n: int) -> Program:
    def _extend(ctx):
        # argi: [current city, visited bitmask, cost so far (fixed point)]
        cur, visited, cost = ctx.argi(0), ctx.argi(1), ctx.argi(2)
        all_visited = visited == (1 << n) - 1
        # close the tour back to city 0
        back = ctx.read("dist", cur * n + 0)
        ctx.write("best", 0, cost + back, op="min", where=all_visited)
        bound = ctx.read("best", 0)
        for c in range(1, n):
            seen = ((visited >> c) & 1) == 1
            step = ctx.read("dist", cur * n + c)
            nc = cost + step
            ctx.fork(
                "extend",
                argi=(c, visited | (1 << c), nc),
                where=~all_visited & ~seen & (nc < bound),
            )

    return Program(
        name="tsp",
        tasks=(TaskType("extend", _extend),),
        n_arg_i=3,
        heap=(
            HeapVar("dist", (n * n,), torch.int32),
            HeapVar("best", (1,), torch.int32),
        ),
    )


def initial() -> InitialTask:
    return InitialTask(task="extend", argi=(0, 1, 0))


def random_instance(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    pts = rng.rand(n, 2)
    d = np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1))
    return np.round(d * SCALE).astype(np.int32)


def greedy_bound(dist: np.ndarray) -> int:
    """Nearest-neighbour tour cost — the initial branch-and-bound bound.

    Breadth-first epoch expansion (the TVM model) completes all tours in the
    *last* epochs, so without an a-priori bound no subtree is ever pruned;
    seeding ``best`` with a greedy tour restores pruning (a host-side
    phase-1 responsibility, where the paper puts serial setup work)."""
    n = dist.shape[0]
    seen = {0}
    cur, cost = 0, 0
    while len(seen) < n:
        nxt = min(
            (c for c in range(n) if c not in seen),
            key=lambda c: dist[cur, c],
        )
        cost += int(dist[cur, nxt])
        seen.add(nxt)
        cur = nxt
    return cost + int(dist[cur, 0])


def heap_init(dist: np.ndarray):
    bound = greedy_bound(dist)
    return dict(dist=dist.ravel(), best=np.asarray([bound], np.int32))


def tsp_reference(dist: np.ndarray) -> int:
    """Exact brute force over the (n-1)! tours from city 0 (n <= ~10)."""
    n = dist.shape[0]
    best = 2**30
    for perm in itertools.permutations(range(1, n)):
        cost = dist[0, perm[0]]
        for a, b in zip(perm, perm[1:]):
            cost += dist[a, b]
        cost += dist[perm[-1], 0]
        best = min(best, int(cost))
    return best


@register_case("tsp")
def case() -> AppCase:
    n = 6
    dist = random_instance(n, seed=3)
    return AppCase(
        name="tsp",
        program=make_program(n),
        initial=initial(),
        heap_init=heap_init(dist),
        capacity=1 << 14,
    )
