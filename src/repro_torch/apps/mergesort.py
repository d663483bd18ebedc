"""Task-parallel mergesort with ``map``-accelerated merges (paper §6.4,
Fig. 9): the ``use_map=True`` variant of the JAX reference.

Double-buffered merge: level ``depth`` reads buffer ``(depth+1) % 2`` and
writes buffer ``depth % 2``; leaves sit at depth ``log2(n)``.  Each element's
merged position is its own offset plus its rank in the sibling half (binary
search, static log2 steps).  Each merge schedules **one data-parallel map**
over its span; all merges of a level land in a single bulk payload launch
(§4.2's point: map amortizes overhead over regular data parallelism).

The map payload runs on ``[P, D]`` broadcasts (lanes x elements): its
``argi`` columns are ``[P, 1]`` and ``eid`` is ``[1, D]``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.program import HeapVar, InitialTask, MapType, Program, TaskType
from .registry import AppCase, register_case


def _rank_in_other(ctx, v, other_lo, half, from_left, log_max):
    """Rank of v within buf[other_lo : other_lo+half] (binary search).

    Left-half elements win ties (stable merge): left counts strict '<',
    right counts '<='.
    """
    lo = torch.zeros(v.shape, dtype=torch.int32, device=v.device)
    hi = lo + half  # search in [lo, hi)
    for _ in range(log_max):
        mid = (lo + hi) // 2
        x = ctx.read("src", other_lo + torch.minimum(mid.clamp(min=0),
                                                     half - 1))
        go_right = torch.where(from_left, x < v, x <= v) & (lo < hi)
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    return lo


def make_program(n: int) -> Program:
    if n <= 0 or n & (n - 1):
        raise ValueError("mergesort needs a power-of-two n")
    log_n = int(math.log2(n))

    # src/dst aliases: logical double buffer packed in one heap array of 2n;
    # buffer b occupies [b*n, b*n+n).
    def _buf(depth):
        return (depth % 2) * n

    def _msort(ctx):
        lo, span, depth = ctx.argi(0), ctx.argi(1), ctx.argi(2)
        leaf = span == 1
        # leaf: copy input element into this level's write buffer
        ctx.write("src", _buf(depth) + lo, ctx.read("inp", lo), where=leaf)
        half = span // 2
        ctx.fork("msort", argi=(lo, half, depth + 1), where=~leaf)
        ctx.fork("msort", argi=(lo + half, half, depth + 1), where=~leaf)
        ctx.join("merge", argi=(lo, span, depth), where=~leaf)

    def _merge(ctx):
        lo, span, depth = ctx.argi(0), ctx.argi(1), ctx.argi(2)
        ctx.map("place", argi=(lo, span, depth))

    def _place(mctx):
        lo, span, depth = mctx.argi(0), mctx.argi(1), mctx.argi(2)
        i = mctx.eid
        half = span // 2
        rbuf = _buf(depth + 1)  # read children's buffer
        wbuf = _buf(depth)
        from_left = i < half
        own_off = torch.where(from_left, i, i - half)
        other_lo = rbuf + torch.where(from_left, lo + half, lo)
        v = mctx.read("src", rbuf + lo + i)
        rank = _rank_in_other(mctx, v, other_lo, half, from_left, log_n)
        mctx.write("src", wbuf + lo + own_off + rank, v)

    return Program(
        name="mergesort_map",
        tasks=(TaskType("msort", _msort), TaskType("merge", _merge)),
        maps=(
            MapType("place", _place, domain=lambda argi: argi[..., 1],
                    max_domain=n),
        ),
        n_arg_i=4,
        heap=(
            HeapVar("inp", (n,), torch.float32),
            HeapVar("src", (2 * n,), torch.float32),
        ),
    )


def initial(n: int) -> InitialTask:
    return InitialTask(task="msort", argi=(0, n, 0))


def result_buffer(n: int) -> slice:
    """Final sorted data lives in buffer depth-0 (= slice [0, n))."""
    return slice(0, n)


def random_input(n: int, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed).uniform(-1, 1, n).astype(np.float32)


@register_case("mergesort")
def case() -> AppCase:
    n = 32
    return AppCase(
        name="mergesort",
        program=make_program(n),
        initial=initial(n),
        heap_init=dict(inp=random_input(n, seed=5)),
        capacity=1 << 12,
    )
