"""Task-parallel mergesort, naive and ``map``-accelerated (paper §6.4,
Fig. 9).

Double-buffered merge: level ``depth`` reads buffer ``(depth+1) % 2`` and
writes buffer ``depth % 2``; leaves sit at depth ``log2(n)``.  Each element's
merged position is its own offset plus its rank in the sibling half (binary
search, static log2 steps).

Two variants, matching the paper's comparison exactly:
  * ``naive`` — each merge **forks one task per element** (``n`` static
    fork sites, ``place1``): the per-element placement pays full fork
    overhead, which is why the paper's naive mergesort "performs
    abysmally";
  * ``map`` — each merge schedules **one data-parallel map** over its
    span; all merges of a level land in a single bulk payload launch
    (§4.2's point: map amortizes overhead over regular data parallelism).

The map payload runs on ``[P, D]`` broadcasts (lanes x elements): its
``argi`` columns are ``[P, 1]`` and ``eid`` is ``[1, D]``.  The map body
keeps the qualname ``make_program.<locals>._place``: the ``epoch_chunk``
kernel's device table for the map variant is found by it.
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


def make_program(n: int, use_map: bool) -> Program:
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
        if use_map:
            ctx.map("place", argi=(lo, span, depth))
        else:
            # fork one placement task per element (static sites = n)
            for i in range(n):
                ctx.fork("place1", argi=(lo, span, depth, i), where=i < span)

    def _place_common(ctx, lo, span, depth, i):
        half = span // 2
        rbuf = _buf(depth + 1)  # read children's buffer
        wbuf = _buf(depth)
        from_left = i < half
        own_off = torch.where(from_left, i, i - half)
        other_lo = rbuf + torch.where(from_left, lo + half, lo)
        v = ctx.read("src", rbuf + lo + i)
        rank = _rank_in_other(ctx, v, other_lo, half, from_left, log_n)
        ctx.write("src", wbuf + lo + own_off + rank, v)

    def _place1(ctx):
        _place_common(ctx, ctx.argi(0), ctx.argi(1), ctx.argi(2),
                      ctx.argi(3))

    def _place(mctx):
        _place_common(mctx, mctx.argi(0), mctx.argi(1), mctx.argi(2),
                      mctx.eid)

    # MapCtx lacks fork/join, so _place_common uses only read/write/args
    tasks = [TaskType("msort", _msort), TaskType("merge", _merge)]
    maps = []
    if use_map:
        maps.append(MapType("place", _place, domain=lambda argi: argi[..., 1],
                            max_domain=n))
    else:
        tasks.append(TaskType("place1", _place1))

    return Program(
        name=f"mergesort_{'map' if use_map else 'naive'}",
        tasks=tuple(tasks),
        maps=tuple(maps),
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
        program=make_program(n, use_map=True),
        initial=initial(n),
        heap_init=dict(inp=random_input(n, seed=5)),
        capacity=1 << 12,
    )
