"""Task-parallel radix-2 DIT FFT (paper §6.2, Fig. 6 — compute-heavy case).

fork even/odd recursion + join that combines with butterfly ``map`` payloads
(one bulk payload launch per level).  Complex data as separate re/im heap
arrays; levels are double-buffered like mergesort.  Subproblem (base, stride)
reads input element ``j`` at ``base + j*stride``; results land contiguously
at ``[lo, lo+span)`` of the level's buffer.

The twiddles are ``torch.cos``/``torch.sin`` of a float32 angle.  XLA's and
torch's float32 ``cos``/``sin`` are different implementations (neither
correctly rounded), and CUDA's ``cosf``/``sinf`` a third: a few twiddles
differ by one ulp between them, so the heap equals the JAX reference's
and the card's equals the CPU's within a bound, not bit for bit (ROADMAP
§3, "Observed differences").  Every other app of the registry is exact.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.program import HeapVar, InitialTask, MapType, Program, TaskType
from .registry import AppCase, register_case


def make_program(n: int) -> Program:
    if n <= 0 or n & (n - 1):
        raise ValueError("fft needs a power-of-two n")

    def _buf(depth):
        return (depth % 2) * n

    def _fft(ctx):
        base, stride, lo, span, depth = (
            ctx.argi(0), ctx.argi(1), ctx.argi(2), ctx.argi(3), ctx.argi(4)
        )
        leaf = span == 1
        ctx.write("re", _buf(depth) + lo, ctx.read("xr", base), where=leaf)
        ctx.write("im", _buf(depth) + lo, ctx.read("xi", base), where=leaf)
        half = span // 2
        ctx.fork(
            "fft", argi=(base, 2 * stride, lo, half, depth + 1), where=~leaf
        )
        ctx.fork(
            "fft",
            argi=(base + stride, 2 * stride, lo + half, half, depth + 1),
            where=~leaf,
        )
        ctx.join("combine", argi=(lo, span, depth), where=~leaf)

    def _combine(ctx):
        lo, span, depth = ctx.argi(0), ctx.argi(1), ctx.argi(2)
        ctx.map("butterfly", argi=(lo, span, depth))

    def _butterfly(mctx):
        lo, span, depth = mctx.argi(0), mctx.argi(1), mctx.argi(2)
        k = mctx.eid
        half = span // 2
        rbuf = _buf(depth + 1)
        wbuf = _buf(depth)
        er = mctx.read("re", rbuf + lo + k)
        ei = mctx.read("im", rbuf + lo + k)
        orr = mctx.read("re", rbuf + lo + half + k)
        oi = mctx.read("im", rbuf + lo + half + k)
        # the reference's -2*pi*k/span: a float32 product, then a division
        ang = (-2.0 * math.pi) * k.to(torch.float32) / span.to(torch.float32)
        wr, wi = torch.cos(ang), torch.sin(ang)
        tr = wr * orr - wi * oi
        ti = wr * oi + wi * orr
        mctx.write("re", wbuf + lo + k, er + tr)
        mctx.write("im", wbuf + lo + k, ei + ti)
        mctx.write("re", wbuf + lo + half + k, er - tr)
        mctx.write("im", wbuf + lo + half + k, ei - ti)

    return Program(
        name="fft",
        tasks=(TaskType("fft", _fft), TaskType("combine", _combine)),
        maps=(
            MapType(
                "butterfly",
                _butterfly,
                domain=lambda argi: argi[..., 1] // 2,
                max_domain=n // 2,
            ),
        ),
        n_arg_i=5,
        heap=(
            HeapVar("xr", (n,), torch.float32),
            HeapVar("xi", (n,), torch.float32),
            HeapVar("re", (2 * n,), torch.float32),
            HeapVar("im", (2 * n,), torch.float32),
        ),
    )


def initial(n: int) -> InitialTask:
    return InitialTask(task="fft", argi=(0, 1, 0, n, 0))


def random_input(n: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    return (
        rng.normal(size=n).astype(np.float32),
        rng.normal(size=n).astype(np.float32),
    )


def fft_reference(xr: np.ndarray, xi: np.ndarray) -> np.ndarray:
    return np.fft.fft(xr.astype(np.float64) + 1j * xi.astype(np.float64))


@register_case("fft")
def case() -> AppCase:
    n = 32
    xr, xi = random_input(n, seed=7)
    return AppCase(
        name="fft",
        program=make_program(n),
        initial=initial(n),
        heap_init=dict(xr=xr, xi=xi),
        capacity=1 << 12,
    )
