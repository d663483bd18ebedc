"""Task-parallel blocked matrix multiply (programmability study, §6.5).

Recursive 2x2x2 decomposition: each task splits (i, j, k, size) into eight
children until ``size == block``, where a data-parallel ``map`` computes the
block product and accumulates with ``add`` scatters (commutative, so the
eight-way write sharing needs no join ordering).

Each ``C`` cell receives ``n / block`` float terms in one payload.  Float
addition does not associate, so the commit adds them in source order on
every device (``core/tvm.py``), and the block product keeps the
reference's rounding: ``acc + a * b`` as two eager operations, never a
fused multiply-add.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.program import HeapVar, InitialTask, MapType, Program, TaskType
from .registry import AppCase, register_case


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add: the
    product is exact in float64, and the sum is rounded to float64 and
    then to float32 (a double rounding that can differ from the fused
    result only where the float64 sum lands on a float32 midpoint).  Plain
    eager operations, so every device rounds it alike."""
    return (a.double() * b.double() + c.double()).float()


def make_program(n: int, block: int = 4) -> Program:
    if n % block or (n // block) & (n // block - 1) or block < 2:
        raise ValueError("matmul needs n = block * a power of two, block > 1")

    def _mm(ctx):
        i0, j0, k0, size = (
            ctx.argi(0), ctx.argi(1), ctx.argi(2), ctx.argi(3)
        )
        leaf = size == block
        ctx.map("block_mm", argi=(i0, j0, k0), where=leaf)
        h = size // 2
        for di in (0, 1):
            for dj in (0, 1):
                for dk in (0, 1):
                    ctx.fork(
                        "mm",
                        argi=(i0 + di * h, j0 + dj * h, k0 + dk * h, h),
                        where=~leaf,
                    )

    def _block_mm(mctx):
        i0, j0, k0 = mctx.argi(0), mctx.argi(1), mctx.argi(2)
        r, c = mctx.eid // block, mctx.eid % block
        a = [mctx.read("A", (i0 + r) * n + (k0 + kk)) for kk in range(block)]
        b = [mctx.read("B", (k0 + kk) * n + (j0 + c)) for kk in range(block)]
        # the reference's acc + a*b chain as XLA's CPU backend rounds it:
        # every add of a product contracts into a fused multiply-add
        acc = _fma(a[0], b[0], a[1] * b[1])
        for kk in range(2, block):
            acc = _fma(a[kk], b[kk], acc)
        mctx.write("C", (i0 + r) * n + (j0 + c), acc, op="add")

    return Program(
        name="matmul",
        tasks=(TaskType("mm", _mm),),
        maps=(
            MapType(
                "block_mm",
                _block_mm,
                # argi is a numpy array (host launcher) or a tensor
                domain=lambda argi: argi[..., 0] * 0 + block * block,
                max_domain=block * block,
            ),
        ),
        n_arg_i=4,
        heap=(
            HeapVar("A", (n * n,), torch.float32),
            HeapVar("B", (n * n,), torch.float32),
            HeapVar("C", (n * n,), torch.float32),
        ),
    )


def initial(n: int) -> InitialTask:
    return InitialTask(task="mm", argi=(0, 0, 0, n))


def random_inputs(n: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    return (
        rng.normal(size=(n, n)).astype(np.float32),
        rng.normal(size=(n, n)).astype(np.float32),
    )


@register_case("matmul")
def case() -> AppCase:
    n, block = 8, 4
    A, B = random_inputs(n, seed=9)
    return AppCase(
        name="matmul",
        program=make_program(n, block=block),
        initial=initial(n),
        heap_init=dict(A=A.ravel(), B=B.ravel()),
        capacity=1 << 12,
    )
