"""Naive task-parallel Fibonacci (paper §6.2, Fig. 5).

The paper's worst case: virtually no computation per task, so the measured
time is almost entirely runtime overhead — fib is the V1/V_inf microscope.

    fib(n): if n < 2: emit n
            else:     fork fib(n-1); fork fib(n-2); join fibsum()
    fibsum: emit child_values[0] + child_values[1]
"""
from __future__ import annotations

import torch

from ..core.program import InitialTask, Program, TaskType
from .registry import AppCase, register_case


def _fib(ctx):
    n = ctx.argi(0)
    leaf = n < 2
    ctx.emit(n, where=leaf)
    ctx.fork("fib", argi=(n - 1,), where=~leaf)
    ctx.fork("fib", argi=(n - 2,), where=~leaf)
    ctx.join("fibsum", where=~leaf)


def _fibsum(ctx):
    cv = ctx.child_values(2)  # [P, 2, 1]
    ctx.emit(cv[:, 0, 0] + cv[:, 1, 0])


PROGRAM = Program(
    name="fib",
    tasks=(TaskType("fib", _fib), TaskType("fibsum", _fibsum)),
    n_arg_i=1,
    value_width=1,
    value_dtype=torch.int32,
)


def initial(n: int) -> InitialTask:
    return InitialTask(task="fib", argi=(n,))


def fib_reference(n: int) -> int:
    a, b = 0, 1
    for _ in range(n):
        a, b = b, a + b
    return a


@register_case("fib")
def case() -> AppCase:
    return AppCase(
        name="fib", program=PROGRAM, initial=initial(12), capacity=1 << 13
    )
