"""N-queens counting — from the paper's programmability study (§6.5).

Classic task-per-partial-placement formulation: ``place(row, cols, d1, d2)``
forks one child per non-attacked column (N static fork sites); completed
boards bump a heap counter with a conflict-free int ``add`` scatter.
"""
from __future__ import annotations

import torch

from ..core.program import HeapVar, InitialTask, Program, TaskType
from .registry import AppCase, register_case

SOLUTIONS = {4: 2, 5: 10, 6: 4, 7: 40, 8: 92, 9: 352, 10: 724, 11: 2680,
             12: 14200}


def make_program(n: int) -> Program:
    def _place(ctx):
        row, cols, d1, d2 = (
            ctx.argi(0), ctx.argi(1), ctx.argi(2), ctx.argi(3)
        )
        done = row == n
        ctx.write("count", 0, 1, op="add", where=done)
        for c in range(n):
            attacked = (
                ((cols >> c) & 1)
                | ((d1 >> (row + c)) & 1)
                | ((d2 >> (row - c + n - 1)) & 1)
            ) == 1
            ctx.fork(
                "place",
                argi=(
                    row + 1,
                    cols | (1 << c),
                    d1 | (1 << (row + c)),
                    d2 | (1 << (row - c + n - 1)),
                ),
                where=~done & ~attacked,
            )

    return Program(
        name="nqueens",
        tasks=(TaskType("place", _place),),
        n_arg_i=4,
        heap=(HeapVar("count", (1,), torch.int32),),
    )


def initial() -> InitialTask:
    return InitialTask(task="place", argi=(0, 0, 0, 0))


@register_case("nqueens")
def case() -> AppCase:
    return AppCase(
        name="nqueens",
        program=make_program(6),
        initial=initial(),
        capacity=1 << 13,
    )
