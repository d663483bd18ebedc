"""Pre/post-order binary-tree traversal — the paper's running example
(Fig. 2 code, Fig. 3 execution trace, Fig. 4 tree), over lane vectors.

The tree lives in the heap as left/right child index arrays (-1 = NULL).
A visit stamps the node with the value of a visit clock, an ``add``-scatter
counter; every visit of one epoch reads the pre-epoch clock.  Post-order
runs each node's ``visit_after`` as the join continuation of its walk, so
a parent is stamped after both children; pre-order stamps before forking.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.program import HeapVar, InitialTask, Program, TaskType
from .registry import AppCase, register_case


def make_program(n_nodes: int, order: str = "post") -> Program:
    if order not in ("pre", "post"):
        raise ValueError(f"order must be 'pre' or 'post', got {order!r}")

    def _walk(ctx):
        node = ctx.argi(0)
        is_null = node < 0
        left = ctx.read("left", node)
        right = ctx.read("right", node)
        if order == "pre":
            # visit before children: stamp with the epoch-level clock
            ctx.write("visit_clock", 0, 1, op="add", where=~is_null)
            ctx.write(
                "visit_epoch", node, ctx.read("visit_clock", 0), where=~is_null
            )
            ctx.fork("walk", argi=(left,), where=~is_null)
            ctx.fork("walk", argi=(right,), where=~is_null)
        else:
            ctx.fork("walk", argi=(left,), where=~is_null)
            ctx.fork("walk", argi=(right,), where=~is_null)
            ctx.join("visit_after", argi=(node,), where=~is_null)

    def _visit_after(ctx):
        node = ctx.argi(0)
        ctx.write("visit_clock", 0, 1, op="add")
        ctx.write("visit_epoch", node, ctx.read("visit_clock", 0), where=True)

    tasks = [TaskType("walk", _walk)]
    if order == "post":
        tasks.append(TaskType("visit_after", _visit_after))
    return Program(
        name=f"treewalk_{order}",
        tasks=tuple(tasks),
        n_arg_i=1,
        value_width=1,
        value_dtype=torch.int32,
        heap=(
            HeapVar("left", (n_nodes,), torch.int32),
            HeapVar("right", (n_nodes,), torch.int32),
            HeapVar("visit_epoch", (n_nodes,), torch.int32),
            HeapVar("visit_clock", (1,), torch.int32),
        ),
    )


def random_tree(n_nodes: int, seed: int = 0):
    """Random binary tree over nodes 0..n-1 rooted at 0 (the JAX
    package's generator: the same trees from the same seed)."""
    rng = np.random.RandomState(seed)
    left = -np.ones(n_nodes, np.int32)
    right = -np.ones(n_nodes, np.int32)
    slots = [0]  # nodes with a free child pointer
    for v in range(1, n_nodes):
        while True:
            p = slots[rng.randint(len(slots))]
            side = rng.randint(2)
            if side == 0 and left[p] < 0:
                left[p] = v
                break
            if side == 1 and right[p] < 0:
                right[p] = v
                break
            if left[p] >= 0 and right[p] >= 0:
                slots.remove(p)
        slots.append(v)
    return left, right


def depths(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """Depth of every node (root 0) of a tree rooted at node 0."""
    depth = np.zeros(left.shape[0], np.int64)
    level = np.array([0])
    d = 0
    while level.size:
        depth[level] = d
        kids = np.concatenate([left[level], right[level]])
        level = kids[kids >= 0]
        d += 1
    return depth


def treewalk_reference(left: np.ndarray, right: np.ndarray,
                       order: str = "post"):
    """The heap a traversal leaves: ``(visit_epoch, visit_clock)``.

    Every node of one depth is visited in the same epoch (the walk forks
    level by level, and the joins unwind level by level), so each reads
    the clock's count of the nodes visited before its level: the deeper
    nodes in post-order, the shallower ones in pre-order.
    """
    depth = depths(left, right)
    per_level = np.bincount(depth)
    if order == "post":
        before = np.cumsum(per_level[::-1])[::-1] - per_level
    else:
        before = np.cumsum(per_level) - per_level
    visit = before[depth].astype(np.int32)
    return visit, np.array([left.shape[0]], np.int32)


def initial() -> InitialTask:
    return InitialTask(task="walk", argi=(0,))


@register_case("treewalk")
def case() -> AppCase:
    n = 21
    left, right = random_tree(n, seed=11)
    return AppCase(
        name="treewalk",
        program=make_program(n, "post"),
        initial=initial(),
        heap_init=dict(left=left, right=right),
        capacity=1 << 10,
    )
