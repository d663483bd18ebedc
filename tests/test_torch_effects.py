"""Effect-API coverage beyond the ported apps: the same small program written
once per lane for the JAX reference and once over lane vectors for the
port, run by both ``HostEngine``s under every dispatch.

It uses what fib, bfs and mergesort do not: ``add`` and ``max`` heap
writes, float ``min`` writes, a float argument register (``argf``), a
two-wide float ``value``, per-lane fork task codes, and epochs that mix
three task types (so the compacted dispatch launches several types).
Heaps, values and every ``RunStats`` field must be equal, exactly.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np

from _torch_threads import one_torch_thread  # noqa: F401
from repro.core import HeapVar as JHeapVar
from repro.core import HostEngine as JHostEngine
from repro.core import InitialTask as JInitialTask
from repro.core import Program as JProgram
from repro.core import TaskType as JTaskType
from repro_torch.core import HeapVar, HostEngine, InitialTask, Program, TaskType

DEPTH = 5
NODE, SUM, LEAF = 0, 1, 2
HEAP_INIT = dict(
    deep=np.full(DEPTH + 1, -1, np.int32),
    lo=np.full(DEPTH + 1, 1e9, np.float32),
)


def _heap(hv, i32, f32):
    return (
        hv("hits", (16,), i32),
        hv("deep", (DEPTH + 1,), i32),
        hv("leafv", (2 ** (DEPTH + 2),), f32),
        hv("lo", (DEPTH + 1,), f32),
    )


# ---------------------------------------------------------- JAX, per lane
def _j_node(ctx):
    d, i, f = ctx.argi(0), ctx.argi(1), ctx.argf(0)
    ctx.write("hits", i % 16, 1, op="add")
    ctx.write("deep", d, i, op="max")
    child = jnp.where((d + 1 == DEPTH) | (i % 3 == 2), LEAF, NODE)
    ctx.fork(child, argi=(d + 1, 2 * i), argf=(f * 0.5,))
    ctx.fork(child, argi=(d + 1, 2 * i + 1), argf=(f + 1.0,))
    ctx.join("sum", argi=(d, i))


def _j_sum(ctx):
    cv = ctx.child_values(2)
    ctx.write("lo", ctx.argi(0), cv[0, 0], op="min")
    ctx.emit(cv[0] + cv[1])


def _j_leaf(ctx):
    i, f = ctx.argi(1), ctx.argf(0)
    ctx.write("leafv", i, f)
    ctx.emit(jnp.stack([f, i.astype(jnp.float32)]))


J_PROGRAM = JProgram(
    name="effects",
    tasks=(JTaskType("node", _j_node), JTaskType("sum", _j_sum),
           JTaskType("leaf", _j_leaf)),
    n_arg_i=2, n_arg_f=1, value_width=2, value_dtype=jnp.float32,
    heap=_heap(JHeapVar, jnp.int32, jnp.float32),
)


# --------------------------------------------------- port, lane vectors
def _t_node(ctx):
    d, i, f = ctx.argi(0), ctx.argi(1), ctx.argf(0)
    ctx.write("hits", i % 16, 1, op="add")
    ctx.write("deep", d, i, op="max")
    child = torch.where((d + 1 == DEPTH) | (i % 3 == 2), LEAF, NODE)
    ctx.fork(child, argi=(d + 1, 2 * i), argf=(f * 0.5,))
    ctx.fork(child, argi=(d + 1, 2 * i + 1), argf=(f + 1.0,))
    ctx.join("sum", argi=(d, i))


def _t_sum(ctx):
    cv = ctx.child_values(2)  # [P, 2, 2]
    ctx.write("lo", ctx.argi(0), cv[:, 0, 0], op="min")
    ctx.emit(cv[:, 0] + cv[:, 1])


def _t_leaf(ctx):
    i, f = ctx.argi(1), ctx.argf(0)
    ctx.write("leafv", i, f)
    ctx.emit(torch.stack([f, i.to(torch.float32)], dim=1))


T_PROGRAM = Program(
    name="effects",
    tasks=(TaskType("node", _t_node), TaskType("sum", _t_sum),
           TaskType("leaf", _t_leaf)),
    n_arg_i=2, n_arg_f=1, value_width=2, value_dtype=torch.float32,
    heap=_heap(HeapVar, torch.int32, torch.float32),
)


@pytest.mark.parametrize("dispatch", ("masked", "compacted", "gather"))
def test_effects_program_matches_jax(dispatch):
    jh, jv, js = JHostEngine(J_PROGRAM, capacity=1 << 8,
                             dispatch=dispatch).run(
        JInitialTask("node", argi=(0, 1), argf=(3.0,)), heap_init=HEAP_INIT
    )
    th, tv, ts = HostEngine(T_PROGRAM, capacity=1 << 8, dispatch=dispatch,
                            device="cpu").run(
        InitialTask("node", argi=(0, 1), argf=(3.0,)), heap_init=HEAP_INIT
    )
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    for k in jh:
        np.testing.assert_array_equal(th[k].numpy(), np.asarray(jh[k]),
                                      err_msg=k)
    assert ts.as_dict() == js.as_dict()
    # the program did exercise what it is here for: every depth above the
    # leaves saw a node, min-writes landed, leaves wrote their floats
    assert (th["deep"].numpy()[:DEPTH] >= 0).all()
    assert (th["lo"].numpy()[:DEPTH - 1] < 1e9).all()
    assert int((th["leafv"] != 0).sum()) > 4
    assert float(tv[0, 1]) > 0
    if dispatch == "compacted":
        assert len(ts.lanes_by_type) == 3
