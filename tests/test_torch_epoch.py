"""One epoch of the port against one epoch of the JAX reference.

The JAX package's own ``init_state``, ``EpochScheduler`` and
``EpochLoop.masked_step`` drive k epochs (as ``HostEngine.run`` does); the
resulting TV state and heap are carried over with ``core/convert.py``, and
the next epoch runs in both implementations under the masked, compacted
and gather steps.  Every TV array, the heap, the step's summary scalars and
the scheduled map launches must be equal, exactly.
"""
from __future__ import annotations

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import numpy as np

from _torch_threads import one_torch_thread  # noqa: F401
from repro.apps import fib as jfib
from repro.apps import get_case as jget_case
from repro.core import tvm as jtvm
from repro.core.engine import EpochLoop as JLoop
from repro.core.engine import HostEngine as JHostEngine
from repro.core.scheduler import EpochScheduler as JScheduler
from repro.core.scheduler import NullStats as JNullStats
from repro.core.scheduler import size_type_buckets as jsize_type_buckets
from repro.apps.registry import AppCase as JCase
from repro_torch.apps import fib as tfib
from repro_torch.apps import get_case as tget_case
from repro_torch.apps.registry import AppCase as TCase
from repro_torch.core import convert
from repro_torch.core.engine import EpochLoop as TLoop
from repro_torch.core.scheduler import size_type_buckets

CPU = torch.device("cpu")


def _cases(name):
    if name.startswith("fib10"):
        return (JCase("fib", jfib.PROGRAM, jfib.initial(10), capacity=1 << 10),
                TCase("fib", tfib.PROGRAM, tfib.initial(10), capacity=1 << 10))
    return jget_case(name), tget_case(name)


@functools.lru_cache(maxsize=None)
def _jax_after(name: str, k: int):
    """JAX state, heap and the next popped dispatch after k epochs.

    fib's epochs are type-homogeneous (LIFO order), so ``fib10mix`` turns
    every third lane of the next frontier into a ``fibsum`` continuation
    (no children: it emits 0) to give both task types one epoch."""
    if name == "fib10mix":
        state, heap, d = _jax_after("fib10", k)
        task = np.asarray(state.task).copy()
        task[d.start:d.start + d.count:3] = 1
        return dataclasses.replace(state, task=jnp.asarray(task)), heap, d
    jc, _ = _cases(name)
    prog = jc.program
    state = jtvm.init_state(prog, jc.capacity, jc.initial)
    heap = prog.init_heap(**dict(jc.heap_init))
    loop = JLoop(prog, "masked")
    sched = JScheduler()
    sched.reset()
    for _ in range(k):
        d = sched.pop()
        P = loop.policy.epoch_bucket(d.count)
        state, heap, summary, mls = loop.masked_step(P)(
            state, heap, None, jnp.int32(d.start), jnp.int32(d.count),
            jnp.int32(d.cen),
        )
        tf, join, map_s, _, overflow, nf = jax.device_get(
            JHostEngine._readback(summary, state)
        )
        assert not overflow
        if join:
            sched.push_join(d.cen, d.start, d.count)
        sched.push_forked(d.cen + 1, int(nf) - int(tf), int(tf))
        if map_s:
            heap = loop.maps.run(mls, heap, JNullStats())
    return state, heap, sched.pop()


def _port_inputs(name, k):
    jstate, jheap, d = _jax_after(name, k)
    leaves = {f.name: np.asarray(getattr(jstate, f.name))
              for f in dataclasses.fields(jstate)}
    heap = {n: np.asarray(v) for n, v in jheap.items()}
    return (convert.state_from_numpy(leaves, CPU),
            convert.heap_from_numpy(heap, CPU), jstate, jheap, d)


def _assert_same(j_out, t_out):
    jstate, jheap, jsum, jmls = j_out
    tstate, theap, tsum, tmls = t_out
    tl = convert.state_to_numpy(tstate)
    for f in dataclasses.fields(jstate):
        np.testing.assert_array_equal(
            tl[f.name], np.asarray(getattr(jstate, f.name)), err_msg=f.name
        )
    th = convert.heap_to_numpy(theap)
    for n in jheap:
        np.testing.assert_array_equal(th[n], np.asarray(jheap[n]), err_msg=n)
    for f in ("total_forks", "join_scheduled", "map_scheduled", "n_active",
              "overflow"):
        assert int(getattr(tsum, f)) == int(getattr(jsum, f)), f
    assert len(tmls) == len(jmls)
    for jm, tm in zip(jmls, tmls):
        assert jm.map_id == tm.map_id
        np.testing.assert_array_equal(tm.where.numpy(), np.asarray(jm.where))
        w = np.asarray(jm.where)
        np.testing.assert_array_equal(tm.argi.numpy()[w],
                                      np.asarray(jm.argi)[w])


# (case, k): epochs chosen to cover forks and joins, joins reading
# child_values, both fib types in one epoch, bfs min-writes, mergesort leaf
# writes and a mergesort epoch that schedules map payloads
POINTS = [("fib10", 0), ("fib10", 5), ("fib10", 12), ("fib10mix", 6),
          ("bfs", 1), ("bfs", 2), ("mergesort", 5), ("mergesort", 6)]


@pytest.mark.parametrize("name,k", POINTS)
def test_masked_step_matches_jax(name, k):
    state, heap, jstate, jheap, d = _port_inputs(name, k)
    jc, tc = _cases(name)
    P = JLoop(jc.program, "masked").policy.epoch_bucket(d.count)
    j_out = JLoop(jc.program, "masked").masked_step(P)(
        jstate, jheap, None, jnp.int32(d.start), jnp.int32(d.count),
        jnp.int32(d.cen),
    )
    t_out = TLoop(tc.program, "masked").masked_step(
        state, heap, d.start, d.count, d.cen, P
    )
    _assert_same(j_out, t_out)


@pytest.mark.parametrize("name,k", POINTS)
def test_compacted_step_matches_jax(name, k):
    state, heap, jstate, jheap, d = _port_inputs(name, k)
    jc, tc = _cases(name)
    jloop = JLoop(jc.program, "compacted")
    tloop = TLoop(tc.program, "compacted")
    P = jloop.policy.epoch_bucket(d.count)
    args = (jnp.int32(d.start), jnp.int32(d.count), jnp.int32(d.cen))
    jperm, jcounts = jloop.compact_pass(P)(jstate, *args)
    tperm, tcounts = tloop.compact_pass(state, d.start, d.count, d.cen, P)
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
    counts = np.asarray(jcounts, np.int64)
    names = [t.name for t in jc.program.tasks]
    buckets, toffs, _, _ = jsize_type_buckets(jloop.policy, counts, names)
    assert size_type_buckets(tloop.policy, counts, names)[0] == buckets
    j_out = jloop.compacted_step(P, buckets)(
        jstate, jheap, None, *args, jperm, jnp.asarray(toffs, jnp.int32),
        jnp.asarray(counts, jnp.int32),
    )
    t_out = tloop.compacted_step(
        state, heap, d.start, d.count, d.cen, tperm, toffs, counts, buckets
    )
    _assert_same(j_out, t_out)


@pytest.mark.parametrize("name,k", POINTS)
def test_gather_step_matches_jax(name, k):
    state, heap, jstate, jheap, d = _port_inputs(name, k)
    jc, tc = _cases(name)
    jloop = JLoop(jc.program, "gather")
    tloop = TLoop(tc.program, "gather")
    P = jloop.policy.epoch_bucket(d.count)
    args = (jnp.int32(d.start), jnp.int32(d.count), jnp.int32(d.cen))
    jperm, jn = jloop.gather_pass(P)(jstate, *args)
    tperm, tn = tloop.gather_pass(state, d.start, d.count, d.cen, P)
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))
    assert int(tn) == int(jn)
    G = jloop.policy.epoch_bucket(int(jn))
    j_out = jloop.gather_step(P, G)(jstate, jheap, None, args[0], jperm)
    t_out = tloop.gather_step(state, heap, d.start, tperm, G)
    _assert_same(j_out, t_out)


def test_convert_round_trip():
    state, heap, jstate, jheap, _ = _port_inputs("bfs", 2)
    leaves = convert.state_to_numpy(state)
    for f in dataclasses.fields(jstate):
        np.testing.assert_array_equal(leaves[f.name],
                                      np.asarray(getattr(jstate, f.name)))
    assert state.capacity == jstate.capacity
    assert state.task.shape[0] == jstate.capacity + 1  # the sink row
    back = convert.heap_to_numpy(heap)
    assert set(back) == set(jheap)
    for n in jheap:
        np.testing.assert_array_equal(back[n], np.asarray(jheap[n]))
