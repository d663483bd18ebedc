"""The port's resident ``DeviceEngine`` against the JAX ``DeviceEngine``.

JAX runs on the CPU with its default chunk implementation (the
``lax.while_loop`` oracle); the port runs its plain loop on the CPU.  On
the registry's fib, bfs and mergesort (map) cases under the masked and
gather dispatches, the heap, the TV values and every ``RunStats`` field
must be equal, exactly; so must the batched device stacks, the width
ladders, and one chunk run from a JAX carry carried over with
``core/convert.py`` (its ``ChunkSummary`` and every carry array, the JAX
hi/lo counters decoded).  The JAX runs are cached per module.
"""
from __future__ import annotations

import dataclasses

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import numpy as np

from repro.apps import get_case as jget_case
from repro.core import DeviceEngine as JDeviceEngine
from repro.core import engine as jengine
from repro.core import scheduler as jsched
from repro.core import tvm as jtvm
from repro_torch.apps import get_case as tget_case
from repro_torch.core import (
    ChunkSummary,
    DeviceEngine,
    EngineError,
    HostEngine,
    ResidentCarry,
    convert,
)
from repro_torch.core import engine as tengine
from repro_torch.core import scheduler as tsched

APPS = ("bfs", "fib", "mergesort")
DISPATCHES = ("masked", "gather")


@pytest.fixture(scope="module")
def jax_runs():
    """``(name, dispatch) -> (heap, value, stats, engine)`` of the JAX
    ``DeviceEngine``, each run once per module."""
    cache = {}

    def get(name, dispatch):
        if (name, dispatch) not in cache:
            case = jget_case(name)
            eng = JDeviceEngine(case.program, capacity=case.capacity,
                                dispatch=dispatch)
            heap, value, stats = eng.run(
                case.initial, heap_init=dict(case.heap_init) or None)
            cache[name, dispatch] = (
                {k: np.asarray(v) for k, v in heap.items()},
                np.asarray(value), stats, eng,
            )
        return cache[name, dispatch]

    return get


@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("name", APPS)
def test_device_engine_matches_jax(jax_runs, name, dispatch):
    jheap, jvalue, jstats, _ = jax_runs(name, dispatch)
    case = tget_case(name)
    heap, value, stats = case.run(engine_cls=DeviceEngine,
                                  dispatch=dispatch, device="cpu")
    np.testing.assert_array_equal(value.numpy(), jvalue)
    assert set(heap) == set(jheap)
    for k in jheap:
        np.testing.assert_array_equal(heap[k].numpy(), jheap[k])
    assert stats.as_dict() == jstats.as_dict()
    assert stats.dispatches == stats.scalar_transfers == 1
    assert (stats.lanes_launched + stats.hole_lanes_skipped
            == stats.epochs * case.capacity)


@pytest.mark.parametrize("name", APPS)
def test_device_engine_matches_host_engine(name):
    case = tget_case(name)
    hh, hv, hs = case.run(dispatch="masked", device="cpu")
    for dispatch in DISPATCHES:
        dh, dv, ds = case.run(engine_cls=DeviceEngine, dispatch=dispatch,
                              device="cpu")
        assert torch.equal(dv, hv)
        for k in hh:
            assert torch.equal(dh[k], hh[k])
        assert ds.tasks_executed == hs.tasks_executed
        assert ds.total_forks == hs.total_forks


def _jax_leaves(carry) -> dict:
    """A JAX ``ResidentCarry`` as the numpy mapping ``convert`` takes."""
    c = jax.device_get(carry)
    out = {f.name: getattr(c, f.name)
           for f in dataclasses.fields(jengine.ResidentCarry)}
    out["state"] = {f.name: np.asarray(getattr(c.state, f.name))
                    for f in dataclasses.fields(jtvm.TVMState)}
    out["heap"] = {k: np.asarray(v) for k, v in c.heap.items()}
    return out


def _assert_summaries_equal(t: ChunkSummary, j) -> None:
    for f in dataclasses.fields(ChunkSummary):
        np.testing.assert_array_equal(
            np.asarray(getattr(t, f.name)), np.asarray(getattr(j, f.name)),
            err_msg=f.name)


@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("name", APPS)
def test_chunk_from_a_jax_carry(jax_runs, name, dispatch):
    jeng = jax_runs(name, dispatch)[3]
    jcase = jget_case(name)
    prog = jcase.program
    jstack, rstack, sp = jsched.batched_device_stacks(1, jeng.stack_depth)
    jcarry = jengine._fresh_resident_carry(
        jtvm.init_state(prog, jcase.capacity, jcase.initial),
        prog.init_heap(**(dict(jcase.heap_init) or {})),
        None, jstack, rstack, sp, n_regions=1,
    )
    mid = jeng.loop.run_chunk(jcarry, 3, 1)  # three epochs in
    leaves = _jax_leaves(mid)

    case = tget_case(name)
    teng = DeviceEngine(case.program, capacity=case.capacity,
                        dispatch=dispatch, device="cpu")
    tcarry = convert.carry_from_numpy(leaves, "cpu")
    back = convert.carry_to_numpy(tcarry)
    for k in ("sp", "jstack", "rstack", "job_tasks", "hole_lanes"):
        np.testing.assert_array_equal(
            back[k], jengine._hilo_value(leaves[k])
            if k in convert.HILO_FIELDS else leaves[k])

    tout = teng.loop.run_chunk(tcarry, 7, 1)
    jout = jeng.loop.run_chunk(mid, 7, 1)
    _assert_summaries_equal(teng.loop.chunk_summary(tout),
                            jeng.loop.chunk_summary(jout))
    got, want = convert.carry_to_numpy(tout), _jax_leaves(jout)
    for k, v in got.items():
        if k in ("state", "heap"):
            for kk in v:
                np.testing.assert_array_equal(v[kk], want[k][kk],
                                              err_msg=f"{k}.{kk}")
        elif k in convert.HILO_FIELDS:
            np.testing.assert_array_equal(v, jengine._hilo_value(want[k]))
        elif k != "arena":
            np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_batched_stacks_match_jax():
    rng = np.random.RandomState(3)
    J, depth = 5, 4
    for trial in range(6):
        js = rng.randint(0, 9, (J, depth)).astype(np.int32)
        rs = rng.randint(0, 9, (J, depth, 2)).astype(np.int32)
        sp = rng.randint(0, depth + 1, J).astype(np.int32)
        jp = jsched.batched_device_pop(jnp.asarray(js), jnp.asarray(rs),
                                       jnp.asarray(sp))
        tp = tsched.batched_device_pop(torch.as_tensor(js),
                                       torch.as_tensor(rs),
                                       torch.as_tensor(sp))
        for a, b in zip(jp, tp):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        cen, start, count = (rng.randint(0, 9, J).astype(np.int32)
                             for _ in range(3))
        pred = rng.rand(J) < 0.7
        if trial == 0:  # every region full: each push overflows
            sp = np.full(J, depth, np.int32)
            pred = np.ones(J, bool)
        jo = jsched.batched_device_push(
            jnp.asarray(js), jnp.asarray(rs), jnp.asarray(sp),
            jnp.asarray(cen), jnp.asarray(start), jnp.asarray(count),
            jnp.asarray(pred), depth)
        to = tsched.batched_device_push(
            torch.as_tensor(js.copy()), torch.as_tensor(rs.copy()),
            torch.as_tensor(sp), torch.as_tensor(cen),
            torch.as_tensor(start), torch.as_tensor(count),
            torch.as_tensor(pred), depth)
        for a, b in zip(jo, to):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        if trial == 0:
            assert to[3].all()
    for a, b in zip(jsched.batched_device_stacks(3, 8),
                    tsched.batched_device_stacks(3, 8, "cpu")):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("cap", (1, 2, 8, 4096, 1 << 21))
def test_width_ladders_match_jax(cap):
    assert tengine._span_width_ladder(cap) == jengine._span_width_ladder(cap)
    assert tengine._map_width_ladder(cap) == jengine._map_width_ladder(cap)


def test_refusals():
    case = tget_case("fib")
    with pytest.raises(ValueError) as err:
        DeviceEngine(case.program, dispatch="compacted", device="cpu")
    assert str(err.value) == jengine._COMPACTED_RESIDENT_MSG
    eng = DeviceEngine(case.program, capacity=case.capacity, device="cpu")
    carry = eng.initial_carry(case.initial)
    # a carry of one region run as a fleet of two (fleet carries run, in
    # tests/test_torch_device_service.py)
    with pytest.raises(ValueError, match="n_regions=2"):
        eng.loop.run_chunk(carry, 4, n_regions=2)
    with pytest.raises(EngineError, match="max_epochs"):
        eng.run(case.initial, max_epochs=3)
    small = DeviceEngine(case.program, capacity=8, device="cpu")
    with pytest.raises(EngineError, match="exhausted"):
        small.run(case.initial)
    shallow = DeviceEngine(case.program, capacity=case.capacity,
                           stack_depth=2, device="cpu")
    with pytest.raises(EngineError, match="exhausted"):
        shallow.run(case.initial)
    assert isinstance(carry, ResidentCarry)


@pytest.mark.parametrize("limits", ({"capacity": 64}, {"stack_depth": 2}),
                         ids=("tv_overflow", "stack_overflow"))
def test_failed_chunk_matches_jax(limits):
    jcase, case = jget_case("fib"), tget_case("fib")
    kw = dict(capacity=case.capacity)
    kw.update(limits)
    jeng = JDeviceEngine(jcase.program, **kw)
    jstack, rstack, sp = jsched.batched_device_stacks(1, jeng.stack_depth)
    jcarry = jengine._fresh_resident_carry(
        jtvm.init_state(jcase.program, jeng.capacity, jcase.initial),
        jcase.program.init_heap(), None, jstack, rstack, sp, n_regions=1)
    jout = jeng.loop.run_chunk(jcarry, 1 << 10, 1)
    teng = DeviceEngine(case.program, device="cpu", **kw)
    tout = teng.loop.run_chunk(teng.initial_carry(case.initial), 1 << 10, 1)
    ts = teng.loop.chunk_summary(tout)
    _assert_summaries_equal(ts, jeng.loop.chunk_summary(jout))
    assert ts.failed[0] and ts.failed_stack[0] == ("stack_depth" in limits)
    got, want = convert.carry_to_numpy(tout), _jax_leaves(jout)
    for kk in got["state"]:
        np.testing.assert_array_equal(got["state"][kk], want["state"][kk],
                                      err_msg=kk)
    for k in ("jstack", "rstack", "sp", "failed", "failed_stack"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
