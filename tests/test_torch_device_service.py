"""The port's resident ``DeviceMultiplexer`` against the JAX one.

Both run on the CPU: JAX its ``lax.while_loop`` chunks, the port its plain
resident fleet loop (``megakernel=True`` runs that loop too on the CPU).
On the registry fleet ``mixed4`` (four tenants, one with map payloads),
masked and gather, at K = 1, 4 and unbounded, every chunk's
``ChunkSummary``, every job's heap, TV values and ``JobStats.solo_dict()``,
and the fleet's ``RunStats`` must be equal, exactly.  A fleet carry taken
from the JAX multiplexer after two chunks, carried over with
``core/convert.py``, runs one port chunk to the JAX chunk's every leaf
(the arena's cursors too, the JAX hi/lo counters decoded).  One JAX
template per dispatch is built once per module and shared across K, as
the JAX suite's own chunked tests share theirs; its compile is this
file's cost, so ``mixed3`` and ``fib_fleet`` are held to the port's solo
runs instead (``tests/test_torch_chunked_service.py``), which other files
hold to the JAX package.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
pytest.importorskip("jax")

import jax

from repro.apps import get_fleet as jget_fleet
from repro.core import engine as jengine
from repro.core import tvm as jtvm
from repro.service import DeviceMultiplexer as JDeviceMultiplexer
from repro.service import Job as JJob
from repro.service import JobHandle as JJobHandle
from repro.service import WaveTemplate as JWaveTemplate
from repro_torch.apps import get_fleet
from repro_torch.core import EpochLoop, convert
from repro_torch.service import DeviceMultiplexer, Job, JobHandle, JobStatus

FLEETS = ("mixed4",)
DISPATCHES = ("masked", "gather")
KS = (1, 4, None)
CARRY_AFTER = 2  # chunks of K=4 before the converted-carry chunk


def _handles(fleet, cls_job, cls_handle):
    return [
        cls_handle(i, cls_job(c.program, c.initial, dict(c.heap_init),
                              quota=q, name=c.name))
        for i, (c, q) in enumerate(fleet)
    ]


def _jax_leaves(carry) -> dict:
    """A JAX fleet ``ResidentCarry`` as the numpy mapping ``convert``
    takes."""
    c = jax.device_get(carry)
    out = {f.name: getattr(c, f.name)
           for f in dataclasses.fields(jengine.ResidentCarry)}
    out["state"] = {f.name: np.asarray(getattr(c.state, f.name))
                    for f in dataclasses.fields(jtvm.TVMState)}
    out["heap"] = {k: np.asarray(v) for k, v in c.heap.items()}
    out["arena"] = {f.name: np.asarray(getattr(c.arena, f.name))
                    for f in dataclasses.fields(jtvm.JobArena)}
    return out


@functools.lru_cache(maxsize=None)
def _jax_template(name: str, dispatch: str):
    """One JAX wave template per (fleet, dispatch): its compiled chunk loop
    serves every K."""
    hs = _handles(jget_fleet(name), JJob, JJobHandle)
    mux = JDeviceMultiplexer(hs, dispatch=dispatch)
    return JWaveTemplate(key=(name, dispatch), program=mux.program,
                         slots=mux.slots, loop=mux.loop)


@functools.lru_cache(maxsize=None)
def _jax_wave(name: str, dispatch: str, K):
    """One JAX wave: each chunk's summary, each job's results and the
    fleet stats; at K=4 also the carry after CARRY_AFTER chunks and after
    one more."""
    hs = _handles(jget_fleet(name), JJob, JJobHandle)
    mux = JDeviceMultiplexer(hs, dispatch=dispatch, chunk=K,
                             template=_jax_template(name, dispatch))
    summaries, carries = [], []
    while mux.live:
        mux.step()
        summaries.append(mux.loop.chunk_summary(mux._carry))
        if K == 4 and len(summaries) in (CARRY_AFTER, CARRY_AFTER + 1):
            carries.append(_jax_leaves(mux._carry))
    jobs = [
        ({k: np.asarray(v) for k, v in h.result.heap.items()},
         np.asarray(h.result.value), h.result.stats.solo_dict())
        for h in hs
    ]
    return summaries, jobs, mux.stats(), carries


def _assert_summaries_equal(t, j, where=""):
    for f in dataclasses.fields(t):
        np.testing.assert_array_equal(
            np.asarray(getattr(t, f.name)), np.asarray(getattr(j, f.name)),
            err_msg=f"{where}{f.name}")


@pytest.mark.parametrize("megakernel", (False, True))
@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("name", FLEETS)
def test_device_multiplexer_matches_jax(name, dispatch, K, megakernel):
    jsums, jjobs, jstats, _ = _jax_wave(name, dispatch, K)
    hs = _handles(get_fleet(name), Job, JobHandle)
    mux = DeviceMultiplexer(hs, dispatch=dispatch, chunk=K,
                            megakernel=megakernel, device="cpu")
    sums = []
    while mux.live:
        mux.step()
        sums.append(mux.loop.chunk_summary(mux._carry))
    assert len(sums) == len(jsums)
    for i, (t, j) in enumerate(zip(sums, jsums)):
        _assert_summaries_equal(t, j, f"chunk {i}: ")
    for h, (jheap, jvalue, jsolo) in zip(hs, jjobs):
        assert h.status is JobStatus.DONE
        np.testing.assert_array_equal(h.result.value.numpy(), jvalue)
        assert set(h.result.heap) == set(jheap)
        for k in jheap:
            np.testing.assert_array_equal(h.result.heap[k].numpy(), jheap[k],
                                          err_msg=f"{h.job.name}:{k}")
        assert h.result.stats.solo_dict() == jsolo
    assert mux.stats().as_dict() == jstats.as_dict()
    assert mux.loop.trace_count == 1  # one resident body, every chunk


@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("name", FLEETS)
def test_chunk_from_a_jax_fleet_carry(name, dispatch):
    """A JAX fleet carry, carried over after two chunks, runs one port
    chunk (the plain fleet body) to the JAX chunk's every leaf."""
    jsums, _, _, (mid, after) = _jax_wave(name, dispatch, 4)
    fleet = get_fleet(name)
    hs = _handles(fleet, Job, JobHandle)
    tmux = DeviceMultiplexer(hs, dispatch=dispatch, chunk=4, device="cpu")
    tcarry = convert.carry_from_numpy(mid, "cpu")
    back = convert.carry_to_numpy(tcarry)
    for k in mid["arena"]:
        np.testing.assert_array_equal(back["arena"][k], mid["arena"][k])
    loop = EpochLoop(tmux.program, dispatch)  # a fresh loop, no tenants
    J = len(fleet)
    limit = int(mid["n_epochs"]) + 4
    tout = loop.run_chunk(tcarry, limit, J)
    _assert_summaries_equal(loop.chunk_summary(tout), jsums[CARRY_AFTER])
    got = convert.carry_to_numpy(tout)
    for k, v in got.items():
        if k in ("state", "heap", "arena"):
            for kk in v:
                np.testing.assert_array_equal(v[kk], after[k][kk],
                                              err_msg=f"{k}.{kk}")
        elif k in convert.HILO_FIELDS:
            np.testing.assert_array_equal(v, jengine._hilo_value(after[k]),
                                          err_msg=k)
        else:
            np.testing.assert_array_equal(v, after[k], err_msg=k)
