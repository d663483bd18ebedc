"""The port's sharded fleet (``repro_torch.distributed.ShardedFleet`` and
``JobService(engine="sharded")``) on the CPU.

The cases of the JAX package's ``tests/test_sharded_fleet.py``, held to
the port's own solo ``HostEngine`` runs (which other files hold to the
JAX package): every job bit-identical to its solo run at P = 1, 2, 4 and
8, work conserved across shards with one dispatch and one readback per
collective step, sticky placement with and without rebalancing, the
placement policies and the refusal of an incompatible job, no rebuild
across consecutive waves or across P, the sharded service, validation and
``make_fleet_mesh``; and the front door's sharded cases
(``tests/test_front_door.py``): preempt/resume under masked and gather,
``placement="auto"``.

One JAX case, run once per module: mixed3 plus one copy through
``JobService(engine="sharded", shards=2, placement="least_loaded",
chunk=4)``.  The port must seat every job on the same shard, make the same
migrations and collective steps, and give every shard's ``RunStats``,
every job's heap, values and ``JobStats.solo_dict()``, the tracer's spans
and the ``shard``-labelled series of the JAX run; and the JAX fleet's
stacked carry entering its third collective chunk, carried over with
``core/convert.py``, runs one port collective chunk to the JAX chunk's
every leaf.  ``canonical_wave_order`` sorts a wave by structural hash,
which hashes bytecode, so the two packages seat mixed3's members in
different orders; the JAX case seats the port's in the JAX order.  The
JAX case runs in a subprocess started with the module's first test, so
the port's cases run beside its compiles.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from repro_torch.apps import fib, get_fleet
from repro_torch.core import EpochLoop, HostEngine, convert
from repro_torch.distributed import PLACEMENTS, ShardedFleet, ShardWave
from repro_torch.distributed import fleet as tfleet
from repro_torch.launch.mesh import make_fleet_mesh
from repro_torch.obs import MetricsRegistry, SpanTracer, to_prometheus
from repro_torch.service import Job, JobHandle, JobService, JobStatus
from repro_torch.service import api as tapi

QUOTA = 256
FIB_N = 9


def _solo(program, initial, quota, heap_init=None):
    return HostEngine(program, capacity=quota, device="cpu").run(
        initial, heap_init=dict(heap_init or {}) or None)


@functools.lru_cache(maxsize=None)
def _fleet_solo(name):
    """Each tenant's solo run of a registry fleet, by name."""
    return {c.name: _solo(c.program, c.initial, q, c.heap_init)
            for c, q in get_fleet(name)}


def _handles(fleet, tag="", first=0):
    return [
        JobHandle(first + i, Job(c.program, c.initial,
                                 heap_init=dict(c.heap_init), quota=q,
                                 name=c.name + tag))
        for i, (c, q) in enumerate(fleet)
    ]


def _assert_solo(h, solo):
    heap, value, stats = solo
    assert h.status is JobStatus.DONE, (h.job.name, h.error)
    assert torch.equal(h.result.value, value), h.job.name
    assert set(h.result.heap) == set(heap)
    for k in heap:
        assert torch.equal(h.result.heap[k], heap[k]), (h.job.name, k)
    assert h.result.stats.solo_dict() == {
        "epochs": stats.epochs, "tasks_executed": stats.tasks_executed,
        "total_forks": stats.total_forks,
        "peak_tv_slots": stats.peak_tv_slots,
    }


def _fleet(handles, shards, **kw):
    return ShardedFleet(handles, shards=shards, device="cpu", **kw)


# ----------------------------------------------------- per-job bit identity
@pytest.mark.parametrize("shards, dispatch", (
    (1, "masked"), (2, "masked"), (4, "masked"), (8, "masked"),
    (2, "gather"), (8, "gather"),
))
def test_fleet_bit_identical_to_solo_across_p(shards, dispatch):
    """Every job's values, heap and solo-comparable stats equal its solo
    run, whatever P."""
    fleet = get_fleet("mixed3")
    solo = _fleet_solo("mixed3")
    anchors = _handles(fleet)
    fl = _fleet(anchors, shards, chunk=4, dispatch=dispatch)
    extra = _handles(fleet, "_b", 10) + _handles(fleet, "_c", 20)
    for h in extra:
        assert fl.admit(h)
    done = fl.run()
    assert len(done) == len(anchors) + len(extra)
    for h in done:
        _assert_solo(h, solo[h.job.name.split("_")[0]])
    assert fl.trace_count == 1  # one resident body serves every shard


@pytest.mark.parametrize("shards", (2, 4))
def test_work_conservation_across_shards(shards):
    """Summed per-shard tasks and forks equal the solo totals exactly, and
    the fleet pays one dispatch and one readback per collective step, not
    per shard."""
    fleet = get_fleet("mixed3")
    reps = 3
    solo = _fleet_solo("mixed3").values()
    solo_tasks = reps * sum(s.tasks_executed for _, _, s in solo)
    solo_forks = reps * sum(s.total_forks for _, _, s in solo)
    fl = _fleet(_handles(fleet), shards, chunk=4, placement="least_loaded")
    for r, tag in enumerate(("_b", "_c")[: reps - 1], 1):
        for h in _handles(fleet, tag, 10 * r):
            assert fl.admit(h)
    fl.run()
    per_shard = fl.shard_stats()
    assert len(per_shard) == shards
    assert sum(s.tasks_executed for s in per_shard) == solo_tasks
    assert sum(s.total_forks for s in per_shard) == solo_forks
    total = fl.stats()
    assert total.tasks_executed == solo_tasks
    assert total.total_forks == solo_forks
    assert total.dispatches == fl.collective_steps
    assert total.scalar_transfers == fl.collective_steps
    assert fl.pending_jobs == 0 and not fl.live


def test_rebalance_migrates_queued_jobs_off_hot_shards():
    """Sticky placement queues every fib job on one shard; rebalancing
    moves some to idle shards' free regions, with solo results; pinned,
    only the sticky shard works."""
    jobs = [Job(fib.PROGRAM, fib.initial(FIB_N), quota=QUOTA,
                name=f"fib#{i}") for i in range(8)]
    solo = _solo(fib.PROGRAM, fib.initial(FIB_N), QUOTA)

    def build(rebalance):
        fl = _fleet([JobHandle(0, jobs[0])], 4, chunk=2, placement="sticky",
                    rebalance=rebalance)
        for i, j in enumerate(jobs[1:], start=1):
            assert fl.admit(JobHandle(i, j))
        return fl

    fl = build(rebalance=True)
    done = fl.run()
    assert len(done) == 8
    assert fl.migrations > 0
    for h in done:
        _assert_solo(h, solo)
    pinned = build(rebalance=False)
    assert len(pinned.run()) == 8
    assert pinned.migrations == 0
    worked = [p for p, s in enumerate(pinned.shard_stats())
              if s.tasks_executed > 0]
    assert len(worked) == 1


def test_placement_policies():
    """round_robin cycles shards; sticky maps equal-structure jobs to one
    shard; least_loaded prefers empty shards; an incompatible job is
    refused (left for the service queue)."""
    fleet = get_fleet("mixed3")
    fl = _fleet(_handles(fleet), 3, chunk=4, placement="round_robin")
    assert [len(q) for q in fl._pending] == [1, 1, 1]
    sticky = _fleet(_handles(fleet), 3, chunk=4, placement="sticky")
    a, b = _handles(fleet, "_a", 10), _handles(fleet, "_b", 20)
    for h in a + b:
        assert sticky.admit(h)
    for ha, hb in zip(a, b):
        pa = [p for p, q in enumerate(sticky._pending) if ha in q]
        pb = [p for p, q in enumerate(sticky._pending) if hb in q]
        assert pa == pb
        assert pa == [tfleet._type_key(ha.job) % 3]
    least = _fleet(_handles(fleet), 3, chunk=4, placement="least_loaded")
    assert [len(q) for q in least._pending] == [1, 1, 1]
    assert least.admit(_handles(fleet, "_d", 30)[0])
    assert sorted(len(q) for q in least._pending) == [1, 1, 2]
    big = get_fleet("fib_fleet")[0][0]
    alien = Job(big.program, big.initial, quota=1 << 20, name="too-big")
    assert not fl.compatible(alien)
    assert not fl.admit(JobHandle(99, alien))
    assert fl.pending_jobs == 3


def test_no_rebuild_across_waves_and_shard_counts():
    """A sharded service reuses ONE wave template across waves, migrations
    and shard counts: the template key is not a function of P, every shard
    runs the template's one resident body, and migration reseeds through
    the existing path."""
    fleet = get_fleet("mixed3")
    cap = sum(q for _, q in fleet)

    def submit_all(svc, reps):
        for r in range(reps):
            for c, q in fleet:
                svc.submit_case(c, quota=q, name=f"{c.name}#{r}")

    svc = JobService(capacity=cap, engine="sharded", shards=2, chunk=4,
                     max_jobs=len(fleet), placement="sticky", device="cpu")
    submit_all(svc, 3)
    assert all(h.status is JobStatus.DONE for h in svc.drain())
    traced = svc.trace_count
    assert traced == 1
    submit_all(svc, 2)
    svc.drain()
    assert svc.trace_count == traced
    svc4 = JobService(capacity=cap, engine="sharded", shards=4, chunk=4,
                      max_jobs=len(fleet), device="cpu",
                      template_cache=svc.template_cache)
    submit_all(svc4, 2)
    svc4.drain()
    assert svc4.template_cache.hits >= 1
    assert svc4.template_cache.misses == 1  # only the very first wave built
    assert svc4.trace_count == traced
    submit_all(svc4, 2)
    svc4.drain()
    assert svc4.trace_count == traced


def test_sharded_service_streams_and_matches_solo():
    """engine="sharded" drains a many-rep queue through placement and
    streaming admission, every job equal to its solo run."""
    fleet = get_fleet("mixed3")
    solo = _fleet_solo("mixed3")
    svc = JobService(capacity=sum(q for _, q in fleet), engine="sharded",
                     shards=4, chunk=4, max_jobs=len(fleet),
                     placement="least_loaded", device="cpu")
    hs = [svc.submit_case(c, quota=q, name=f"{c.name}#{r}")
          for r in range(4) for c, q in fleet]
    done = svc.drain()
    assert len(done) == len(hs)
    for h in hs:
        _assert_solo(h, solo[h.job.name.split("#")[0]])
    assert svc.stats().tasks_executed == sum(
        4 * s.tasks_executed for _, _, s in solo.values())


def test_sharded_engine_validation():
    with pytest.raises(ValueError, match="shards"):
        JobService(engine="device", shards=2, device="cpu")
    with pytest.raises(ValueError, match="placement"):
        JobService(engine="sharded", shards=2, placement="random",
                   device="cpu")
    with pytest.raises(ValueError, match="shards"):
        JobService(engine="sharded", shards=0, device="cpu")
    with pytest.raises(ValueError, match="masked"):
        JobService(engine="sharded", dispatch="compacted", device="cpu")
    with pytest.raises(ValueError, match="fuse_all"):
        JobService(engine="sharded", gang=2, device="cpu")
    with pytest.raises(ValueError, match="chunk"):
        JobService(engine="sharded", chunk=0, device="cpu")
    svc = JobService(engine="sharded", shards=3, placement="auto",
                     rebalance=False, device="cpu")
    assert (svc.shards, svc.placement, svc.rebalance) == (3, "auto", False)
    assert svc.placement_controller is not None
    assert PLACEMENTS == ("round_robin", "least_loaded", "sticky")
    h = [JobHandle(0, Job(fib.PROGRAM, fib.initial(5), quota=64))]
    with pytest.raises(ValueError, match="shard"):
        _fleet(h, 0)
    with pytest.raises(ValueError, match="placement"):
        _fleet(h, 2, placement="random")
    with pytest.raises(ValueError, match="anchor"):
        _fleet([], 2)


def test_fleet_mesh(monkeypatch):
    """make_fleet_mesh: below one shard raises; one shard, or fewer CUDA
    devices than shards, is the single-device form (None); P or more CUDA
    devices would call for the multi-device form, which raises."""
    with pytest.raises(ValueError):
        make_fleet_mesh(0)
    assert make_fleet_mesh(1) is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert make_fleet_mesh(1) is None
    assert make_fleet_mesh(8) is None
    for p in (2, 4):
        with pytest.raises(NotImplementedError, match="ROADMAP item 9"):
            make_fleet_mesh(p)
    # a fleet on the CPU stays on its one device whatever cards exist
    h = JobHandle(0, Job(fib.PROGRAM, fib.initial(6), quota=QUOTA))
    fl = _fleet([h], 2, chunk=2)
    assert fl.mesh is None
    fl.run()
    assert int(h.result.value[0, 0]) == fib.fib_reference(6)


# ---------------------------------------------- the front door's sharded cases
@pytest.mark.parametrize("dispatch", ("masked", "gather"))
def test_preempt_resume_bit_identical(dispatch):
    """Preempt mid-flight off a shard, re-admit into a fresh fleet: the
    result and every solo-comparable stat equal an uninterrupted solo run,
    and the rider is untouched."""
    solo = _solo(fib.PROGRAM, fib.initial(FIB_N), QUOTA)

    def handle(i):
        return JobHandle(i, Job(fib.PROGRAM, fib.initial(FIB_N),
                                quota=QUOTA))

    h = handle(0)
    m1 = _fleet([h], 2, dispatch=dispatch, chunk=2)
    for _ in range(3):
        m1.step()
    assert m1.running_handles() == [h]
    assert m1.preempt(h)
    assert not m1.preempt(h)
    assert h.status is JobStatus.PREEMPTED
    assert h.preemptions == 1 and h.checkpoint is not None
    h2 = handle(1)
    m2 = _fleet([h2, h], 2, dispatch=dispatch, chunk=2)
    m2.run()
    _assert_solo(h, solo)
    _assert_solo(h2, solo)


def test_auto_placement_runs():
    def handle(i):
        return JobHandle(i, Job(fib.PROGRAM, fib.initial(FIB_N),
                                quota=QUOTA))

    fl = _fleet([handle(0)], 2, chunk=2, placement="auto")
    assert fl.admit(handle(1))
    done = fl.run()
    assert len(done) == 2
    assert all(x.status is JobStatus.DONE for x in done)
    assert sum(fl._pctl.decisions.values()) == 2


# ------------------------------------------------------------- the JAX case
PARITY = dict(shards=2, placement="least_loaded", chunk=4)
PARITY_STEP = 2  # collective steps before the converted-carry chunk


def _series(exposition: str):
    """The exposition's shard-labelled samples."""
    return [ln for ln in exposition.splitlines() if 'shard="' in ln]


def _spans(events):
    return [(e["name"], e.get("cat"), e["tid"], e["args"])
            for e in events if e["ph"] == "X"]


def _sharded_service(cls, fleet_fn, registry, tracer, **kw):
    fleet = fleet_fn("mixed3")
    svc = cls(capacity=sum(q for _, q in fleet), max_jobs=len(fleet),
              engine="sharded", metrics=registry, tracer=tracer,
              **PARITY, **kw)
    hs = [svc.submit_case(c, quota=q, name=f"{c.name}#{r}")
          for r in range(2) for c, q in fleet]
    svc.drain()
    return svc, hs


def _seats_by_shard(seats, fl):
    index = {id(sh): p for p, sh in enumerate(fl._shards)}
    return [(name, index[key]) for key, name in seats]


TESTS = pathlib.Path(__file__).resolve().parent
_JAX_RUN = ("import pickle, sys\n"
            "import test_torch_sharded_fleet as t\n"
            "sys.stdout.buffer.write(pickle.dumps(t.jax_case_run()))\n")
_JAX_PROC = []


@pytest.fixture(scope="module", autouse=True)
def jax_case_started():
    """The JAX case's subprocess, started with the module's first test."""
    try:
        import jax  # noqa: F401
    except ImportError:
        yield
        return
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(TESTS.parent / "src"), str(TESTS)])
    env.setdefault("JAX_PLATFORMS", "cpu")
    _JAX_PROC.append(subprocess.Popen(
        [sys.executable, "-c", _JAX_RUN], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, env=env, cwd=TESTS.parent))
    yield
    for p in _JAX_PROC:
        if p.poll() is None:
            p.kill()
        p.communicate()


@functools.lru_cache(maxsize=None)
def _jax_case():
    """The JAX case's results (:func:`jax_case_run`, in the subprocess)."""
    pytest.importorskip("jax")
    out, err = _JAX_PROC[0].communicate(timeout=600)
    assert _JAX_PROC[0].returncode == 0, err[-3000:].decode()
    return pickle.loads(out)


def jax_case_run():
    """The JAX service's run: seats, per-shard and fleet stats, jobs,
    spans, series, and the third collective chunk's input and output."""
    import jax

    from repro import obs as jobs_
    from repro.apps import get_fleet as jget_fleet
    from repro.core import engine as jengine
    from repro.distributed import fleet as jfleet
    from repro.service import JobService as JJobService
    from repro.service import canonical_wave_order as jorder

    seats, steps = [], []
    admit0, run0 = jfleet.ShardWave.admit, jengine.EpochLoop.run_chunk_fleet

    def admit(self, h):
        ok = admit0(self, h)
        if ok:
            seats.append((id(self), h.job.name))
        return ok

    def run_chunk_fleet(self, carry, limits, **kw):
        keep = len(steps) == PARITY_STEP
        cin = _jax_leaves(jax, jengine, carry) if keep else None
        out = run0(self, carry, limits, **kw)
        steps.append(None if not keep else (
            cin, np.asarray(limits), _jax_leaves(jax, jengine, out),
            self.fleet_chunk_summaries(out, kw["n_shards"])))
        return out

    jfleet.ShardWave.admit = admit
    jengine.EpochLoop.run_chunk_fleet = run_chunk_fleet
    try:
        reg, tr = jobs_.MetricsRegistry(), jobs_.SpanTracer()
        svc, hs = _sharded_service(JJobService, jget_fleet, reg, tr)
    finally:
        jfleet.ShardWave.admit = admit0
        jengine.EpochLoop.run_chunk_fleet = run0
    fl = svc._mux
    jobs = [(h.job.name, {k: np.asarray(v) for k, v in h.result.heap.items()},
             np.asarray(h.result.value), h.result.stats.solo_dict())
            for h in hs]
    jjobs = [jj for jj in (h.job for h in hs[:3])]
    rank = {jjobs[i].program.name: k
            for k, i in enumerate(jorder(jjobs))}
    return dict(
        seats=_seats_by_shard(seats, fl), migrations=fl.migrations,
        steps=fl.collective_steps,
        shard_stats=[s.as_dict() for s in fl.shard_stats()],
        stats=fl.stats().as_dict(), jobs=jobs, spans=_spans(tr.events),
        series=_series(jobs_.to_prometheus(reg)), chunk=steps[PARITY_STEP],
        rank=rank,
    )


def _jax_leaves(jax, jengine, carry) -> dict:
    """A JAX stacked fleet carry as the numpy mapping ``convert`` takes."""
    from repro.core import tvm as jtvm

    c = jax.device_get(carry)
    out = {f.name: np.asarray(getattr(c, f.name))
           for f in dataclasses.fields(jengine.ResidentCarry)
           if f.name not in ("state", "heap", "arena")}
    out["state"] = {f.name: np.asarray(getattr(c.state, f.name))
                    for f in dataclasses.fields(jtvm.TVMState)}
    out["heap"] = {k: np.asarray(v) for k, v in c.heap.items()}
    out["arena"] = {f.name: np.asarray(getattr(c.arena, f.name))
                    for f in dataclasses.fields(jtvm.JobArena)}
    return out


@functools.lru_cache(maxsize=None)
def _port_case():
    """The port's run of the JAX case, its members seated in the JAX
    package's canonical order."""
    rank = _jax_case()["rank"]

    def jax_order(jobs):
        return tuple(sorted(range(len(jobs)), key=lambda i: (
            rank[jobs[i].program.name], jobs[i].quota)))

    seats = []
    mp = pytest.MonkeyPatch()
    admit0 = ShardWave.admit

    def admit(self, h):
        ok = admit0(self, h)
        if ok:
            seats.append((id(self), h.job.name))
        return ok

    mp.setattr(tapi, "canonical_wave_order", jax_order)
    mp.setattr(tfleet, "canonical_wave_order", jax_order)
    mp.setattr(ShardWave, "admit", admit)
    try:
        reg, tr = MetricsRegistry(), SpanTracer()
        svc, hs = _sharded_service(JobService, get_fleet, reg, tr,
                                   device="cpu")
    finally:
        mp.undo()
    return svc, hs, reg, tr, _seats_by_shard(seats, svc._mux)


def test_sharded_service_matches_jax():
    j = _jax_case()
    svc, hs, reg, tr, seats = _port_case()
    fl = svc._mux
    assert seats == j["seats"]
    assert fl.migrations == j["migrations"]
    assert fl.collective_steps == j["steps"] > PARITY_STEP
    assert [s.as_dict() for s in fl.shard_stats()] == j["shard_stats"]
    assert fl.stats().as_dict() == j["stats"]
    for h, (name, heap, value, solo) in zip(hs, j["jobs"]):
        assert h.job.name == name
        np.testing.assert_array_equal(h.result.value.numpy(), value)
        assert set(h.result.heap) == set(heap)
        for k in heap:
            np.testing.assert_array_equal(h.result.heap[k].numpy(), heap[k],
                                          err_msg=f"{name}:{k}")
        assert h.result.stats.solo_dict() == solo
    assert _spans(tr.events) == j["spans"]
    assert sum(1 for s in _spans(tr.events)
               if s[0] == "collective_chunk") == fl.collective_steps
    assert _series(to_prometheus(reg)) == j["series"]
    assert j["series"]


def test_collective_chunk_from_a_jax_fleet_carry():
    """The JAX fleet's stacked carry entering its third collective chunk,
    carried over, runs one port collective chunk (the plain fleet loop,
    shard after shard) to the JAX chunk's every leaf and summary."""
    cin, limits, jout, jsums = _jax_case()["chunk"]
    svc = _port_case()[0]
    carries = convert.fleet_carries_from_numpy(cin, "cpu")
    back = convert.fleet_carries_to_numpy(carries)
    for k in cin["arena"]:
        np.testing.assert_array_equal(back["arena"][k], cin["arena"][k])
    loop = EpochLoop(svc._mux.template.program, "masked")  # no tenants
    J = len(svc._mux.slots)
    out = loop.run_chunk_fleet(carries, limits, n_regions=J)
    assert len(jsums) == len(out) == 2
    for p, (t, js) in enumerate(zip(loop.fleet_chunk_summaries(out),
                                    jsums)):
        for f in dataclasses.fields(t):
            np.testing.assert_array_equal(
                np.asarray(getattr(t, f.name)),
                np.asarray(getattr(js, f.name)),
                err_msg=f"shard {p} {f.name}")
    got = convert.fleet_carries_to_numpy(out)
    for k, v in got.items():
        if k in ("state", "heap", "arena"):
            for kk in v:
                np.testing.assert_array_equal(v[kk], jout[k][kk],
                                              err_msg=f"{k}.{kk}")
        elif k in convert.HILO_FIELDS:
            from repro.core import engine as jengine

            np.testing.assert_array_equal(v, jengine._hilo_value(jout[k]),
                                          err_msg=k)
        else:
            np.testing.assert_array_equal(v, jout[k], err_msg=k)
