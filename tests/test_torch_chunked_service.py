"""The port's resident job service on the CPU: ``DeviceMultiplexer`` and
``JobService(engine="device")``.

The behaviour the JAX package's chunked and device service tests check,
held here to the port's own solo ``HostEngine`` runs (which other files
hold to the JAX package): every tenant of the registry fleets at K = 1, 4
and unbounded, masked and gather; completions stream at chunk boundaries,
a job
admitted into a freed region mid-wave and a job preempted and resumed each
equal their solo runs, an unbounded wave (``chunk=None``) is closed to
admission and preemption, an overflowing region fails alone mid-chunk, a K
past the last epoch and steps after the drain change nothing, identical
and permuted consecutive waves build nothing new (``trace_count``), the
template key ignores member order, and the resident steps launch at the
rung of the live span.  The refusals: ``compacted``, the host-only
options, and the options still to port.  No JAX here.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from repro_torch.apps import fib, get_case, get_fleet
from repro_torch.core import HostEngine
from repro_torch.service import (
    DeviceMultiplexer,
    Job,
    JobFailure,
    JobHandle,
    JobService,
    JobStatus,
    WaveTemplate,
    wave_template_key,
)


def _fib(i, n, quota, name=""):
    return JobHandle(i, Job(fib.PROGRAM, fib.initial(n), quota=quota,
                            name=name or f"fib{n}"))


def _solo(program, initial, quota, heap_init=None):
    return HostEngine(program, capacity=quota, device="cpu").run(
        initial, heap_init=dict(heap_init or {}) or None)


def _assert_solo(h, solo):
    heap, value, stats = solo
    assert h.status is JobStatus.DONE, h.error
    assert torch.equal(h.result.value, value), h.job.name
    assert set(h.result.heap) == set(heap)
    for k in heap:
        assert torch.equal(h.result.heap[k], heap[k]), (h.job.name, k)
    assert h.result.stats.solo_dict() == {
        "epochs": stats.epochs, "tasks_executed": stats.tasks_executed,
        "total_forks": stats.total_forks,
        "peak_tv_slots": stats.peak_tv_slots,
    }


def _mux(handles, **kw):
    return DeviceMultiplexer(handles, device="cpu", **kw)


# ------------------------------------------------------ the registry fleets
@functools.lru_cache(maxsize=None)
def _fleet_solo(name):
    """Each tenant's solo run of a registry fleet (cached per module)."""
    return [_solo(c.program, c.initial, q, c.heap_init)
            for c, q in get_fleet(name)]


@pytest.mark.parametrize("K", (1, 4, None))
@pytest.mark.parametrize("dispatch", ("masked", "gather"))
@pytest.mark.parametrize("name", ("mixed3", "mixed4", "fib_fleet"))
def test_registry_fleet_matches_solo_runs(name, dispatch, K):
    """Every tenant of a registry fleet equals its solo run, at every K
    (mixed4's chunks equal the JAX multiplexer's too:
    tests/test_torch_device_service.py); the wave takes the global
    epochs of its longest tenant in ceil(epochs / K) readbacks."""
    fleet = get_fleet(name)
    handles = [JobHandle(i, Job(c.program, c.initial, dict(c.heap_init),
                                quota=q, name=c.name))
               for i, (c, q) in enumerate(fleet)]
    mux = _mux(handles, dispatch=dispatch, chunk=K)
    mux.run()
    solo = _fleet_solo(name)
    for h, sr in zip(handles, solo):
        _assert_solo(h, sr)
    fs = mux.stats()
    E = max(sr[2].epochs for sr in solo)
    assert fs.epochs == E
    assert fs.dispatches == fs.scalar_transfers == (
        1 if K is None else math.ceil(E / K))
    assert fs.ranges_coalesced == sum(sr[2].epochs for sr in solo) - E


# ------------------------------------------------- chunk-boundary features
@pytest.mark.parametrize("dispatch", ("masked", "gather"))
def test_streaming_completion_surfaces_before_wave_drains(dispatch):
    short, long_ = _fib(0, 4, 64, "short"), _fib(1, 12, 512, "long")
    mux = _mux([short, long_], chunk=2, dispatch=dispatch)
    boundaries = 0
    while not short.done:
        mux.step()
        boundaries += 1
    assert long_.status is JobStatus.RUNNING  # the wave is still running
    _assert_solo(short, _solo(fib.PROGRAM, fib.initial(4), 64))
    assert boundaries == math.ceil((2 * 4 - 1) / 2)  # its epochs / K
    mux.run()
    _assert_solo(long_, _solo(fib.PROGRAM, fib.initial(12), 512))


@pytest.mark.parametrize("megakernel", (False, True))
def test_job_admitted_mid_wave_matches_solo(megakernel):
    first, long_ = _fib(0, 4, 64, "first"), _fib(1, 12, 512, "long")
    mux = _mux([first, long_], chunk=2, megakernel=megakernel)
    while not first.done:
        mux.step()
    late = _fib(2, 6, 32, "late")  # a smaller quota than the region's
    assert mux.admit(late) is True
    assert late.status is JobStatus.RUNNING
    mux.run()
    _assert_solo(late, _solo(fib.PROGRAM, fib.initial(6), 32))
    _assert_solo(long_, _solo(fib.PROGRAM, fib.initial(12), 512))
    assert mux.loop.trace_count == 1  # the reseed built nothing


def test_fully_resident_wave_is_closed_to_admission_and_preemption():
    h = _fib(0, 8, 128)
    mux = _mux([h], chunk=None)
    late = _fib(1, 8, 128)
    assert mux.admit(late) is False
    assert mux.preempt(h) is False
    assert len(mux.step()) == 1  # the whole wave in one chunk
    assert mux.admit(late) is False
    assert mux.step() == []
    s = mux.stats()
    assert s.dispatches == s.scalar_transfers == 1


@pytest.mark.parametrize("dispatch", ("masked", "gather"))
def test_preempt_resume_matches_uninterrupted_run(dispatch):
    """A job lifted off the live carry at a chunk boundary
    (``_capture_region``) and resumed in another region of another wave
    (``_restore_region``) ends as an uninterrupted run does."""
    case = get_case("mergesort")
    solo = _solo(case.program, case.initial, 512, case.heap_init)

    def handle(i):
        return JobHandle(i, Job(case.program, case.initial,
                                dict(case.heap_init), quota=512,
                                name=f"msort{i}"))

    h, rider = handle(0), _fib(1, 10, 512)
    m1 = _mux([rider, h], chunk=3, dispatch=dispatch)
    m1.step()
    m1.step()
    assert m1.preempt(h) and h.status is JobStatus.PREEMPTED
    assert h.checkpoint.sp > 0 and h.checkpoint.job_epochs == 6
    m1.run()
    _assert_solo(rider, _solo(fib.PROGRAM, fib.initial(10), 512))
    # the checkpoint resumes in the second region of a fresh wave, and
    # again after a second preemption, into the live carry of a third
    other = handle(2)
    m2 = _mux([other, h], chunk=3, dispatch=dispatch)
    m2.step()
    assert m2.preempt(h)
    late = handle(3)
    m3 = _mux([late, _fib(4, 9, 512)], chunk=3, dispatch=dispatch)
    m3.step()
    while late.status is JobStatus.RUNNING:
        m3.step()
    assert m3.admit(h) is True  # restored into the freed region
    m3.run()
    m2.run()
    for x in (h, other, late):
        _assert_solo(x, solo)
    assert h.preemptions == 2


def test_mid_chunk_overflow_isolates_one_region():
    bad, good = _fib(0, 12, 8, "bad"), _fib(1, 10, 512, "good")
    mux = _mux([bad, good], chunk=2)
    mux.run()
    assert bad.status is JobStatus.FAILED
    assert isinstance(bad.error, JobFailure)
    _assert_solo(good, _solo(fib.PROGRAM, fib.initial(10), 512))


def test_stack_overflow_fails_its_region_alone():
    bad, good = _fib(0, 12, 512, "bad"), _fib(1, 10, 512, "good")
    mux = _mux([bad, good], chunk=4, stack_depth=4)
    mux.run()
    assert bad.status is JobStatus.FAILED
    assert "stack_depth=4" in str(bad.error)


def test_vacant_region_of_a_template_wave_seats_a_job():
    """A template wave may start with a vacant region (handle None): its
    stack starts empty and a structurally equal job seats there at a
    chunk boundary, ending as its solo run does."""
    first = _mux([_fib(0, 8, 512), _fib(1, 8, 512)], chunk=2)
    tpl = WaveTemplate(key="fib2", program=first.program, slots=first.slots,
                       loop=first.loop)
    live = _fib(2, 10, 512)
    mux = _mux([live, None], chunk=2, template=tpl)
    mux.step()
    late = _fib(3, 7, 256)
    assert mux.admit(late) is True
    mux.run()
    _assert_solo(live, _solo(fib.PROGRAM, fib.initial(10), 512))
    _assert_solo(late, _solo(fib.PROGRAM, fib.initial(7), 256))
    assert tpl.loop.trace_count == 1  # one resident body, on the template


# ----------------------------------------------------- trailing-drain edges
def test_chunk_larger_than_remaining_epochs_is_clean():
    def run(chunk):
        h = _fib(0, 10, 512)
        mux = _mux([h], chunk=chunk)
        mux.run()
        return h, mux.stats()

    h_inf, s_inf = run(None)
    h_big, s_big = run(1000)  # far past the 19 epochs it takes
    assert dataclasses.asdict(s_big) == dataclasses.asdict(s_inf)
    assert torch.equal(h_big.result.value, h_inf.result.value)
    h_k10, s_k10 = run(10)  # chunks of 10 + 9
    assert s_k10.scalar_transfers == 2
    for f in ("epochs", "tasks_executed", "total_forks", "map_launches",
              "map_elements", "map_lanes_launched", "lanes_launched"):
        assert getattr(s_k10, f) == getattr(s_inf, f), f


def test_empty_steps_after_the_drain_change_nothing():
    mux = _mux([_fib(0, 8, 128)], chunk=4)
    mux.run()
    snap = dataclasses.asdict(mux.stats())
    assert mux.step() == []
    assert mux.step() == []
    assert dataclasses.asdict(mux.stats()) == snap


# ------------------------------------------------ the wave-template cache
def test_identical_consecutive_waves_build_nothing():
    svc = JobService(capacity=512, max_jobs=2, engine="device", chunk=3,
                     device="cpu")
    ns = (8, 9)
    wave_a = [svc.submit(fib.PROGRAM, fib.initial(n), quota=256) for n in ns]
    svc.drain()
    builds = svc.trace_count
    assert builds > 0
    assert (svc.template_cache.misses, svc.template_cache.hits) == (1, 0)
    wave_b = [svc.submit(fib.PROGRAM, fib.initial(n), quota=256) for n in ns]
    svc.drain()
    assert svc.trace_count == builds  # zero new builds
    assert svc.template_cache.hits == 1
    for h, n in zip(wave_a + wave_b, ns + ns):
        assert h.status is JobStatus.DONE
        assert int(h.result.value[0, 0]) == fib.fib_reference(n)


def test_permuted_wave_builds_nothing():
    fibc, treec = get_case("fib"), get_case("treewalk")
    solo = {c.name: _solo(c.program, c.initial, q, c.heap_init)
            for c, q in ((fibc, 512), (treec, 256))}
    svc = JobService(capacity=768, max_jobs=2, engine="device", chunk=3,
                     device="cpu")
    wave_a = [svc.submit_case(fibc, quota=512),
              svc.submit_case(treec, quota=256)]
    svc.drain()
    builds = svc.trace_count
    wave_b = [svc.submit_case(treec, quota=256),
              svc.submit_case(fibc, quota=512)]
    svc.drain()
    assert svc.trace_count == builds
    assert (svc.template_cache.misses, svc.template_cache.hits) == (1, 1)
    for h in wave_a + wave_b:
        _assert_solo(h, solo[h.job.name])


def test_wave_template_key_ignores_member_order():
    fibc, treec = get_case("fib"), get_case("treewalk")
    a = Job(fibc.program, fibc.initial, quota=512, name="fib")
    b = Job(treec.program, treec.initial, heap_init=dict(treec.heap_init),
            quota=256, name="treewalk")
    k_ab = wave_template_key([a, b], 768, 1 << 10, 3)
    assert k_ab == wave_template_key([b, a], 768, 1 << 10, 3)
    a2 = Job(fibc.program, fibc.initial, quota=256, name="fib")
    assert wave_template_key([a2, b], 768, 1 << 10, 3) != k_ab
    assert wave_template_key([a, b], 768, 1 << 10, 3,
                             megakernel=True) != k_ab


def test_service_streams_admission_through_chunked_waves():
    svc = JobService(capacity=1024, max_jobs=2, engine="device", chunk=2,
                     device="cpu")
    ns = (4, 12, 6)
    hs = [svc.submit(fib.PROGRAM, fib.initial(n), quota=512) for n in ns]
    svc.drain()
    for h, n in zip(hs, ns):
        _assert_solo(h, _solo(fib.PROGRAM, fib.initial(n), 512))
    # the third job was seated mid-wave: one wave shape was ever built
    assert (svc.template_cache.misses, svc.template_cache.hits) == (1, 0)


def test_service_priority_preempts_and_resumes_on_device_waves():
    from repro_torch.service import QuotaClass

    svc = JobService(
        capacity=256, max_jobs=1, engine="device", chunk=2, device="cpu",
        classes=[QuotaClass("batch"), QuotaClass("interactive", priority=10)],
    )
    lo = svc.submit(fib.PROGRAM, fib.initial(9), quota=256, klass="batch")
    svc._pump()
    svc._pump()
    hi = svc.submit(fib.PROGRAM, fib.initial(7), quota=256,
                    klass="interactive", deadline=60.0)
    done = svc.drain()
    assert done[0] is hi and lo.preemptions >= 1
    _assert_solo(lo, _solo(fib.PROGRAM, fib.initial(9), 256))
    assert int(hi.result.value[0, 0]) == fib.fib_reference(7)


# -------------------------------------------- live-span bucketed task steps
@pytest.mark.parametrize("dispatch", ("masked", "gather"))
def test_resident_launches_bucket_to_the_live_span(dispatch):
    handles = [JobHandle(i, Job(c.program, c.initial, dict(c.heap_init),
                                quota=q, name=c.name))
               for i, (c, q) in enumerate(get_fleet("mixed3"))]
    mux = _mux(handles, dispatch=dispatch)
    mux.run()
    fs = mux.stats()
    assert fs.hole_lanes_skipped > 0
    assert fs.lanes_launched + fs.hole_lanes_skipped == (
        fs.epochs * mux.capacity)
    assert fs.lanes_launched < fs.epochs * mux.capacity


# --------------------------------------------------------- the service
def test_service_device_engine_end_to_end():
    """engine='device', chunk=None: each wave is one chunk, so the fleet
    pays one dispatch and one readback a wave."""
    svc = JobService(capacity=1024, max_jobs=2, engine="device",
                     device="cpu")
    ns = (8, 9, 10, 11, 12)
    hs = [svc.submit(fib.PROGRAM, fib.initial(n), quota=512) for n in ns]
    done = svc.drain()
    assert {h.job_id for h in done} == {h.job_id for h in hs}
    for h, n in zip(hs, ns):
        assert int(h.result.value[0, 0]) == fib.fib_reference(n)
        assert h.result.stats.shared_dispatches == 1
    fs = svc.stats()
    assert fs.dispatches == fs.scalar_transfers == 3  # three waves


@pytest.mark.parametrize("dispatch", ("masked", "gather"))
def test_service_device_wave_matches_host_wave(dispatch):
    fleet = get_fleet("mixed4")
    runs = {}
    for engine in ("host", "device"):
        kw = dict(chunk=4, megakernel=True) if engine == "device" else {}
        svc = JobService(capacity=sum(q for _, q in fleet), engine=engine,
                         dispatch=dispatch, device="cpu", **kw)
        runs[engine] = ([svc.submit_case(c, quota=q) for c, q in fleet],
                        svc.stats)
        svc.drain()
    for h, d in zip(*(runs[e][0] for e in ("host", "device"))):
        assert torch.equal(h.result.value, d.result.value)
        for k in h.result.heap:
            assert torch.equal(h.result.heap[k], d.result.heap[k])
        assert h.result.stats.solo_dict() == d.result.stats.solo_dict()
    hs, ds = runs["host"][1](), runs["device"][1]()
    assert ds.epochs == hs.epochs and ds.tasks_executed == hs.tasks_executed
    assert ds.dispatches == math.ceil(ds.epochs / 4) < hs.dispatches


# ------------------------------------------------------------ refusals
def test_device_multiplexer_refuses_compacted():
    with pytest.raises(ValueError, match="masked"):
        _mux([_fib(0, 8, 64)], dispatch="compacted")


def test_service_device_engine_refuses_host_only_options():
    with pytest.raises(ValueError, match="masked"):
        JobService(engine="device", dispatch="compacted", device="cpu")
    with pytest.raises(ValueError, match="fuse_all"):
        JobService(engine="device", pop_policy="round_robin", device="cpu")
    with pytest.raises(ValueError, match="fuse_all"):
        JobService(engine="device", gang=2, device="cpu")
    with pytest.raises(ValueError, match="host"):
        JobService(engine="tpu", device="cpu")
    with pytest.raises(ValueError, match="engine='device'"):
        JobService(chunk=4, device="cpu")
    with pytest.raises(ValueError, match="engine='device'"):
        JobService(megakernel=True, device="cpu")
    with pytest.raises(ValueError, match="chunk"):
        JobService(engine="device", chunk=0, device="cpu")


@pytest.mark.parametrize("kw, item", (
    (dict(engine="sharded"), "9"),
    (dict(engine="device", chunk="auto"), "8"),
    (dict(engine="device", dispatch="auto"), "8"),
    (dict(engine="device", tracer=object()), "8"),
))
def test_options_still_to_port_raise(kw, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP item {item}"):
        JobService(device="cpu", **kw)
