"""The port's multi-tenant job service (host half) on the CPU.

Co-scheduling N programs in one shared TVM must be invisible to each
tenant: under the masked, compacted and gather dispatches every job's
heap, TV-value block and ``JobStats.solo_dict()`` equal, exactly, a solo
``HostEngine(capacity=quota)`` run of the port (which earlier files hold to
the JAX package); on ``mixed4`` (masked, gather) and ``fib_fleet``
(masked) they equal the JAX ``EpochMultiplexer`` per job, and the fleet
``RunStats`` equal the JAX fleet's field for field.  Around that: the
fused program's tables, one arena commit from a converted JAX state,
streaming completions, mid-flight admission, preempt/resume, quota
overflow, refusals, and the admission policy on a fake clock.
"""
from __future__ import annotations

import asyncio
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.apps import get_fleet as jget_fleet
from repro.service import EpochMultiplexer as JEpochMultiplexer
from repro.service import Job as JJob
from repro.service import JobHandle as JJobHandle
from repro.service import fuse_programs as jfuse_programs
from repro_torch.apps import fib, get_fleet, treewalk
from repro_torch.core import HostEngine, InitialTask, Program, TaskType
from repro_torch.core import convert
from repro_torch.kernels import fork_compact
from repro_torch.service import (
    AdmissionController,
    AdmissionError,
    EpochMultiplexer,
    Job,
    JobFailure,
    JobHandle,
    JobService,
    JobStatus,
    QuotaClass,
    fuse_programs,
)

DISPATCHES = ("masked", "compacted", "gather")
FLEETS = ("mixed3", "mixed4", "fib_fleet")
SNAP_AFTER = 4  # global epochs before the converted-state commit


def _solo(case, quota, dispatch="masked"):
    return HostEngine(case.program, capacity=quota, dispatch=dispatch,
                      device="cpu").run(
        case.initial, heap_init=dict(case.heap_init) or None)


def _handles(fleet, cls_job, cls_handle):
    return [
        cls_handle(i, cls_job(c.program, c.initial, dict(c.heap_init),
                              quota=q, name=c.name))
        for i, (c, q) in enumerate(fleet)
    ]


def _np(x):
    return np.asarray(x)


@functools.lru_cache(maxsize=None)
def _jax_fleet(name: str, dispatch: str):
    """One JAX EpochMultiplexer run of a fleet (cached per module): each
    job's value, heap and JobStats, the fleet RunStats, and — on the
    masked run — the TVM state, heap, arena and stacks before and after
    global epoch SNAP_AFTER + 1."""
    hs = _handles(jget_fleet(name), JJob, JJobHandle)
    mux = JEpochMultiplexer(hs, dispatch=dispatch)
    snaps = []

    def snap():
        snaps.append(dict(
            state={f: _np(getattr(mux._state, f)).copy()
                   for f in convert.FIELDS},
            heap={k: _np(v).copy() for k, v in mux._heap.items()},
            arena={f: _np(getattr(mux._arena, f)).copy()
                   for f in ("slot_job", "base", "end", "next")},
            stacks=[r.sched.export_stack() if r.sched else None
                    for r in mux._regions],
        ))

    if dispatch == "masked":
        for _ in range(SNAP_AFTER):
            mux.step()
        snap()
        mux.step()
        snap()
    mux.run()
    jobs = {
        h.job.name if name != "fib_fleet" else h.job_id: dict(
            value=_np(h.result.value),
            heap={k: _np(v) for k, v in h.result.heap.items()},
            stats=dataclasses.asdict(h.result.stats),
        )
        for h in hs
    }
    return jobs, mux.stats().as_dict(), snaps


def _assert_matches_solo(h, solo, what):
    heap, value, stats = solo
    assert h.status is JobStatus.DONE, (what, h.error)
    assert torch.equal(h.result.value, value), what
    assert set(h.result.heap) == set(heap)
    for k in heap:
        assert torch.equal(h.result.heap[k], heap[k]), (what, k)
    sd = h.result.stats.solo_dict()
    assert sd == {k: getattr(stats, k) for k in sd}, what


# ------------------------------------------- the multi-tenant equivalence
@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("name", FLEETS)
def test_fleet_matches_solo_runs(name, dispatch):
    fleet = get_fleet(name)
    solo = [_solo(c, q, dispatch) for c, q in fleet]
    svc = JobService(capacity=sum(q for _, q in fleet), dispatch=dispatch,
                     device="cpu")
    handles = [svc.submit_case(c, quota=q) for c, q in fleet]
    done = svc.drain()
    assert {h.job_id for h in done} == {h.job_id for h in handles}
    for h, s, (c, _) in zip(handles, solo, fleet):
        _assert_matches_solo(h, s, f"{name}/{dispatch}/{c.name}")
    fs = svc.stats()
    # fused global epochs = the longest member's, not the sum
    assert fs.epochs == max(s[2].epochs for s in solo)
    assert fs.dispatches + fs.scalar_transfers < sum(
        s[2].dispatches + s[2].scalar_transfers for s in solo)


@pytest.mark.parametrize("name,dispatch", [
    ("mixed4", "masked"), ("mixed4", "gather"), ("fib_fleet", "masked"),
])
def test_fleet_matches_jax_multiplexer(name, dispatch):
    jobs, jstats, _ = _jax_fleet(name, dispatch)
    hs = _handles(get_fleet(name), Job, JobHandle)
    mux = EpochMultiplexer(hs, dispatch=dispatch, device="cpu")
    mux.run()
    for h in hs:
        want = jobs[h.job.name if name != "fib_fleet" else h.job_id]
        np.testing.assert_array_equal(h.result.value.numpy(), want["value"])
        assert set(h.result.heap) == set(want["heap"])
        for k, v in want["heap"].items():
            np.testing.assert_array_equal(h.result.heap[k].numpy(), v)
        assert dataclasses.asdict(h.result.stats) == want["stats"]
    assert mux.stats().as_dict() == jstats


def test_arena_commit_from_converted_jax_state():
    """Hand the JAX fleet's state, heap, arena and stacks after a few
    global epochs to the port; one more epoch on each gives the same TV,
    heap and arena, field for field."""
    _, _, (pre, post) = _jax_fleet("mixed4", "masked")
    hs = _handles(get_fleet("mixed4"), Job, JobHandle)
    mux = EpochMultiplexer(hs, device="cpu")
    for _ in range(SNAP_AFTER):
        mux.step()
    mux._state = convert.state_from_numpy(pre["state"], "cpu")
    mux._heap = convert.heap_from_numpy(pre["heap"], "cpu")
    mux._arena = convert.arena_from_numpy(pre["arena"], "cpu")
    for r, st in zip(mux._regions, pre["stacks"]):
        r.sched.load_stack(*st)
    mux.step()
    got = convert.state_to_numpy(mux._state)
    for f in convert.FIELDS:
        np.testing.assert_array_equal(got[f], post["state"][f], err_msg=f)
    heap = convert.heap_to_numpy(mux._heap)
    assert set(heap) == set(post["heap"])
    for k, v in post["heap"].items():
        np.testing.assert_array_equal(heap[k], v, err_msg=k)
    arena = convert.arena_to_numpy(mux._arena)
    for f, v in post["arena"].items():
        np.testing.assert_array_equal(arena[f], v, err_msg=f)
    for r, st in zip(mux._regions, post["stacks"]):
        if st is not None and r.sched is not None:
            for a, b in zip(r.sched.export_stack(), st):
                np.testing.assert_array_equal(a, b)


def test_fused_program_tables_match_jax():
    fleet, jfleet = get_fleet("mixed4"), jget_fleet("mixed4")
    quotas = [q for _, q in fleet]
    fused, slots = fuse_programs([c.program for c, _ in fleet], quotas)
    jfused, jslots = jfuse_programs([c.program for c, _ in jfleet], quotas)
    assert [t.name for t in fused.tasks] == [t.name for t in jfused.tasks]
    assert [m.name for m in fused.maps] == [m.name for m in jfused.maps]
    assert [(h.name, tuple(h.shape)) for h in fused.heap] == [
        (h.name, tuple(h.shape)) for h in jfused.heap]
    assert (fused.n_arg_i, fused.n_arg_f, fused.value_width) == (
        jfused.n_arg_i, jfused.n_arg_f, jfused.value_width)
    keys = ("index", "task_offset", "map_offset", "prefix", "base", "quota")
    assert [[getattr(s, k) for k in keys] for s in slots] == [
        [getattr(s, k) for k in keys] for s in jslots]
    for s, (c, _) in zip(slots, fleet):
        for t in c.program.tasks:
            assert fused.task_id(s.prefix + t.name) == (
                s.task_offset + c.program.task_id(t.name))


def test_treewalk_matches_its_reference():
    for order in ("post", "pre"):
        left, right = treewalk.random_tree(37, seed=3)
        heap, _, _ = HostEngine(
            treewalk.make_program(37, order), capacity=1 << 10,
            device="cpu",
        ).run(treewalk.initial(), heap_init=dict(left=left, right=right))
        visit, clock = treewalk.treewalk_reference(left, right, order)
        np.testing.assert_array_equal(heap["visit_epoch"].numpy(), visit)
        np.testing.assert_array_equal(heap["visit_clock"].numpy(), clock)


# ------------------------------------------- structural program hashing
def _make_tree_prog(fanout=2):
    """A fresh Program each call: the same construction path gives the
    same structure with distinct function objects."""

    def _node(ctx):
        d, maxd = ctx.argi(0), ctx.argi(1)
        leaf = d >= maxd
        ctx.emit(d, where=leaf)
        for _ in range(fanout):
            ctx.fork("node", argi=(d + 1, maxd), where=~leaf)
        ctx.join("sum", where=~leaf)

    def _sum(ctx):
        ctx.emit(ctx.child_values(fanout)[..., 0].sum(1))

    return Program(
        name=f"tree{fanout}",
        tasks=(TaskType("node", _node), TaskType("sum", _sum)),
        n_arg_i=2,
    )


def test_structural_hash_equality_and_sensitivity():
    a, b, c = _make_tree_prog(2), _make_tree_prog(2), _make_tree_prog(3)
    assert a.structural_hash() == b.structural_hash()
    assert a.structural_hash() != c.structural_hash()
    assert a.structural_hash() == dataclasses.replace(
        a, name="renamed").structural_hash()
    fused, _ = fuse_programs([a, b], [32, 32])
    assert fused.structural_hash() != a.structural_hash()
    # array contents are structure (a heap-size constant captured by value)
    assert (treewalk.make_program(21).structural_hash()
            != treewalk.make_program(22).structural_hash())


# --------------------------------------------------- streaming / reuse
def test_streaming_completions_admit_midflight():
    """Six fib jobs through four regions: the two queued jobs seat in
    freed regions of the same wave, and completions stream as each job
    drains."""
    ns = (11, 8, 12, 9, 10, 7)
    svc = JobService(capacity=4 * 512, max_jobs=4, device="cpu")
    handles = [svc.submit(fib.PROGRAM, fib.initial(n), quota=512,
                          name=f"fib{n}") for n in ns]
    muxes, order = set(), []
    for h in svc.completions():
        muxes.add(svc._mux)
        order.append(h.job.name)
    assert len(muxes) == 1 and len(order) == len(ns)
    assert order.index("fib8") < order.index("fib12")
    for h, n in zip(handles, ns):
        solo = HostEngine(fib.PROGRAM, capacity=512, device="cpu").run(
            fib.initial(n))
        _assert_matches_solo(h, solo, f"fib{n}")
        assert int(h.result.value[0, 0]) == fib.fib_reference(n)


def test_structurally_equal_tenant_reuses_region():
    p1, p2 = _make_tree_prog(), _make_tree_prog()
    svc = JobService(capacity=512, max_jobs=2, device="cpu")
    a = svc.submit(p1, InitialTask("node", (0, 2)), quota=256, name="short")
    b = svc.submit(p1, InitialTask("node", (0, 6)), quota=256, name="long")
    c = svc.submit(p2, InitialTask("node", (0, 3)), quota=256, name="late")
    muxes = set()
    for _ in svc.completions():
        muxes.add(svc._mux)
    assert len(muxes) == 1
    for h, p, d in ((a, p1, 2), (b, p1, 6), (c, p2, 3)):
        solo = HostEngine(p, capacity=256, device="cpu").run(
            InitialTask("node", (0, d)))
        _assert_matches_solo(h, solo, h.job.name)


def test_structurally_different_tenant_waits_for_next_wave():
    p1, p2 = _make_tree_prog(2), _make_tree_prog(3)
    svc = JobService(capacity=512, max_jobs=2, device="cpu")
    svc.submit(p1, InitialTask("node", (0, 2)), quota=256)
    svc.submit(p1, InitialTask("node", (0, 6)), quota=256)
    svc.submit(p2, InitialTask("node", (0, 2)), quota=256)
    muxes = set()
    for _ in svc.completions():
        muxes.add(svc._mux)
    assert len(muxes) == 2


# ------------------------------------------------------ preempt/resume
@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_preempt_resume_bit_identical(dispatch):
    solo = HostEngine(fib.PROGRAM, capacity=256, dispatch=dispatch,
                      device="cpu").run(fib.initial(9))

    def handle(i):
        return JobHandle(i, Job(fib.PROGRAM, fib.initial(9), quota=256))

    h = handle(0)
    m1 = EpochMultiplexer([h], dispatch=dispatch, device="cpu")
    for _ in range(3):
        m1.step()
    assert m1.preempt(h) and h.status is JobStatus.PREEMPTED
    assert h.preemptions == 1 and h.checkpoint is not None
    rider = handle(1)
    # the checkpoint resumes in the second region of a fresh wave
    m2 = EpochMultiplexer([rider, h], dispatch=dispatch, device="cpu")
    m2.run()
    _assert_matches_solo(h, solo, "resumed")
    _assert_matches_solo(rider, solo, "rider")
    assert not m2.preempt(h)  # finished: nothing to preempt


def test_service_priority_preempts_and_resumes():
    solo = HostEngine(fib.PROGRAM, capacity=256, device="cpu").run(
        fib.initial(9))
    svc = JobService(
        capacity=256, max_jobs=1, device="cpu",
        classes=[QuotaClass("batch"), QuotaClass("interactive", priority=10)],
    )
    lo = svc.submit(fib.PROGRAM, fib.initial(9), quota=256, klass="batch")
    svc._pump()
    svc._pump()
    hi = svc.submit(fib.PROGRAM, fib.initial(7), quota=256,
                    klass="interactive", deadline=60.0)
    done = svc.drain()
    assert done[0] is hi and lo.preemptions >= 1
    _assert_matches_solo(lo, solo, "preempted")
    assert svc.admission.preempted == {"batch": lo.preemptions}
    assert int(hi.result.value[0, 0]) == fib.fib_reference(7)


def test_explicit_preempt_requeues_and_resumes():
    solo = HostEngine(fib.PROGRAM, capacity=256, device="cpu").run(
        fib.initial(10))
    svc = JobService(capacity=256, device="cpu")
    h = svc.submit(fib.PROGRAM, fib.initial(10), quota=256)
    for _ in range(4):
        svc._pump()
    assert svc.preempt(h) and h.status is JobStatus.PREEMPTED
    assert not svc.preempt(h)
    assert svc.result(h) is h.result
    _assert_matches_solo(h, solo, "explicit preempt")


# -------------------------------------------------- failure / admission
def test_quota_overflow_fails_only_that_job():
    svc = JobService(capacity=1024, device="cpu")
    bad = svc.submit(fib.PROGRAM, fib.initial(12), quota=8, name="bad")
    good = svc.submit(fib.PROGRAM, fib.initial(10), quota=512, name="good")
    svc.drain()
    assert bad.status is JobStatus.FAILED
    assert isinstance(bad.error, JobFailure)
    solo = HostEngine(fib.PROGRAM, capacity=512, device="cpu").run(
        fib.initial(10))
    _assert_matches_solo(good, solo, "neighbour")
    with pytest.raises(JobFailure):
        svc.result(bad)


def test_admission_rejects_bad_jobs():
    svc = JobService(capacity=1024, device="cpu")
    with pytest.raises(AdmissionError):
        svc.submit(fib.PROGRAM, fib.initial(8), quota=4096)
    with pytest.raises(AdmissionError):
        svc.submit(fib.PROGRAM, fib.initial(8), quota=1)
    with pytest.raises(AdmissionError):
        svc.submit(fib.PROGRAM, InitialTask("nope", (1,)), quota=64)
    with pytest.raises(AdmissionError):
        svc.submit(fib.PROGRAM, fib.initial(5), quota=64, klass="nope")


def test_unported_options_raise():
    # engine="device" is ported (tests/test_torch_chunked_service.py);
    # its adaptive chunk is not
    assert JobService(engine="device", device="cpu").engine == "device"
    with pytest.raises(NotImplementedError, match="ROADMAP item 8"):
        JobService(engine="device", chunk="auto", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP item 9"):
        JobService(engine="sharded", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP item 8"):
        JobService(dispatch="auto", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP item 8"):
        JobService(metrics=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP item 8"):
        JobService(tracer=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            JobService()


def test_submit_async_and_cpu_path_launches_no_kernel():
    fork_compact.reset_launches()
    svc = JobService(capacity=1024, device="cpu")

    async def main():
        futs = [svc.submit_async(fib.PROGRAM, fib.initial(n), quota=256)
                for n in (6, 9, 7)]
        return await asyncio.gather(*futs)

    results = asyncio.run(main())
    assert [int(r.value[0, 0]) for r in results] == [
        fib.fib_reference(n) for n in (6, 9, 7)]
    assert fork_compact.LAUNCHES["segmented_fork_scan"] == 0


# ---------------------------------------------- admission policy (pure)
def _jh(i, quota=64, **kw):
    return JobHandle(i, Job(fib.PROGRAM, fib.initial(5), quota=quota), **kw)


def test_admission_order_priority_then_edf_then_fifo():
    adm = AdmissionController(
        classes=[QuotaClass("hi", priority=5)], clock=lambda: 0.0)
    a, b = _jh(0), _jh(1, deadline=10.0)
    c, d = _jh(2, klass="hi"), _jh(3, priority=9)
    assert adm.order([a, b, c, d]) == [d, c, b, a]


def test_admission_share_and_rate_limit():
    adm = AdmissionController(
        classes=[QuotaClass("greedy", share=0.5)], clock=lambda: 0.0)
    hs = [_jh(i, klass="greedy") for i in range(4)] + [_jh(4)]
    wave, left = adm.take_wave(hs, capacity=256, max_jobs=8)
    assert [h.job_id for h in wave] == [0, 1, 4]
    assert [h.job_id for h in left] == [2, 3]
    t = [0.0]
    adm = AdmissionController(
        classes=[QuotaClass("limited", rate=1.0, burst=1.0)],
        clock=lambda: t[0])
    a, b = _jh(0, klass="limited"), _jh(1, klass="limited")
    assert adm.allow(a) and not adm.allow(b) and not adm.has_token(b)
    t[0] = 1.5
    assert adm.has_token(b) and adm.allow(b)


def test_plan_preemptions_and_deadlines_on_a_fake_clock():
    t = [0.0]
    adm = AdmissionController(
        classes=[QuotaClass("hi", priority=5),
                 QuotaClass("pinned", preemptible=False)],
        clock=lambda: t[0])
    run_lo, run_pin, run_hi = _jh(0), _jh(1, klass="pinned"), _jh(2,
                                                                 klass="hi")
    for h in (run_lo, run_pin, run_hi):
        h.mark_running()
    assert adm.plan_preemptions([run_lo, run_pin, run_hi],
                                [_jh(3, klass="hi")]) == [run_lo]
    assert adm.plan_preemptions([run_hi], [_jh(4, klass="hi")]) == []
    h = _jh(5, deadline=5.0, clock=lambda: t[0])
    assert adm.deadline_slack([h]) == 5.0
    t[0] = 2.0
    h.mark_running()
    t[0] = 4.0
    h.mark_finished()
    assert adm.note_finished(h) is True
    assert (h.queue_wait, h.run_time) == (2.0, 2.0)
    late = _jh(6, deadline=1.0, clock=lambda: t[0])
    late.mark_running()
    t[0] = 9.0
    late.mark_finished()
    assert adm.note_finished(late) is False and adm.miss_ratio() == 0.5
