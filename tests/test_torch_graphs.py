"""CUDA graphs of the host epoch steps and of the server's decode step.

On the CPU (no card, no JAX): the tensors a captured step reads keep their
addresses from epoch to epoch — the TV, heap and arena, updated in place,
and the steps' input buffers — on ``HostEngine`` in the three dispatches,
on ``EpochMultiplexer`` across a mid-flight admission, and in two
``decode_step`` calls; and the compacted step's device-side type offsets
give the bits of host-int slices.

On the CPU too, ``JobService`` runs a host wave on the last wave's loop
and buffers when the layout is the same.

Marked ``cuda`` (skipped here): graphed runs against eager runs
(``graphs=False``) on the card, each key captured at its third use (the
fourth of four identical runs capturing nothing), graphs
replayed out of their capture order, and the servers' tokens.  The file
imports no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_graphs.py
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: F401,E402

from repro_torch import configs  # noqa: E402
from repro_torch.apps import all_cases, fib, get_case, get_fleet  # noqa: E402
from repro_torch.apps.registry import AppCase  # noqa: E402
from repro_torch.core import HostEngine, tvm  # noqa: E402
from repro_torch.core.engine import _bound_tensors  # noqa: E402
from repro_torch.core.graphs import CapturedStep  # noqa: E402
from repro_torch.core.scheduler import (  # noqa: E402
    EpochScheduler,
    size_type_buckets,
)
from repro_torch.models import decode_step, init_cache, init_model  # noqa: E402
from repro_torch.serving import EpochServer, Request  # noqa: E402
from repro_torch.service import (  # noqa: E402
    EpochMultiplexer,
    Job,
    JobHandle,
    JobService,
)

DISPATCHES = ("masked", "compacted", "gather")


def _ptrs(tensors):
    return [t.data_ptr() for t in tensors]


def _watch(loop):
    """Record, for every epoch ``loop`` runs, the addresses of what a
    captured step reads: the state, heap and arena, the inputs the steps
    were handed, and the readback's stack."""
    seen = []
    run_epoch = loop.run_epoch
    steps = {}

    def spy(name):
        fn = getattr(loop, name)

        def wrapped(state, heap, start, *rest, **kw):
            steps.setdefault("inputs", []).append(
                (name, start) + tuple(a for a in rest
                                      if torch.is_tensor(a)
                                      and a.dim() <= 1))
            return fn(state, heap, start, *rest, **kw)
        return wrapped

    for name in ("masked_step", "compacted_step", "gather_step"):
        setattr(loop, name, spy(name))

    def wrapped(state, heap, start, span, cen, col, readback, arena=None):
        steps["inputs"] = []
        out = run_epoch(state, heap, start, span, cen, col, readback,
                        arena=arena)
        ins = steps["inputs"]
        assert len(ins) == 1 and all(torch.is_tensor(t) for t in ins[0][1:])
        seen.append((_ptrs(_bound_tensors(state, heap, arena)),
                     [(t.data_ptr(), tuple(t.shape)) for t in ins[0][1:]]))
        return out

    loop.run_epoch = wrapped
    return seen


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_host_engine_steps_read_fixed_tensors(dispatch):
    eng = HostEngine(fib.PROGRAM, capacity=1 << 10, dispatch=dispatch,
                     device="cpu")
    seen = _watch(eng.loop)
    heap, value, stats = eng.run(fib.initial(12))
    assert int(value[0, 0]) == fib.fib_reference(12)
    assert len(seen) == stats.epochs > 10
    assert all(s[0] == seen[0][0] for s in seen)
    # start, count and cen (a solo frontier: 0-d) come from one buffer
    scalars = {p for s in seen for p in s[1] if p[1] == ()}
    assert len(scalars) == (1 if dispatch == "gather" else 3)
    if dispatch == "compacted":
        # perm, its per-type offsets and counts: one [P] perm per bucket
        assert all(len(s[1]) == 6 for s in seen)


def test_multiplexer_steps_read_fixed_tensors():
    fleet = get_fleet("mixed3")
    quotas = [q for _, q in fleet]
    extra = get_case("bfs")
    svc = JobService(capacity=sum(quotas), dispatch="masked", device="cpu")
    handles = [svc.submit_case(c, quota=q) for c, q in fleet]
    # a fourth job: seated in the bfs region once that frees, mid-flight
    handles.append(svc.submit_case(extra, quota=quotas[2]))
    svc._pump()
    mux = svc._mux
    assert isinstance(mux, EpochMultiplexer)
    seen = _watch(mux.loop)
    arena, heap = mux._arena, dict(mux._heap)
    list(svc.completions())
    assert all(h.status.value == "done" for h in handles)
    # the fourth job rode the same wave: the region was reseeded in place
    assert svc._mux is mux and not mux.live
    assert len({tuple(s[0]) for s in seen}) == 1
    assert mux._arena is arena
    assert all(mux._heap[k] is v for k, v in heap.items())
    # the fused cen buffer of each bucket keeps its address
    cens = {}
    for _, ins in seen:
        ptr, shape = ins[2]
        assert cens.setdefault(shape, ptr) == ptr
    solo = HostEngine(extra.program, capacity=quotas[2], device="cpu").run(
        extra.initial, heap_init=dict(extra.heap_init) or None)
    assert torch.equal(handles[-1].result.value, solo[1])
    assert torch.equal(handles[-1].result.heap["dist"], solo[0]["dist"])


def _handles(fleet):
    return [JobHandle(job_id=i, job=Job(
        program=c.program, initial=c.initial, heap_init=dict(c.heap_init),
        quota=q, name=c.name)) for i, (c, q) in enumerate(fleet)]


def _results(handles):
    return [(h.result.heap, h.result.value, h.result.stats.solo_dict())
            for h in handles]


def _same_results(a, b):
    for (ha, va, sa), (hb, vb, sb) in zip(a, b):
        assert torch.equal(va, vb) and sa == sb
        assert ha.keys() == hb.keys()
        assert all(torch.equal(ha[k], hb[k]) for k in ha)


def _drain_wave(svc, members):
    handles = [svc.submit_case(c, quota=q) for c, q in members]
    list(svc.completions())
    assert all(h.status.value == "done" for h in handles)
    return handles, svc._mux


def test_service_wave_runs_on_the_last_waves_loop():
    """JobService hands a finished host wave's loop and TV, heap and arena
    tensors (what keeps its graphs valid on the card) to the next wave of
    the same layout, which gives the first wave's results; a wave of
    another layout gets its own."""
    fleet = get_fleet("mixed3")
    svc = JobService(capacity=sum(q for _, q in fleet), dispatch="masked",
                     device="cpu")
    first_h, first = _drain_wave(svc, fleet)
    again_h, again = _drain_wave(svc, fleet)
    assert again is not first and again.loop is first.loop
    assert again._state is first._state and again._arena is first._arena
    assert again._heap is first._heap
    _same_results(_results(again_h), _results(first_h))
    other = [(c, q) for c, q in fleet[:2]]
    other_h, third = _drain_wave(svc, other)
    assert third.loop is not first.loop and third._state is not first._state
    solo = [HostEngine(c.program, capacity=q, device="cpu").run(
        c.initial, heap_init=dict(c.heap_init) or None) for c, q in other]
    for h, (heap, value, _) in zip(other_h, solo):
        assert torch.equal(h.result.value, value)
        assert all(torch.equal(h.result.heap[k], heap[k]) for k in heap)
    # a multiplexer that has stepped, or another dispatch, keeps its own
    fresh = EpochMultiplexer(_handles(fleet), device="cpu",
                             dispatch="gather")
    assert not fresh._adopt(again)
    fresh = EpochMultiplexer(_handles(fleet), device="cpu")
    fresh.step()
    assert not fresh._adopt(again) and fresh.loop is not again.loop


def test_every_kernel_counter_is_registered():
    """The graphs' launch accounting reads the registry: every kernel
    module's LAUNCHES is in it, and a name nothing registered raises."""
    import repro_torch.kernels as kernels
    from repro_torch.kernels import counters

    mods = [getattr(kernels, n) for n in dir(kernels)
            if hasattr(getattr(kernels, n), "LAUNCHES")]
    assert len(mods) == 6
    assert all(any(m.LAUNCHES is c for c in counters._REGISTRY)
               for m in mods)
    snap = counters.snapshot()
    assert set(snap) == {k for m in mods for k in m.LAUNCHES}
    counters.add({"fork_scan": 2})
    counters.add({"fork_scan": 2}, -1)
    assert counters.snapshot() == snap
    with pytest.raises(KeyError):
        counters.add({"no_such_kernel": 1})
    with pytest.raises(ValueError):
        counters.register({"fork_scan": 0})


def test_trace_tasks_compacted_device_offsets_match_host_slices():
    """The compacted step reads each type's slice of the permutation at a
    device-side offset; against slices at host ints (the readback values),
    every recorded effect is the same, bit for bit."""
    case = get_case("mergesort")
    program = case.program
    eng = HostEngine(program, capacity=case.capacity, dispatch="compacted",
                     device="cpu")
    state = tvm.init_state(program, case.capacity, case.initial, "cpu")
    heap = tvm.heap_with_sink(program.init_heap("cpu", **case.heap_init))
    sched = EpochScheduler()
    sched.reset()
    loop = eng.loop
    names = [t.name for t in program.tasks]
    checked = 0
    while sched:
        d = sched.pop()
        P = loop.policy.epoch_bucket(d.count)
        perm, counts = loop.compact_pass(state, d.start, d.count, d.cen, P)
        np_counts = counts.numpy().astype(np.int64)
        buckets, toffs, _, _ = size_type_buckets(loop.policy, np_counts,
                                                 names)
        dev_offs = torch.cumsum(counts, 0, dtype=torch.int32) - counts
        got = tvm.trace_tasks_compacted(
            program, state, heap, torch.tensor(d.start, dtype=torch.int32),
            torch.tensor(d.count, dtype=torch.int32),
            torch.tensor(d.cen, dtype=torch.int32), perm, dev_offs, counts,
            buckets)
        want = _host_slices(program, state, heap, d.start, d.count, d.cen,
                            perm, toffs, np_counts, buckets)
        _same_effects(got, want)
        checked += sum(b > 0 for b in buckets)
        state, heap, summary, mls = loop.compacted_step(
            state, heap, d.start, d.count, d.cen, perm, toffs, np_counts,
            buckets)
        join, forks = bool(summary.join_scheduled), int(summary.total_forks)
        if join:
            sched.push_join(d.cen, d.start, d.count)
        nf = int(state.next_free)
        sched.push_forked(d.cen + 1, nf - forks, forks)
        if bool(summary.map_scheduled):
            heap = loop.maps.run(mls, heap, eng._collector())
    assert checked > 10


def _host_slices(program, state, heap, start, count, cen, perm, toffs,
                 tcounts, buckets):
    """The compacted phase 2 with each type's slice cut at host ints."""
    P = perm.shape[0]
    C = state.capacity
    ar = torch.arange(P, dtype=torch.int32)
    idx = start + ar
    cidx = idx.clamp(0, C - 1)
    active = (ar < count) & (cen > 0) & (state.epoch[cidx] == cen)
    g_task = state.task[cidx]
    perm_p = torch.cat([perm, torch.full((max(buckets),), -1,
                                         dtype=torch.int32)])
    per_type = []
    for tid, B in enumerate(buckets):
        if B <= 0:
            continue
        ts = int(toffs[tid])
        lanepos = perm_p[ts:ts + B]
        within = torch.arange(B, dtype=torch.int32) < int(tcounts[tid])
        valid = within & (lanepos >= 0)
        src = (start + lanepos).clamp(0, C - 1)
        ctx = tvm._run_type(program, tid, state, heap, src)
        pos = torch.where(valid, lanepos, P)
        per_type.append((active & (g_task == tid),
                         tvm._scatter_effects(ctx, pos, P)))
    return per_type, idx, active


def _same_effects(got, want):
    (g_types, g_idx, g_act), (w_types, w_idx, w_act) = got, want
    assert torch.equal(g_idx, w_idx) and torch.equal(g_act, w_act)
    assert len(g_types) == len(w_types)
    for (gm, ge), (wm, we) in zip(g_types, w_types):
        assert torch.equal(gm, wm)
        assert torch.equal(ge.emit_where, we.emit_where)
        assert torch.equal(ge.emit_value, we.emit_value)
        assert (ge.join_site is None) == (we.join_site is None)
        if ge.join_site is not None:
            ge.forks.append(ge.join_site)
            we.forks.append(we.join_site)
        for a, b in zip(ge.forks + ge.writes + ge.map_sites,
                        we.forks + we.writes + we.map_sites):
            for f in dataclasses.fields(a):
                x, y = getattr(a, f.name), getattr(b, f.name)
                assert (torch.equal(x, y) if torch.is_tensor(x)
                        else x == y), f.name


@pytest.mark.parametrize("arch", ("granite_3_8b", "mamba2_1_3b"))
def test_decode_step_updates_cache_in_place(arch):
    cfg = dataclasses.replace(configs.get_reduced(arch), n_layers=2)
    model = init_model(cfg, seed=0, device="cpu")
    cache = init_cache(cfg, 3, 16, device="cpu")
    before = {k: (v, v.data_ptr()) for k, v in cache.items()}
    toks = torch.tensor([[5], [6], [7]])
    for _ in range(2):
        logits, out = decode_step(model, cfg, toks, cache)
        assert out is cache and torch.isfinite(logits).all()
    for k, (t, ptr) in before.items():
        assert cache[k] is t and t.data_ptr() == ptr
    assert cache["lengths"].tolist() == [2, 2, 2]


def test_server_decodes_from_one_token_buffer():
    cfg = dataclasses.replace(configs.get_reduced("granite_3_8b"),
                              n_layers=2, compute_dtype=torch.float32)
    srv = EpochServer(cfg, init_model(cfg, seed=0, device="cpu"),
                      n_slots=2, max_len=32, device="cpu")
    buf = srv._tokens
    for i in range(3):
        srv.submit(Request(prompt=np.arange(3, 9 + i, dtype=np.int32),
                           max_new_tokens=3))
    srv.run_to_completion()
    assert srv._tokens is buf and not srv.graphs and srv.captures == 0
    assert [len(r.output) for r in srv.completed] == [3, 3, 3]


# ------------------------------------------------------------- on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _host(run):
    heap, value, stats = run
    return ({k: v.cpu() for k, v in heap.items()}, value.cpu(),
            stats.as_dict())


def _equal_runs(a, b, what):
    (ha, va, sa), (hb, vb, sb) = a, b
    assert torch.equal(va, vb), what
    assert ha.keys() == hb.keys()
    for k in ha:
        assert torch.equal(ha[k], hb[k]), (what, k)
    assert sa == sb, what


CASES = sorted(all_cases())


@pytest.mark.cuda
@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("name", CASES)
def test_graphed_runs_equal_eager(cuda_device, name, dispatch):
    case = get_case(name)
    eager = _host(case.run(dispatch=dispatch, device=cuda_device,
                           graphs=False))
    eng = HostEngine(case.program, capacity=case.capacity, dispatch=dispatch,
                     device=cuda_device)
    args = (case.initial, dict(case.heap_init) or None)
    loop = eng.loop
    entries = lambda: [e for c in (loop._step_cache, loop._compact_cache,
                                   loop._gather_cache) for e in c.values()]
    # each key is captured at its third use, in whichever run that falls;
    # after three runs every key is, and a fourth captures nothing
    runs = []
    for _ in range(3):
        runs.append(_host(eng.run(*args)))
        assert loop.captures == sum(isinstance(e, CapturedStep)
                                    for e in entries())
    captures = loop.captures
    assert captures > 0 and all(isinstance(e, CapturedStep)
                                for e in entries())
    runs.append(_host(eng.run(*args)))
    assert loop.captures == captures  # every key replayed
    for i, run in enumerate(runs):
        _equal_runs(run, eager, f"{name} {dispatch} graphed run {i + 1}")
    first = runs[0]
    cpu = _host(case.run(dispatch=dispatch, device="cpu"))
    if name != "fft":  # fft: the card's cos/sin differ by an ulp
        _equal_runs(first, cpu, f"{name} {dispatch} card vs CPU")


@pytest.mark.cuda
@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_graphs_replay_out_of_capture_order(cuda_device, dispatch):
    """One engine runs fib(14), then fib(11) and fib(16): the later runs
    replay the buckets' graphs in another order than they were captured
    (and capture the new ones), with the eager runs' bits."""
    eng = HostEngine(fib.PROGRAM, capacity=1 << 13, dispatch=dispatch,
                     device=cuda_device)
    for n in (14, 11, 16, 11):
        got = _host(eng.run(fib.initial(n)))
        want = _host(AppCase("fib", fib.PROGRAM, fib.initial(n),
                             capacity=1 << 13).run(
            dispatch=dispatch, device=cuda_device, graphs=False))
        _equal_runs(got, want, f"fib({n}) {dispatch}")
    assert eng.loop.captures > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("fleet", ("mixed3", "mixed4", "fib_fleet"))
def test_graphed_fleets_equal_eager(cuda_device, fleet, dispatch):
    members = get_fleet(fleet)
    eager_h = _handles(members)
    eager = EpochMultiplexer(eager_h, dispatch=dispatch, device=cuda_device,
                             graphs=False)
    eager.run()
    svc = JobService(capacity=sum(q for _, q in members), dispatch=dispatch,
                     device=cuda_device)
    handles = [svc.submit_case(c, quota=q) for c, q in members]
    list(svc.completions())
    assert all(h.status.value == "done" for h in handles)
    _same_results(_results(handles), _results(eager_h))
    assert svc.stats().as_dict() == eager.stats().as_dict()
    # the next waves on the first's loop: by the end of the third every
    # key has had its third use, and the fourth captures nothing; the
    # same bits
    first = svc._mux
    captures = [first.loop.captures]
    for _ in range(3):
        again_h, again = _drain_wave(svc, members)
        assert again.loop is first.loop
        captures.append(again.loop.captures)
        _same_results(_results(again_h), _results(eager_h))
    loop = first.loop
    assert all(isinstance(e, CapturedStep)
               for c in (loop._step_cache, loop._compact_cache,
                         loop._gather_cache) for e in c.values())
    assert captures[0] <= captures[1] <= captures[2] == captures[3] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ("granite_3_8b", "mamba2_1_3b",
                                  "hymba_1_5b"))
def test_graphed_server_tokens_equal_eager(cuda_device, arch):
    cfg = configs.get_reduced(arch)
    model = init_model(cfg, seed=0, device=cuda_device)
    outs = {}
    for graphs in (True, False):
        srv = EpochServer(cfg, model, n_slots=4, max_len=64,
                          device=cuda_device, graphs=graphs)
        rng = np.random.RandomState(0)
        for i in range(7):
            srv.submit(Request(
                prompt=rng.randint(3, cfg.vocab, 5 + 3 * i).astype(np.int32),
                max_new_tokens=4 + i))
        srv.run_to_completion()
        outs[graphs] = ([(r.rid, r.output) for r in srv.completed],
                        srv.epochs, srv.captures)
    assert outs[True][:2] == outs[False][:2]
    assert outs[True][2] == 1 and outs[False][2] == 0
