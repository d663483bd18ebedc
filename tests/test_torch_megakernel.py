"""The port's resident chunk loop and its ``epoch_chunk`` kernel.

On the CPU: the chunk cadence (K = 1, 4 and unbounded give the same final
carry, with one readback per chunk), the reclamation invariant the kernel
relies on, the device task table lookup (every program of the registry has
one), and the refusals.  On a card (marker ``cuda``; they skip here): the
kernel against its plain version, ``kernels/ref.py::epoch_chunk_ref``,
every carry tensor exactly, ``DeviceEngine(megakernel=True)`` against the
CPU, and matmul's ordered float add with runs of 128 terms a cell.  The file imports no
JAX, so it runs on a GPU machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_megakernel.py
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.apps import (
    all_cases, annealing, bfs, fft, fib, get_case, matmul, mergesort, nqueens,
    sssp, treewalk, tsp,
)
from repro_torch.apps.registry import AppCase
from repro_torch.core import DeviceEngine, EngineError, EpochLoop, Program
from repro_torch.core.program import HeapVar, TaskType
from repro_torch.kernels import epoch_megakernel as mk

APPS = ("bfs", "fib", "mergesort")
# the later tables: the registry's treewalk (post-order), its tree walked
# in pre-order, sssp, nqueens, tsp, naive mergesort of 64 floats,
# annealing, fft and matmul
MORE_APPS = ("treewalk", "treewalk_pre", "sssp", "nqueens", "tsp", "naive",
             "annealing", "fft", "matmul")
DISPATCHES = ("masked", "gather")
KS = (1, 4, None)  # None: one unbounded chunk


def _case(name):
    if name == "treewalk_pre":
        case = get_case("treewalk")
        n = case.heap_init["left"].shape[0]
        return dataclasses.replace(
            case, name=name, program=treewalk.make_program(n, "pre"))
    if name == "naive":
        n = 64
        return AppCase(name, mergesort.make_program(n, use_map=False),
                       mergesort.initial(n),
                       dict(inp=mergesort.random_input(n, seed=5)),
                       capacity=1 << 12)
    return get_case(name)


def _engine(name, dispatch, device, megakernel=False):
    case = _case(name)
    return case, DeviceEngine(case.program, capacity=case.capacity,
                              dispatch=dispatch, megakernel=megakernel,
                              device=device)


def _fresh(case, eng):
    return eng.initial_carry(case.initial, dict(case.heap_init) or None)


def _run_chunks(eng, carry, K, max_epochs=1 << 16):
    """Chunks of K epochs until the carry drains; (carry, summary, reads)."""
    reads = 0
    while True:
        limit = max_epochs if K is None else min(
            max_epochs, int(carry.n_epochs) + K)
        carry = eng.loop.run_chunk(carry, limit, 1)
        s = eng.loop.chunk_summary(carry)
        reads += 1
        if not (s.sp > 0).any() or s.n_epochs >= max_epochs:
            return carry, s, reads


def _tensors(carry):
    out = {}
    for f in dataclasses.fields(carry):
        v = getattr(carry, f.name)
        if f.name == "state":
            for g in dataclasses.fields(v):
                out["state." + g.name] = getattr(v, g.name)
        elif f.name == "heap":
            for k, t in v.items():
                out["heap." + k] = t
        elif v is not None:
            out[f.name] = v
    return out


def assert_carries_equal(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        x, y = ta[k].cpu(), tb[k].cpu()
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert torch.equal(x, y), k


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("name", APPS + MORE_APPS)
def test_chunk_cadence_gives_one_carry(name, dispatch, K):
    case, eng = _engine(name, dispatch, "cpu")
    whole, s_whole, one = _run_chunks(eng, _fresh(case, eng), None)
    assert one == 1
    got, s, reads = _run_chunks(eng, _fresh(case, eng), K)
    assert_carries_equal(got, whole)
    E = s_whole.n_epochs
    assert reads == (1 if K is None else math.ceil(E / K))
    for f in dataclasses.fields(s):
        np.testing.assert_array_equal(getattr(s, f.name),
                                      getattr(s_whole, f.name))


@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("name", APPS + MORE_APPS)
def test_no_valid_slot_at_or_above_next_free(name, dispatch):
    # the kernel searches for the last valid slot downward from
    # next_free + forks - 1; that is exact only if this holds after
    # every epoch
    case, eng = _engine(name, dispatch, "cpu")
    carry = _fresh(case, eng)
    epochs = 0
    while bool((carry.sp > 0).any()):
        carry = eng.loop.run_chunk(carry, int(carry.n_epochs) + 1, 1)
        nf = int(carry.state.next_free)
        C = carry.state.capacity
        assert 0 <= nf <= C
        assert not bool((carry.state.epoch[nf:C] > 0).any())
        epochs += 1
    assert epochs == int(carry.n_epochs) > 1


@pytest.mark.parametrize("name", APPS + MORE_APPS)
def test_megakernel_flag_on_cpu_runs_the_plain_loop(name):
    for dispatch in DISPATCHES:
        case, _ = _engine(name, dispatch, "cpu")
        h0, v0, s0 = case.run(engine_cls=DeviceEngine, dispatch=dispatch,
                              device="cpu")
        h1, v1, s1 = case.run(engine_cls=DeviceEngine, dispatch=dispatch,
                              device="cpu", megakernel=True)
        assert torch.equal(v0, v1) and s0 == s1
        for k in h0:
            assert torch.equal(h0[k], h1[k])


def test_drained_carry_is_a_noop():
    case, eng = _engine("fib", "masked", "cpu")
    done, s, _ = _run_chunks(eng, _fresh(case, eng), None)
    again = eng.loop.run_chunk(done.clone(), 1 << 16, 1)
    assert_carries_equal(again, done)
    # a carry already at its bound does not move either
    fresh = _fresh(case, eng)
    same = eng.loop.run_chunk(fresh.clone(), 0, 1)
    assert_carries_equal(same, fresh)


def test_device_tables_cover_the_registry_programs():
    ids = {}
    for name in APPS + MORE_APPS:
        t = mk.device_table(_case(name).program)
        assert t is not None, name
        ids[name] = t.app_id
    assert len(set(ids.values())) == len(ids)
    assert sorted(ids.values()) == [t.app_id for t in mk.TABLES]
    assert mk.device_table(fib.PROGRAM).app_id == 0
    assert mk.device_table(bfs.make_program(100, 400)).app_id == 1
    assert mk.device_table(
        mergesort.make_program(64, use_map=True)).app_id == 2
    # every program of the registry, by its own table
    reg = {name: mk.device_table(c.program)
           for name, c in all_cases().items()}
    assert None not in reg.values(), reg
    assert len({t.app_id for t in reg.values()}) == len(reg)


def _renamed(program: Program, **kw) -> Program:
    return dataclasses.replace(program, **kw)


def test_device_table_checks_more_than_the_name():
    p = fib.PROGRAM
    t0, t1 = p.tasks
    assert mk.device_table(_renamed(p, name="other")) is not None
    # same names, another body
    assert mk.device_table(_renamed(p, tasks=(
        t0, TaskType("fibsum", lambda ctx: ctx.emit(0))))) is None
    assert mk.device_table(_renamed(p, tasks=(
        TaskType("fib2", t0.fn), t1))) is None
    assert mk.device_table(_renamed(p, n_arg_i=2)) is None
    assert mk.device_table(_renamed(p, value_width=2)) is None
    q = bfs.make_program(10, 40)
    assert mk.device_table(_renamed(q, heap=q.heap[:2] + (
        HeapVar("dist", (10,), torch.float32),))) is None
    assert mk.device_table(_renamed(q, heap=q.heap[:2] + (
        HeapVar("dist", (11,), torch.int32),))) is None
    m = mergesort.make_program(16, use_map=True)
    assert mk.device_table(_renamed(m, maps=())) is None

    # treewalk: the orders share `walk`'s qualname; the task tuple and the
    # walk's captured `order` tell them apart
    post, pre = (treewalk.make_program(9, o) for o in ("post", "pre"))
    assert mk.device_table(post).app_id != mk.device_table(pre).app_id
    assert mk.device_table(_renamed(post, tasks=post.tasks[:1])) is None
    assert mk.device_table(_renamed(pre, tasks=pre.tasks + (
        post.tasks[1],))) is None
    # mergesort: naive and map variants are two tables; naive's merge
    # forks one site per element of `inp`, so its n must be inp's length
    naive = mergesort.make_program(16, use_map=False)
    assert mk.device_table(naive).app_id != mk.device_table(m).app_id
    assert mk.device_table(_renamed(naive, heap=(
        HeapVar("inp", (32,), torch.float32),
        HeapVar("src", (64,), torch.float32)))) is None
    # nqueens: n lives only in the closure, and the launch passes it
    for n in (6, 8):
        q = nqueens.make_program(n)
        assert mk.device_table(q).consts(q) == (n,)
    assert mk.device_table(nqueens.make_program(16)) is not None
    assert mk.device_table(nqueens.make_program(17)) is None
    # tsp: the closure's n against sqrt(len(dist)), at most 31
    t5 = tsp.make_program(5)
    assert mk.device_table(t5).consts(t5) == (5,)
    for bad in (24, 36):  # not a square; the square of another n
        assert mk.device_table(_renamed(t5, heap=(
            HeapVar("dist", (bad,), torch.int32), t5.heap[1]))) is None
    assert mk.device_table(tsp.make_program(31)) is not None
    assert mk.device_table(tsp.make_program(32)) is None
    # sssp: the float heap and the float argument are part of the table
    g = sssp.make_program(10, 40)
    assert mk.device_table(g) is not None
    assert mk.device_table(_renamed(g, heap=g.heap[:3] + (
        HeapVar("dist", (10,), torch.int32),))) is None
    assert mk.device_table(_renamed(g, n_arg_f=0)) is None
    # annealing: n_bits, n_steps and n_chains live in two closures and go
    # to the kernel in that order; n_bits <= 16
    a = annealing.make_program(16, n_steps=20, n_chains=8)
    assert mk.device_table(a).consts(a) == (16, 20, 8)
    assert mk.device_table(annealing.make_program(
        17, n_steps=20, n_chains=8)) is None
    a6 = annealing.make_program(6, n_steps=5, n_chains=3)
    assert mk.device_table(a6).consts(a6) == (6, 5, 3)
    assert mk.device_table(_renamed(a6, heap=(
        HeapVar("Q", (49,), torch.int32), a6.heap[1]))) is None
    # fft: the body's n (its level buffers) against len(xr) and len(xi)
    f8, f16 = fft.make_program(8), fft.make_program(16)
    assert mk.device_table(f8) is not None
    assert mk.device_table(_renamed(f8, heap=f16.heap)) is None
    assert mk.device_table(_renamed(f8, heap=(
        f8.heap[0], HeapVar("xi", (16,), torch.float32)) + f8.heap[2:])) \
        is None
    # matmul: A, B, C of n^2 floats for the closure's n; one block in both
    # bodies
    m8 = matmul.make_program(8, block=4)
    assert mk.device_table(m8).consts(m8) == (8, 4)
    assert mk.device_table(m8).stage(m8) == 8**3 // 4
    m16 = matmul.make_program(16, block=4)
    assert mk.device_table(_renamed(m8, heap=m16.heap)) is None
    assert mk.device_table(_renamed(m8, heap=(
        HeapVar("A", (63,), torch.float32),) + m8.heap[1:])) is None
    m8b2 = matmul.make_program(8, block=2)
    assert mk.device_table(m8b2).consts(m8b2) == (8, 2)
    assert mk.device_table(_renamed(m8, maps=m8b2.maps)) is None
    assert mk.device_table(_renamed(m8b2, tasks=m8.tasks)) is None


def test_program_without_a_table_is_refused():
    odd = _renamed(fib.PROGRAM, tasks=(
        fib.PROGRAM.tasks[0], TaskType("fibsum", lambda ctx: None)))
    loop = EpochLoop(odd, "masked", megakernel=True)
    with pytest.raises(EngineError, match="device task table"):
        loop.device_table()
    case, eng = _engine("fib", "masked", "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        mk.launch(case.program, _fresh(case, eng), 8, gather=False)
    with pytest.raises(ValueError, match="device task table"):
        mk.launch(odd, _fresh(case, eng), 8, gather=False)


def test_coop_scratch_words():
    """The cooperative scratch: a 23-word header (the barrier counters,
    the popped range with the pending map launches and the reclamation
    words, by epoch parity) and a 10-word record of totals per CTA, for 1
    to MAX_GRID CTAs."""
    assert mk.coop_scratch_words(1) == 33
    assert mk.coop_scratch_words(132) == 23 + 10 * 132
    assert mk.coop_scratch_words(mk.MAX_GRID) == 23 + 10 * mk.MAX_GRID
    for bad in (0, mk.MAX_GRID + 1):
        with pytest.raises(ValueError, match="grid"):
            mk.coop_scratch_words(bad)


# ------------------------------------------------------------------ on a card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("name", APPS + MORE_APPS)
def test_kernel_matches_plain_loop(cuda_device, name, dispatch):
    case, plain = _engine(name, dispatch, "cuda")
    _, kern = _engine(name, dispatch, "cuda", megakernel=True)
    for K in KS:
        mk.reset_launches()
        got, s_got, reads = _run_chunks(kern, _fresh(case, kern), K)
        torch.cuda.synchronize()
        assert mk.LAUNCHES["epoch_chunk"] == reads
        want, s_want, _ = _run_chunks(plain, _fresh(case, plain), K)
        assert_carries_equal(got, want)
        for f in dataclasses.fields(s_got):
            np.testing.assert_array_equal(getattr(s_got, f.name),
                                          getattr(s_want, f.name))


def _wide_case(name):
    """Each app at a size whose widest ranges span several CTAs (tens for
    fib, bfs, mergesort, sssp, fft and matmul), but naive mergesort of 2^8
    floats, whose ranges are at most 256 lanes (its merges fork 2^7 and
    2^8 sites from one lane), and annealing's 256 chains, one CTA's
    worth."""
    n = 2**14
    if name == "annealing":
        Q = annealing.random_qubo(16, seed=5)
        # each epoch's 256 successors go above the TV's last valid slot:
        # about 256 slots an epoch until the chains end
        return AppCase("annealing", annealing.make_program(
            16, n_steps=50, n_chains=256), annealing.initial(),
            dict(Q=Q.ravel()), capacity=2**14)
    if name == "fft":
        xr, xi = fft.random_input(n, seed=0)
        return AppCase("fft", fft.make_program(n), fft.initial(n),
                       dict(xr=xr, xi=xi), capacity=2**16)
    if name == "matmul":
        A, B = matmul.random_inputs(128, seed=0)
        return AppCase("matmul", matmul.make_program(128, block=4),
                       matmul.initial(128), dict(A=A.ravel(), B=B.ravel()),
                       capacity=2**16)
    if name == "fib":
        return AppCase("fib", fib.PROGRAM, fib.initial(24), capacity=2**19)
    if name in ("bfs", "sssp"):
        adj_off, adj = bfs.random_graph(n, avg_degree=4, seed=0)
        if name == "bfs":
            return AppCase("bfs", bfs.make_program(n, len(adj)),
                           bfs.initial(0), bfs.heap_init(adj_off, adj, n),
                           capacity=2**19)
        wgt = sssp.random_weights(len(adj), seed=0)
        return AppCase("sssp", sssp.make_program(n, len(adj)),
                       sssp.initial(0),
                       sssp.heap_init(adj_off, adj, wgt, n), capacity=2**19)
    if name in ("treewalk", "treewalk_pre"):
        left, right = treewalk.random_tree(n, seed=0)
        order = "pre" if name == "treewalk_pre" else "post"
        return AppCase(name, treewalk.make_program(n, order),
                       treewalk.initial(), dict(left=left, right=right),
                       capacity=2**17)
    if name == "nqueens":
        return AppCase("nqueens", nqueens.make_program(10),
                       nqueens.initial(), capacity=2**16)
    if name == "tsp":
        dist = tsp.random_instance(8, seed=3)
        return AppCase("tsp", tsp.make_program(8), tsp.initial(),
                       tsp.heap_init(dist), capacity=2**14)
    use_map = name == "mergesort"
    n = n if use_map else 2**8
    return AppCase(name, mergesort.make_program(n, use_map=use_map),
                   mergesort.initial(n),
                   dict(inp=mergesort.random_input(n, seed=0)),
                   capacity=2**16 if use_map else 2**12)


def _chunk_stats(case, carry, dispatch):
    """One unbounded chunk of ``carry`` with the kernel's epoch and
    barrier counts."""
    stats = torch.zeros(len(mk.STATS), dtype=torch.int64,
                        device=carry.state.task.device)
    mk.launch(case.program, carry, 1 << 16, gather=dispatch == "gather",
              stats=stats)
    return dict(zip(mk.STATS, stats.tolist()))


@pytest.mark.cuda
@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("name", APPS + MORE_APPS)
def test_kernel_matches_plain_loop_across_ctas(cuda_device, name, dispatch,
                                               K):
    """Ranges split over many CTAs of the cooperative grid, exact against
    the plain loop; K = 1 and 4 re-enter the kernel every few epochs, each
    launch from freshly cleared barrier words."""
    case = _wide_case(name)
    kw = dict(capacity=case.capacity, dispatch=dispatch, device="cuda")
    kern = DeviceEngine(case.program, megakernel=True, **kw)
    plain = DeviceEngine(case.program, **kw)
    fresh = _fresh(case, kern)
    got, s_got, _ = _run_chunks(kern, fresh.clone(), K)
    want, s_want, _ = _run_chunks(plain, fresh.clone(), K)
    assert not s_got.failed.any() and not s_got.sp.any()
    assert_carries_equal(got, want)
    for f in dataclasses.fields(s_got):
        np.testing.assert_array_equal(getattr(s_got, f.name),
                                      getattr(s_want, f.name))
    again = fresh.clone()
    st = _chunk_stats(case, again, dispatch)
    assert_carries_equal(again, want)
    E = s_got.n_epochs
    assert (st["wide_epochs"] > 0) == (name not in ("naive", "annealing"))
    assert st["narrow_epochs"] + st["wide_epochs"] == E
    # one an epoch, one that finds nothing to pop, two a map launch (and
    # four more where its float adds are ordered: matmul's), one a round
    # of a deep reclamation search
    maps = int(again.map_launches)
    assert st["ordered_barriers"] == (4 * maps if name == "matmul" else 0)
    assert st["grid_barriers"] == (E + 1 + 2 * maps + st["search_barriers"]
                                   + st["ordered_barriers"])
    assert st["group_barriers"] >= 3 * st["wide_epochs"]
    if name in MORE_APPS:  # the app's own reference
        assert _matches_reference(case, got)


def _matches_reference(case, carry) -> bool:
    h = {k: v[:-1].cpu().numpy() for k, v in carry.heap.items()}
    i = case.heap_init
    if case.name == "annealing":
        return int(h["best"][0]) >= annealing.brute_force_min(
            i["Q"].reshape(16, 16))
    if case.name == "fft":
        n = i["xr"].shape[0]
        got = h["re"][:n].astype(np.float64) + 1j * h["im"][:n]
        want = fft.fft_reference(i["xr"], i["xi"])
        return np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want)
    if case.name == "matmul":
        n = int(math.isqrt(i["A"].shape[0]))
        want = (i["A"].reshape(n, n).astype(np.float64)
                @ i["B"].reshape(n, n).astype(np.float64))
        return np.abs(h["C"].reshape(n, n) - want).max() <= 1e-5 * np.abs(
            want).max()
    if case.name.startswith("treewalk"):
        order = "pre" if case.name == "treewalk_pre" else "post"
        visit, clock = treewalk.treewalk_reference(
            case.heap_init["left"], case.heap_init["right"], order)
        return (np.array_equal(h["visit_epoch"], visit)
                and np.array_equal(h["visit_clock"], clock))
    if case.name == "sssp":
        i = case.heap_init
        n = i["dist"].shape[0]
        ref = sssp.sssp_reference(i["adj_off"], i["adj"], i["wgt"], 0, n)
        return np.allclose(h["dist"], ref, rtol=1e-5)
    if case.name == "nqueens":
        return int(h["count"][0]) == nqueens.SOLUTIONS[10]
    if case.name == "tsp":
        return int(h["best"][0]) == tsp.tsp_reference(
            case.heap_init["dist"].reshape(8, 8))
    n = case.heap_init["inp"].shape[0]
    return np.array_equal(h["src"][:n], np.sort(case.heap_init["inp"]))


@pytest.mark.cuda
def test_narrow_chunk_stays_on_one_cta(cuda_device):
    """A run whose ranges all fit one CTA crosses one grid barrier an
    epoch and no group barrier, and is exact."""
    case = AppCase("fib", fib.PROGRAM, fib.initial(12), capacity=2**10)
    kern = DeviceEngine(case.program, capacity=case.capacity,
                        megakernel=True, device="cuda")
    plain = DeviceEngine(case.program, capacity=case.capacity,
                         device="cuda")
    fresh = _fresh(case, kern)
    want, s_want, _ = _run_chunks(plain, fresh.clone(), None)
    got = fresh.clone()
    st = _chunk_stats(case, got, "masked")
    assert_carries_equal(got, want)
    assert st == {"narrow_epochs": s_want.n_epochs, "wide_epochs": 0,
                  "grid_barriers": s_want.n_epochs + 1, "group_barriers": 0,
                  "search_barriers": 0, "ordered_barriers": 0}


@pytest.mark.cuda
def test_back_to_back_chunks_on_one_stream(cuda_device):
    """Chunks of two carries enqueued back to back with no synchronisation
    between them, each then run to the end: every launch clears its own
    barrier words, so none reads a word the other left."""
    runs = []
    for name in ("fib", "mergesort"):
        case = _wide_case(name)
        kw = dict(capacity=case.capacity, device="cuda")
        kern = DeviceEngine(case.program, megakernel=True, **kw)
        plain = DeviceEngine(case.program, **kw)
        fresh = _fresh(case, kern)
        want, _, _ = _run_chunks(plain, fresh.clone(), None)
        runs.append((kern, fresh.clone(), want))
    for limit in (7, 19, 1 << 16):
        for kern, carry, _ in runs:
            kern.loop.run_chunk(carry, limit, 1)
    torch.cuda.synchronize()
    for _, carry, want in runs:
        assert_carries_equal(carry, want)


@pytest.mark.cuda
def test_grid_covers_every_sm(cuda_device):
    """The cooperative grid holds at least one CTA per SM, and the
    library sizes its scratch as coop_scratch_words does."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    lib = mk._load()
    for table in mk.TABLES:
        g = mk.grid(table.app_id, cuda_device)
        assert sms <= g <= mk.MAX_GRID and g % sms == 0
        assert lib.trees_epoch_coop_words(g) == mk.coop_scratch_words(g)


# fft's heap, card against CPU: within this share of its largest |CPU
# value| (CUDA's cosf/sinf and the CPU's round a few twiddles one ulp
# apart), as tests/test_torch_cuda.py::FFT_RTOL; on the card the kernel
# and the plain loop agree exactly
FFT_RTOL = 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("name", APPS + MORE_APPS)
def test_megakernel_engine_on_cuda_matches_cpu(cuda_device, name, dispatch):
    case = _case(name)
    gh, gv, gs = case.run(engine_cls=DeviceEngine, dispatch=dispatch,
                          device="cuda", megakernel=True)
    ch, cv, cs = case.run(engine_cls=DeviceEngine, dispatch=dispatch,
                          device="cpu")
    assert torch.equal(gv.cpu(), cv) and gs == cs
    for k in ch:
        if name == "fft" and k in ("re", "im"):
            bound = FFT_RTOL * float(ch[k].abs().max())
            assert float((gh[k].cpu() - ch[k]).abs().max()) <= bound, k
        else:
            assert torch.equal(gh[k].cpu(), ch[k]), k


@pytest.mark.cuda
def test_unknown_program_raises_on_cuda(cuda_device):
    odd = _renamed(fib.PROGRAM, tasks=(
        fib.PROGRAM.tasks[0], TaskType("fibsum", lambda ctx: None)))
    with pytest.raises(EngineError, match="device task table"):
        DeviceEngine(odd, capacity=1 << 10, megakernel=True, device="cuda")
    # the plain loop takes it
    DeviceEngine(odd, capacity=1 << 10, device="cuda")


@pytest.mark.cuda
def test_kernel_reads_a_device_limit(cuda_device):
    case, kern = _engine("fib", "masked", "cuda", megakernel=True)
    carry = _fresh(case, kern)
    lim = torch.tensor(5, dtype=torch.int32, device=cuda_device)
    carry = kern.loop.run_chunk(carry, lim, 1)
    assert kern.loop.chunk_summary(carry).n_epochs == 5


@pytest.mark.cuda
@pytest.mark.parametrize("limits", ({"capacity": 64}, {"stack_depth": 2}),
                         ids=("tv_overflow", "stack_overflow"))
def test_kernel_matches_plain_loop_on_failure(cuda_device, limits):
    case = get_case("fib")
    for d in DISPATCHES:
        kw = dict(capacity=case.capacity, dispatch=d, device="cuda")
        kw.update(limits)
        kern = DeviceEngine(case.program, megakernel=True, **kw)
        plain = DeviceEngine(case.program, **kw)
        fresh = kern.initial_carry(case.initial)
        got, s, _ = _run_chunks(kern, fresh.clone(), None)
        want, _, _ = _run_chunks(plain, fresh.clone(), None)
        assert s.failed[0] and s.sp[0] == 0
        assert s.failed_stack[0] == ("stack_depth" in limits)
        assert_carries_equal(got, want)


@pytest.mark.cuda
def test_kernel_reports_a_map_stage_fault(cuda_device):
    # two merges of the whole array in one epoch need twice the stage the
    # mergesort table allocates (n elements): the kernel must say so
    # rather than write a wrong heap
    n = 16
    prog = mergesort.make_program(n, use_map=True)
    eng = DeviceEngine(prog, capacity=64, megakernel=True, device="cuda")
    carry = eng.initial_carry(mergesort.initial(n),
                              dict(inp=mergesort.random_input(n, seed=1)))
    st = carry.state
    st.task[:2] = prog.task_id("merge")
    st.argi[:2] = torch.tensor([0, n, 0, 0], dtype=torch.int32)
    st.epoch[:2] = 1
    st.next_free.fill_(2)
    carry.rstack[0, 0, 1] = 2
    carry = eng.loop.run_chunk(carry, 1, 1)
    with pytest.raises(EngineError, match="fault 1"):
        eng.loop.chunk_summary(carry)


@pytest.mark.cuda
def test_matmul_long_runs_through_the_kernel(cuda_device, monkeypatch):
    """matmul at n = 256 in blocks of 2: each C cell takes 128 float terms
    in one payload, runs longer than one thread's, which the kernel sorts
    a CTA a run.  Exact against the plain loop on the card with the plain
    ordered add (``ref.ordered_add_ref``) in place of the ordered_add
    kernel, and the same bits on each of 5 runs."""
    from repro_torch.kernels import ops, ref

    n, block = 256, 2
    A, B = matmul.random_inputs(n, seed=2)
    case = AppCase("matmul", matmul.make_program(n, block=block),
                   matmul.initial(n), dict(A=A.ravel(), B=B.ravel()),
                   capacity=2**22)
    kw = dict(capacity=case.capacity, device="cuda")
    kern = DeviceEngine(case.program, megakernel=True, **kw)
    fresh = _fresh(case, kern)
    runs = []
    for _ in range(5):
        got, s, _ = _run_chunks(kern, fresh.clone(), None)
        assert not s.failed.any() and not s.sp.any()
        runs.append(got)
    for other in runs[1:]:
        assert_carries_equal(runs[0], other)
    monkeypatch.setattr(ops.ordered_add, "ordered_add_",
                        ref.ordered_add_ref)
    plain = DeviceEngine(case.program, **kw)
    want, _, _ = _run_chunks(plain, fresh.clone(), None)
    assert_carries_equal(runs[0], want)
    stats = _chunk_stats(case, fresh.clone(), "masked")
    assert stats["ordered_barriers"] == 4
    assert _matches_reference(case, runs[0])
