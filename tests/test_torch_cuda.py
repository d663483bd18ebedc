"""The port on a CUDA card: each kernel against its plain PyTorch version,
and whole runs on the card (engine, service, LLM server) against runs on
the CPU.

Every test here is marked ``cuda`` and skips where there is no card.  The
file imports no JAX, so it runs on a GPU machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs
from repro_torch.apps import all_cases, get_fleet
from repro_torch.kernels import (
    decode_attention, flash_attention, fork_compact, ops, ref, ssd_scan,
)
from repro_torch.models import init_model
from repro_torch.serving import EpochServer, Request
from repro_torch.service import DeviceMultiplexer, Job, JobHandle, JobService

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("n", (1, 7, 1000, 1024, 1025, 3000, 2**16 + 3))
def test_kernels_match_plain(cuda_device, n):
    rng = np.random.RandomState(n)
    counts = torch.as_tensor(rng.randint(0, 4, n).astype(np.int32),
                             device=cuda_device)
    fork_compact.reset_launches()
    offs, total = ops.fork_offsets(counts)
    r_offs, r_total = ref.fork_scan_ref(counts)
    assert torch.equal(offs, r_offs) and int(total) == int(r_total)
    for n_types in (1, 2, 3, 8):
        types = torch.as_tensor(rng.randint(0, n_types, n).astype(np.int32),
                                device=cuda_device)
        for act in (rng.rand(n) < 0.6, np.zeros(n, bool), np.ones(n, bool)):
            active = torch.as_tensor(act, device=cuda_device)
            rank, cnt = ops.type_rank(types, active, n_types)
            r_rank, r_cnt = ref.type_rank_ref(types, active, n_types)
            assert torch.equal(rank, r_rank) and torch.equal(cnt, r_cnt)
    perm, c = ops.lane_pack(active)
    r_perm, r_c = ref.lane_pack_ref(active)
    assert torch.equal(perm, r_perm) and int(c) == int(r_c)
    torch.cuda.synchronize()
    assert fork_compact.LAUNCHES == {
        "fork_scan": 1, "segmented_fork_scan": 0, "type_rank": 13}


def test_fork_scan_wraps_like_int32(cuda_device):
    counts = torch.full((5001,), 2**30, dtype=torch.int32, device=cuda_device)
    offs, total = ops.fork_offsets(counts)
    r_offs, r_total = ref.fork_scan_ref(counts.cpu())
    assert torch.equal(offs.cpu(), r_offs) and int(total) == int(r_total)


# fork_scan takes tiles of 4096 lanes: lengths on either side of one and
# two tile boundaries, and the widest main-path shape plus a ragged tail
SCAN_LENGTHS = (4095, 4096, 4097, 8191, 8193, 2**21 + 5)


@pytest.mark.parametrize("offset", (0, 1), ids=("aligned", "offset"))
@pytest.mark.parametrize("n", SCAN_LENGTHS)
def test_fork_scan_exact_across_tiles(cuda_device, n, offset):
    """Exact at tile boundaries; ``offset`` starts the view 4 bytes into
    its storage, so the kernel takes its scalar loads."""
    rng = np.random.RandomState(n + offset)
    base = torch.as_tensor(rng.randint(0, 4, n + offset).astype(np.int32),
                           device=cuda_device)
    counts = base[offset:]
    fork_compact.reset_launches()
    offs, total = fork_compact.fork_scan(counts)
    r_offs, r_total = ref.fork_scan_ref(counts)
    torch.cuda.synchronize()
    assert fork_compact.LAUNCHES["fork_scan"] == 1
    assert torch.equal(offs, r_offs) and int(total) == int(r_total)


def test_fork_scan_wraps_across_tiles(cuda_device):
    counts = torch.full((50 * 4096 + 7,), 2**30 + 3, dtype=torch.int32,
                        device=cuda_device)
    offs, total = fork_compact.fork_scan(counts)
    r_offs, r_total = ref.fork_scan_ref(counts.cpu())
    assert torch.equal(offs.cpu(), r_offs) and int(total) == int(r_total)


def test_fork_scan_back_to_back_calls(cuda_device):
    """Three calls in a row at one length: the caching allocator hands each
    the scratch the last one left, status words and counter set."""
    rng = np.random.RandomState(5)
    n = 2**20 + 3
    inputs = [torch.as_tensor(rng.randint(0, 5, n).astype(np.int32),
                              device=cuda_device) for _ in range(3)]
    outs = [fork_compact.fork_scan(c) for c in inputs]
    for c, (offs, total) in zip(inputs, outs):
        r_offs, r_total = ref.fork_scan_ref(c)
        assert torch.equal(offs, r_offs) and int(total) == int(r_total)


def test_fork_scan_graph_replay(cuda_device):
    """Four calls captured in one CUDA graph, replayed three times with new
    counts written in place before each replay: every replay is exact, so
    no call reads a status word that an earlier call or replay left."""
    rng = np.random.RandomState(6)
    n = 2**21
    counts = torch.empty((n,), dtype=torch.int32, device=cuda_device)
    counts.copy_(torch.as_tensor(rng.randint(0, 4, n).astype(np.int32)))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fork_compact.fork_scan(counts)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fork_compact.fork_scan(counts) for _ in range(4)]
    for rep in range(3):
        counts.copy_(torch.as_tensor(
            rng.randint(0, 4 + rep, n).astype(np.int32)))
        graph.replay()
        torch.cuda.synchronize()
        r_offs, r_total = ref.fork_scan_ref(counts)
        for offs, total in outs:
            assert torch.equal(offs, r_offs) and int(total) == int(r_total)


def test_wrappers_check_their_inputs(cuda_device):
    x = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="n_types"):
        fork_compact.type_rank(x, x == 0, 0)
    with pytest.raises(ValueError, match="n_segs"):
        fork_compact.segmented_fork_scan(x, x, 0)
    with pytest.raises(ValueError, match="length"):
        fork_compact.segmented_fork_scan(x, x[:4], 1)
    with pytest.raises(TypeError):
        fork_compact.fork_scan(x.long())
    with pytest.raises(ValueError, match="contiguous"):
        fork_compact.fork_scan(torch.zeros(16, dtype=torch.int32,
                                           device=cuda_device)[::2])
    with pytest.raises(ValueError, match="length"):
        fork_compact.type_rank(x, x[:4] == 0, 1)


@pytest.mark.parametrize("dispatch", ("masked", "compacted", "gather"))
@pytest.mark.parametrize("name", ("bfs", "fib", "mergesort"))
def test_engine_on_cuda_matches_cpu(cuda_device, name, dispatch):
    case = all_cases()[name]
    fork_compact.reset_launches()
    gh, gv, gs = case.run(dispatch=dispatch, device="cuda")
    launches = dict(fork_compact.LAUNCHES)
    ch, cv, cs = case.run(dispatch=dispatch, device="cpu")
    assert torch.equal(gv.cpu(), cv)
    for k in ch:
        assert torch.equal(gh[k].cpu(), ch[k]), k
    assert gs.as_dict() == cs.as_dict()
    assert launches["fork_scan"] >= gs.epochs
    assert (launches["type_rank"] > 0) == (dispatch != "masked")


# fft's heap, card against CPU: relative to the largest |CPU value| (CUDA's
# cosf/sinf and the CPU's round a few twiddles one ulp apart)
FFT_RTOL = 1e-5
NEW_APPS = ("annealing", "fft", "matmul", "nqueens", "sssp", "tsp")


@pytest.mark.parametrize("name", NEW_APPS)
def test_new_apps_on_cuda_match_cpu(cuda_device, name):
    case = all_cases()[name]
    gh, gv, gs = case.run(dispatch="masked", device="cuda")
    ch, cv, cs = case.run(dispatch="masked", device="cpu")
    assert torch.equal(gv.cpu(), cv)
    for k in ch:
        if name == "fft" and k in ("re", "im"):
            bound = FFT_RTOL * float(ch[k].abs().max())
            assert float((gh[k].cpu() - ch[k]).abs().max()) <= bound, k
        else:
            assert torch.equal(gh[k].cpu(), ch[k]), k
    assert gs.as_dict() == cs.as_dict()
    _megakernel_matches_cpu(case)


def _megakernel_matches_cpu(case):
    """DeviceEngine(megakernel=True) on the card, masked and gather,
    against the plain resident loop on the card (exactly) and on the CPU:
    heap, values, RunStats; fft's heap against the CPU's within FFT_RTOL
    of its largest |value| (CUDA's cosf/sinf and the CPU's)."""
    from repro_torch.core import DeviceEngine
    from repro_torch.kernels import epoch_megakernel

    for dispatch in ("masked", "gather"):
        epoch_megakernel.reset_launches()
        gh, gv, gs = case.run(engine_cls=DeviceEngine, dispatch=dispatch,
                              device="cuda", megakernel=True)
        torch.cuda.synchronize()
        assert epoch_megakernel.LAUNCHES["epoch_chunk"] > 0
        ph, pv, ps = case.run(engine_cls=DeviceEngine, dispatch=dispatch,
                              device="cuda")
        assert torch.equal(gv, pv) and gs.as_dict() == ps.as_dict()
        for k in ph:
            assert torch.equal(gh[k], ph[k]), (dispatch, k)
        ch, cv, cs = case.run(engine_cls=DeviceEngine, dispatch=dispatch,
                              device="cpu")
        assert torch.equal(gv.cpu(), cv)
        for k in ch:
            if case.name == "fft" and k in ("re", "im"):
                bound = FFT_RTOL * float(ch[k].abs().max())
                assert float((gh[k].cpu() - ch[k]).abs().max()) <= bound, k
            else:
                assert torch.equal(gh[k].cpu(), ch[k]), (dispatch, k)
        assert gs.as_dict() == cs.as_dict()


def test_naive_mergesort_on_cuda_matches_cpu(cuda_device):
    from repro_torch.apps import mergesort
    from repro_torch.apps.registry import AppCase

    n = 64
    case = AppCase("naive", mergesort.make_program(n, use_map=False),
                   mergesort.initial(n),
                   dict(inp=mergesort.random_input(n, seed=5)),
                   capacity=1 << 12)
    for dispatch in ("masked", "compacted", "gather"):
        gh, _, gs = case.run(dispatch=dispatch, device="cuda")
        ch, _, cs = case.run(dispatch=dispatch, device="cpu")
        assert torch.equal(gh["src"].cpu(), ch["src"])
        assert gs.as_dict() == cs.as_dict()
    _megakernel_matches_cpu(case)


def test_matmul_c_is_the_same_bits_every_run(cuda_device):
    """16 float terms into each C cell in one payload: the ordered add
    gives the CPU's bits on every run."""
    from repro_torch.apps import matmul
    from repro_torch.core import HostEngine

    n, block = 64, 4
    A, B = matmul.random_inputs(n, seed=9)
    prog = matmul.make_program(n, block=block)
    hi = dict(A=A.ravel(), B=B.ravel())
    cpu = HostEngine(prog, capacity=1 << 13, device="cpu").run(
        matmul.initial(n), heap_init=hi)[0]["C"]
    for _ in range(5):
        got = HostEngine(prog, capacity=1 << 13).run(
            matmul.initial(n), heap_init=hi)[0]["C"]
        assert torch.equal(got.cpu(), cpu)


def _same_bits(got, want):
    """Equal bit for bit, a NaN wherever the other has one."""
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32),
                       want[~nan].view(torch.int32))


def _ordered_case(kind, device):
    """``(rows, idx, val)`` of one adversarial ordered-add case; row
    ``rows - 1`` is the sink."""
    g = torch.Generator().manual_seed(len(kind))
    if kind == "hot_cell":  # one cell takes 2^20 terms: a long merge
        n = 1 << 20
        idx = torch.full((n,), 3, dtype=torch.int32)
        val = torch.randn(n, generator=g)
        rows = 11
    elif kind == "one_term_cells":  # 2^18 cells, one term each
        n = 1 << 18
        idx = torch.randperm(n, generator=g).to(torch.int32)
        val = torch.randn(n, generator=g)
        rows = n + 1
    elif kind == "tile_boundaries":
        # runs either side of one thread's (32), of a CTA's sort tile
        # (4096) and of two, laid out interleaved so that each run's terms
        # cross many 1024-thread CTAs of the count and place launches
        lens = (1, 31, 32, 33, 1023, 1024, 1025, 4095, 4096, 4097, 8193)
        parts = [torch.full((m,), r, dtype=torch.int32)
                 for r, m in enumerate(lens)]
        idx = torch.cat(parts)[torch.randperm(sum(lens), generator=g)]
        val = torch.randn(idx.shape[0], generator=g) * 1e3
        rows = len(lens) + 1
    elif kind == "sink":  # a third of the terms aim at the sink, int64 idx
        idx = torch.randint(0, 101, (30000,), generator=g)
        val = torch.randn(30000, 3, generator=g)
        rows = 101
    elif kind == "empty":
        idx = torch.zeros((0,), dtype=torch.int32)
        val = torch.zeros((0,))
        rows = 17
    else:  # specials: signed zeros, infinities, a NaN
        vals = torch.tensor([-0.0, 0.0, float("inf"), -float("inf"),
                             float("nan"), 1e30, -1e30, 1.0])
        idx = torch.randint(0, 40, (4000,), generator=g).to(torch.int32)
        val = vals[torch.randint(0, 8, (4000,), generator=g)]
        val[idx >= 30] = -0.0  # cells 30..39 take -0.0 alone
        rows = 41
    return rows, idx.to(device), val.to(device)


ORDERED_CASES = ("hot_cell", "one_term_cells", "tile_boundaries", "sink",
                 "empty", "specials")


@pytest.mark.parametrize("kind", ORDERED_CASES)
def test_ordered_add_matches_plain(cuda_device, kind):
    """The ordered_add kernel against its plain version, exactly, and the
    same bits on each of 5 runs.  The hot cell's plain run is the CPU's
    serial index_add_ (ref.ordered_add_ref would take 2^20 passes; the CPU
    tests hold the two equal)."""
    from repro_torch.kernels import ordered_add

    rows, idx, val = _ordered_case(kind, cuda_device)
    g = torch.Generator().manual_seed(1)
    base = torch.randn((rows,) + tuple(val.shape[1:]), generator=g)
    if kind == "specials":
        base[30:] = -0.0
    base = base.to(cuda_device)
    if kind == "hot_cell":
        want = base.cpu().index_add_(0, idx.cpu(), val.cpu())
    else:
        want = ref.ordered_add_ref(base.clone(), idx, val).cpu()
    ordered_add.reset_launches()
    for _ in range(5):
        got = ordered_add.ordered_add_(base.clone(), idx, val)
        torch.cuda.synchronize()
        _same_bits(got[:-1].cpu(), want[:-1])
    assert ordered_add.LAUNCHES["ordered_add"] == (0 if kind == "empty"
                                                   else 5)


def test_ordered_add_graph_replay(cuda_device):
    """The call captured in a CUDA graph and replayed 5 times on new
    inputs: every replay clears its own scratch and adds in order, exactly
    as the plain version."""
    from repro_torch.kernels import ordered_add

    rows, idx, val = _ordered_case("tile_boundaries", cuda_device)
    arr = torch.zeros(rows, device=cuda_device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ordered_add.ordered_add_(arr, idx, val)  # warm: build and load
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ordered_add.ordered_add_(arr, idx, val)
    g = torch.Generator().manual_seed(7)
    for _ in range(5):
        start = torch.randn(rows, generator=g).to(cuda_device)
        val.copy_(torch.randn(val.shape[0], generator=g))
        arr.copy_(start)
        graph.replay()
        torch.cuda.synchronize()
        want = ref.ordered_add_ref(start, idx, val)
        _same_bits(arr[:-1].cpu(), want[:-1].cpu())


def test_ordered_add_makes_no_host_sync(cuda_device):
    """A float add through tvm._scatter_heap on the card reads nothing
    back: 5 calls run under set_sync_debug_mode("error"), each exactly as
    the plain version."""
    from repro_torch.core import tvm

    rows, idx, val = _ordered_case("tile_boundaries", cuda_device)
    arr = torch.zeros(rows, device=cuda_device)
    tvm._scatter_heap(arr, idx, val, "add")  # build and load first
    torch.cuda.synchronize()
    want = ref.ordered_add_ref(torch.zeros(rows, device=cuda_device), idx,
                               val).cpu()
    for _ in range(5):
        arr.zero_()
        torch.cuda.set_sync_debug_mode("error")
        try:
            tvm._scatter_heap(arr, idx, val, "add")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        _same_bits(arr[:-1].cpu(), want[:-1])


def test_ordered_add_checks_its_inputs(cuda_device):
    from repro_torch.kernels import ordered_add

    arr = torch.zeros(9, device=cuda_device)
    idx = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    val = torch.ones(4, device=cuda_device)
    for bad, err in (
        ((arr.double(), idx, val.double()), TypeError),
        ((arr, idx.to(torch.int16), val), TypeError),
        ((arr.cpu(), idx, val), ValueError),
        ((arr, idx, val[:3]), ValueError),
        ((torch.zeros(9, 2, device=cuda_device)[:, 0], idx, val), ValueError),
    ):
        with pytest.raises(err):
            ordered_add.ordered_add_(*bad)


def test_float_add_scatter_is_ordered(cuda_device):
    from repro_torch.core import tvm

    g = torch.Generator().manual_seed(0)
    idx = torch.randint(0, 1001, (1 << 20,), generator=g).to(torch.int32)
    val = torch.randn(1 << 20, generator=g) * 100
    base = torch.randn(1001, generator=g)
    cpu = base.clone()
    tvm._scatter_heap(cpu, idx, val, "add")
    for _ in range(3):
        dev = base.to(cuda_device)
        tvm._scatter_heap(dev, idx.to(cuda_device), val.to(cuda_device),
                          "add")
        assert torch.equal(dev[:-1].cpu(), cpu[:-1])  # row 1000: the sink


# segmented_fork_scan takes tiles of 2048 lanes and groups of 32 segments:
# lengths on either side of one and two tile boundaries, J up to one group
# and one past it
@pytest.mark.parametrize("n", (1, 7, 1024, 1025, 2047, 2048, 2049, 4095,
                               4096, 4097, 5000, 2**16 + 3))
@pytest.mark.parametrize("n_segs", (1, 3, 4, 8, 32, 33))
def test_segmented_scan_matches_plain(cuda_device, n, n_segs):
    rng = np.random.RandomState(n + n_segs)
    counts = rng.randint(0, 5, n).astype(np.int32)
    counts[rng.rand(n) < 0.3] = 0
    for seg in (np.sort(rng.randint(0, n_segs, n)),    # contiguous
                rng.randint(0, n_segs, n),             # shuffled
                rng.randint(-1, n_segs + 1, n)):       # ids -1 and J too
        c = torch.as_tensor(counts, device=cuda_device)
        s = torch.as_tensor(seg.astype(np.int32), device=cuda_device)
        fork_compact.reset_launches()
        offs, totals = ops.segmented_fork_offsets(c, s, n_segs)
        assert fork_compact.LAUNCHES["segmented_fork_scan"] == 1
        r_offs, r_totals = ref.segmented_fork_scan_ref(c, s, n_segs)
        assert torch.equal(offs, r_offs) and torch.equal(totals, r_totals)
    torch.cuda.synchronize()


@pytest.mark.parametrize("n_segs", (4, 33))
def test_segmented_scan_graph_replay(cuda_device, n_segs):
    """Three calls captured in one CUDA graph, replayed with new counts and
    ids written in place before each replay: every replay is exact, so no
    call reads a status word an earlier call or replay left."""
    rng = np.random.RandomState(7 + n_segs)
    n = 2**20 + 5
    counts = torch.empty((n,), dtype=torch.int32, device=cuda_device)
    seg = torch.empty((n,), dtype=torch.int32, device=cuda_device)
    counts.copy_(torch.as_tensor(rng.randint(0, 4, n).astype(np.int32)))
    seg.copy_(torch.as_tensor(rng.randint(0, n_segs, n).astype(np.int32)))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fork_compact.segmented_fork_scan(counts, seg, n_segs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fork_compact.segmented_fork_scan(counts, seg, n_segs)
                for _ in range(3)]
    for rep in range(3):
        counts.copy_(torch.as_tensor(
            rng.randint(0, 4 + rep, n).astype(np.int32)))
        seg.copy_(torch.as_tensor(
            rng.randint(-1, n_segs + 1, n).astype(np.int32)))
        graph.replay()
        torch.cuda.synchronize()
        r_offs, r_totals = ref.segmented_fork_scan_ref(counts, seg, n_segs)
        for offs, totals in outs:
            assert torch.equal(offs, r_offs)
            assert torch.equal(totals, r_totals)


def test_segmented_scan_scratch_matches_the_library(cuda_device):
    lib = fork_compact._load()
    for n in (0, 1, 4095, 4096, 4097, 2**23):
        for n_segs in (1, 2, 3, 4, 5, 31, 32, 33, 64, 65, 1000):
            assert lib.trees_segmented_fork_scan_scratch_words(n, n_segs) \
                == fork_compact.seg_scan_scratch_words(n, n_segs)


def test_segmented_scan_wraps_like_int32(cuda_device):
    rng = np.random.RandomState(3)
    counts = torch.full((5001,), 2**30 + 7, dtype=torch.int32,
                        device=cuda_device)
    seg = torch.as_tensor(rng.randint(0, 3, 5001).astype(np.int32),
                          device=cuda_device)
    offs, totals = ops.segmented_fork_offsets(counts, seg, 3)
    r_offs, r_totals = ref.segmented_fork_scan_ref(counts.cpu(), seg.cpu(), 3)
    assert torch.equal(offs.cpu(), r_offs)
    assert torch.equal(totals.cpu(), r_totals)


@pytest.mark.parametrize("n_types", (9, 24))
@pytest.mark.parametrize("n", (1, 1025, 2**16 + 3))
def test_type_rank_past_eight_types(cuda_device, n, n_types):
    rng = np.random.RandomState(n * n_types)
    types = torch.as_tensor(rng.randint(0, n_types, n).astype(np.int32),
                            device=cuda_device)
    for act in (rng.rand(n) < 0.6, np.zeros(n, bool), np.ones(n, bool)):
        active = torch.as_tensor(act, device=cuda_device)
        rank, cnt = ops.type_rank(types, active, n_types)
        r_rank, r_cnt = ref.type_rank_ref(types, active, n_types)
        assert torch.equal(rank, r_rank) and torch.equal(cnt, r_cnt)


def _type_entries(types, active, n_types):
    """type_rank, lane_pack and type_pack on the card against their plain
    versions, exactly."""
    rank, cnt = fork_compact.type_rank(types, active, n_types)
    r_rank, r_cnt = ref.type_rank_ref(types, active, n_types)
    assert torch.equal(rank, r_rank) and torch.equal(cnt, r_cnt)
    perm, c = fork_compact.lane_pack(active)
    r_perm, r_c = ref.lane_pack_ref(active)
    assert torch.equal(perm, r_perm) and int(c) == int(r_c)
    perm, cnt = fork_compact.type_pack(types, active, n_types)
    r_perm, r_cnt = ref.type_pack_ref(types, active, n_types)
    assert torch.equal(perm, r_perm) and torch.equal(cnt, r_cnt)


# type_rank takes tiles of 2048 lanes and groups of 32 types: lengths on
# either side of one and two tiles, 7 types (the mixed4 fleet), one group
# and one past it
@pytest.mark.parametrize("n_types", (1, 2, 7, 32, 33))
@pytest.mark.parametrize("n", (0, 2047, 2048, 2049, 4095, 4096, 4097,
                               2**16 + 3))
def test_type_entries_exact_across_tiles(cuda_device, n, n_types):
    """Random, no and all lanes active; ``types`` views 4 bytes and
    ``active`` views 1 byte into their storage take the scalar loads."""
    rng = np.random.RandomState(n + 100 * n_types)
    for offset in (0, 1):
        tbase = torch.as_tensor(
            rng.randint(0, n_types, n + offset).astype(np.int32),
            device=cuda_device)
        types = tbase[offset:]
        for act in (rng.rand(n + offset) < 0.6, np.zeros(n + offset, bool),
                    np.ones(n + offset, bool)):
            active = torch.as_tensor(act, device=cuda_device)[offset:]
            fork_compact.reset_launches()
            _type_entries(types, active, n_types)
            assert fork_compact.LAUNCHES["type_rank"] == 3
    torch.cuda.synchronize()


def test_type_rank_out_of_range_and_byte_flags(cuda_device):
    """Active lanes with types -1 and n_types rank 0, as the Pallas kernel
    ranks them (the plain version, like the JAX oracle, ranks them within
    the clamped type); every other lane and the counts equal the plain
    version.  Any nonzero byte of a ``u8`` mask is active."""
    rng = np.random.RandomState(4)
    n = 5000
    for n_types in (3, 33):
        types = torch.as_tensor(
            rng.randint(-1, n_types + 1, n).astype(np.int32),
            device=cuda_device)
        active = torch.as_tensor(
            rng.randint(0, 3, n).astype(np.uint8), device=cuda_device)
        rank, cnt = fork_compact.type_rank(types, active, n_types)
        r_rank, r_cnt = ref.type_rank_ref(types, active, n_types)
        outside = (active != 0) & ((types < 0) | (types >= n_types))
        assert bool(outside.any())
        assert torch.equal(rank, torch.where(outside, 0, r_rank))
        assert torch.equal(cnt, r_cnt)
        perm, c = fork_compact.lane_pack(active)
        r_perm, r_c = ref.lane_pack_ref(active)
        assert torch.equal(perm, r_perm) and int(c) == int(r_c)


@pytest.mark.parametrize("n_types", (7, 33))
def test_type_entries_graph_replay(cuda_device, n_types):
    """Each entry captured twice in one CUDA graph, replayed three times
    with new types and flags written in place before each replay: every
    call is exact after every replay, so none reads a status word, a tile
    counter or a permutation entry that an earlier call left."""
    rng = np.random.RandomState(8 + n_types)
    n = 2**20 + 3
    types = torch.empty((n,), dtype=torch.int32, device=cuda_device)
    active = torch.empty((n,), dtype=torch.bool, device=cuda_device)

    def refill(rep):
        types.copy_(torch.as_tensor(
            rng.randint(0, n_types, n).astype(np.int32)))
        active.copy_(torch.as_tensor(rng.rand(n) < 0.3 + 0.2 * rep))

    def calls():
        return [(fork_compact.type_rank(types, active, n_types),
                 fork_compact.lane_pack(active),
                 fork_compact.type_pack(types, active, n_types))
                for _ in range(2)]

    refill(0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = calls()
    for rep in range(3):
        refill(rep)
        graph.replay()
        torch.cuda.synchronize()
        want = (ref.type_rank_ref(types, active, n_types),
                ref.lane_pack_ref(active),
                ref.type_pack_ref(types, active, n_types))
        for got in outs:
            for (a, b), (ra, rb) in zip(got, want):
                assert torch.equal(a, ra) and torch.equal(b, rb)


def test_type_entries_back_to_back_n_types(cuda_device):
    """Calls with different n_types in a row on one stream: each takes the
    scratch the last one left (other widths, other groups)."""
    rng = np.random.RandomState(9)
    n = 2**18 + 5
    active = torch.as_tensor(rng.rand(n) < 0.5, device=cuda_device)
    inputs = [(torch.as_tensor(rng.randint(0, k, n).astype(np.int32),
                               device=cuda_device), k)
              for k in (1, 7, 33, 2, 32, 7)]
    outs = [(fork_compact.type_rank(t, active, k),
             fork_compact.type_pack(t, active, k)) for t, k in inputs]
    for (t, k), (rc, pc) in zip(inputs, outs):
        for (a, b), (ra, rb) in zip((rc, pc),
                                    (ref.type_rank_ref(t, active, k),
                                     ref.type_pack_ref(t, active, k))):
            assert torch.equal(a, ra) and torch.equal(b, rb)


def test_type_entries_device_operations(cuda_device):
    """type_rank and lane_pack are a memset and one kernel on the card,
    type_pack a memset and two (torch.profiler's device events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n = 2**16
    types = torch.zeros((n,), dtype=torch.int32, device=cuda_device)
    active = torch.ones((n,), dtype=torch.bool, device=cuda_device)
    want = {"type_rank": 2, "lane_pack": 2, "type_pack": 3}
    calls = {"type_rank": lambda: fork_compact.type_rank(types, active, 7),
             "lane_pack": lambda: fork_compact.lane_pack(active),
             "type_pack": lambda: fork_compact.type_pack(types, active, 7)}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ops_on_card = [e for e in prof.events()
                       if e.device_type == DeviceType.CUDA]
        assert len(ops_on_card) == want[name], (
            name, [e.name for e in ops_on_card])


def test_type_rank_scratch_matches_the_library(cuda_device):
    lib = fork_compact._load()
    for n in (0, 1, 2047, 2048, 2049, 2**23):
        for n_types in (1, 2, 3, 7, 8, 31, 32, 33, 64, 65, 1000):
            assert lib.trees_type_rank_scratch_words(n, n_types) \
                == fork_compact.type_rank_scratch_words(n, n_types)


def test_type_wrappers_check_their_inputs(cuda_device):
    x = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    for fn in (fork_compact.type_rank, fork_compact.type_pack):
        with pytest.raises(ValueError, match="n_types"):
            fn(x, x == 0, 0)
        with pytest.raises(ValueError, match="length"):
            fn(x, x[:4] == 0, 1)
        with pytest.raises(TypeError):
            fn(x.long(), x == 0, 1)
        with pytest.raises(TypeError):
            fn(x, x.float(), 1)
        with pytest.raises(ValueError, match="contiguous"):
            fn(torch.zeros(16, dtype=torch.int32, device=cuda_device)[::2],
               x == 0, 1)
        with pytest.raises(ValueError, match="CUDA"):
            fn(x.cpu(), x == 0, 1)
    with pytest.raises(TypeError):
        fork_compact.lane_pack(x)
    with pytest.raises(ValueError, match="contiguous"):
        fork_compact.lane_pack((x == 0)[::2])
    with pytest.raises(ValueError, match="CUDA"):
        fork_compact.lane_pack((x == 0).cpu())


@pytest.mark.parametrize("dispatch", ("masked", "compacted", "gather"))
def test_service_on_cuda_matches_cpu(cuda_device, dispatch):
    fleet = get_fleet("mixed4")
    runs = {}
    for dev in ("cuda", "cpu"):
        fork_compact.reset_launches()
        svc = JobService(capacity=sum(q for _, q in fleet),
                         dispatch=dispatch, device=dev)
        handles = [svc.submit_case(c, quota=q) for c, q in fleet]
        svc.drain()
        runs[dev] = (handles, svc.stats(), dict(fork_compact.LAUNCHES))
    (gh, gs, launches), (ch, cs, _) = runs["cuda"], runs["cpu"]
    for g, c in zip(gh, ch):
        assert g.status is c.status is g.status.DONE
        assert torch.equal(g.result.value.cpu(), c.result.value)
        for k in c.result.heap:
            assert torch.equal(g.result.heap[k].cpu(), c.result.heap[k]), k
        assert g.result.stats == c.result.stats
    assert gs.as_dict() == cs.as_dict()
    assert launches["segmented_fork_scan"] == gs.epochs


def _fleet_mux(name, dispatch, megakernel, device, chunk=None):
    handles = [
        JobHandle(i, Job(c.program, c.initial, dict(c.heap_init), quota=q,
                         name=c.name))
        for i, (c, q) in enumerate(get_fleet(name))
    ]
    mux = DeviceMultiplexer(handles, dispatch=dispatch, chunk=chunk,
                            megakernel=megakernel, device=device)
    mux._ensure_carry()
    return handles, mux


def _carry_tensors(carry):
    out = {}
    for f in dataclasses.fields(carry):
        v = getattr(carry, f.name)
        if isinstance(v, dict):
            out.update({f"{f.name}.{k}": t for k, t in v.items()})
        elif dataclasses.is_dataclass(v):  # TVMState, JobArena
            out.update({f"{f.name}.{g.name}": getattr(v, g.name)
                        for g in dataclasses.fields(v)})
        elif v is not None:
            out[f.name] = v
    return out


def _assert_same_carry(a, b):
    ta, tb = _carry_tensors(a), _carry_tensors(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        assert ta[k].dtype == tb[k].dtype and ta[k].shape == tb[k].shape, k
        assert torch.equal(ta[k].cpu(), tb[k].cpu()), k


@pytest.mark.parametrize("K", (1, 4, None))
@pytest.mark.parametrize("dispatch", ("masked", "gather"))
@pytest.mark.parametrize("name", ("mixed3", "mixed4", "fib_fleet"))
def test_fleet_kernel_matches_plain_fleet_loop(cuda_device, name, dispatch,
                                               K):
    """The fleet epoch_chunk against the plain resident fleet loop on the
    card, every carry tensor after every chunk."""
    from repro_torch.kernels import epoch_megakernel as mk

    _, plain = _fleet_mux(name, dispatch, False, "cuda")
    _, kern = _fleet_mux(name, dispatch, True, "cuda")
    J = len(plain.slots)
    mk.reset_launches()
    chunks = 0
    while True:
        limit = 1 << 16 if K is None else int(plain._carry.n_epochs) + K
        want = plain.loop.run_chunk(plain._carry, limit, J)
        got = kern.loop.run_chunk(kern._carry, limit, J)
        plain._attach_carry(want)
        kern._attach_carry(got)
        torch.cuda.synchronize()
        chunks += 1
        _assert_same_carry(got, want)
        sg, sw = kern.loop.chunk_summary(got), plain.loop.chunk_summary(want)
        for f in dataclasses.fields(sg):
            np.testing.assert_array_equal(getattr(sg, f.name),
                                          getattr(sw, f.name), f.name)
        if not bool((want.sp > 0).any()):
            break
    assert mk.LAUNCHES["epoch_chunk"] == chunks


@pytest.mark.parametrize("dispatch", ("masked", "gather"))
def test_one_region_fleet_is_the_solo_kernel(cuda_device, dispatch):
    """A solo carry is the one-region case of a fleet: fib through the
    fleet kernel (J = 1) ends in the solo kernel's carry, every tensor the
    two carries share equal."""
    from repro_torch.apps import fib
    from repro_torch.core import DeviceEngine

    quota = 1 << 14
    handles = [JobHandle(0, Job(fib.PROGRAM, fib.initial(18), quota=quota,
                                name="fib"))]
    mux = DeviceMultiplexer(handles, dispatch=dispatch, megakernel=True,
                            device="cuda")
    mux._ensure_carry()
    got = mux.loop.run_chunk(mux._carry, 1 << 16, 1)
    eng = DeviceEngine(fib.PROGRAM, capacity=quota, dispatch=dispatch,
                       megakernel=True, device="cuda")
    want = eng.loop.run_chunk(eng.initial_carry(fib.initial(18)), 1 << 16, 1)
    ta, tb = _carry_tensors(got), _carry_tensors(want)
    assert set(ta) - set(tb) == {f"arena.{f}" for f in
                                 ("base", "end", "next", "slot_job")}
    for k in tb:
        assert torch.equal(ta[k], tb[k]), k


def test_fleet_without_an_instantiated_mix_raises(cuda_device):
    """A wave whose tenant tables lie in no instantiated fleet set raises
    on the card with megakernel=True, rather than running the plain loop;
    megakernel=False runs it."""
    from repro_torch.apps import get_case
    from repro_torch.core import EngineError

    members = [(get_case("fib"), 512), (get_case("sssp"), 1 << 11)]
    handles = [JobHandle(i, Job(c.program, c.initial, dict(c.heap_init),
                                quota=q, name=c.name))
               for i, (c, q) in enumerate(members)]
    with pytest.raises(EngineError, match="no fleet kernel"):
        DeviceMultiplexer(handles, megakernel=True, device="cuda")
    svc = JobService(capacity=512 + (1 << 11), engine="device",
                     megakernel=True, device="cuda")
    for c, q in members:
        svc.submit_case(c, quota=q)
    with pytest.raises(EngineError, match="no fleet kernel"):
        svc.drain()
    svc = JobService(capacity=512 + (1 << 11), engine="device",
                     device="cuda")
    hs = [svc.submit_case(c, quota=q) for c, q in members]
    svc.drain()
    assert all(h.status is h.status.DONE for h in hs)


@pytest.mark.parametrize("megakernel", (False, True))
@pytest.mark.parametrize("dispatch", ("masked", "gather"))
def test_device_service_on_cuda_matches_cpu(cuda_device, dispatch,
                                            megakernel):
    """JobService(engine='device') on the card (plain resident loop or the
    fleet kernel) against the same wave on the CPU, per job and fleet."""
    fleet = get_fleet("mixed4")
    runs = {}
    for dev in ("cuda", "cpu"):
        svc = JobService(capacity=sum(q for _, q in fleet),
                         dispatch=dispatch, engine="device", chunk=4,
                         megakernel=megakernel and dev == "cuda", device=dev)
        handles = [svc.submit_case(c, quota=q) for c, q in fleet]
        svc.drain()
        runs[dev] = (handles, svc.stats())
    (gh, gs), (ch, cs) = runs["cuda"], runs["cpu"]
    for g, c in zip(gh, ch):
        assert g.status is c.status is g.status.DONE
        assert torch.equal(g.result.value.cpu(), c.result.value)
        for k in c.result.heap:
            assert torch.equal(g.result.heap[k].cpu(), c.result.heap[k]), k
        assert g.result.stats == c.result.stats
    assert gs.as_dict() == cs.as_dict()


@pytest.mark.parametrize("placement", ("least_loaded", "sticky"))
@pytest.mark.parametrize("megakernel", (False, True))
def test_sharded_service_on_cuda_matches_cpu(cuda_device, megakernel,
                                             placement):
    """JobService(engine='sharded') at P = 2 on the card (the plain fleet
    loop, or one epoch_chunk launch a shard) against the same service on
    the CPU: every job, every shard's RunStats and the fleet's, the
    collective steps and the migrations."""
    from repro_torch.kernels import epoch_megakernel

    fleet = get_fleet("mixed4")
    runs = {}
    for dev in ("cuda", "cpu"):
        svc = JobService(capacity=sum(q for _, q in fleet),
                         max_jobs=len(fleet), engine="sharded", shards=2,
                         chunk=4, placement=placement,
                         megakernel=megakernel and dev == "cuda",
                         device=dev)
        handles = [svc.submit_case(c, quota=q, name=f"{c.name}#{r}")
                   for r in range(2) for c, q in fleet]
        k0 = epoch_megakernel.LAUNCHES["epoch_chunk"]
        svc.drain()
        runs[dev] = (handles, svc._mux,
                     epoch_megakernel.LAUNCHES["epoch_chunk"] - k0)
    (gh, gf, launches), (ch, cf, _) = runs["cuda"], runs["cpu"]
    for g, c in zip(gh, ch):
        assert g.status is c.status is g.status.DONE
        assert torch.equal(g.result.value.cpu(), c.result.value)
        for k in c.result.heap:
            assert torch.equal(g.result.heap[k].cpu(), c.result.heap[k]), k
        assert g.result.stats.solo_dict() == c.result.stats.solo_dict()
    assert [s.as_dict() for s in gf.shard_stats()] == [
        s.as_dict() for s in cf.shard_stats()]
    assert gf.stats().as_dict() == cf.stats().as_dict()
    assert (gf.collective_steps, gf.migrations) == (cf.collective_steps,
                                                    cf.migrations)
    if megakernel:
        assert gf.collective_steps <= launches <= 2 * gf.collective_steps


def _flip_controller(flip):
    """A recording DispatchController that leaves masked for ``flip`` on a
    sparse fleet: the reference's priors (gather), or a cheap pack
    limited to masked and compacted."""
    from repro_torch.control import CostModel, DispatchController

    class Recording(DispatchController):
        def choose(self, span_bucket):
            d = super().choose(span_bucket)
            self.log.append(d.mode)
            return d

    if flip == "gather":
        ctl = Recording(cost=CostModel())
    else:
        ctl = Recording(cost=CostModel(dispatch_s=1e-7, transfer_s=1e-7,
                                       per_type_s=0.0),
                        modes=("masked", "compacted"))
    ctl.log = []
    return ctl


@pytest.mark.parametrize("flip", ("gather", "compacted"))
def test_auto_flips_modes_on_graphs_like_the_cpu(cuda_device, flip):
    """dispatch="auto" switching modes on graphed steps: four waves of two
    fib tenants at the two ends of a sparse TV on one service (each wave on
    the last wave's loop, so both modes' keys are captured and replayed)
    make the CPU's decisions and give the CPU's and a masked wave's bits."""
    fib = all_cases()["fib"]
    runs = {}
    for dev in ("cuda", "cpu"):
        svc = JobService(capacity=4096, dispatch="auto", calibrate=False,
                         device=dev)
        svc.controller = _flip_controller(flip)
        waves = []
        for _ in range(4):
            n0 = len(svc.controller.log)
            hs = [svc.submit_case(fib, quota=2048) for _ in range(2)]
            svc.drain()
            waves.append((hs, svc._mux.stats().as_dict(),
                          svc.controller.log[n0:]))
        runs[dev] = (waves, svc._mux.loop.captures)
    masked = JobService(capacity=4096, device="cpu")
    mhs = [masked.submit_case(fib, quota=2048) for _ in range(2)]
    masked.drain()
    (gw, captures), (cw, _) = runs["cuda"], runs["cpu"]
    assert captures > 0
    assert {m for _, _, log in gw for m in log} == {"masked", flip}
    for (ghs, gstats, glog), (chs, cstats, clog) in zip(gw, cw):
        assert glog == clog and gstats == cstats
        for g, c, m in zip(ghs, chs, mhs):
            assert g.status is c.status is g.status.DONE
            for want in (c.result, m.result):
                assert torch.equal(g.result.value.cpu(), want.value)
                for k in want.heap:
                    assert torch.equal(g.result.heap[k].cpu(),
                                       want.heap[k]), k
                assert g.result.stats.solo_dict() == \
                    want.stats.solo_dict()


# B, Hq, Hkv, Sq, Skv, D, causal, q_offset, window
FLASH = [
    (2, 8, 2, 128, 128, 128, True, 0, 0),
    (1, 4, 4, 100, 100, 64, True, 0, 0),      # group 1, ragged tile
    (2, 8, 2, 40, 300, 32, True, 260, 0),     # q_offset
    (1, 8, 2, 200, 200, 128, True, 0, 50),    # window
    (1, 4, 1, 70, 130, 64, False, 0, 0),      # non-causal, group 4
    (1, 8, 2, 512, 512, 128, False, 0, 0),    # interior tiles only
    (1, 8, 2, 200, 456, 64, True, 256, 0),    # q tile across the diagonal
    (1, 8, 2, 300, 300, 128, True, 0, 100),   # window edge inside a K tile
    (1, 56, 8, 130, 130, 128, True, 0, 0),    # group 7: yi-34b's heads
    (2, 4, 2, 77, 77, 16, True, 0, 0),        # D = 16, the smallest tile
]
ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _attn_close(got, want, dtype):
    tol = ATTN_TOL[dtype]
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * max(1.0, float(want.float().abs().max())), err


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("case", FLASH)
def test_flash_attention_matches_plain(cuda_device, case, dtype):
    B, Hq, Hkv, Sq, Skv, D, causal, qo, win = case
    g = torch.Generator(device=cuda_device).manual_seed(Sq + Skv)
    q = torch.randn((B, Sq, Hq, D), generator=g, device=cuda_device,
                    dtype=dtype).transpose(1, 2)   # strided, as on the path
    k, v = (torch.randn((B, Hkv, Skv, D), generator=g, device=cuda_device,
                        dtype=dtype) for _ in range(2))
    flash_attention.reset_launches()
    got = ops.attention(q, k, v, causal=causal, q_offset=qo, window=win)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES["flash_attention"] == 1
    assert got.shape == q.shape and got.dtype == dtype
    _attn_close(got, ref.mha_ref(q, k, v, causal=causal, q_offset=qo,
                                 window=win), dtype)


# the backward: each 64-row tile of one (batch, head) of each gradient
# (consecutive queries of dq, keys of dk and dv) within tol of its own
# Frobenius norm (float32: sums in another order; bfloat16: P and dS are
# rounded to bf16 as the products' operands, as the forward rounds P).
# Tile by tile, since under a causal mask a late key's gradient is many
# times smaller than an early one's; not row by row, since dq's first
# row is zero in exact arithmetic and both versions give noise there.
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
LSE_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-4}


def _tile_rel_err(got, want, rows=64):
    """max over tiles of ``rows`` consecutive positions of one (batch,
    head) of ||got - want|| / ||want|| (Frobenius), a tile's norm floored
    at 1e-6 of the largest (an unseen key's gradient is 0)."""
    pad = (-want.shape[-2]) % rows

    def tiles(x):
        x = torch.nn.functional.pad(x.float(), (0, 0, 0, pad))
        return x.reshape(*x.shape[:-2], -1, rows * x.shape[-1])

    norm = tiles(want).norm(dim=-1)
    err = tiles(got.float() - want.float()).norm(dim=-1)
    return float((err / norm.clamp_min(1e-6 * float(norm.max()))).max())


def _flash_case(case, dtype, device, seed):
    B, Hq, Hkv, Sq, Skv, D = case[:6]
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((B, Sq, Hq, D), generator=g, device=device,
                    dtype=dtype).transpose(1, 2)   # strided, as on the path
    k, v = (torch.randn((B, Skv, Hkv, D), generator=g, device=device,
                        dtype=dtype).transpose(1, 2) for _ in range(2))
    do = torch.randn((B, Hq, Sq, D), generator=g, device=device, dtype=dtype)
    return q, k, v, do


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("case", FLASH)
def test_flash_attention_bwd_matches_plain(cuda_device, case, dtype):
    """The forward's lse and the backward's dq, dk, dv against the plain
    versions on the kernel's own output and lse."""
    causal, qo, win = case[6:]
    q, k, v, do = _flash_case(case, dtype, cuda_device, sum(case[:6]))
    kw = dict(causal=causal, q_offset=qo, window=win)
    flash_attention.reset_launches()
    out, lse = flash_attention.flash_attention(q, k, v, return_lse=True,
                                               **kw)
    got = flash_attention.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES == {"flash_attention": 1,
                                        "flash_attention_bwd": 3}
    _, want_lse = ref.mha_ref(q, k, v, return_lse=True, **kw)
    err = float((lse - want_lse).abs().max())
    assert err <= LSE_TOL[dtype] * max(1.0, float(want_lse.abs().max()))
    want = ref.mha_backward_ref(q, k, v, out, lse, do, **kw)
    for name, g, w, x in zip("qkv", got, want, (q, k, v)):
        assert g.shape == x.shape and g.dtype == dtype, name
        assert torch.isfinite(g).all(), name
        err = _tile_rel_err(g, w)
        assert err <= BWD_TOL[dtype], (name, err)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_attention_gradient_on_the_card(cuda_device, dtype):
    """``ops.attention`` under grad runs ``FlashAttention``: one forward
    and one backward (three launches), gradients equal to autograd's
    through the plain version."""
    case = (2, 8, 2, 200, 200, 128, True, 0, 0)
    q, k, v, do = _flash_case(case, dtype, cuda_device, 5)
    grads = {}
    for how in ("kernel", "plain"):
        xs = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        flash_attention.reset_launches()
        if how == "kernel":
            out = ops.attention(*xs)
        else:
            out = ref.mha_ref(*(x.float() for x in xs))
        out.backward(do.to(out.dtype))
        torch.cuda.synchronize()
        want = (1, 3) if how == "kernel" else (0, 0)
        assert (flash_attention.LAUNCHES["flash_attention"],
                flash_attention.LAUNCHES["flash_attention_bwd"]) == want
        grads[how] = [x.grad.float() for x in xs]
    for g, w in zip(grads["kernel"], grads["plain"]):
        err = _tile_rel_err(g, w)
        assert err <= BWD_TOL[dtype], err


def test_kernels_without_backward_raise_under_grad(cuda_device):
    """``ssd`` and ``gqa_decode`` write through ctypes, out of autograd's
    sight: under grad they raise rather than drop the gradient."""
    q = torch.randn((2, 4, 16), device=cuda_device, requires_grad=True)
    kc = torch.randn((2, 2, 8, 16), device=cuda_device)
    lens = torch.full((2,), 8, dtype=torch.int32, device=cuda_device)
    with pytest.raises(NotImplementedError, match="item 11"):
        ops.gqa_decode(q, kc, kc, lens)
    x = torch.randn((1, 8, 2, 8), device=cuda_device, requires_grad=True)
    dt = torch.rand((1, 8, 2), device=cuda_device)
    A = -torch.rand((2,), device=cuda_device)
    Bm = torch.randn((1, 8, 16), device=cuda_device)
    with pytest.raises(NotImplementedError, match="ssd_scan's backward"):
        ops.ssd(x, dt, A, Bm, Bm)
    with torch.no_grad():  # serving: no gradient wanted
        ops.gqa_decode(q, kc, kc, lens)
        ops.ssd(x, dt, A, Bm, Bm)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_model_gradients_on_the_card(cuda_device, dtype):
    """A trainable reduced granite on the card: every parameter gets a
    finite gradient through the attention kernels (one forward a layer,
    another in the remat recompute, one backward), held to the CPU's
    in float32."""
    from repro_torch.data import SyntheticLM, place_batch
    from repro_torch.models import loss_fn

    cfg = dataclasses.replace(configs.get_reduced("granite_3_8b"),
                              compute_dtype=dtype)
    batch = SyntheticLM(cfg.vocab, 64, 2, seed=0).batch_at(0)
    grads = {}
    for dev in ("cuda", "cpu"):
        if dev == "cpu" and dtype != torch.float32:
            break
        model = init_model(cfg, seed=0, device="cpu", trainable=True).to(dev)
        flash_attention.reset_launches()
        loss, _ = loss_fn(model, cfg, place_batch(batch, dev))
        leaves = model.named_leaves()
        gs = torch.autograd.grad(loss, [p for _, p, _ in leaves])
        grads[dev] = {n: g.float().cpu() for (n, _, _), g in zip(leaves, gs)}
        if dev == "cuda":
            torch.cuda.synchronize()
            L = cfg.n_layers
            assert flash_attention.LAUNCHES == {
                "flash_attention": 2 * L, "flash_attention_bwd": 3 * L}
    for name, g in grads["cuda"].items():
        assert torch.isfinite(g).all(), name
        if "attn/" in name:
            assert g.abs().max() > 0, name
    if "cpu" in grads:
        for name, g in grads["cuda"].items():
            w = grads["cpu"][name]
            err = float((g - w).abs().max())
            assert err <= 1e-4 * float(w.abs().max()), (name, err)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("group,D,window", ((1, 128, 0), (4, 128, 0),
                                            (4, 128, 100), (2, 64, 0),
                                            (8, 32, 7), (5, 64, 0),
                                            (5, 64, 100), (7, 128, 0),
                                            (7, 64, 100), (3, 16, 0)))
def test_decode_attention_matches_plain(cuda_device, group, D, window,
                                        dtype):
    # lengths 37, 300 and S - 1 end inside a split of the kernel's
    # (decode_attention.split_rows: 128 rows at S = 512, 256 at D = 16 bf16)
    B, Hkv, S = 6, 2, 512
    g = torch.Generator(device=cuda_device).manual_seed(group * D + window)
    q = torch.randn((B, Hkv * group, D), generator=g, device=cuda_device,
                    dtype=dtype)
    k, v = (torch.randn((B, Hkv, S, D), generator=g, device=cuda_device,
                        dtype=dtype) for _ in range(2))
    lengths = torch.tensor([1, 37, S - 1, S, S + 5, 300], dtype=torch.int32,
                           device=cuda_device)
    if window:  # every sequence keeps a visible row
        lengths = lengths.clamp(max=S + window - 1)
    decode_attention.reset_launches()
    got = ops.gqa_decode(q, k, v, lengths, window=window)
    torch.cuda.synchronize()
    assert decode_attention.LAUNCHES["decode_attention"] == 1
    _attn_close(got, ref.decode_attention_ref(q, k, v, lengths,
                                              window=window), dtype)


def test_attention_wrappers_check_their_inputs(cuda_device):
    q = torch.zeros((1, 2, 8, 128), device=cuda_device)
    with pytest.raises(TypeError):
        flash_attention.flash_attention(q, q.half(), q.half())
    with pytest.raises(ValueError, match="head dim"):
        flash_attention.flash_attention(q[..., :48], q[..., :48],
                                        q[..., :48])
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention.flash_attention(q[..., ::2], q[..., ::2],
                                        q[..., ::2])
    with pytest.raises(TypeError, match="int32"):
        decode_attention.decode_attention(q[:, :, 0], q, q,
                                          torch.ones(1, device=cuda_device))


def test_server_on_cuda_matches_cpu(cuda_device):
    cfg = dataclasses.replace(configs.get_reduced("granite_3_8b"),
                              compute_dtype=torch.float32, head_dim=32,
                              d_model=128)
    model = init_model(cfg, seed=0, device="cpu")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(3, cfg.vocab, n).astype(np.int32)
               for n in (5, 30, 9, 17, 2)]
    out = {}
    for dev in ("cuda", "cpu"):
        flash_attention.reset_launches()
        decode_attention.reset_launches()
        fork_compact.reset_launches()
        srv = EpochServer(cfg, model.to(dev), n_slots=3, max_len=64,
                          device=dev)
        for p in prompts:
            srv.submit(Request(prompt=p, max_new_tokens=6))
        done = srv.run_to_completion()
        out[dev] = ([(r.rid, r.output) for r in done], srv.epochs)
        if dev == "cuda":
            assert flash_attention.LAUNCHES["flash_attention"] > 0
            assert decode_attention.LAUNCHES["decode_attention"] == \
                srv.epochs * cfg.n_layers
            assert fork_compact.LAUNCHES["fork_scan"] > 0
    assert out["cuda"] == out["cpu"]


def test_server_serves_with_no_device_given(cuda_device):
    """The natural call, ``EpochServer(cfg, init_model(cfg))``: the model,
    the cache and the server all take CUDA by default."""
    cfg = configs.get_reduced("granite_3_8b")
    srv = EpochServer(cfg, init_model(cfg), n_slots=2, max_len=32)
    assert srv.device.type == "cuda"
    srv.submit(Request(prompt=np.arange(3, 8, dtype=np.int32),
                       max_new_tokens=4))
    done = srv.run_to_completion()
    assert len(done) == 1 and len(done[0].output) == 4


# Bt, S, H, P, N: the reduced configs' shapes, hymba's heads, ragged S;
# bf16 with P and N multiples of 16 takes the tensor-core design
SSD = [
    (2, 96, 16, 8, 16),
    (3, 65, 5, 64, 16),
    (2, 130, 4, 32, 128),
    (1, 1, 2, 16, 8),
    (2, 200, 3, 64, 64),
    (1, 64, 2, 8, 32),
    (2, 1000, 8, 64, 128),   # mamba2's head, a ragged last chunk
    (2, 300, 50, 64, 16),    # hymba's heads, an odd pair count
]


@pytest.mark.parametrize("with_h0", (False, True))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("case", SSD)
def test_ssd_scan_matches_plain(cuda_device, case, dtype, with_h0):
    """x, B and C as strided slices of one (Bt, S, H * P + 2N) tensor, as
    the SSM block hands them over."""
    Bt, S, H, P, N = case
    g = torch.Generator(device=cuda_device).manual_seed(S * H + P + N)
    conv = torch.randn((Bt, S, H * P + 2 * N), generator=g,
                       device=cuda_device).to(dtype)
    x = conv[..., :H * P].reshape(Bt, S, H, P)
    B, C = conv[..., H * P:H * P + N], conv[..., H * P + N:]
    dt = (torch.rand((Bt, S, H), generator=g, device=cuda_device) * 0.2
          + 0.01).to(dtype)
    A = -(torch.rand((H,), generator=g, device=cuda_device) * 1.5 + 0.5)
    h0 = (torch.randn((Bt, H, P, N), generator=g, device=cuda_device)
          if with_h0 else None)
    ssd_scan.reset_launches()
    y, h = ops.ssd(x, dt, A, B, C, h0)
    torch.cuda.synchronize()
    assert ssd_scan.LAUNCHES["ssd_scan"] == 1
    assert y.dtype == dtype and h.dtype == torch.float32
    ry, rh = ref.ssd_chunked(x, dt, A, B, C, h0)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for got, want in ((y, ry), (h, rh)):
        err = float((got.float() - want.float()).abs().max())
        assert err <= tol * max(1.0, float(want.float().abs().max())), err


def test_ssd_scan_unaligned_views_and_cuda_core_design(cuda_device):
    """The tensor-core design on views that are not 16-byte aligned (its
    plain-load staging), and the CUDA-core design asked for by name on the
    same bf16 inputs, each within the bf16 tolerance of the plain version."""
    Bt, S, H, P, N = 2, 200, 4, 64, 32
    g = torch.Generator(device=cuda_device).manual_seed(9)
    conv = torch.randn((Bt, S, 1 + H * P + 2 * N), generator=g,
                       device=cuda_device).bfloat16()
    x = conv[..., 1:1 + H * P].reshape(Bt, S, H, P)
    B, C = conv[..., 1 + H * P:1 + H * P + N], conv[..., 1 + H * P + N:]
    dt = (torch.rand((Bt, S, H), generator=g, device=cuda_device) * 0.2
          + 0.01).bfloat16()
    A = -(torch.rand((H,), generator=g, device=cuda_device) * 1.5 + 0.5)
    h0 = torch.randn((Bt, H, P, N), generator=g, device=cuda_device)
    assert ssd_scan.pick_design(torch.bfloat16, P, N) == "tensor_core"
    ry, rh = ref.ssd_chunked(x, dt, A, B, C, h0)
    for design in ("tensor_core", "cuda_core"):
        y, h = ssd_scan.ssd_scan(x, dt, A, B, C, h0, design=design)
        torch.cuda.synchronize()
        for got, want in ((y, ry), (h, rh)):
            err = float((got.float() - want.float()).abs().max())
            assert err <= 2e-2 * max(1.0, float(want.float().abs().max()))
    with pytest.raises(ValueError, match="design"):
        ssd_scan.ssd_scan(x.float(), dt.float(), A, B.float(), C.float(),
                          design="tensor_core")


def test_ssd_scan_checks_its_inputs(cuda_device):
    x = torch.zeros((1, 8, 2, 8), device=cuda_device)
    dt = torch.zeros((1, 8, 2), device=cuda_device)
    A = torch.zeros((2,), device=cuda_device)
    B = torch.zeros((1, 8, 16), device=cuda_device)
    with pytest.raises(TypeError):
        ssd_scan.ssd_scan(x, dt.bfloat16(), A, B, B)
    with pytest.raises(ValueError, match="head dim"):
        ssd_scan.ssd_scan(torch.zeros((1, 8, 2, 12), device=cuda_device),
                          dt, A, B, B)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan.ssd_scan(x, dt, A, torch.zeros((1, 8, 32),
                                                device=cuda_device)[..., ::2],
                          B)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan.ssd_scan(x.cpu(), dt, A, B, B)


@pytest.mark.parametrize("arch", ("granite_moe_1b_a400m",
                                  "llama4_scout_17b_a16e",
                                  "whisper_large_v3"))
def test_moe_and_encdec_servers_on_cuda_match_cpu(cuda_device, arch):
    """The MoE and encoder-decoder servers (reduced, float32) on the card:
    the tokens and epochs of the CPU, the decode step captured once, and
    the attention launches the code predicts (whisper: a prefill's encoder,
    self- and cross-attention, an epoch's self and cross decodes)."""
    cfg = dataclasses.replace(configs.get_reduced(arch),
                              compute_dtype=torch.float32)
    model = init_model(cfg, seed=0, device="cpu")
    rng = np.random.RandomState(2)
    frames = (rng.normal(size=(1, cfg.encoder_len, cfg.d_model))
              .astype(np.float32) if cfg.encdec else None)
    prompts = [rng.randint(3, cfg.vocab, n).astype(np.int32)
               for n in (5, 30, 9, 17, 2)]
    per_prefill = cfg.n_layers * (2 if cfg.encdec else 1) + (
        cfg.n_encoder_layers if cfg.encdec else 0)
    per_epoch = cfg.n_layers * (2 if cfg.encdec else 1)
    out = {}
    for dev in ("cuda", "cpu"):
        srv = EpochServer(cfg, model.to(dev), n_slots=3, max_len=64,
                          device=dev, enc_frames=frames)
        flash_attention.reset_launches()
        decode_attention.reset_launches()
        for p in prompts:
            srv.submit(Request(prompt=p, max_new_tokens=6))
        done = srv.run_to_completion()
        out[dev] = ([(r.rid, r.output) for r in done], srv.epochs)
        if dev == "cuda":
            assert srv.captures == 1
            assert flash_attention.LAUNCHES["flash_attention"] == \
                srv.timings["prefills"] * per_prefill
            assert decode_attention.LAUNCHES["decode_attention"] == \
                srv.epochs * per_epoch
    assert out["cuda"] == out["cpu"]


@pytest.mark.parametrize("arch", ("mamba2_1_3b", "hymba_1_5b"))
def test_ssm_server_on_cuda_matches_cpu(cuda_device, arch):
    cfg = dataclasses.replace(configs.get_reduced(arch),
                              compute_dtype=torch.float32)
    model = init_model(cfg, seed=0, device="cpu")
    rng = np.random.RandomState(1)
    prompts = [rng.randint(3, cfg.vocab, n).astype(np.int32)
               for n in (5, 30, 9, 17, 2)]
    out = {}
    for dev in ("cuda", "cpu"):
        ssd_scan.reset_launches()
        srv = EpochServer(cfg, model.to(dev), n_slots=3, max_len=64,
                          device=dev)
        for p in prompts:
            srv.submit(Request(prompt=p, max_new_tokens=6))
        done = srv.run_to_completion()
        out[dev] = ([(r.rid, r.output) for r in done], srv.epochs)
        if dev == "cuda":
            assert ssd_scan.LAUNCHES["ssd_scan"] == \
                srv.timings["prefills"] * cfg.n_layers
    assert out["cuda"] == out["cpu"]
