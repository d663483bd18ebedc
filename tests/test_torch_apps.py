"""The port's six remaining paper apps and naive mergesort on its
``HostEngine`` on the CPU against the JAX ``HostEngine``, and every app
against its numpy reference and the port's baselines.

Under each of the masked, compacted and gather dispatches the heap arrays,
the TV ``values`` and every field of ``RunStats.as_dict()`` must be equal,
exactly.  The one exception is fft's heap: its twiddles are ``cos``/``sin``
of float32 angles, which XLA and torch round differently by one ulp on a
few angles, so it is held to :data:`FFT_RTOL` of the largest |JAX value|.
matmul at n = 16, block 4 (four float terms added into each ``C`` cell in
one payload) is the case where the order of the adds shows; it too is
exact.  The JAX runs are cached per module.
"""
from __future__ import annotations

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.apps import get_case as jget_case
from repro.apps import matmul as jmatmul
from repro.apps import mergesort as jmergesort
from repro.core import HostEngine as JHostEngine
from repro_torch.apps import (
    all_cases, annealing, bfs, fft, get_case, matmul, mergesort, nqueens,
    sssp, tsp,
)
from repro_torch.apps.baselines import bitonic, worklist
from repro_torch.core import HostEngine
from repro_torch.kernels import epoch_megakernel

DISPATCHES = ("masked", "compacted", "gather")
APPS = ("annealing", "fft", "matmul", "nqueens", "sssp", "tsp")
# fft's heap against JAX: relative to the largest |JAX value|.  Measured
# on the registry case (n = 32): 1.9e-6 absolute on values up to 16.5,
# about 1.2e-7 relative (one ulp of the largest value).
FFT_RTOL = 1e-5


def assert_heaps(theap, jheap, name):
    assert set(theap) == set(jheap)
    for k in jheap:
        got = theap[k].numpy()
        want = np.asarray(jheap[k])
        if name.startswith("fft") and k in ("re", "im"):
            bound = FFT_RTOL * float(np.abs(want).max())
            np.testing.assert_allclose(got, want, rtol=0, atol=bound)
        else:
            np.testing.assert_array_equal(got, want)


def assert_same_run(t, j, name):
    theap, tval, tstats = t
    jheap, jval, jstats = j
    np.testing.assert_array_equal(tval.numpy(), np.asarray(jval))
    assert_heaps(theap, jheap, name)
    assert tstats.as_dict() == jstats.as_dict()


@pytest.fixture(scope="module")
def jax_host():
    """``(key, dispatch) -> (heap, value, stats)`` of the JAX
    ``HostEngine``, each run once per module; ``key`` is a registry name
    or a ``(name, args)`` tuple built by ``_programs``."""
    cache = {}

    def get(key, dispatch):
        if (key, dispatch) not in cache:
            prog, init, heap_init, cap = _programs(key, jax=True)
            heap, value, stats = JHostEngine(
                prog, capacity=cap, dispatch=dispatch
            ).run(init, heap_init=heap_init)
            cache[key, dispatch] = (
                {k: np.asarray(v) for k, v in heap.items()},
                np.asarray(value), stats,
            )
        return cache[key, dispatch]

    return get


def _programs(key, jax: bool):
    """The program, initial task, heap init and capacity of a registry
    case or of one of this file's extra cases, from either package."""
    if isinstance(key, str):
        case = jget_case(key) if jax else get_case(key)
        return (case.program, case.initial, dict(case.heap_init) or None,
                case.capacity)
    name, n = key[0], key[1]
    if name == "naive":
        m = jmergesort if jax else mergesort
        return (m.make_program(n, use_map=False), m.initial(n),
                dict(inp=m.random_input(n, seed=5)), 1 << 12)
    if name == "matmul16":
        m = jmatmul if jax else matmul
        A, B = m.random_inputs(n, seed=9)
        return (m.make_program(n, block=key[2]), m.initial(n),
                dict(A=A.ravel(), B=B.ravel()), 1 << 12)
    raise KeyError(key)


def _run_port(key, dispatch):
    prog, init, heap_init, cap = _programs(key, jax=False)
    return HostEngine(prog, capacity=cap, dispatch=dispatch,
                      device="cpu").run(init, heap_init=heap_init)


def test_registry_holds_the_ten_paper_cases():
    from repro.apps import all_cases as jall_cases

    assert sorted(all_cases()) == sorted(jall_cases())
    for name, case in all_cases().items():
        jcase = jget_case(name)
        assert case.program.name == jcase.program.name
        assert case.capacity == jcase.capacity


@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("name", APPS)
def test_app_matches_jax(jax_host, name, dispatch):
    assert_same_run(_run_port(name, dispatch), jax_host(name, dispatch),
                    name)


@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("n", (8, 16))
def test_naive_mergesort_matches_jax(jax_host, n, dispatch):
    got = _run_port(("naive", n), dispatch)
    assert_same_run(got, jax_host(("naive", n), dispatch), "naive")
    inp = mergesort.random_input(n, seed=5)
    np.testing.assert_array_equal(got[0]["src"][:n].numpy(), np.sort(inp))
    assert got[2].map_launches == 0


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_matmul_adds_in_the_reference_order(jax_host, dispatch):
    key = ("matmul16", 16, 4)
    assert_same_run(_run_port(key, dispatch), jax_host(key, dispatch),
                    "matmul")


def _generators(m):
    """Each app's input generators and references, called on fixed
    seeds, from either package's modules ``m``."""
    adj_off, adj = m["sssp"].random_graph(40, avg_degree=4, seed=7)
    wgt = m["sssp"].random_weights(len(adj), seed=2)
    dist = m["tsp"].random_instance(6, seed=3)
    Q = m["annealing"].random_qubo(6, seed=5)
    xr, xi = m["fft"].random_input(16, seed=7)
    return dict(
        graph=(adj_off, adj), wgt=wgt, dist=dist,
        greedy=m["tsp"].greedy_bound(dist),
        tsp_ref=m["tsp"].tsp_reference(dist),
        sssp_ref=m["sssp"].sssp_reference(adj_off, adj, wgt, 0, 40),
        qubo=Q, qmin=m["annealing"].brute_force_min(Q), fft=(xr, xi),
        fft_ref=m["fft"].fft_reference(xr, xi),
        mm=m["matmul"].random_inputs(8, seed=9),
        sort=m["mergesort"].random_input(32, seed=5),
        heap=m["sssp"].heap_init(adj_off, adj, wgt, 40),
        tsp_heap=m["tsp"].heap_init(dist),
    )


def _assert_equal(a, b):
    if isinstance(b, dict):
        assert set(a) == set(b)
        for k in b:
            _assert_equal(a[k], b[k])
    elif isinstance(b, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_generators_and_references_match_jax():
    import repro.apps as japps
    import repro_torch.apps as tapps

    names = ("sssp", "tsp", "annealing", "fft", "matmul", "mergesort")
    _assert_equal(_generators({k: getattr(tapps, k) for k in names}),
                  _generators({k: getattr(japps, k) for k in names}))
    assert tapps.nqueens.SOLUTIONS[7] == japps.nqueens.SOLUTIONS[7]


def test_naive_program_has_no_device_table():
    # the name is older than naive mergesort's device table: the naive and
    # map programs now find tables of their own, and of the apps here only
    # fft, matmul and annealing have none
    assert mergesort.make_program(16, use_map=False).name == "mergesort_naive"
    assert mergesort.make_program(16, use_map=True).name == "mergesort_map"
    mapped = epoch_megakernel.device_table(
        mergesort.make_program(16, use_map=True))
    naive = epoch_megakernel.device_table(
        mergesort.make_program(16, use_map=False))
    assert mapped is not None and naive is not None
    assert naive.app_id != mapped.app_id
    for name in APPS:
        table = epoch_megakernel.device_table(get_case(name).program)
        assert (table is None) == (name in ("annealing", "fft", "matmul"))


# ------------------------------------------------------- the references
def _host(prog, cap, init, heap_init=None):
    return HostEngine(prog, capacity=cap, device="cpu").run(
        init, heap_init=heap_init)


@pytest.mark.parametrize("n", (4, 5, 6, 7))
def test_nqueens_counts_solutions(n):
    heap, _, _ = _host(nqueens.make_program(n), 1 << 13, nqueens.initial())
    assert int(heap["count"][0]) == nqueens.SOLUTIONS[n]


def test_tsp_exact_with_pruning():
    n = 7
    dist = tsp.random_instance(n, seed=3)
    heap, _, stats = _host(tsp.make_program(n), 1 << 14, tsp.initial(),
                           tsp.heap_init(dist))
    assert int(heap["best"][0]) == tsp.tsp_reference(dist)
    full_tree = sum(
        math.factorial(n - 1) // math.factorial(n - 1 - d)
        for d in range(1, n)
    )
    assert stats.tasks_executed < full_tree


def test_annealing_reaches_good_energy():
    nb = 8
    Q = annealing.random_qubo(nb, seed=5)
    heap, _, stats = _host(annealing.make_program(nb, n_steps=40,
                                                  n_chains=16),
                           1 << 10, annealing.initial(), dict(Q=Q.ravel()))
    got = int(heap["best"][0])
    opt = annealing.brute_force_min(Q)
    assert got >= opt
    assert got <= opt + max(2, int(abs(opt) * 0.2))
    assert stats.epochs <= 45


def test_brute_force_min_matches_the_loop():
    for nb, seed in ((5, 0), (8, 5)):
        Q = annealing.random_qubo(nb, seed=seed)
        best = min(
            sum(int(Q[i, j]) * ((s >> i) & 1) * ((s >> j) & 1)
                for i in range(nb) for j in range(i, nb))
            for s in range(1 << nb)
        )
        assert annealing.brute_force_min(Q) == best


@pytest.mark.parametrize("n,block", ((4, 4), (8, 4), (16, 8)))
def test_matmul_matches_numpy(n, block):
    A, B = matmul.random_inputs(n, seed=9)
    heap, _, _ = _host(matmul.make_program(n, block=block), 1 << 12,
                       matmul.initial(n), dict(A=A.ravel(), B=B.ravel()))
    np.testing.assert_allclose(heap["C"].numpy().reshape(n, n), A @ B,
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n", (8, 32))
def test_fft_matches_numpy(n):
    xr, xi = fft.random_input(n, seed=7)
    heap, _, _ = _host(fft.make_program(n), 1 << 12, fft.initial(n),
                       dict(xr=xr, xi=xi))
    got = heap["re"][:n].numpy() + 1j * heap["im"][:n].numpy()
    np.testing.assert_allclose(got, fft.fft_reference(xr, xi), rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("n", (16, 64))
def test_sssp_matches_dijkstra_and_worklist(n):
    adj_off, adj = sssp.random_graph(n, avg_degree=4, seed=7)
    wgt = sssp.random_weights(len(adj), seed=2)
    ref = sssp.sssp_reference(adj_off, adj, wgt, 0, n)
    heap, _, _ = _host(sssp.make_program(n, len(adj)), 1 << 14,
                       sssp.initial(0), sssp.heap_init(adj_off, adj, wgt, n))
    np.testing.assert_allclose(heap["dist"].numpy(), ref, rtol=1e-5)
    wl, rounds = worklist.sssp_worklist(adj_off, adj, wgt, 0, n,
                                        device="cpu")
    np.testing.assert_allclose(wl.numpy(), ref, rtol=1e-5)
    assert rounds >= 1


@pytest.mark.parametrize("seed", (0, 3))
@pytest.mark.parametrize("n", (16, 96))
def test_bfs_matches_worklist(n, seed):
    adj_off, adj = bfs.random_graph(n, avg_degree=4, seed=seed)
    ref = bfs.bfs_reference(adj_off, adj, 0, n)
    wl, _ = worklist.bfs_worklist(adj_off, adj, 0, n, device="cpu")
    np.testing.assert_array_equal(wl.numpy(), ref)


@pytest.mark.parametrize("n", (16, 64, 256))
def test_bitonic_sorts(n):
    x = mergesort.random_input(n, seed=1)
    got = bitonic.bitonic_sort(torch.as_tensor(x))
    np.testing.assert_array_equal(got.numpy(), np.sort(x))
    down = bitonic.bitonic_sort(torch.as_tensor(x), ascending=False)
    np.testing.assert_array_equal(down.numpy(), np.sort(x)[::-1])


def test_baselines_match_the_jax_baselines():
    from repro.apps.baselines import bitonic as jbitonic
    from repro.apps.baselines import worklist as jworklist

    n = 96
    adj_off, adj = bfs.random_graph(n, avg_degree=4, seed=3)
    wgt = sssp.random_weights(len(adj), seed=2)
    jd, jr = jworklist.bfs_worklist(adj_off, adj, 0, n)
    td, tr = worklist.bfs_worklist(adj_off, adj, 0, n, device="cpu")
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert tr == jr
    jd, jr = jworklist.sssp_worklist(adj_off, adj, wgt, 0, n)
    td, tr = worklist.sssp_worklist(adj_off, adj, wgt, 0, n, device="cpu")
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert tr == jr
    x = mergesort.random_input(64, seed=2)
    np.testing.assert_array_equal(
        bitonic.bitonic_sort(torch.as_tensor(x), ascending=False).numpy(),
        np.asarray(jbitonic.bitonic_sort(x, ascending=False)))


def test_entry_points_check_their_arguments():
    with pytest.raises(ValueError, match="power-of-two"):
        mergesort.make_program(24, use_map=False)
    with pytest.raises(ValueError, match="power-of-two"):
        fft.make_program(12)
    with pytest.raises(ValueError, match="block"):
        matmul.make_program(12, block=4)
    with pytest.raises(ValueError, match="power-of-two"):
        bitonic.bitonic_sort(torch.zeros(12))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            worklist.bfs_worklist(*bfs.random_graph(8, seed=0), 0, 8)
