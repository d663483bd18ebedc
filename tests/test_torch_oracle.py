"""The port's sequential oracle (``core/interp.py``), its overhead
accounting (``core/analysis.py``) and the ``HostEngine`` / ``DeviceEngine``
hooks, on the CPU.

* ``run_oracle`` against the JAX ``run_oracle`` on fib(9), nqueens(5) and
  fft(8): heaps, values and ``OracleStats``, exactly;
* the port's ``HostEngine`` (all three dispatches) against the port's
  oracle on seeded random fork/join programs built here;
* ``compare`` and ``OverheadReport`` against the JAX ones on the same
  stats, and the same ``ValueError`` on a task-count mismatch;
* each hook given the plain versions from ``kernels/ref.py``: called, and
  the default path's results;
* ``coalesce=False`` against the JAX engine's, ``ranges_coalesced``
  included, and a ``stats_factory`` collector that is used.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from _torch_threads import one_torch_thread  # noqa: F401
from repro.apps import fft as jfft
from repro.apps import fib as jfib
from repro.apps import get_case as jget_case
from repro.apps import nqueens as jnqueens
from repro.core import HostEngine as JHostEngine
from repro.core import OracleStats as JOracleStats
from repro.core import compare as jcompare
from repro.core import run_oracle as jrun_oracle
from repro.core.engine import RunStats as JRunStats
from repro_torch.apps import fft, fib, get_case, nqueens
from repro_torch.core import (
    DeviceEngine, HeapVar, HostEngine, InitialTask, OracleStats,
    OverheadReport, Program, RunStats, RunStatsCollector, TaskType, compare,
    run_oracle,
)
from repro_torch.kernels import ref as kref


def _fft_program(m, n):
    """fft's program; the JAX one with its map element index handed to the
    body as a ``jnp.int32`` (the JAX oracle passes a Python int, which the
    butterfly's ``k.astype`` cannot take; its engines pass an array)."""
    prog = m.make_program(n)
    if m is not jfft:
        return prog
    import jax.numpy as jnp

    mt = prog.maps[0]

    class _ArrayEid:
        def __init__(self, mctx):
            self._mctx = mctx

        def __getattr__(self, name):
            return getattr(self._mctx, name)

        @property
        def eid(self):
            return jnp.int32(self._mctx.eid)

    return dataclasses.replace(prog, maps=(dataclasses.replace(
        mt, fn=lambda mctx: mt.fn(_ArrayEid(mctx))),))


ORACLE_CASES = {
    "fib9": lambda m: (m.PROGRAM, m.initial(9), None),
    "nqueens5": lambda m: (m.make_program(5), m.initial(), None),
    "fft8": lambda m: (_fft_program(m, 8), m.initial(8),
                       dict(zip(("xr", "xi"), m.random_input(8, seed=7)))),
}
JMOD = {"fib9": jfib, "nqueens5": jnqueens, "fft8": jfft}
TMOD = {"fib9": fib, "nqueens5": nqueens, "fft8": fft}


@pytest.fixture(scope="module")
def jax_oracle():
    cache = {}

    def get(name):
        if name not in cache:
            prog, init, heap_init = ORACLE_CASES[name](JMOD[name])
            cache[name] = jrun_oracle(prog, init, heap_init=heap_init,
                                      capacity=1 << 10)
        return cache[name]

    return get


@pytest.mark.parametrize("name", sorted(ORACLE_CASES))
def test_oracle_matches_jax(jax_oracle, name):
    jheap, jvalue, jstats = jax_oracle(name)
    prog, init, heap_init = ORACLE_CASES[name](TMOD[name])
    heap, value, stats = run_oracle(prog, init, heap_init=heap_init,
                                    capacity=1 << 10)
    assert set(heap) == set(jheap)
    for k in jheap:
        np.testing.assert_array_equal(heap[k].numpy(), np.asarray(jheap[k]))
    np.testing.assert_array_equal(value.numpy(), np.asarray(jvalue))
    assert dataclasses.asdict(stats) == dataclasses.asdict(jstats)


@pytest.mark.parametrize("name", sorted(ORACLE_CASES))
def test_host_engine_matches_oracle_on_the_apps(name):
    prog, init, heap_init = ORACLE_CASES[name](TMOD[name])
    oheap, ovalue, ostats = run_oracle(prog, init, heap_init=heap_init,
                                       capacity=1 << 10)
    heap, value, stats = HostEngine(prog, capacity=1 << 10,
                                    device="cpu").run(init, heap_init)
    for k in oheap:
        assert torch.equal(heap[k], oheap[k])
    assert torch.equal(value, ovalue)
    assert (stats.epochs, stats.tasks_executed, stats.total_forks) == (
        ostats.epochs, ostats.tasks_executed, ostats.total_forks)


# ---------------------------------------------------- random fork/join DAGs
def _random_dag_program(max_depth: int, fanout_mod: int) -> Program:
    """Each node hashes its args into a child count, forks that many
    children, add-scatters into a heap cell, and either emits a leaf value
    or joins a task that sums its children's values."""
    def _node(ctx):
        depth, salt = ctx.argi(0), ctx.argi(1)
        h = (salt * 31421 + depth * 6927 + 17) & 0x7FFF
        n_kids = torch.where(depth >= max_depth, 0, h % fanout_mod)
        ctx.write("touch", h % 16, 1, op="add")
        for k in range(fanout_mod - 1):
            ctx.fork("node", argi=(depth + 1, h + 31 * k + 7),
                     where=k < n_kids)
        has_kids = n_kids > 0
        ctx.emit(depth + (h % 5), where=~has_kids)
        ctx.join("gather", argi=(depth, salt), where=has_kids)

    def _gather(ctx):
        cv = ctx.child_values(fanout_mod - 1)  # [P, n, 1]
        ctx.emit(cv[:, :, 0].sum(1) + 1)

    return Program(
        name="random_dag",
        tasks=(TaskType("node", _node), TaskType("gather", _gather)),
        n_arg_i=2,
        heap=(HeapVar("touch", (16,), torch.int32),),
    )


_DAGS = [tuple(int(x) for x in (s, d, f)) for s, d, f in zip(
    np.random.RandomState(11).randint(0, 2**15, 5), (1, 2, 3, 4, 3),
    (2, 3, 4, 3, 3))]


@pytest.mark.parametrize("dispatch", ("masked", "compacted", "gather"))
@pytest.mark.parametrize("seed,max_depth,fanout_mod", _DAGS)
def test_random_dag_engine_matches_oracle(seed, max_depth, fanout_mod,
                                          dispatch):
    prog = _random_dag_program(max_depth, fanout_mod)
    init = InitialTask(task="node", argi=(0, seed))
    oheap, ovalue, ostats = run_oracle(prog, init, capacity=1 << 12)
    heap, value, stats = HostEngine(prog, capacity=1 << 12,
                                    dispatch=dispatch, device="cpu").run(init)
    assert torch.equal(heap["touch"], oheap["touch"])
    assert int(value[0, 0]) == int(ovalue[0, 0])
    assert stats.epochs == ostats.epochs
    assert stats.tasks_executed == ostats.tasks_executed


def test_oracle_raises_on_overflow():
    with pytest.raises(RuntimeError, match="overflow"):
        run_oracle(fib.PROGRAM, fib.initial(9), capacity=8)


# --------------------------------------------------------------- analysis
def test_compare_matches_jax():
    jprog, jinit, _ = ORACLE_CASES["nqueens5"](jnqueens)
    tprog, tinit, _ = ORACLE_CASES["nqueens5"](nqueens)
    _, _, jo = jrun_oracle(jprog, jinit, capacity=1 << 10)
    _, _, js = JHostEngine(jprog, capacity=1 << 10).run(jinit)
    _, _, to = run_oracle(tprog, tinit, capacity=1 << 10)
    _, _, ts = HostEngine(tprog, capacity=1 << 10, device="cpu").run(tinit)
    jrep, trep = jcompare(jo, js), compare(to, ts)
    assert isinstance(trep, OverheadReport)
    assert dataclasses.asdict(trep) == dataclasses.asdict(jrep)
    for p in (1, 7, 1024):
        assert trep.greedy_bound(p) == jrep.greedy_bound(p)


def test_compare_rejects_a_task_count_mismatch():
    o = OracleStats(epochs=3, tasks_executed=10)
    bad = RunStats(epochs=3, tasks_executed=11)
    with pytest.raises(ValueError, match="different task count") as te:
        compare(o, bad)
    with pytest.raises(ValueError, match="different task count") as je:
        jcompare(JOracleStats(epochs=3, tasks_executed=10),
                 JRunStats(epochs=3, tasks_executed=11))
    assert str(te.value) == str(je.value)
    # an engine that counted no tasks is not checked
    assert compare(o, RunStats(epochs=3)).t1_tasks == 10


# ------------------------------------------------------------------ hooks
class _Counted:
    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a):
        self.calls += 1
        return self.fn(*a)


def _same(a, b):
    ha, va, sa = a
    hb, vb, sb = b
    assert torch.equal(va, vb)
    assert set(ha) == set(hb)
    for k in ha:
        assert torch.equal(ha[k], hb[k])
    assert sa.as_dict() == sb.as_dict()


@pytest.mark.parametrize("name", ("fib", "mergesort"))
@pytest.mark.parametrize("dispatch", ("masked", "compacted", "gather"))
def test_host_hooks_take_the_plain_versions(name, dispatch):
    case = get_case(name)
    want = case.run(dispatch=dispatch, device="cpu")
    offsets = _Counted(kref.fork_scan_ref)
    rank = _Counted(kref.type_rank_ref)
    pack = _Counted(kref.lane_pack_ref)
    got = case.run(dispatch=dispatch, device="cpu", fork_offsets_fn=offsets,
                   rank_fn=rank, pack_fn=pack)
    _same(got, want)
    assert offsets.calls > 0
    assert rank.calls == (want[2].epochs if dispatch == "compacted" else 0)
    assert pack.calls == (want[2].epochs if dispatch == "gather" else 0)


def test_rank_fn_alone_builds_the_compacted_permutation():
    case = get_case("fib")
    rank = _Counted(kref.type_rank_ref)
    _same(case.run(dispatch="compacted", device="cpu", rank_fn=rank),
          case.run(dispatch="compacted", device="cpu"))
    assert rank.calls > 0


@pytest.mark.parametrize("dispatch", ("masked", "gather"))
def test_device_engine_fork_offsets_hook(dispatch):
    case = get_case("mergesort")
    offsets = _Counted(kref.fork_scan_ref)
    got = case.run(engine_cls=DeviceEngine, dispatch=dispatch, device="cpu",
                   fork_offsets_fn=offsets)
    _same(got, case.run(engine_cls=DeviceEngine, dispatch=dispatch,
                        device="cpu"))
    assert offsets.calls == got[2].epochs


@pytest.mark.parametrize("name", ("fib", "mergesort", "fft"))
def test_coalesce_off_matches_jax(name, monkeypatch):
    """``coalesce`` reaches the engine's scheduler; off, the runs equal the
    JAX engine's with it off (``ranges_coalesced`` 0: a solo run never has
    two same-CEN ranges on top of its stacks, so on and off agree)."""
    from repro_torch.core import engine as tengine

    made = []

    class Spy(tengine.EpochScheduler):
        def __init__(self, coalesce=True):
            super().__init__(coalesce=coalesce)
            made.append(coalesce)

    monkeypatch.setattr(tengine, "EpochScheduler", Spy)
    jcase, tcase = jget_case(name), get_case(name)
    jheap, jvalue, jstats = jcase.run(coalesce=False)
    theap, tvalue, tstats = tcase.run(coalesce=False, device="cpu")
    assert made == [False]
    np.testing.assert_array_equal(tvalue.numpy(), np.asarray(jvalue))
    if name != "fft":  # fft's heap: test_torch_apps.FFT_RTOL
        for k in jheap:
            np.testing.assert_array_equal(theap[k].numpy(),
                                          np.asarray(jheap[k]))
    assert tstats.as_dict() == jstats.as_dict()
    assert tstats.ranges_coalesced == 0
    _same(tcase.run(device="cpu"), (theap, tvalue, tstats))
    assert made == [False, True]


def test_stats_factory_collector_is_used():
    made = []

    class Counting(RunStatsCollector):
        def __init__(self):
            super().__init__()
            self.epoch_calls = 0
            made.append(self)

        def epoch(self, cen, n_ranges=1):
            self.epoch_calls += 1
            super().epoch(cen, n_ranges)

    case = get_case("fib")
    _, value, stats = case.run(device="cpu", stats_factory=Counting)
    assert len(made) == 1 and made[0].epoch_calls == stats.epochs > 0
    _same((_, value, stats), case.run(device="cpu"))
