"""The port's controllers (``repro_torch.control``) against the JAX
package's, on the CPU.

The JAX ``tests/test_controller.py`` regimes run through both packages
with the same inputs: the same observations must give the same
``Decision`` sequence (mode, fill, costs, reason, span), the same K
trajectory and placement picks, and the same registry values after
``bind_registry``.  Inside the drivers, with an explicit
``DispatchController(cost=CostModel())`` (the reference's priors) on each
side: ``HostEngine(dispatch="auto")`` on fib and bfs, the sparse
two-tenant ``EpochMultiplexer`` (which must go gather; with masked and
compacted allowed and a cheap pack, compacted, against the masked wave)
and ``DeviceEngine`` resolving
``"auto"`` from a warm window — per-epoch decisions, heaps, values and
whole ``RunStats`` equal.  ``JobService(engine="device", chunk="auto",
dispatch="auto")`` on a constant clock gives the JAX service's K sequence
(the chunk spans' ``k``), per-job results and decision counters, and
builds nothing for a repeated wave.  ``CostModel.calibrated`` probes once
per process on the CPU and ``save``/``load`` round-trip.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
pytest.importorskip("jax")

from repro import control as jcontrol
from repro.apps import get_case as jget_case
from repro.control import controller as jcc
from repro.core import DeviceEngine as JDeviceEngine
from repro.core import HostEngine as JHostEngine
from repro.obs import MetricsRegistry as JMetricsRegistry
from repro.obs import SpanTracer as JSpanTracer
from repro.service import EpochMultiplexer as JEpochMultiplexer
from repro.service import Job as JJob
from repro.service import JobHandle as JJobHandle
from repro.service import JobService as JJobService
from repro_torch import control as tcontrol
from repro_torch.apps import fib as tfib
from repro_torch.apps import get_case as tget_case
from repro_torch.control import controller as tcc
from repro_torch.core import DeviceEngine as TDeviceEngine
from repro_torch.core import HostEngine as THostEngine
from repro_torch.obs import MetricsRegistry as TMetricsRegistry
from repro_torch.obs import SpanTracer as TSpanTracer
from repro_torch.service import EpochMultiplexer as TEpochMultiplexer
from repro_torch.service import Job as TJob
from repro_torch.service import JobHandle as TJobHandle
from repro_torch.service import JobService as TJobService

PACKAGES = {"jax": jcontrol, "torch": tcontrol}


def _dec(d):
    return (d.mode, d.fill, tuple(sorted(d.costs.items())), d.reason,
            d.span_bucket, d.hole_fraction)


def _recording(module, **kw):
    """A DispatchController of ``module`` that logs every decision."""

    class Recording(module.DispatchController):
        def __init__(self, **k):
            super().__init__(**k)
            self.log = []

        def choose(self, span_bucket):
            d = super().choose(span_bucket)
            self.log.append(_dec(d))
            return d

    return Recording(**kw)


def _both(fn):
    """``fn(package)`` for each package; asserts the two results equal and
    returns the port's."""
    got = {name: fn(pkg) for name, pkg in PACKAGES.items()}
    assert got["torch"] == got["jax"]
    return got["torch"]


def _values(reg) -> dict:
    """Every counter/gauge child's value and every histogram child's
    buckets, sum and count, by (name, labels)."""
    out = {}
    for fam in reg.families():
        for labels, child in fam.items():
            key = (fam.name, tuple(sorted(labels.items())))
            if hasattr(child, "counts"):
                out[key] = (tuple(child.counts), child.sum, child.count)
            else:
                out[key] = child.value
    return out


# ------------------------------------------------------------ rolling window
def test_rolling_window_mean_and_eviction():
    def run(pkg):
        w = pkg.RollingWindow(3)
        out = [(w.mean(), w.last(), len(w))]
        for v in (1.0, 2.0, 3.0, 7.0, 0.25):
            w.add(v)
            out.append((w.mean(), w.last(), len(w)))
        return out

    out = _both(run)
    assert out[3][0] == pytest.approx(2.0)
    assert out[4] == (pytest.approx(4.0), 7.0, 3)


# --------------------------------------------------------------- cost model
def test_cost_model_prices_match_the_reference():
    grid = [(P, fill, nt) for P in (1, 8, 1024, 4096, 1 << 20)
            for fill in (0.0, 0.001, 0.01, 0.25, 0.5, 1.0, 1.5)
            for nt in (1, 3, 9)]
    costs = _both(lambda pkg: [pkg.CostModel().epoch_costs(*g)
                               for g in grid])
    dense = tcontrol.CostModel().epoch_costs(4096, fill=1.0)
    sparse = tcontrol.CostModel().epoch_costs(4096, fill=0.01)
    assert dense["masked"] < dense["gather"] < dense["compacted"]
    assert sparse["gather"] < sparse["masked"]
    assert len(costs) == len(grid)
    # the priors are the reference's literals (the parity tests need them)
    assert tcontrol.CostModel() == tcontrol.CostModel(
        dispatch_s=40e-6, transfer_s=15e-6, lane_s=60e-9, pack_lane_s=8e-9,
        per_type_s=2e-6, source="roofline")


def _feed(ctl, obs):
    out = []
    for item in obs:
        if item[0] == "observe":
            ctl.observe(*item[1:])
        elif item[0] == "choose":
            out.append(_dec(ctl.choose(item[1])))
        else:
            out.append(_dec(ctl.choose_resident(item[1])))
    return out


REGIMES = {
    # nearly-empty frontier: 8 live lanes in 4096 -> gather
    "all_holes": ({}, [("observe", 8, 4096)] * 4 + [("choose", 4096)]),
    "dense": ({}, [("observe", 4096, 4096)] * 4 + [("choose", 4096)]),
    "cold_start": ({}, [("choose", 1024)]),
    # parked on gather, then a dense window inside a huge band
    "hysteresis": (dict(hysteresis=10.0),
                   [("observe", 8, 4096)] * 8 + [("choose", 4096)]
                   + [("observe", 4096, 4096)] * 32 + [("choose", 4096)]),
    "resident": ({}, [("observe", 2, 4096)] * 4
                 + [("resident", 4096), ("choose", 4096)]),
    "two_types_compacted": (
        dict(modes=("masked", "compacted"), n_types=2,
             cost_kw=dict(dispatch_s=1e-7, transfer_s=1e-7)),
        [("observe", 3, 512), ("choose", 512)]
        + [("observe", 512, 512)] * 10
        + [("choose", 512), ("observe", 0, 0), ("choose", 64)]),
}


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_dispatch_controller_regimes_match(regime):
    kw, obs = REGIMES[regime]

    def run(pkg):
        k = dict(kw)
        cost_kw = k.pop("cost_kw", None)
        if cost_kw is not None:
            k["cost"] = pkg.CostModel(**cost_kw)
        ctl = pkg.DispatchController(**k)
        return _feed(ctl, obs), ctl.decisions, ctl.modes

    log, decisions, modes = _both(run)
    last = log[-1]
    if regime == "all_holes":
        assert last[0] == "gather" and last[3] == "cost"
        assert last[5] == pytest.approx(1.0 - 8 / 4096)
    elif regime == "dense":
        assert last[0] == "masked"
    elif regime == "cold_start":
        assert last[0] == "masked" and last[3] == "no-data"
        assert last[1] is None
    elif regime == "hysteresis":
        assert log[0][0] == "gather"
        assert last[0] == "gather" and last[3] == "hysteresis"
    elif regime == "resident":
        assert log[0][0] in ("masked", "gather")
        assert modes == ("masked", "compacted", "gather")
    else:
        assert log[0][0] == "compacted" and log[1][0] == "masked"
    assert sum(decisions.values()) == len(log)


def test_dispatch_controller_refuses_unknown_modes():
    for pkg in PACKAGES.values():
        with pytest.raises(ValueError, match="unknown auto dispatch mode"):
            pkg.DispatchController(modes=("masked", "eager"))


def test_decision_counters_exported():
    def run(pkg, reg):
        ctl = pkg.DispatchController(registry=reg, driver="host", app="t")
        for _ in range(4):
            ctl.observe(8, 4096)
        ctl.choose(4096)
        ctl.observe(4000, 4096)
        ctl.choose(4096)
        return _values(reg)

    got = run(tcontrol, TMetricsRegistry())
    assert got == run(jcontrol, JMetricsRegistry())
    reg = TMetricsRegistry()
    run(tcontrol, reg)
    assert reg.value("trees_controller_decisions_total",
                     driver="host", app="t", mode="gather") == 2
    assert reg.value("trees_controller_fill", driver="host",
                     app="t") == pytest.approx(4000 / 4096)


# ----------------------------------------------------------- chunk controller
def _chunk_obs(seed, n=64):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        queued = int(rng.integers(0, 3))
        wait = float(rng.choice([0.0, 0.001, 0.05, 1.0]))
        slack = float(rng.choice([math.inf, 0.05, 5.0]))
        out.append((int(rng.integers(0, 3)), queued, wait, slack))
    return out


@pytest.mark.parametrize("kw", (
    dict(k_init=1, k_max=64),
    dict(k_init=16, hot_wait_s=0.05),
    dict(k_init=8, k_min=2, k_max=32, tight_slack_s=1.0),
))
def test_chunk_controller_trajectory_matches(kw):
    obs = _chunk_obs(7)

    def run(pkg):
        ctl = pkg.ChunkController(**kw)
        ks = [ctl.observe(c, q, w, deadline_slack=s) for c, q, w, s in obs]
        ks += [ctl.observe(completions=0) for _ in range(8)]
        return ks, ctl.widened, ctl.shrunk, ctl.current()

    ks, widened, shrunk, k = _both(run)
    assert widened > 0 and shrunk > 0 and len(set(ks)) > 2


def test_chunk_controller_regimes():
    ctl = tcontrol.ChunkController(k_init=1, k_max=64)
    ks = [ctl.observe(completions=0) for _ in range(8)]
    assert ks[:6] == [2, 4, 8, 16, 32, 64] and ctl.current() == 64
    ctl = tcontrol.ChunkController(k_init=16, hot_wait_s=0.05)
    assert ctl.observe(completions=2, queued=3, oldest_wait_s=1.0) == 8
    for _ in range(8):
        k = ctl.observe(completions=0, queued=3, oldest_wait_s=1.0)
    assert k == 1
    assert ctl.observe(completions=1, queued=0) == 1
    ctl = tcontrol.ChunkController(k_init=8, hot_wait_s=0.05)
    assert ctl.observe(completions=1, queued=2, oldest_wait_s=0.001) == 8
    for pkg in PACKAGES.values():
        with pytest.raises(ValueError):
            pkg.ChunkController(k_init=0)
        with pytest.raises(ValueError):
            pkg.ChunkController(k_init=8, k_max=4)


def test_chunk_controller_registry_gauges():
    def run(pkg, reg):
        ctl = pkg.ChunkController(k_init=2, registry=reg, app="t")
        for c, q, w, s in _chunk_obs(3, 12):
            ctl.observe(c, q, w, deadline_slack=s)
        return _values(reg)

    assert run(tcontrol, TMetricsRegistry()) == run(jcontrol,
                                                     JMetricsRegistry())
    reg = TMetricsRegistry()
    ctl = tcontrol.ChunkController(k_init=2, registry=reg, app="t")
    ctl.observe(completions=0)
    assert reg.value("trees_controller_chunk_k", app="t") == 4
    assert reg.value("trees_controller_chunk_adaptations_total",
                     app="t", action="widen") == 1


# ------------------------------------------------------ placement controller
def test_placement_controller_matches():
    rng = np.random.default_rng(5)
    steps = []
    for _ in range(200):
        r = rng.random()
        if r < 0.5:
            steps.append(("job", int(rng.integers(0, 4))))
        elif r < 0.7:
            steps.append(("imbalance", float(rng.choice([0.0, 0.1, 0.5])),
                          int(rng.integers(0, 4))))
        else:
            steps.append(("choose",))

    def run(pkg, reg):
        ctl = pkg.PlacementController(window=8, registry=reg, app="t")
        picks = []
        for st in steps:
            if st[0] == "job":
                ctl.observe_job(st[1])
            elif st[0] == "imbalance":
                ctl.observe_imbalance(st[1], st[2])
            else:
                picks.append((ctl.choose(), ctl.diversity))
        return picks, ctl.decisions, ctl.last_policy, _values(reg)

    picks, decisions, last, values = run(tcc, TMetricsRegistry())
    assert (picks, decisions, last, values) == run(jcc, JMetricsRegistry())
    assert set(decisions) == {"round_robin", "least_loaded", "sticky"}
    ctl = tcc.PlacementController()
    assert ctl.choose() == "round_robin" and ctl.diversity == 0.0
    ctl.observe_job("a")
    ctl.observe_job("b")
    assert ctl.choose() == "sticky"
    ctl.observe_imbalance(0.5, 0)
    assert ctl.choose() == "least_loaded"


# ------------------------------------------------------------- calibration
def test_calibration_is_one_shot_per_process(tmp_path):
    saved = dict(tcc._CALIBRATION_CACHE)
    tcc._CALIBRATION_CACHE.clear()
    try:
        p = str(tmp_path / "cal.json")
        m1 = tcontrol.CostModel.calibrated(capacity=256, repeats=1, path=p,
                                           device="cpu")
        assert m1.source == "calibrated:cpu"
        assert m1.dispatch_s > 0 and m1.lane_s > 0 and m1.pack_lane_s > 0
        assert m1.dispatch_s == pytest.approx(2 * m1.transfer_s)
        # the second call comes from the process cache (the same object)
        assert tcontrol.CostModel.calibrated(device="cpu") is m1
        tcc._CALIBRATION_CACHE.clear()
        m2 = tcontrol.CostModel.load(p, backend="cpu")
        assert m2 == m1
        assert tcontrol.CostModel.load(p, backend="cuda:other") is None
        # a fresh process loads the file instead of probing
        assert tcontrol.CostModel.calibrated(path=p, device="cpu") == m1
        assert tcontrol.CostModel.load(str(tmp_path / "none.json")) is None
    finally:
        tcc._CALIBRATION_CACHE.clear()
        tcc._CALIBRATION_CACHE.update(saved)


# ------------------------------------------------------ inside the drivers
def _np(x):
    return np.asarray(x.cpu() if hasattr(x, "cpu") else x)


def _same_run(t, j):
    (th, tv, ts), (jh, jv, js) = t, j
    np.testing.assert_array_equal(_np(tv), np.asarray(jv))
    assert set(th) == set(jh)
    for k in jh:
        np.testing.assert_array_equal(_np(th[k]), np.asarray(jh[k]))
    if hasattr(ts, "as_dict"):
        assert ts.as_dict() == js.as_dict()
    elif dataclasses.is_dataclass(ts):  # a tenant's JobStats
        assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    else:
        assert ts == js


@pytest.mark.parametrize("case", ("fib", "bfs"))
def test_host_engine_auto_matches_jax(case):
    tc, jc = tget_case(case), jget_case(case)
    tctl = _recording(tcontrol, cost=tcontrol.CostModel())
    jctl = _recording(jcontrol, cost=jcontrol.CostModel())
    t = THostEngine(tc.program, capacity=tc.capacity, dispatch="auto",
                    controller=tctl, device="cpu").run(
        tc.initial, heap_init=dict(tc.heap_init) or None)
    j = JHostEngine(jc.program, capacity=jc.capacity, dispatch="auto",
                    controller=jctl).run(
        jc.initial, heap_init=dict(jc.heap_init) or None)
    _same_run(t, j)
    assert tctl.log == jctl.log and len(tctl.log) == t[2].epochs
    assert tctl.decisions == jctl.decisions
    # a solo frontier is span-sized: masked throughout
    assert tctl.decisions["masked"] == t[2].epochs


def _sparse_fleet(cls_job, cls_handle, cls_case):
    """Two small fib tenants at opposite ends of a wide TV."""
    return [
        cls_handle(i, cls_job(c.program, c.initial,
                              heap_init=dict(c.heap_init), quota=2048,
                              name=f"{c.name}#{i}"))
        for i, c in enumerate((cls_case("fib"), cls_case("fib")))
    ]


@functools.lru_cache(maxsize=None)
def _jax_sparse_fleet():
    ctl = _recording(jcontrol, cost=jcontrol.CostModel())
    hs = _sparse_fleet(JJob, JJobHandle, jget_case)
    mux = JEpochMultiplexer(hs, dispatch="auto", controller=ctl)
    mux.run()
    return hs, mux.stats(), ctl


def test_sparse_fleet_auto_matches_jax():
    jhs, jstats, jctl = _jax_sparse_fleet()
    tctl = _recording(tcontrol, cost=tcontrol.CostModel())
    ths = _sparse_fleet(TJob, TJobHandle, tget_case)
    mux = TEpochMultiplexer(ths, dispatch="auto", controller=tctl,
                            device="cpu")
    mux.run()
    assert tctl.log == jctl.log
    assert tctl.decisions["gather"] > 0, tctl.decisions
    assert mux.stats().as_dict() == jstats.as_dict()
    for th, jh in zip(ths, jhs):
        tr, jr = th.result, jh.result
        _same_run((tr.heap, tr.value, tr.stats), (jr.heap, jr.value,
                                                  jr.stats))


def test_sparse_fleet_auto_compacted_equals_masked():
    """The port alone: a controller allowed masked and compacted (a pack
    pass priced nearly free) takes compacted epochs on the sparse fleet,
    and every tenant equals the masked wave's."""
    cost = tcontrol.CostModel(dispatch_s=1e-7, transfer_s=1e-7,
                              per_type_s=0.0)
    ctl = tcontrol.DispatchController(cost=cost,
                                      modes=("masked", "compacted"))
    got = _sparse_fleet(TJob, TJobHandle, tget_case)
    mux = TEpochMultiplexer(got, dispatch="auto", controller=ctl,
                            device="cpu")
    mux.run()
    assert ctl.decisions["compacted"] > 0, ctl.decisions
    want = _sparse_fleet(TJob, TJobHandle, tget_case)
    TEpochMultiplexer(want, dispatch="masked", device="cpu").run()
    for g, w in zip(got, want):
        gr, wr = g.result, w.result
        _same_run((gr.heap, gr.value, gr.stats.solo_dict()),
                  (wr.heap, wr.value, wr.stats.solo_dict()))


def test_device_engine_auto_matches_jax():
    """A warm window (the sparse fleet's observations) resolves "auto" to
    gather on both sides, a cold controller to masked; the runs match."""
    window = list(_jax_sparse_fleet()[2].window._items)
    ctls = {}
    for name, pkg in PACKAGES.items():
        ctls[name] = _recording(pkg, cost=pkg.CostModel())
        for v in window:
            ctls[name].window.add(v)
    tc, jc = tget_case("fib"), jget_case("fib")
    cold = TDeviceEngine(tc.program, capacity=tc.capacity, dispatch="auto",
                         device="cpu")
    assert cold.policy.name == "masked"
    ttr, jtr = TSpanTracer(), JSpanTracer()
    t_eng = TDeviceEngine(tc.program, capacity=tc.capacity,
                          dispatch="auto", controller=ctls["torch"],
                          device="cpu", tracer=ttr)
    j_eng = JDeviceEngine(jc.program, capacity=jc.capacity,
                          dispatch="auto", controller=ctls["jax"],
                          tracer=jtr)
    assert ctls["torch"].log == ctls["jax"].log and len(ctls["jax"].log) == 1
    assert t_eng.policy.name == j_eng.policy.name == "gather"
    _same_run(t_eng.run(tc.initial), j_eng.run(jc.initial))
    # one "wave" span with its readback, the same args as the reference's
    spans = [(e["name"], e["cat"], e["args"]) for e in ttr.events
             if e["ph"] == "X"]
    assert spans == [(e["name"], e["cat"], e["args"]) for e in jtr.events
                     if e["ph"] == "X"]
    assert [n for n, _, _ in spans] == ["readback", "wave"]


# ------------------------------------------------- the device job service
def _service_wave(svc, fib_mod):
    hs = [svc.submit(fib_mod.PROGRAM, fib_mod.initial(n), quota=256,
                     name=f"t{n}") for n in (6, 9, 8, 7)]
    svc.drain()
    return hs


def _chunk_args(tracer):
    return [{k: v for k, v in e["args"].items()}
            for e in tracer.events_named("chunk")]


@functools.lru_cache(maxsize=None)
def _jax_device_service():
    reg, tr = JMetricsRegistry(), JSpanTracer()
    from repro.apps import fib as jfib

    svc = JJobService(capacity=512, max_jobs=2, engine="device",
                      chunk="auto", dispatch="auto", calibrate=False,
                      metrics=reg, tracer=tr, clock=lambda: 0.0)
    hs = _service_wave(svc, jfib)
    return svc, hs, reg, tr


def test_device_service_chunk_auto_matches_jax():
    jsvc, jhs, jreg, jtr = _jax_device_service()
    reg, tr = TMetricsRegistry(), TSpanTracer()
    svc = TJobService(capacity=512, max_jobs=2, engine="device",
                      chunk="auto", dispatch="auto", calibrate=False,
                      metrics=reg, tracer=tr, clock=lambda: 0.0,
                      device="cpu")
    hs = _service_wave(svc, tfib)
    ks = [a["k"] for a in _chunk_args(tr)]
    assert ks == [a["k"] for a in _chunk_args(jtr)]
    assert len(set(ks)) > 1, ks  # K moved
    assert _chunk_args(tr) == _chunk_args(jtr)
    for th, jh in zip(hs, jhs):
        assert th.status.value == jh.status.value == "done"
        tr_, jr = th.result, jh.result
        np.testing.assert_array_equal(_np(tr_.value), np.asarray(jr.value))
        assert tr_.stats.solo_dict() == jr.stats.solo_dict()
    assert svc.stats().as_dict() == jsvc.stats().as_dict()
    assert svc.chunk_controller.k == jsvc.chunk_controller.k
    assert svc.controller.decisions == jsvc.controller.decisions
    for name in ("trees_controller_decisions_total",
                 "trees_controller_chunk_k",
                 "trees_controller_chunk_adaptations_total",
                 "trees_wave_template_lookups_total"):
        tv = {k: v for k, v in _values(reg).items() if k[0] == name}
        assert tv and tv == {k: v for k, v in _values(jreg).items()
                             if k[0] == name}, name
    # a repeated wave keeps its template's mode and builds nothing
    before = svc.trace_count
    _service_wave(svc, tfib)
    assert svc.trace_count == before
