"""The port's telemetry (``repro_torch.obs``) against the JAX package's, on
the CPU.

The JAX ``tests/test_obs.py`` cases (apart from the two of
``benchmarks/check.py``): spans land as valid Chrome-trace JSON, the null
tracer is inert, host drivers emit one ``epoch`` span per epoch with its
``pack``/``dispatch``/``readback`` phases in each mode, tracing on is bit
for bit tracing off, a chunked device service gives ⌈E/K⌉ ``chunk`` and
``readback`` spans and per-tenant latency histograms, the registry's
declaration rules, histogram quantiles, the collector's pairing of holes
with lanes, JSONL and Prometheus export, ``export_run_stats`` and the
logger.  Where the JAX package gives a value for the same run it is
compared: span names, counts and non-time args, registry values (time
histograms by their counts), and the Prometheus text of a
``JobService(dispatch="auto")`` wave with the time-valued samples masked.
"""
from __future__ import annotations

import functools
import logging
import math
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
pytest.importorskip("jax")

from repro import obs as jobs_
from repro.apps import fib as jfib
from repro.core import HostEngine as JHostEngine
from repro.core import RunStats as JRunStats
from repro.core import RunStatsCollector as JRunStatsCollector
from repro.service import JobService as JJobService
from repro_torch import obs as tobs
from repro_torch.apps import fib as tfib
from repro_torch.core import HostEngine as THostEngine
from repro_torch.core import RunStats as TRunStats
from repro_torch.core import RunStatsCollector as TRunStatsCollector
from repro_torch.obs import (
    NULL_TRACER,
    MetricsCollector,
    MetricsError,
    MetricsRegistry,
    SpanTracer,
    export_run_stats,
    get_logger,
    iter_samples,
    iter_spans,
    kv,
    load_trace,
    read_jsonl,
    to_prometheus,
    validate_chrome_trace,
    write_jsonl,
)
from repro_torch.service import JobService

MODES = ("masked", "compacted", "gather")
# the seconds-valued series: compared by their counts alone
TIME_SERIES = ("trees_job_queue_wait_seconds", "trees_job_run_seconds",
               "trees_class_queue_wait_seconds")


def _spans(events):
    """Each complete event's name, category, track and args (no times)."""
    return [(e["name"], e.get("cat"), e["tid"], e["args"])
            for e in events if e["ph"] == "X"]


def _masked_prometheus(text: str) -> str:
    """The exposition text with every time-valued sample's value masked
    but its ``_count``."""
    out = []
    for line in text.splitlines():
        name = line.split("{")[0].split(" ")[0]
        if (not line.startswith("#") and name.startswith(TIME_SERIES)
                and not name.endswith("_count")):
            line = line.rsplit(" ", 1)[0] + " <t>"
        out.append(line)
    return "\n".join(out)


# ---------------------------------------------------------------- trace.py
def _tracer_script(pkg, path=None):
    tr = pkg.SpanTracer()
    tr.thread(1, "host-epochs")
    with tr.span("epoch", "host", tid=1, cen=3) as args:
        with tr.span("dispatch", "host", tid=1, launched=8):
            with tr.annotation("trees:epoch_step"):
                pass
        args.update(util=0.5)
    tr.instant("admit", "service", tid=1, job="t0")
    tr.counter("queue_depth", tid=1, queued=2)
    if path is not None:
        tr.write(str(path))
    return tr


def test_span_tracer_writes_valid_chrome_trace(tmp_path):
    path = tmp_path / "trace.json"
    tr = _tracer_script(tobs, path)
    events = load_trace(str(path))
    spans = list(iter_spans(events, "epoch"))
    assert len(spans) == 1
    assert spans[0]["args"] == {"cen": 3, "util": 0.5}
    inner = list(iter_spans(events, "dispatch", "host"))
    assert len(inner) == 1 and inner[0]["dur"] >= 0
    assert spans[0]["ts"] <= inner[0]["ts"]
    # the same events as the JAX tracer's, times aside
    jtr = _tracer_script(jobs_)

    def shape(t):
        return [{k: v for k, v in e.items() if k not in ("ts", "dur")}
                for e in t.events]

    assert shape(tr) == shape(jtr)
    assert [(e["ph"], e["name"]) for e in events] == [
        (e["ph"], e["name"]) for e in jtr.events]


def test_validate_chrome_trace_rejects_malformed():
    bad = [({"events": []}, "traceEvents"), ([{"name": "x"}], "phase"),
           ([{"ph": "X", "name": "x", "ts": 0, "dur": "?", "pid": 1,
              "tid": 0}], "dur"),
           ([{"ph": "i", "name": "x", "pid": 1}], "ts"), (3, "dict")]
    for doc, match in bad:
        for validate in (validate_chrome_trace, jobs_.validate_chrome_trace):
            with pytest.raises(ValueError, match=match):
                validate(doc)
    good = [{"ph": "M", "name": "process_name", "pid": 1}]
    assert validate_chrome_trace(good) == good


def test_null_tracer_is_inert():
    assert not NULL_TRACER.enabled
    with NULL_TRACER.span("epoch", foo=1) as args:
        args.update(bar=2)  # throwaway dict, must not raise
    NULL_TRACER.instant("x")
    NULL_TRACER.counter("x", v=1)
    with NULL_TRACER.annotation("x"):
        pass
    assert NULL_TRACER.events_named("epoch") == []
    # the engines' default: no events anywhere
    eng = THostEngine(tfib.PROGRAM, capacity=256, device="cpu")
    assert eng.tracer is NULL_TRACER and eng.loop.maps.tracer is NULL_TRACER


def _host_labels(mode):
    return dict(driver="host", dispatch=mode, app="fib")


@functools.lru_cache(maxsize=None)
def _jax_host(mode):
    tr, reg = jobs_.SpanTracer(), jobs_.MetricsRegistry()
    eng = JHostEngine(
        jfib.PROGRAM, capacity=256, dispatch=mode, tracer=tr,
        stats_factory=lambda: jobs_.MetricsCollector(
            JRunStatsCollector(), reg, **_host_labels(mode)),
    )
    _, vals, stats = eng.run(jfib.initial(8))
    return np.asarray(vals), stats, tr, reg


def _port_host(mode, tracer=None, registry=None):
    kw = {}
    if registry is not None:
        kw["stats_factory"] = lambda: MetricsCollector(
            TRunStatsCollector(), registry, **_host_labels(mode))
    eng = THostEngine(tfib.PROGRAM, capacity=256, dispatch=mode,
                      tracer=tracer, device="cpu", **kw)
    _, vals, stats = eng.run(tfib.initial(8))
    return vals.numpy(), stats


@pytest.mark.parametrize("mode", MODES)
def test_host_engine_emits_per_epoch_spans(mode):
    tr = SpanTracer()
    _, stats = _port_host(mode, tracer=tr)
    E = stats.epochs
    epochs = list(iter_spans(tr.events, "epoch", "host"))
    assert len(epochs) == E
    packs = len(list(iter_spans(tr.events, "pack", "host")))
    assert packs == (0 if mode == "masked" else E)
    assert len(list(iter_spans(tr.events, "dispatch", "host"))) == E
    assert len(list(iter_spans(tr.events, "readback", "host"))) == E
    for e in epochs:
        assert e["args"]["mode"] == mode
        assert 0.0 <= e["args"]["util"] <= 1.0
    validate_chrome_trace(tr.to_dict())
    # the JAX engine's spans on the same run: names, tracks and args
    _, _, jtr, _ = _jax_host(mode)
    assert _spans(tr.events) == _spans(jtr.events)


def test_host_engine_map_spans():
    """One "map" span per payload launch, inside its epoch's span."""
    from repro_torch.apps import get_case

    case = get_case("mergesort")
    tr = SpanTracer()
    _, _, stats = case.run(device="cpu", tracer=tr)
    maps = list(iter_spans(tr.events, "map", "host"))
    assert stats.map_launches > 0 and len(maps) == stats.map_launches
    assert all(m["args"]["width"] >= 8 for m in maps)
    epochs = list(iter_spans(tr.events, "epoch", "host"))
    assert all(any(e["ts"] <= m["ts"] and m["ts"] + m["dur"]
                   <= e["ts"] + e["dur"] for e in epochs) for m in maps)


def test_tracing_off_is_bit_identical():
    for mode in MODES + ("auto",):
        ref_vals, ref_stats = _port_host(mode)
        tr = SpanTracer()
        vals, stats = _port_host(mode, tracer=tr)
        np.testing.assert_array_equal(vals, ref_vals)
        assert stats == ref_stats
        assert len(list(iter_spans(tr.events, "epoch"))) == stats.epochs
    jvals, jstats = _jax_host("masked")[:2]
    np.testing.assert_array_equal(_port_host("masked")[0], jvals)


# --------------------------------------- acceptance: resident chunk cadence
K = 3


def _device_wave(cls, fib_mod, **kw):
    svc = cls(capacity=512, max_jobs=2, engine="device", chunk=K, **kw)
    svc.submit(fib_mod.PROGRAM, fib_mod.initial(8), quota=256,
               name="tenant-a")
    svc.submit(fib_mod.PROGRAM, fib_mod.initial(9), quota=256,
               name="tenant-b")
    return svc, svc.drain()


@functools.lru_cache(maxsize=None)
def _jax_device_wave():
    reg, tr = jobs_.MetricsRegistry(), jobs_.SpanTracer()
    svc, hs = _device_wave(JJobService, jfib, metrics=reg, tracer=tr)
    return svc, hs, reg, tr


def test_device_service_trace_readbacks_and_tenant_latency():
    reg, tr = MetricsRegistry(), SpanTracer()
    svc, handles = _device_wave(JobService, tfib, metrics=reg, tracer=tr,
                                device="cpu")
    assert all(h.status.value == "done" for h in handles)
    E = svc.stats().epochs
    assert E > K
    readbacks = list(iter_spans(tr.events, "readback", "resident"))
    chunks = list(iter_spans(tr.events, "chunk", "resident"))
    assert len(readbacks) == len(chunks) == math.ceil(E / K)
    assert sum(c["args"]["epochs"] for c in chunks) == E
    assert all(c["args"]["k"] == K for c in chunks)
    assert sum(c["args"]["tasks"] for c in chunks) == \
        svc.stats().tasks_executed
    validate_chrome_trace(tr.to_dict())
    qw = reg.get("trees_job_queue_wait_seconds")
    rt = reg.get("trees_job_run_seconds")
    for tenant in ("tenant-a", "tenant-b"):
        assert qw.labels(tenant=tenant).count == 1
        assert rt.labels(tenant=tenant).count == 1
        assert qw.labels(tenant=tenant).sum >= 0.0
        assert rt.labels(tenant=tenant).sum > 0.0
        assert reg.value("trees_jobs_finished_total", tenant=tenant,
                         status="done") == 1
    assert reg.value("trees_wave_template_lookups_total",
                     outcome="miss") == 1
    assert reg.value("trees_wave_template_traces") == svc.trace_count
    assert reg.value("trees_epochs_total", driver="device",
                     dispatch="masked", app="service") == E
    # the JAX service on the same wave: the same spans (times aside) and
    # the same exposition (time-valued samples and the template build
    # counter, which counts different builds in the two packages, masked)
    jsvc, jhs, jreg, jtr = _jax_device_wave()
    assert jsvc.stats().as_dict() == svc.stats().as_dict()
    assert _spans(tr.events) == _spans(jtr.events)

    def text(exposition):
        return re.sub(r"(trees_wave_template_traces(\{\})?) \d+",
                      r"\1 <n>", _masked_prometheus(exposition))

    assert text(to_prometheus(reg)) == text(jobs_.to_prometheus(jreg))


def test_host_service_auto_exposition_matches_jax():
    """JobService(engine="host", dispatch="auto") with metrics and a
    tracer: the decisions, every series (time-valued samples masked) and
    every span's args equal the JAX service's, and the tenants equal."""
    def run(cls, fib_mod, obs_mod, **kw):
        reg, tr = obs_mod.MetricsRegistry(), obs_mod.SpanTracer()
        svc = cls(capacity=4096, max_jobs=2, dispatch="auto",
                  calibrate=False, metrics=reg, tracer=tr, **kw)
        hs = [svc.submit(fib_mod.PROGRAM, fib_mod.initial(n), quota=q,
                         name=f"t{n}") for n, q in ((7, 2048), (9, 2048),
                                                    (6, 2048))]
        svc.drain()
        return svc, hs, reg, tr

    svc, hs, reg, tr = run(JobService, tfib, tobs, device="cpu")
    jsvc, jhs, jreg, jtr = run(JJobService, jfib, jobs_)
    assert svc.controller.decisions == jsvc.controller.decisions
    assert svc.controller.decisions["gather"] > 0
    assert _masked_prometheus(to_prometheus(reg)) == _masked_prometheus(
        jobs_.to_prometheus(jreg))
    assert _spans(tr.events) == _spans(jtr.events)
    for h, jh in zip(hs, jhs):
        np.testing.assert_array_equal(h.result.value.numpy(),
                                      np.asarray(jh.result.value))
        assert h.result.stats.solo_dict() == jh.result.stats.solo_dict()
    assert svc.stats().as_dict() == jsvc.stats().as_dict()


# -------------------------------------------------------------- metrics.py
def test_registry_declaration_semantics():
    r = MetricsRegistry()
    c1 = r.counter("x_total", "a counter", ("driver",))
    c2 = r.counter("x_total", "a counter", ("driver",))
    assert c1 is c2
    with pytest.raises(MetricsError, match="already registered"):
        r.gauge("x_total", "now a gauge", ("driver",))
    with pytest.raises(MetricsError, match="do not match"):
        c1.labels(nope="x")
    c1.labels(driver="host").inc(2)
    assert r.value("x_total", driver="host") == 2
    with pytest.raises(MetricsError, match=">= 0"):
        c1.labels(driver="host").inc(-1)
    g = r.gauge("y", "", ()).labels()
    g.set(3)
    g.max(2)
    g.max(5)
    assert r.value("y") == 5
    with pytest.raises(MetricsError, match="window size"):
        tobs.metrics.RollingWindow(0)


def test_histogram_buckets_and_quantile():
    def run(pkg):
        r = pkg.MetricsRegistry()
        h = r.histogram("lat_seconds", "", (), buckets=(0.1, 1.0)).labels()
        out = [h.quantile(0.5)]
        for v in (0.05, 0.5, 5.0, 0.1, 1.0):
            h.observe(v)
        out += [h.count, list(h.counts), h.sum]
        out += [h.quantile(q) for q in (0.0, 0.2, 0.5, 0.8, 1.0)]
        return out, r

    (got, r), (want, _) = run(tobs), run(jobs_)
    assert math.isnan(got[0]) and math.isnan(want[0])
    assert got[1:] == want[1:]
    assert got[1] == 5 and got[2] == [2, 2, 1]
    assert got[-1] == math.inf
    with pytest.raises(MetricsError, match="histogram"):
        r.value("lat_seconds")
    with pytest.raises(MetricsError, match="quantile"):
        r.get("lat_seconds").labels().quantile(2.0)


@pytest.mark.parametrize("mode", ("masked", "gather"))
def test_metrics_collector_pairs_holes_with_lanes(mode):
    r = MetricsRegistry()
    _, stats = _port_host(mode, registry=r)
    lab = _host_labels(mode)
    util = r.get("trees_lane_utilization").labels(**lab)
    frac = r.get("trees_hole_fraction").labels(**lab)
    assert util.count == frac.count == stats.epochs
    assert r.value("trees_tasks_total", **lab) == stats.tasks_executed
    assert r.value("trees_lanes_total", **lab) == stats.lanes_launched
    assert r.value("trees_hole_lanes_total", **lab) == \
        stats.hole_lanes_skipped
    assert r.value("trees_peak_tv_slots", **lab) == stats.peak_tv_slots
    assert r.value("trees_dispatches_total", **lab) == stats.dispatches
    # every series equal to the JAX collector's on the same run
    jreg = _jax_host(mode)[3]
    assert to_prometheus(r) == jobs_.to_prometheus(jreg)


# --------------------------------------------------------------- export.py
def _export_registry(pkg):
    r = pkg.MetricsRegistry()
    r.counter("trees_epochs_total", "epochs", ("driver",)).labels(
        driver="host").inc(23)
    r.gauge("trees_fill", 'a "quoted"\nhelp', ("app",)).labels(
        app='we"ird\\').set(0.25)
    r.histogram("trees_lat_seconds", "lat", (), buckets=(1.0,)).labels(
    ).observe(0.5)
    return r


def test_export_jsonl_and_prometheus(tmp_path):
    r = _export_registry(tobs)
    path = tmp_path / "metrics.jsonl"
    n = write_jsonl(r, str(path))
    samples = read_jsonl(str(path))
    assert len(samples) == n == len(list(iter_samples(r)))
    by_name = {s["name"]: s for s in samples}
    assert by_name["trees_epochs_total"]["value"] == 23
    assert by_name["trees_epochs_total"]["labels"] == {"driver": "host"}
    assert by_name["trees_lat_seconds"]["count"] == 1
    text = to_prometheus(r)
    assert "# TYPE trees_epochs_total counter" in text
    assert 'trees_epochs_total{driver="host"} 23' in text
    assert 'trees_lat_seconds_bucket{le="1"} 1' in text
    assert 'trees_lat_seconds_bucket{le="+Inf"} 1' in text
    assert "trees_lat_seconds_count 1" in text
    assert text.endswith("\n")
    jr = _export_registry(jobs_)
    assert text == jobs_.to_prometheus(jr)
    assert list(iter_samples(r)) == list(jobs_.iter_samples(jr))
    tobs.write_prometheus(r, str(tmp_path / "m.prom"))
    assert (tmp_path / "m.prom").read_text() == text


def test_export_run_stats_shares_vocabulary():
    kw = dict(epochs=3, tasks_executed=7, lanes_launched=10,
              dispatches=6, hole_lanes_skipped=2)
    r = MetricsRegistry()
    stats = TRunStats(**kw)
    export_run_stats(r, stats, driver="host", app="fib")
    assert r.value("trees_run_epochs", driver="host", app="fib") == 3
    assert r.value("trees_run_tasks_executed", driver="host",
                   app="fib") == 7
    assert r.value("trees_run_utilization", driver="host",
                   app="fib") == stats.utilization
    jr = jobs_.MetricsRegistry()
    jobs_.export_run_stats(jr, JRunStats(**kw), driver="host", app="fib")
    assert to_prometheus(r) == jobs_.to_prometheus(jr)


# ------------------------------------------------------------------ log.py
def test_logger_hierarchy_and_kv():
    log = get_logger("runtime")
    assert log.name == "repro.runtime"
    assert get_logger("runtime") is log
    assert get_logger().name == "repro"
    fields = dict(step=3, elapsed_s=0.25, name="a b", big=1e-7)
    line = kv(**fields)
    assert line == jobs_.kv(**fields)
    assert "step=3" in line and "elapsed_s=0.25" in line
    assert "name='a b'" in line
    rec = logging.LogRecord(
        "repro.runtime", logging.WARNING, __file__, 1,
        "straggler %s", (kv(step=3),), None,
    )
    out = tobs.log.KeyValueFormatter().format(rec)
    assert "WARNING" in out and "repro.runtime" in out
    assert "straggler step=3" in out
    root = tobs.log.configure(level="DEBUG", force=True)
    try:
        assert root.level == logging.DEBUG
        assert sum(getattr(h, "_repro_obs", False)
                   for h in root.handlers) == 1
    finally:
        tobs.log.configure(level="WARNING", force=True)
