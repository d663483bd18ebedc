"""The port stands alone: it imports no JAX and nothing of the JAX package
(every module, the job service, the sharded fleet, the treewalk app, the
ten registry cases, the baselines, the oracle and its overhead report,
the LLM server, on an attention, an SSM, two MoE and an encoder-decoder
model, and the three example twins, among them, runs with both blocked),
runs on the CPU only when asked, and its chip smoke script refuses to run
without a card or without the repository beside it."""
from __future__ import annotations

import os
import pathlib
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch.apps import fib
from repro_torch.core import DeviceEngine, HostEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]

_BLOCK = r'''
import importlib, importlib.abc, pkgutil, sys

class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"{name} is blocked")
        return None

sys.meta_path.insert(0, _Block())
'''

_BLOCKED_RUN = _BLOCK + r'''
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
import chip_smoke  # noqa: F401
from repro_torch.apps import fib
from repro_torch.core import DeviceEngine
from repro_torch.kernels import epoch_megakernel
heap, value, stats = fib.case().run(device="cpu")
assert int(value[0, 0]) == fib.fib_reference(12), value[0]
_, rvalue, rstats = fib.case().run(engine_cls=DeviceEngine, device="cpu",
                                   dispatch="gather", megakernel=True)
assert int(rvalue[0, 0]) == fib.fib_reference(12), rvalue[0]
assert epoch_megakernel.device_table(fib.PROGRAM) is not None
from repro_torch.apps import get_fleet, treewalk
from repro_torch.obs import SpanTracer, iter_spans
from repro_torch.service import JobService
tr = SpanTracer()
_, _, astats = fib.case().run(device="cpu", dispatch="auto", tracer=tr)
assert len(list(iter_spans(tr.events, "epoch"))) == astats.epochs
fleet = get_fleet("mixed3")
svc = JobService(capacity=sum(q for _, q in fleet), device="cpu")
handles = [svc.submit_case(c, quota=q) for c, q in fleet]
svc.drain()
assert all(h.status.value == "done" for h in handles), handles
from repro_torch.distributed import ShardedFleet
import repro_torch.launch.mesh
sharded = JobService(capacity=sum(q for _, q in fleet), engine="sharded",
                     shards=2, chunk=4, device="cpu")
sharded_hs = [sharded.submit_case(c, quota=q) for c, q in fleet * 2]
sharded.drain()
assert all(h.status.value == "done" for h in sharded_hs), sharded_hs
assert isinstance(sharded._mux, ShardedFleet)
walk = handles[1].result.heap
visit, clock = treewalk.treewalk_reference(
    fleet[1][0].heap_init["left"], fleet[1][0].heap_init["right"])
assert (walk["visit_epoch"].numpy() == visit).all()
import numpy as np
from repro_torch import configs
from repro_torch.models import init_model
from repro_torch.serving import EpochServer, Request
cfg = configs.get_reduced("granite_3_8b")
srv = EpochServer(cfg, init_model(cfg, seed=0, device="cpu"), n_slots=2,
                  max_len=32, device="cpu")
for n in (5, 9):
    srv.submit(Request(prompt=np.arange(3, 3 + n, dtype=np.int32),
                       max_new_tokens=4))
served = srv.run_to_completion()
assert [len(r.output) for r in served] == [4, 4], served
cfg = configs.get_reduced("mamba2_1_3b")
ssm_srv = EpochServer(cfg, init_model(cfg, seed=0, device="cpu"), n_slots=2,
                      max_len=32, device="cpu")
for n in (5, 9):
    ssm_srv.submit(Request(prompt=np.arange(3, 3 + n, dtype=np.int32),
                           max_new_tokens=3))
assert [len(r.output) for r in ssm_srv.run_to_completion()] == [3, 3]
served_more = []
for arch in ("granite_moe_1b_a400m", "llama4_scout_17b_a16e",
             "whisper_large_v3"):
    cfg = configs.get_reduced(arch)
    enc = (np.ones((1, cfg.encoder_len, cfg.d_model), np.float32)
           if cfg.encdec else None)
    more = EpochServer(cfg, init_model(cfg, seed=0, device="cpu"),
                       n_slots=2, max_len=32, device="cpu", enc_frames=enc)
    more.submit(Request(prompt=np.arange(3, 8, dtype=np.int32),
                        max_new_tokens=3))
    served_more += [len(r.output) for r in more.run_to_completion()]
assert served_more == [3, 3, 3], served_more
from repro_torch.apps import all_cases, mergesort, nqueens, sssp
from repro_torch.apps.baselines import bitonic, worklist
from repro_torch.core import compare, run_oracle
import torch
assert len(all_cases()) == 10
qheap, _, qstats = nqueens.case().run(device="cpu")
assert int(qheap["count"][0]) == nqueens.SOLUTIONS[6]
_, _, ostats = run_oracle(nqueens.make_program(6), nqueens.initial(),
                          capacity=1 << 13)
report = compare(ostats, qstats)
adj_off, adj = sssp.random_graph(32, seed=7)
wgt = sssp.random_weights(len(adj), seed=2)
wl, _ = worklist.sssp_worklist(adj_off, adj, wgt, 0, 32, device="cpu")
assert np.allclose(wl.numpy(), sssp.sssp_reference(adj_off, adj, wgt, 0, 32))
x = mergesort.random_input(16, seed=1)
assert (bitonic.bitonic_sort(torch.as_tensor(x)).numpy() == np.sort(x)).all()
leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")]
assert not leaked, leaked
print("isolated", stats.epochs, "resident", rstats.epochs,
      "service", svc.stats().epochs, "served", srv.epochs,
      "ssm", ssm_srv.epochs, "moe and encdec", len(served_more))
print("apps", len(all_cases()), "oracle", report.t1_tasks,
      report.t_inf_epochs)
'''


def _env():
    """The subprocesses' environment: the checkout on the path, and one
    OpenMP thread for torch (their tensors are small, as in the test
    modules that pin one thread)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    env["OMP_NUM_THREADS"] = "1"
    return env


def test_port_imports_and_runs_without_jax():
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN], capture_output=True, text=True,
        env=_env(), cwd=ROOT, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert ("isolated 23 resident 23 service 23 served 4 ssm 3 "
            "moe and encdec 3") in out.stdout
    assert "apps 10 oracle 153 7" in out.stdout


_TWINS_RUN = _BLOCK + r'''
import runpy
for argv in (["quickstart_torch.py"],
             ["graph_analytics_torch.py", "--nodes", "64"],
             ["serve_llm_torch.py", "--requests", "3"],
             ["serve_llm_torch.py", "--legacy", "--requests", "2"]):
    sys.argv = argv + ["--device", "cpu"]
    runpy.run_path("examples/" + argv[0], run_name="__main__")
leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")]
assert not leaked, leaked
print("twins isolated")
'''


def test_example_twins_run_without_jax():
    out = subprocess.run(
        [sys.executable, "-c", _TWINS_RUN], capture_output=True, text=True,
        env=_env(), cwd=ROOT, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "quickstart OK" in out.stdout and "twins isolated" in out.stdout


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        HostEngine(fib.PROGRAM, capacity=1 << 10)
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceEngine(fib.PROGRAM, capacity=1 << 10, megakernel=True)


def test_auto_dispatch_is_refused():
    """dispatch="auto" runs (the controller's per-epoch pick, each of the
    three modes bit-identical); what stays refused is a mode outside the
    three, and compacted on a resident loop."""
    from repro_torch.control import DispatchController

    eng = HostEngine(fib.PROGRAM, capacity=1 << 8, dispatch="auto",
                     device="cpu")
    _, value, stats = eng.run(fib.initial(10))
    assert int(value[0, 0]) == fib.fib_reference(10)
    assert sum(eng.controller.decisions.values()) == stats.epochs
    with pytest.raises(ValueError, match="auto"):
        DispatchController(modes=("masked", "eager"))
    with pytest.raises(ValueError, match="compacted"):
        DeviceEngine(fib.PROGRAM, dispatch="compacted", device="cpu")


def _no_result(proc) -> None:
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _no_result(subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
        text=True, env=_env(), cwd=ROOT, timeout=300,
    ))


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    _no_result(subprocess.run(
        [sys.executable, "chip_smoke.py"], capture_output=True, text=True,
        env=env, cwd=tmp_path, timeout=300,
    ))
