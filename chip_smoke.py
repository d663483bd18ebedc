#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; there is no CPU fallback):
  1. build   — compile the CUDA kernels from src/repro_torch/kernels/csrc
               with nvcc into src/repro_torch/kernels/build/ (ptxas report);
  2. kernels — hold each kernel (fork_scan, type_rank, and lane_pack on top
               of type_rank) against its plain PyTorch version on the card,
               exactly, at every listed length; time kernel, plain version
               and the library call at the main path's widest shape;
  3. path    — drive the port's HostEngine on CUDA at full size (fib(28),
               bfs on 2^17 vertices, mergesort of 2^18 floats) under the
               masked, compacted and gather dispatches; check results
               against the numpy references, the dispatches against each
               other, the masked CUDA run against a masked CPU run, and
               that the kernels' launch counters grew during the phase;
  4. profile — one masked fib(28) run under torch.profiler: device busy
               time, its share of the wall time, the top device ops.
Then it prints the card's name and power limit, one JSON line describing
each kernel, and, last, ``{"ok": true, "device": {...}}``.
It imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
CUDA_CORE_OPS_PER_S = 67e12  # H100 SXM non-tensor float32 rate (int32 alike)
LENGTHS = (1, 1000, 1024, 1025, 2**16 + 3, 2**21)
WIDE = 2**21  # the main path's widest fork_scan / type_rank shape


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def _events_ms(run, n: int) -> float:
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    run()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def call_ms(fn, iters: int = 50) -> float:
    """Time of one eager ``fn()`` call back to back (CUDA events): the
    device time or the host's launch overhead, whichever is longer."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()
    return _events_ms(run, iters)


def cuda_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Device time of one ``fn()``: ``iters`` calls captured in one CUDA
    graph, replayed ``reps`` times and timed with CUDA events, so the
    host's launch overhead is not counted.  Inputs stay in L2 between
    calls, as they do on the path (the engine has just written them)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            graph.replay()
    return _events_ms(run, iters * reps)


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / CUDA_CORE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- phase 1
def phase_build():
    from repro_torch.kernels import fork_compact

    ver = subprocess.run([fork_compact.nvcc_path(), "--version"],
                         capture_output=True, text=True, check=True)
    print("[build] nvcc:", ver.stdout.strip().splitlines()[-1])
    t0 = time.perf_counter()
    path, log = fork_compact.build(ptxas_info=True)
    dt = time.perf_counter() - t0
    for line in log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("[build]", line.strip())
    print(f"[build] {path.name} built in {dt:.2f} s")


# ---------------------------------------------------------------- phase 2
def phase_kernels(dev):
    from repro_torch.kernels import fork_compact, ops, ref

    rng = np.random.RandomState(0)
    err = {"fork_scan": 0, "type_rank": 0}

    def check_equal(name, got, want, what):
        got, want = [t.to(torch.int64).cpu() for t in (got, want)]
        if got.shape != want.shape:
            fail(f"{name} {what}: shape {tuple(got.shape)} != "
                 f"{tuple(want.shape)}")
        if got.numel():
            d = int((got - want).abs().max())
            err[name] = max(err[name], d)
            if d != 0:
                fail(f"{name} {what}: max |kernel - plain| = {d}")

    for P in LENGTHS:
        counts = torch.as_tensor(rng.randint(0, 4, P).astype(np.int32),
                                 device=dev)
        offs, total = fork_compact.fork_scan(counts)
        r_offs, r_total = ref.fork_scan_ref(counts)
        check_equal("fork_scan", offs, r_offs, f"P={P} offsets")
        check_equal("fork_scan", total, r_total, f"P={P} total")
        for n_types in (1, 2, 4):
            types = torch.as_tensor(
                rng.randint(0, n_types, P).astype(np.int32), device=dev)
            for kind in ("random", "none", "all"):
                act_np = {"random": rng.rand(P) < 0.6,
                          "none": np.zeros(P, bool),
                          "all": np.ones(P, bool)}[kind]
                active = torch.as_tensor(act_np, device=dev)
                rank, cnt = fork_compact.type_rank(types, active, n_types)
                r_rank, r_cnt = ref.type_rank_ref(types, active, n_types)
                what = f"P={P} n_types={n_types} {kind}"
                check_equal("type_rank", rank, r_rank, what + " rank")
                check_equal("type_rank", cnt, r_cnt, what + " counts")
        active = torch.as_tensor(rng.rand(P) < 0.5, device=dev)
        perm, n = ops.lane_pack(active)
        r_perm, r_n = ref.lane_pack_ref(active)
        check_equal("type_rank", perm, r_perm, f"P={P} lane_pack perm")
        check_equal("type_rank", n, r_n, f"P={P} lane_pack count")
    torch.cuda.synchronize()
    print(f"[kernels] exact at P in {list(LENGTHS)}: fork_scan, "
          f"type_rank (n_types 1/2/4; random/none/all masks), lane_pack")

    # timing at the main path's widest shape
    counts = torch.as_tensor(rng.randint(0, 3, WIDE).astype(np.int32),
                             device=dev)
    types = torch.as_tensor(rng.randint(0, 2, WIDE).astype(np.int32),
                            device=dev)
    active = torch.as_tensor(rng.rand(WIDE) < 0.6, device=dev)

    def timed(kernel, plain, library):
        t = {"ms": cuda_ms(kernel), "call_ms": call_ms(kernel),
             "plain_ms": cuda_ms(plain), "library_ms": None}
        if library is not None:
            t["library_ms"] = cuda_ms(library)
        return t

    rows = []
    b, by = bound_ms(8 * WIDE + 4, WIDE)
    rows.append(dict(
        name="fork_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/fork_compact.cu",
        replaces="src/repro/kernels/fork_compact.py:51",
        max_abs_err=err["fork_scan"], bound_ms=b, bound_by=by,
        **timed(lambda: fork_compact.fork_scan(counts),
                lambda: ref.fork_scan_ref(counts),
                lambda: torch.cumsum(counts, 0, dtype=torch.int32) - counts),
    ))
    b, by = bound_ms(9 * WIDE + 4 * 2, 2 * WIDE)
    rows.append(dict(
        name="type_rank", route="cuda",
        source="src/repro_torch/kernels/csrc/fork_compact.cu",
        replaces="src/repro/kernels/fork_compact.py:195",
        max_abs_err=err["type_rank"], bound_ms=b, bound_by=by,
        **timed(lambda: fork_compact.type_rank(types, active, 2),
                lambda: ref.type_rank_ref(types, active, 2), None),
    ))
    for r in rows:
        print(f"[kernels] {r['name']} P=2^21: device {r['ms']:.5f} ms "
              f"(eager call {r['call_ms']:.5f} ms), bound "
              f"{r['bound_ms']:.5f} ms ({r['bound_by']}), plain "
              f"{r['plain_ms']:.5f} ms, library {r['library_ms']}")
    return rows


# ---------------------------------------------------------------- phase 3
INVARIANT = ("epochs", "tasks_executed", "total_forks", "peak_tv_slots",
             "map_launches", "map_elements", "map_lanes_launched",
             "ranges_coalesced")


def _run(case, dispatch, device):
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    heap, value, stats = case.run(dispatch=dispatch, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    heap = {k: v.cpu().numpy() for k, v in heap.items()}
    value = value.cpu().numpy()
    print(f"[path] {case.name:9s} {dispatch:9s} {device:4s} "
          f"capacity={case.capacity} epochs={stats.epochs} "
          f"tasks={stats.tasks_executed} peak_tv_slots={stats.peak_tv_slots}"
          f" wall_ms={wall * 1e3:.1f} "
          f"us_per_task={wall * 1e6 / max(1, stats.tasks_executed):.3f}")
    return heap, value, stats


def _same(a, b, what):
    ha, va, sa = a
    hb, vb, sb = b
    if not np.array_equal(va, vb):
        fail(f"{what}: TV values differ")
    for k in ha:
        if not np.array_equal(ha[k], hb[k]):
            fail(f"{what}: heap[{k!r}] differs")
    da, db = sa.as_dict(), sb.as_dict()
    for k in INVARIANT:
        if da[k] != db[k]:
            fail(f"{what}: stats[{k!r}] {da[k]} != {db[k]}")


def path_cases():
    from repro_torch.apps import bfs, fib, mergesort
    from repro_torch.apps.registry import AppCase

    n_bfs = 2**17
    adj_off, adj = bfs.random_graph(n_bfs, avg_degree=4, seed=0)
    n_ms = 2**18
    inp = mergesort.random_input(n_ms, seed=0)
    return [
        (AppCase("fib", fib.PROGRAM, fib.initial(28), capacity=2**21),
         lambda h, v: int(v[0, 0]) == fib.fib_reference(28)),
        (AppCase("bfs", bfs.make_program(n_bfs, len(adj)), bfs.initial(0),
                 bfs.heap_init(adj_off, adj, n_bfs), capacity=2**22),
         lambda h, v: np.array_equal(
             h["dist"], bfs.bfs_reference(adj_off, adj, 0, n_bfs))),
        (AppCase("mergesort", mergesort.make_program(n_ms),
                 mergesort.initial(n_ms), dict(inp=inp), capacity=2**20),
         lambda h, v: np.array_equal(h["src"][:n_ms], np.sort(inp))),
    ]


def phase_path():
    from repro_torch.apps import fib
    from repro_torch.apps.registry import AppCase
    from repro_torch.kernels import fork_compact

    cases = path_cases()
    # one small run so CUDA start-up is not charged to the first timed run
    AppCase("fib", fib.PROGRAM, fib.initial(10), capacity=2**10).run(
        device="cuda")
    torch.cuda.synchronize()
    fork_compact.reset_launches()
    runs = {}
    for case, correct in cases:
        for d in ("masked", "compacted", "gather"):
            runs[case.name, d] = r = _run(case, d, "cuda")
            if not correct(r[0], r[1]):
                fail(f"{case.name} {d}: result differs from the reference")
            _same(runs[case.name, "masked"], r, f"{case.name} {d} vs masked")
    torch.cuda.synchronize()
    launches = dict(fork_compact.LAUNCHES)
    print(f"[path] kernel launches during the path phase: {launches}")
    for k, n in launches.items():
        if n <= 0:
            fail(f"kernel {k} was not launched on the main path")
    for case, _ in cases:
        cpu = _run(case, "masked", "cpu")
        gpu = runs[case.name, "masked"]
        if gpu[2].as_dict() != cpu[2].as_dict():
            fail(f"{case.name}: CUDA stats differ from the CPU run")
        _same(gpu, cpu, f"{case.name} masked cuda vs cpu")
    print("[path] all runs match their references, each other and the CPU")
    return launches, cases


# ---------------------------------------------------------------- phase 4
def phase_profile(case):
    """Where the time goes: one masked run under ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, stats = case.run(dispatch="masked", device="cuda")
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only (kernels, memcpy, memset): the host ops that
    # launched them carry the same time and would count it twice
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in events)
    if busy_us <= 0:
        fail("the profiler saw no device time")
    n_kernels = sum(e.count for e in events)
    print(f"[profile] {case.name} masked (profiled): wall {wall_us:.0f} us, "
          f"device busy {busy_us:.0f} us ({100 * busy_us / wall_us:.1f}%), "
          f"{n_kernels} device ops, "
          f"{n_kernels / stats.epochs:.0f} per epoch")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"[profile]   {e.self_device_time_total:10.0f} us "
              f"x{e.count:<6d} {e.key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print("[env]", sys.version.split()[0], "torch", torch.__version__,
          "cuda", torch.version.cuda, torch.cuda.get_device_name(0))
    phase_build()
    rows = phase_kernels(dev)
    launches, cases = phase_path()
    phase_profile(cases[0][0])
    for r in rows:
        r["launches"] = launches[r["name"]]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    print(smi.stdout.strip())
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
