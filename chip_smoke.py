#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; there is no CPU fallback):
  1. build    — compile the CUDA kernels from src/repro_torch/kernels/csrc
                (fork_compact.cu, epoch_megakernel.cu, ordered_add.cu,
                flash_attention.cu, decode_attention.cu, ssd_scan.cu: one
                nvcc each, in parallel, each timed) into
                src/repro_torch/kernels/build/ (ptxas report: each
                kernel's registers, spills and shared memory, one
                epoch_chunk instantiation per device table);
  2. kernels  — hold each kernel against its plain PyTorch version on the
                card, exactly: fork_scan, type_rank and type_pack (1 to
                24 types) and lane_pack at every listed length; the three
                type entries also either side of their 2048-lane tiles at
                7, 32 and 33 types, random, no and all lanes active, on
                views 4 (types) and 1 (active) bytes off, and in every call
                of their timing graphs (type_rank at 2^21 lanes, the packs
                there and at the mixed4 wave's 2^23 lanes and 7 types),
                each entry's device operations counted by torch.profiler
                (a memset and one launch; type_pack two); fork_scan also either
                side of its 4096-lane tiles, on views 4 bytes off, and in
                every call of the CUDA graph that times it, after the
                replays; segmented_fork_scan at
                every listed length, either side of its 2048-lane tiles
                and at 2^23 for 1, 3, 4, 8, 32 and 33 segments, shuffled
                and out-of-range ids, and in every call of its timing
                graph; epoch_chunk against epoch_chunk_ref from
                the same fresh carry, every carry tensor, for all eleven
                programs: fib, bfs and mergesort (phase 3's cases),
                treewalk post- and pre-order (phase 7's tree), sssp,
                nqueens(12), tsp(10), naive mergesort of 2^10, fft of
                2^18, matmul 512 x 512 in blocks of 16 and annealing of 16
                bits x 256 chains x 200 steps (phase 3b's cases) at full
                size and at the registry's small size, masked and gather,
                in chunks of K = 1, 4 and unbounded against one plain run
                each, then its cooperative grid, the cost of one grid
                barrier (an empty cooperative kernel of 2000 barriers),
                and each full-size masked chunk and fib's gather chunk
                timed beside its bytes bound, its barrier floor (the
                barriers it crossed x that cost) and its narrow and wide
                epochs; the fleet epoch_chunk (a JobArena carry of J
                regions, each through its tenant's table) against the
                plain resident fleet loop, every carry tensor, on the
                full-size mixed4 wave (phase 7's) and the registry's
                mixed4 and fib_fleet, masked and gather, K = 1, 4 and
                unbounded, the full-size chunk timed beside its bytes
                bound, its grid barriers and the plain fleet loop's wall;
                ordered_add against ordered_add_ref at matmul's
                payload (2^23 terms, 32 a cell over 2^18 cells, in a
                random order), exactly, timed beside its plain version,
                one stable torch.sort of the indices and index_add_ (which
                adds the same terms atomically, in no fixed order: a
                yardstick, not the same function);
                flash_attention against mha_ref at the prefill shape
                (16 x 32 q heads x 1024, 8 kv heads, D = 128, bf16, causal)
                at ragged shapes (q_offset, window, group 1, 4 and yi-34b's
                7, D = 16, lengths off the tile) and at hymba's prefill
                bucket (16 x 25 q heads x 1024 over 5 kv heads, D = 64,
                causal, windows 2048 and 0) in bf16 and float32;
                decode_attention against decode_attention_ref at 16 x 32 q
                heads over a 2048-row cache with lengths 1, S - 1, S and
                above S, with and without a window, at hymba's group of 5
                (16 x 25 q heads over 5 kv heads, D = 64, windows 2048 and
                0), at yi-34b's group 7 (56 q heads over 8) and at D = 16;
                tolerance 1e-5 (float32) and 2e-2 (bf16) of max(1, max
                |plain|); ssd_scan against ssd_chunked at the mamba2
                prefill bucket (16 x 1024, 64 heads, P = 64, N = 128, bf16,
                x, B and C strided as the block hands them), hymba's 50
                heads with N = 16, and S in {1, 65, 1000, 8192} with and
                without h0 in float32 and bf16, plus a sequence split in
                two with the state carried across; tolerance 1e-4
                (float32) and 2e-2 (bf16) of max(1, max |plain|); time
                each kernel (ssd_scan at the mamba2 and hymba buckets, its
                CUDA-core design beside it), its plain version and the
                library call
                (decode over copies of its caches that keep them cold in
                L2, as on the path, and warm beside it);
  3. path     — drive the port's HostEngine on CUDA at full size (fib(28),
                bfs on 2^17 vertices, mergesort of 2^18 floats) under the
                masked, compacted and gather dispatches; check results
                against the numpy references, the dispatches against each
                other, the masked CUDA run against a masked CPU run, and
                that fork_scan and type_rank were launched during the phase;
  3b. apps    — the six remaining paper apps and naive mergesort at full
                size (sssp on phase 3's graph with random_weights(seed=1),
                nqueens(12), tsp(10), fft of 2^18 points, matmul 512 x 512
                in blocks of 16, annealing of 16 bits x 256 chains x 200
                steps, naive mergesort of 2^10): HostEngine masked,
                compacted and gather, the plain resident DeviceEngine
                masked and gather and DeviceEngine(megakernel=True) masked
                and gather on CUDA, each megakernel wall printed beside
                the plain resident one (treewalk in both orders on phase
                7's tree too); check each against its reference
                (Dijkstra, the solution count, brute force, np.fft within
                a relative L2 error of 1e-4, A @ B in float64 within 1e-5
                of its largest value, the brute-force optimum as a floor,
                np.sort), every run against the masked one (heaps, values,
                the shared RunStats), the masked run against the CPU's
                (exactly; fft's heap within 1e-5 of its largest value), each
                capacity against the smallest power of two that fits, and
                that fork_scan, type_rank, ordered_add (matmul's host and
                plain resident runs) and epoch_chunk were launched during
                the phase; then the paper's yardsticks: bfs and sssp
                against the worklist baselines, naive and map mergesort
                against bitonic_sort, fft (masked and megakernel) against
                torch.fft.fft, nqueens(7)'s V1 / V_inf against the
                sequential oracle;
  4. profile  — one masked fib(28) HostEngine run under torch.profiler:
                device busy time, its share of the wall time, the top ops;
  5. resident — drive DeviceEngine(megakernel=True) on CUDA on the same
                three cases under masked and gather; check results against
                the numpy references and the host path's heaps and values,
                that epoch_chunk was launched during the phase, and (after
                it) that RunStats equal a plain resident run on CUDA and
                one on the CPU field for field;
  6. profile  — one DeviceEngine(megakernel=True) masked run of each of
                the three cases under torch.profiler, walls and busy shares
                beside the one-CTA kernel's (phase 5's walls too);
  7. service  — drive JobService(engine="host") on CUDA on the full-size
                mixed4 wave (phase 3's fib, bfs and mergesort cases plus
                treewalk post-order on random_tree(2^16, seed=11)) under
                masked, compacted and gather; check each tenant against its
                solo HostEngine run on the card and its numpy reference, the
                dispatches against each other, and that segmented_fork_scan
                and type_rank (the compacted and gather waves' packs) were
                launched during the phase; then JobService(engine=
                "device") on the same wave: the plain resident fleet loop
                at K=4 and the fleet epoch_chunk at K = 1, 4 and unbounded,
                masked and gather, each tenant against its solo run and the
                host wave's tenant, global epochs, dispatches and walls
                beside the host wave's, and epoch_chunk launched; then
                streaming admission (six fib jobs into four regions) and
                one preempt/resume of a bfs tenant at a medium size, on the
                host engine and on the device engine's epoch_chunk at K=4,
                and one masked host wave and one unbounded device wave under
                torch.profiler;
  8. serve    — drive EpochServer on granite-3-8b at full width and depth
                (40 layers, bf16, random weights from seed 0) with 16 slots
                of 2048 rows: 48 requests, prompts of 64-1024 tokens, 32-128
                new tokens each; check every output, finite logits, the
                epoch count the host bookkeeping predicts, and that
                flash_attention, decode_attention and fork_scan were
                launched during the run; then the same model at 2 layers in
                float32 on the card and on the CPU from the same weights
                (equal tokens, first decode epoch's logits within 1e-3), one
                decode epoch under torch.profiler (device ms per epoch,
                decode_attention's share) and one full-bucket prefill (16 x
                1024 tokens; flash_attention's share);
  9. ssm      — drive EpochServer on mamba2-1.3b at full width and depth
                (48 layers, bf16, random weights from seed 0) with phase
                8's slots and request mix; check every output, finite
                logits, the predicted epochs, ssd_scan launched once per
                layer of every prefill, fork_scan once per prefill and no
                attention kernel; one decode epoch and one full-bucket
                prefill (16 x 1024 tokens; ssd_scan's share) under
                torch.profiler; the same model at 2 layers in float32 on the card and on
                the CPU (equal tokens, first decode epoch's logits within
                1e-3); then hymba-1.5b (attention ∥ SSM, 32 layers) at full
                width and depth on 16 requests, flash_attention and
                ssd_scan once per layer of every prefill, decode_attention
                once per layer of every epoch.
Then it prints the card's name and power limit, one JSON line describing
each kernel (with its design), and, last, ``{"ok": true, "device":
{...}}``.
It imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import json
import os
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
CUDA_CORE_OPS_PER_S = 67e12  # H100 SXM non-tensor float32 rate (int32 alike)
TENSOR_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
LENGTHS = (1, 1000, 1024, 1025, 2**16 + 3, 2**21)
# fork_scan's tiles are 4096 lanes: either side of one and two boundaries,
# and the widest main-path shape with a ragged tail
SCAN_LENGTHS = (4095, 4096, 4097, 8191, 8193, 2**21 + 5)
# segmented_fork_scan's are 2048 lanes
SEG_LENGTHS = (2047, 2048, 2049, 4095, 4096, 4097)
WIDE = 2**21  # the main path's widest fork_scan / type_rank shape
FLEET_WIDE = 2**23  # the full-size mixed4 wave's epoch bucket
N_SEGS = (1, 3, 4, 8, 32, 33)  # 32: one group of the single pass; 33: two
N_TYPES = (1, 2, 4, 8, 9, 24)
# type_rank's tiles are 2048 lanes and its groups 32 types: either side of
# one and two tiles, at the mixed4 fleet's 7 types, one group and two
TYPE_LENGTHS = (2047, 2048, 2049, 4095, 4096, 4097)
TYPE_GROUPS = (7, 32, 33)
FLEET_TYPES = 7  # the mixed4 wave's task types
# device operations each type entry may take: a memset and one launch
# (type_pack: and its scatter launch)
TYPE_DEVICE_OPS = {"type_rank": 2, "lane_pack": 2, "type_pack": 3}
# phase 7: the treewalk tenant's tree, and the medium streaming and
# preemption runs (fib sizes and their region quota, bfs vertices)
SERVICE_TREE = 2**16
MEDIUM_QUOTA = 2**18
MEDIUM_FIBS = (24, 20, 21, 24, 24, 23)
MEDIUM_BFS = 2**15
# phases 5-6 with the one-CTA epoch_chunk that preceded the cooperative
# grid (this script on an NVIDIA H100 80GB HBM3 at 700.00 W), printed
# beside this run's
ONE_CTA_RESIDENT_WALL_MS = {
    ("fib", "masked"): 8.8, ("fib", "gather"): 7.9,
    ("bfs", "masked"): 22.5, ("bfs", "gather"): 21.1,
    ("mergesort", "masked"): 28.0, ("mergesort", "gather"): 27.7,
}
ONE_CTA_RESIDENT_BUSY = {"fib": "54.6% of 11069 us"}


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


def cuda_ms(fn, iters: int = 20, reps: int = 5, check=None) -> float:
    """Device time of one ``fn()``: ``iters`` calls captured in one CUDA
    graph, replayed ``reps`` times and timed with CUDA events, so the
    host's launch overhead is not counted.  Inputs stay in L2 between
    calls, as they do on the path (the engine has just written them).
    ``check``, if given, receives the captured calls' results after the
    last replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fn() for _ in range(iters)]
    graph.replay()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            graph.replay()
    ms = _events_ms(run, iters * reps)
    if check is not None:
        check(outs)
    return ms


def bound_ms(n_bytes: float, n_ops: float,
             ops_per_s: float = CUDA_CORE_OPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- phase 1
def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import (
        decode_attention, epoch_megakernel, flash_attention, fork_compact,
        nvcc, ordered_add, ssd_scan,
    )

    ver = subprocess.run([nvcc.nvcc_path(), "--version"],
                         capture_output=True, text=True, check=True)
    print("[build] nvcc:", ver.stdout.strip().splitlines()[-1])
    t0 = time.perf_counter()
    mods = (fork_compact, epoch_megakernel, ordered_add, flash_attention,
            decode_attention, ssd_scan)

    def timed_build(m):
        t = time.perf_counter()
        path, log = m.build(ptxas_info=True)
        return path, log, time.perf_counter() - t

    with ThreadPoolExecutor(len(mods)) as pool:
        built = list(pool.map(timed_build, mods))
    dt = time.perf_counter() - t0
    for path, log, secs in built:
        print(f"[build] {path.name} in {secs:.2f} s")
        for name, info in ptxas_kernels(log):
            print(f"[build]   {name}: {info}")
    print(f"[build] {len(mods)} libraries built in {dt:.2f} s (in parallel)")


def ptxas_kernels(log: str):
    """(kernel, "N registers, spills ..., smem ...") for each entry
    function of a ``ptxas -v`` report, names demangled where ``c++filt``
    is found."""
    import re
    import shutil

    entries, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill = m.group(1), ""
        elif name and "spill" in line:
            spill = line.split(",", 1)[-1].strip()
        elif name and "registers" in line:
            used = line.split("Used", 1)[-1].strip()
            entries.append([name, f"{used}; {spill}"])
            name = None
    if entries and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(
            e[0] for e in entries), capture_output=True, text=True).stdout
        for e, d in zip(entries, out.splitlines()):
            e[0] = re.sub(r"^void |\(anonymous namespace\)::|\(.*", "",
                          d)
    return entries


# ---------------------------------------------------------------- phase 2
def device_ops(fn):
    """Names of the device operations (kernels, memsets, copies) one
    ``fn()`` call puts on the card, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def phase_kernels(dev):
    from repro_torch.kernels import fork_compact, ops, ref

    rng = np.random.RandomState(0)
    err = {"fork_scan": 0, "type_rank": 0, "segmented_fork_scan": 0}

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

    def check_types(types, active, n_types, what, packs=True):
        """type_rank, type_pack and (``packs``) lane_pack against their
        plain versions (the three entries of the type_rank kernel)."""
        rank, cnt = fork_compact.type_rank(types, active, n_types)
        r_rank, r_cnt = ref.type_rank_ref(types, active, n_types)
        check_equal("type_rank", rank, r_rank, what + " rank")
        check_equal("type_rank", cnt, r_cnt, what + " counts")
        perm, cnt = fork_compact.type_pack(types, active, n_types)
        r_perm, r_cnt = ref.type_pack_ref(types, active, n_types)
        check_equal("type_rank", perm, r_perm, what + " type_pack perm")
        check_equal("type_rank", cnt, r_cnt, what + " type_pack counts")
        if packs:
            perm, n = ops.lane_pack(active)
            r_perm, r_n = ref.lane_pack_ref(active)
            check_equal("type_rank", perm, r_perm, what + " lane_pack perm")
            check_equal("type_rank", n, r_n, what + " lane_pack count")

    def mask(kind, P):
        return {"random": rng.rand(P) < 0.6, "none": np.zeros(P, bool),
                "all": np.ones(P, bool)}[kind]

    for P in LENGTHS:
        counts = torch.as_tensor(rng.randint(0, 4, P).astype(np.int32),
                                 device=dev)
        offs, total = fork_compact.fork_scan(counts)
        r_offs, r_total = ref.fork_scan_ref(counts)
        check_equal("fork_scan", offs, r_offs, f"P={P} offsets")
        check_equal("fork_scan", total, r_total, f"P={P} total")
        for n_types in N_TYPES:
            types = torch.as_tensor(
                rng.randint(0, n_types, P).astype(np.int32), device=dev)
            for kind in ("random", "none", "all"):
                active = torch.as_tensor(mask(kind, P), device=dev)
                check_types(types, active, n_types,
                            f"P={P} n_types={n_types} {kind}",
                            packs=n_types == 1)
    for P in TYPE_LENGTHS:
        for n_types in TYPE_GROUPS:
            for off in (0, 1):  # 1: types 4 bytes, active 1 byte in
                types = torch.as_tensor(
                    rng.randint(0, n_types, P + off).astype(np.int32),
                    device=dev)[off:]
                for kind in ("random", "none", "all"):
                    active = torch.as_tensor(mask(kind, P + off),
                                             device=dev)[off:]
                    check_types(types, active, n_types,
                                f"P={P}+{off} n_types={n_types} {kind}",
                                packs=n_types == TYPE_GROUPS[0])
    for P in LENGTHS + SEG_LENGTHS + (FLEET_WIDE,):
        counts = rng.randint(0, 4, P).astype(np.int32)
        counts[rng.rand(P) < 0.3] = 0
        counts = torch.as_tensor(counts, device=dev)
        for J in N_SEGS:
            for kind, lo, hi in (("shuffled", 0, J), ("out-of-range", -1,
                                                      J + 1)):
                seg = torch.as_tensor(
                    rng.randint(lo, hi, P).astype(np.int32), device=dev)
                offs, tot = fork_compact.segmented_fork_scan(counts, seg, J)
                r_offs, r_tot = ref.segmented_fork_scan_ref(counts, seg, J)
                what = f"P={P} J={J} {kind}"
                check_equal("segmented_fork_scan", offs, r_offs,
                            what + " offsets")
                check_equal("segmented_fork_scan", tot, r_tot,
                            what + " totals")
    for P in SCAN_LENGTHS:
        for offset in (0, 1):  # 1: a view 4 bytes into its storage
            counts = torch.as_tensor(
                rng.randint(0, 4, P + offset).astype(np.int32),
                device=dev)[offset:]
            offs, total = fork_compact.fork_scan(counts)
            r_offs, r_total = ref.fork_scan_ref(counts)
            check_equal("fork_scan", offs, r_offs, f"P={P}+{offset} offsets")
            check_equal("fork_scan", total, r_total, f"P={P}+{offset} total")
    torch.cuda.synchronize()
    print(f"[kernels] fork_scan exact at P in {list(SCAN_LENGTHS)}, aligned "
          "and 4 bytes off")
    print(f"[kernels] type_rank, type_pack and lane_pack exact at P in "
          f"{list(TYPE_LENGTHS)} for n_types {'/'.join(map(str, TYPE_GROUPS))}"
          ", random/none/all masks, aligned and on views 4 (types) and 1 "
          "(active) bytes off")
    print(f"[kernels] exact at P in {list(LENGTHS)}: fork_scan, "
          f"type_rank and type_pack (n_types {'/'.join(map(str, N_TYPES))}; "
          f"random/none/all masks), lane_pack; segmented_fork_scan also "
          f"either side of its 2048-lane tiles and at P=2^23 (J "
          f"{'/'.join(map(str, N_SEGS))}; shuffled and out-of-range ids)")

    # timing at the main path's widest shape
    counts = torch.as_tensor(rng.randint(0, 3, WIDE).astype(np.int32),
                             device=dev)
    types = torch.as_tensor(rng.randint(0, 2, WIDE).astype(np.int32),
                            device=dev)
    active = torch.as_tensor(rng.rand(WIDE) < 0.6, device=dev)

    def timed(kernel, plain, library, check=None):
        t = {"ms": cuda_ms(kernel, check=check), "call_ms": call_ms(kernel),
             "plain_ms": cuda_ms(plain), "library_ms": None}
        if library is not None:
            t["library_ms"] = cuda_ms(library)
        return t

    r_offs, r_total = ref.fork_scan_ref(counts)

    def replayed(outs):
        """Every call of the timed graph exact after its last replay (the
        scratch's status words are cleared by each call, not left over)."""
        for i, (offs, total) in enumerate(outs):
            check_equal("fork_scan", offs, r_offs, f"graph call {i} offsets")
            check_equal("fork_scan", total, r_total, f"graph call {i} total")

    rows = []
    b, by = bound_ms(8 * WIDE + 4, WIDE)
    rows.append(dict(
        name="fork_scan", route="cuda",
        design="single pass, decoupled look-back: a memset of the status "
               "words and one launch, 4096-lane tiles from an atomic counter",
        source="src/repro_torch/kernels/csrc/fork_compact.cu",
        replaces="src/repro/kernels/fork_compact.py:51",
        max_abs_err=err["fork_scan"], bound_ms=b, bound_by=by,
        **timed(lambda: fork_compact.fork_scan(counts),
                lambda: ref.fork_scan_ref(counts),
                lambda: torch.cumsum(counts, 0, dtype=torch.int32) - counts,
                check=replayed),
    ))
    # yardsticks: one pass that reads and writes the lanes, and clearing a
    # scratch of the look-back's size (its tile counter and status words)
    copy_out = torch.empty_like(counts)
    rows[0]["copy_ms"] = cuda_ms(lambda: copy_out.copy_(counts))
    words = fork_compact._load().trees_fork_scan_scratch_words(WIDE)
    scratch = torch.empty((words,), dtype=torch.int64, device=dev)
    rows[0]["clear_ms"] = cuda_ms(lambda: scratch.zero_())
    print(f"[kernels] fork_scan exact in all 20 calls of its timing graph "
          f"after 5 replays; a plain copy of its input takes "
          f"{rows[0]['copy_ms']:.5f} ms, clearing its {8 * words}-byte "
          f"scratch {rows[0]['clear_ms']:.5f} ms")
    def types_replayed(entry, want):
        def check(outs):
            for i, got in enumerate(outs):
                for part, a, b in zip(("first", "second"), got, want):
                    check_equal("type_rank", a, b,
                                f"{entry} graph call {i} {part} output")
        return check

    r_rank = ref.type_rank_ref(types, active, 2)
    b, by = bound_ms(9 * WIDE + 4 * 2, 2 * WIDE)
    rows.append(dict(
        name="type_rank", route="cuda",
        design="single pass, decoupled look-back: one memset (scratch and "
               "counts) and one launch, 2048-lane tiles from an atomic "
               "counter, 16 lanes a thread in 16-byte vectors, one status "
               "word per (tile, type), groups of 32 types; lane_pack (one "
               "type, active alone) and type_pack (a count pass and a "
               "scatter pass) write their packs from it",
        source="src/repro_torch/kernels/csrc/fork_compact.cu",
        replaces="src/repro/kernels/fork_compact.py:195",
        max_abs_err=err["type_rank"], bound_ms=b, bound_by=by,
        **timed(lambda: fork_compact.type_rank(types, active, 2),
                lambda: ref.type_rank_ref(types, active, 2), None,
                check=types_replayed("type_rank", r_rank)),
    ))
    # the packs, at the host path's widest shape (2 types) and the mixed4
    # wave's epoch bucket (7 types); the library yardstick is a stable sort
    # by (type, inactive last), which orders the active lanes as the pack
    # does but keeps the inactive lanes in the tail where the pack has -1
    packs = []
    for P, n_types in ((WIDE, 2), (FLEET_WIDE, FLEET_TYPES)):
        if P == WIDE:
            p_types, p_active = types, active
        else:
            p_types = torch.as_tensor(
                rng.randint(0, n_types, P).astype(np.int32), device=dev)
            p_active = torch.as_tensor(rng.rand(P) < 0.6, device=dev)
        key = torch.where(p_active, p_types, n_types)
        inactive = (~p_active).to(torch.uint8)
        for entry, per_lane, kernel, plain, library in (
            ("lane_pack", 5,
             lambda a=p_active: fork_compact.lane_pack(a),
             lambda a=p_active: ref.lane_pack_ref(a),
             lambda k=inactive: torch.sort(k, stable=True)),
            ("type_pack", 9,
             lambda t=p_types, a=p_active, k=n_types:
                 fork_compact.type_pack(t, a, k),
             lambda t=p_types, a=p_active, k=n_types:
                 ref.type_pack_ref(t, a, k),
             lambda k=key: torch.sort(k, stable=True)),
        ):
            b, by = bound_ms(per_lane * P + 4 * n_types, 2 * P)
            packs.append(dict(
                entry=entry, P=P, n_types=n_types, bound_ms=b, bound_by=by,
                **timed(kernel, plain, library,
                        check=types_replayed(entry, plain())),
            ))
    rows[-1]["packs"] = packs
    rows[-1]["device_ops"] = {}
    for entry, fn in (
            ("type_rank", lambda: fork_compact.type_rank(types, active, 2)),
            ("lane_pack", lambda: fork_compact.lane_pack(active)),
            ("type_pack", lambda: fork_compact.type_pack(types, active, 2))):
        names = device_ops(fn)
        rows[-1]["device_ops"][entry] = len(names)
        print(f"[kernels] {entry}: {len(names)} device operations "
              f"{names}")
        if not 0 < len(names) <= TYPE_DEVICE_OPS[entry]:
            fail(f"{entry} took {len(names)} device operations, at most "
                 f"{TYPE_DEVICE_OPS[entry]} expected")
    print("[kernels] type_rank, lane_pack and type_pack exact in all 20 "
          "calls of each timing graph after 5 replays")
    for pk in packs:
        print(f"[kernels] {pk['entry']} P={pk['P']} n_types={pk['n_types']}"
              f": device {pk['ms']:.5f} ms (eager call {pk['call_ms']:.5f} "
              f"ms), bound {pk['bound_ms']:.5f} ms ({pk['bound_by']}), "
              f"plain {pk['plain_ms']:.5f} ms, stable sort "
              f"{pk['library_ms']:.5f} ms")
    counts = torch.as_tensor(rng.randint(0, 3, FLEET_WIDE).astype(np.int32),
                             device=dev)
    seg = torch.as_tensor(rng.randint(0, 4, FLEET_WIDE).astype(np.int32),
                          device=dev)
    r_seg = ref.segmented_fork_scan_ref(counts, seg, 4)

    def seg_replayed(outs):
        for i, (offs, totals) in enumerate(outs):
            check_equal("segmented_fork_scan", offs, r_seg[0],
                        f"graph call {i} offsets")
            check_equal("segmented_fork_scan", totals, r_seg[1],
                        f"graph call {i} totals")

    b, by = bound_ms(12 * FLEET_WIDE + 4 * 4, FLEET_WIDE)
    rows.append(dict(
        name="segmented_fork_scan", route="cuda",
        design="single pass, decoupled look-back: a memset of the status "
               "words and one launch, 2048-lane tiles from an atomic "
               "counter, one status word per (tile, segment), groups of 32 "
               "segments",
        source="src/repro_torch/kernels/csrc/fork_compact.cu",
        replaces="src/repro/kernels/fork_compact.py:114",
        max_abs_err=err["segmented_fork_scan"], bound_ms=b, bound_by=by,
        **timed(lambda: fork_compact.segmented_fork_scan(counts, seg, 4),
                lambda: ref.segmented_fork_scan_ref(counts, seg, 4), None,
                check=seg_replayed),
    ))
    print("[kernels] segmented_fork_scan exact in all 20 calls of its "
          "timing graph after 5 replays")
    for r in rows:
        wide = "2^23, J=4" if r["name"] == "segmented_fork_scan" else "2^21"
        print(f"[kernels] {r['name']} P={wide}: device {r['ms']:.5f} ms "
              f"(eager call {r['call_ms']:.5f} ms), bound "
              f"{r['bound_ms']:.5f} ms ({r['bound_by']}), plain "
              f"{r['plain_ms']:.5f} ms, library {r['library_ms']}")
    return rows


# ------------------------------------------------------- phase 2, epoch_chunk
def _carry_tensors(carry):
    out = {}
    for f in dataclasses.fields(carry):
        v = getattr(carry, f.name)
        if dataclasses.is_dataclass(v):  # the TVM state, a fleet's arena
            for g in dataclasses.fields(v):
                out[f"{f.name}.{g.name}"] = getattr(v, g.name)
        elif f.name == "heap":
            for k, t in v.items():
                out["heap." + k] = t
        elif v is not None:
            out[f.name] = v
    return out


def carry_err(a, b, what) -> float:
    """Max |a - b| over every carry tensor (shapes and dtypes must agree)."""
    ta, tb = _carry_tensors(a), _carry_tensors(b)
    if ta.keys() != tb.keys():
        fail(f"{what}: carries hold different fields")
    err = 0.0
    for k in ta:
        x, y = ta[k], tb[k]
        if x.dtype != y.dtype or x.shape != y.shape:
            fail(f"{what}: {k} is {x.dtype}{tuple(x.shape)} vs "
                 f"{y.dtype}{tuple(y.shape)}")
        if x.numel():
            wide = torch.float64 if x.is_floating_point() else torch.int64
            err = max(err, float((x.to(wide) - y.to(wide)).abs().max()))
    return err


def run_chunks(eng, carry, K, max_epochs=1 << 16):
    """Chunks of K epochs (K=None: one unbounded chunk) until the carry
    drains; returns (carry, last ChunkSummary, readbacks)."""
    reads = 0
    while True:
        limit = max_epochs if K is None else min(
            max_epochs, int(carry.n_epochs) + K)
        carry = eng.loop.run_chunk(carry, limit, 1)
        s = eng.loop.chunk_summary(carry)
        reads += 1
        if not (s.sp > 0).any() or s.n_epochs >= max_epochs:
            return carry, s, reads


def _chunk_bound(program, stats):
    """Least bytes a chunk must move, from its RunStats: every task's TV
    row read and every fork's row written once, the heap once, and each
    live map element's 4-byte read and 4-byte write (bound_by the
    operations only if one operation per task outweighs that)."""
    # task, epoch, child_base, child_count, the args and the value
    row = 4 * (4 + program.n_arg_i + program.n_arg_f + program.value_width)
    heap = sum(4 * hv.shape[0] for hv in program.heap)
    n_bytes = ((stats.tasks_executed + stats.total_forks) * row + heap
               + 8 * stats.map_elements)
    return bound_ms(n_bytes, stats.tasks_executed)


def _fleet_bound(mux, s):
    """Least bytes a fleet chunk must move, region by region, from its
    ChunkSummary: each task reads its tenant's own prefix of its row (the
    kernel reads no padding column), each fork writes a row of the fused
    stride (its padding zeroed, as the plain loop writes it), the heap
    once, 8 bytes a live map element; bound_by the operations only if one
    operation per task outweighs that."""
    fused = mux.program
    fork_row = 4 * (4 + fused.n_arg_i + fused.n_arg_f + fused.value_width)
    n_bytes = (sum(4 * hv.shape[0] for hv in fused.heap)
               + 8 * s.map_elements)
    for slot, tasks, forks in zip(mux.slots, s.job_tasks, s.job_forks):
        sub = slot.program
        row = 4 * (4 + sub.n_arg_i + sub.n_arg_f + sub.value_width)
        n_bytes += int(tasks) * row + int(forks) * fork_row
    return bound_ms(n_bytes, int(s.job_tasks.sum()))


# the programs of epoch_chunk's later device tables, held at the registry's
# size and at full size: phase 3b's cells and treewalk on phase 7's tree
CHUNK_APPS = ("treewalk", "treewalk_pre", "sssp", "nqueens", "tsp", "naive",
              "fft", "matmul", "annealing")


@functools.lru_cache(maxsize=None)
def service_tree():
    """random_tree(SERVICE_TREE, seed=11), generated once for phases 2, 3b
    and 7: (left, right, seconds it took)."""
    from repro_torch.apps import treewalk

    t0 = time.perf_counter()
    left, right = treewalk.random_tree(SERVICE_TREE, seed=11)
    return left, right, time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def tree_case(order):
    """``(AppCase, check)`` of treewalk in ``order`` on the service tree at
    the least power of two at or above its solo peak (a masked HostEngine
    probe at 2^20); ``check(heap, value)`` returns ``(ok, detail)``."""
    from repro_torch.apps import treewalk
    from repro_torch.apps.registry import AppCase

    left, right, gen_s = service_tree()
    n = left.shape[0]
    name = "treewalk" if order == "post" else "treewalk_pre"
    probe = AppCase(name, treewalk.make_program(n, order),
                    treewalk.initial(), dict(left=left, right=right),
                    capacity=2**20)
    peak = _run(probe, "masked", "cuda", tag="tree")[2].peak_tv_slots
    case = dataclasses.replace(probe, capacity=1 << (peak - 1).bit_length())
    print(f"[tree] {name}: random_tree({n}) in {gen_s:.1f} s, solo peak "
          f"{peak} slots, capacity {case.capacity}")
    visit, clock = treewalk.treewalk_reference(left, right, order)

    def check(h, v):
        ok = (np.array_equal(h["visit_epoch"], visit)
              and np.array_equal(h["visit_clock"], clock))
        return ok, f"{order}-order stamps of {n} nodes"
    return case, check


def chunk_case(name, size):
    """The AppCase phase 2 holds epoch_chunk to for a program of
    CHUNK_APPS: ``size`` "full", or "small" (the registry's case; naive
    mergesort at the registry mergesort's n, treewalk_pre on the registry
    treewalk's tree)."""
    from repro_torch.apps import get_case, mergesort, treewalk

    if size == "full":
        if name.startswith("treewalk"):
            return tree_case("pre" if name == "treewalk_pre" else "post")[0]
        return app_case(name, APP_FULL[name])[0]
    if name == "treewalk_pre":
        c = get_case("treewalk")
        return dataclasses.replace(c, name=name, program=treewalk.make_program(
            c.heap_init["left"].shape[0], "pre"))
    if name == "naive":
        c = get_case("mergesort")
        return dataclasses.replace(c, name=name, program=mergesort.make_program(
            c.heap_init["inp"].shape[0], use_map=False))
    return get_case(name)


def phase_chunks(dev):
    """epoch_chunk against epoch_chunk_ref on the card, every carry
    tensor, at full size and the registry's size, K in {1, 4, inf}."""
    from repro_torch.apps import get_case
    from repro_torch.core import DeviceEngine
    from repro_torch.kernels import epoch_megakernel

    err = 0.0
    timing = {}
    sizes = [(c, "full") for c, _ in path_cases()]
    sizes += [(get_case(c.name), "small") for c, _ in path_cases()]
    sizes += [(chunk_case(name, size), size) for size in ("small", "full")
              for name in CHUNK_APPS]
    for case, size in sizes:
        for d in ("masked", "gather"):
            kw = dict(capacity=case.capacity, dispatch=d, device="cuda")
            kern = DeviceEngine(case.program, megakernel=True, **kw)
            plain = DeviceEngine(case.program, **kw)
            fresh = kern.initial_carry(case.initial,
                                       dict(case.heap_init) or None)
            # one plain run: its final carry is the same at every K
            # (tests/test_torch_megakernel.py::
            # test_chunk_cadence_gives_one_carry)
            want, _, _ = run_chunks(plain, fresh.clone(), None)
            for K in (1, 4, None):
                got, s_got, reads = run_chunks(kern, fresh.clone(), K)
                torch.cuda.synchronize()
                if reads != (1 if K is None else -(-s_got.n_epochs // K)):
                    fail(f"epoch_chunk {case.name} {size} {d} K={K}: "
                         f"{reads} readbacks for {s_got.n_epochs} epochs")
                e = carry_err(got, want, f"epoch_chunk {case.name} {size} "
                              f"{d} K={K}")
                err = max(err, e)
                if e != 0 or s_got.sp.any() or s_got.failed.any():
                    fail(f"epoch_chunk {case.name} {size} {d} K={K}: "
                         f"max |kernel - plain| = {e}, sp={s_got.sp}, "
                         f"failed={s_got.failed}")
            print(f"[kernels] epoch_chunk {case.name:12s} {size:5s} {d:6s} "
                  f"capacity={case.capacity} epochs={s_got.n_epochs}: "
                  f"exact at K=1, 4, inf (readbacks = ceil(epochs / K))")
            if size == "full" and (d == "masked" or case.name == "fib"):
                timing[case.name, d] = (case, kern, plain, fresh)
    # the failure paths: forks past the TV, a push onto a full stack
    case = get_case("fib")
    for limits in ({"capacity": 64}, {"stack_depth": 2}):
        for d in ("masked", "gather"):
            kw = dict(capacity=case.capacity, dispatch=d, device="cuda")
            kw.update(limits)
            kern = DeviceEngine(case.program, megakernel=True, **kw)
            plain = DeviceEngine(case.program, **kw)
            fresh = kern.initial_carry(case.initial)
            for K in (1, 4, None):
                got, s_got, _ = run_chunks(kern, fresh.clone(), K)
                want, _, _ = run_chunks(plain, fresh.clone(), K)
                e = carry_err(got, want, f"epoch_chunk fib {limits} {d}")
                err = max(err, e)
                if (e != 0 or not s_got.failed[0] or s_got.sp[0] != 0
                        or s_got.failed_stack[0] != ("stack_depth" in limits)):
                    fail(f"epoch_chunk fib {limits} {d} K={K}: max |kernel "
                         f"- plain| = {e}, summary {s_got}")
        print(f"[kernels] epoch_chunk fib small {limits}: the region fails "
              "as in the plain loop, exact at K=1, 4, inf, masked/gather")

    # the grid, and the barrier's own cost: an empty cooperative kernel of
    # N grid barriers against one of none
    G = epoch_megakernel.grid(0, dev)
    grids = [epoch_megakernel.grid(t.app_id, dev)
             for t in epoch_megakernel.TABLES]
    print(f"[kernels] epoch_chunk grid: {G} CTAs x 1024 threads "
          f"({torch.cuda.get_device_properties(dev).multi_processor_count} "
          f"SMs; cooperative launch); the {len(grids)} tables' grids "
          f"{grids}")
    def bench_ms(n, iters=5):
        epoch_megakernel.grid_sync_bench(n, G, dev)
        torch.cuda.synchronize()
        return _events_ms(lambda: [epoch_megakernel.grid_sync_bench(n, G, dev)
                                   for _ in range(iters)], iters)

    n_bar = 2000
    t_n, t_0 = bench_ms(n_bar), bench_ms(0)
    barrier_us = (t_n - t_0) / n_bar * 1e3
    print(f"[kernels] grid barrier of {G} CTAs: {barrier_us:.3f} us "
          f"({n_bar} barriers {t_n:.4f} ms, none {t_0:.4f} ms)")

    # time each full-size chunk (the whole run in one chunk): fresh clones,
    # CUDA events around the chunk alone, median of 3.  With `device`, the
    # card first sleeps while the host enqueues the chunk (the wrapper's
    # checks and scratch), so the events hold the device's time alone;
    # without, they hold the whole call, the host's part included.
    def chunk_ms(eng, fresh, reps=3, device=True):
        ts = []
        for _ in range(reps):
            c = fresh.clone()
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            if device:
                torch.cuda._sleep(5_000_000)
            a.record()
            out = eng.loop.run_chunk(c, 1 << 16, 1)
            b.record()
            torch.cuda.synchronize()
            ts.append(a.elapsed_time(b))
        return sorted(ts)[len(ts) // 2], out

    row = dict(
        name="epoch_chunk", route="cuda",
        design=f"cooperative grid of {G} CTAs x 1024 threads: each epoch "
               "starts at a grid barrier; a range wider than one CTA splits "
               "into contiguous blocks over the first CTAs (about four group "
               "barriers an epoch), a narrower one runs on CTA 0; a fleet "
               "carry (the job service's) runs fleet_chunk_kernel, each "
               "region through its tenant's table, every CTA in every "
               "epoch (four grid barriers an epoch and more)",
        source="src/repro_torch/kernels/csrc/epoch_megakernel.cu",
        replaces="src/repro/kernels/epoch_megakernel.py:50",
        max_abs_err=err, library_ms=None, grid_ctas=G,
        barrier_us=barrier_us,
    )
    for (name, d), (case, kern, plain, fresh) in timing.items():
        ms, out = chunk_ms(kern, fresh)
        call_ms, _ = chunk_ms(kern, fresh, device=False)
        # the later tables' plain walls are phase 3b's (naive's plain run
        # takes seconds)
        plain_ms = None if name in CHUNK_APPS else chunk_ms(plain, fresh)[0]
        stats = kern.stats(kern.loop.chunk_summary(out))
        b, by = _chunk_bound(case.program, stats)
        st = torch.zeros(len(epoch_megakernel.STATS), dtype=torch.int64,
                         device=dev)
        again = fresh.clone()
        epoch_megakernel.launch(case.program, again, 1 << 16,
                                gather=d == "gather", stats=st)
        if carry_err(again, out, f"epoch_chunk {name} {d} stats run") != 0:
            fail(f"epoch_chunk {name} {d}: the counted run differs")
        st = dict(zip(epoch_megakernel.STATS, st.tolist()))
        n_barriers = st["grid_barriers"] + st["group_barriers"]
        floor = n_barriers * barrier_us * 1e-3
        plain_s = "" if plain_ms is None else f", plain {plain_ms:.3f} ms"
        print(f"[kernels] epoch_chunk {name}({case.capacity}) {d}, one "
              f"chunk: device {ms:.3f} ms (with the host's enqueue "
              f"{call_ms:.3f} ms), bound {b:.5f} ms ({by}), barrier floor "
              f"{floor:.3f} ms{plain_s} ({stats.epochs} epochs, "
              f"{stats.tasks_executed} tasks, {stats.total_forks} forks)")
        print(f"[kernels]   {st['narrow_epochs']} narrow epochs (one CTA), "
              f"{st['wide_epochs']} wide; {st['grid_barriers']} grid "
              f"barriers ({st['search_barriers']} of a deep reclamation "
              f"search) + {st['group_barriers']} group barriers = "
              f"{n_barriers} x {barrier_us:.3f} us")
        if (name, d) == ("fib", "masked"):
            row.update(ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                       bound_ms=b, bound_by=by, floor_ms=floor, stats=st)
        else:
            row[f"{name}_{d}_ms"] = ms
            row[f"{name}_{d}_call_ms"] = call_ms
            row[f"{name}_{d}_bound_ms"] = b
            row[f"{name}_{d}_floor_ms"] = floor
            row[f"{name}_{d}_stats"] = st
    return row


# ------------------------------------------------- phase 2, fleet epoch_chunk
def fleet_mux(members, dispatch, megakernel):
    """A DeviceMultiplexer on the card over ``members`` ((AppCase, quota)
    pairs, in slot order), its carry built."""
    from repro_torch.service import DeviceMultiplexer, Job, JobHandle

    handles = [JobHandle(i, Job(c.program, c.initial, dict(c.heap_init),
                                quota=q, name=c.name))
               for i, (c, q) in enumerate(members)]
    mux = DeviceMultiplexer(handles, dispatch=dispatch, megakernel=megakernel,
                            device="cuda")
    mux._ensure_carry()
    return mux


def run_fleet_chunks(mux, carry, K, max_epochs=1 << 16):
    """Chunks of K epochs (None: one) of a fleet carry through ``mux``'s
    loop until it drains; (carry, last ChunkSummary, readbacks)."""
    J, reads = len(mux.slots), 0
    while True:
        limit = max_epochs if K is None else min(
            max_epochs, int(carry.n_epochs) + K)
        carry = mux.loop.run_chunk(carry, limit, J)
        s = mux.loop.chunk_summary(carry)
        reads += 1
        if not (s.sp > 0).any() or s.n_epochs >= max_epochs:
            return carry, s, reads


def fleet_members(size):
    """The fleets phase 2 holds the fleet kernel to: the full-size mixed4
    wave (phase 7's: phase 3's fib, bfs and mergesort, treewalk post-order
    on phase 7's tree, each at its solo capacity) and the registry's
    mixed4 and fib_fleet at their quotas."""
    from repro_torch.apps import get_fleet

    if size == "full":
        by_name = {c.name: c for c, _ in path_cases()}
        wave = [by_name["fib"], tree_case("post")[0], by_name["bfs"],
                by_name["mergesort"]]
        return [("mixed4", [(c, c.capacity) for c in wave])]
    return [(f, get_fleet(f)) for f in ("mixed4", "fib_fleet")]


def phase_fleet_chunks(dev, row):
    """The fleet epoch_chunk against the plain resident fleet loop on the
    card, every carry tensor: full-size mixed4 and the registry's mixed4
    and fib_fleet, masked and gather, K in {1, 4, inf}; then the full-size
    chunk's device time, barriers and bytes bound, and fib(28) as a
    one-region fleet against the solo kernel.  Adds to ``row``."""
    from repro_torch.kernels import epoch_megakernel

    err = 0.0
    timing = {}
    for size in ("small", "full"):
        for fleet, members in fleet_members(size):
            for d in ("masked", "gather"):
                plain = fleet_mux(members, d, False)
                kern = fleet_mux(members, d, True)
                fresh = kern._carry.clone()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                want, s_want, _ = run_fleet_chunks(plain, plain._carry, None)
                torch.cuda.synchronize()
                plain_ms = (time.perf_counter() - t0) * 1e3
                for K in (1, 4, None):
                    got, s_got, reads = run_fleet_chunks(kern, fresh.clone(),
                                                         K)
                    torch.cuda.synchronize()
                    what = f"fleet epoch_chunk {fleet} {size} {d} K={K}"
                    if reads != (1 if K is None
                                 else -(-s_got.n_epochs // K)):
                        fail(f"{what}: {reads} readbacks for "
                             f"{s_got.n_epochs} epochs")
                    e = carry_err(got, want, what)
                    err = max(err, e)
                    if e != 0 or s_got.sp.any() or s_got.failed.any():
                        fail(f"{what}: max |kernel - plain| = {e}, "
                             f"sp={s_got.sp}, failed={s_got.failed}")
                cap = sum(q for _, q in members)
                print(f"[kernels] fleet epoch_chunk {fleet:9s} {size:5s} "
                      f"{d:6s} capacity={cap} global epochs="
                      f"{s_want.n_epochs} tasks={int(s_want.job_tasks.sum())}"
                      f": exact at K=1, 4, inf; plain fleet loop "
                      f"{plain_ms:.1f} ms")
                if size == "full":
                    timing[d] = (members, kern, fresh, s_want, plain_ms)
    row["fleet_max_abs_err"] = err

    def chunk_ms(run, fresh, reps=3, device=True):
        # as phase_chunks' chunk_ms: the card sleeps while the host
        # enqueues, so the events hold the device's time alone
        ts = []
        for _ in range(reps):
            c = fresh.clone()
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            if device:
                torch.cuda._sleep(5_000_000)
            a.record()
            run(c)
            b.record()
            torch.cuda.synchronize()
            ts.append(a.elapsed_time(b))
        return sorted(ts)[len(ts) // 2]

    def loop_chunk(mux):
        return lambda c: mux.loop.run_chunk(c, 1 << 16, len(mux.slots))

    def counted(mux, fresh):
        """One chunk of a fresh clone with the kernel's STATS: (carry,
        stats)."""
        st = torch.zeros(len(epoch_megakernel.STATS), dtype=torch.int64,
                         device=dev)
        c = fresh.clone()
        epoch_megakernel.launch(mux.program, c, 1 << 16,
                                gather=mux.policy.name == "gather", stats=st,
                                plan=mux.loop.device_table())
        torch.cuda.synchronize()
        return c, dict(zip(epoch_megakernel.STATS, st.tolist()))

    for d, (members, kern, fresh, s, plain_ms) in timing.items():
        ms = chunk_ms(loop_chunk(kern), fresh)
        call_ms = chunk_ms(loop_chunk(kern), fresh, device=False)
        b, by = _fleet_bound(kern, s)
        _, st = counted(kern, fresh)
        G = epoch_megakernel.fleet_grid(kern.loop.device_table().set_id, dev)
        floor = st["grid_barriers"] * row["barrier_us"] * 1e-3
        tasks, forks = int(s.job_tasks.sum()), int(s.job_forks.sum())
        print(f"[kernels] fleet epoch_chunk mixed4 full {d}, one chunk "
              f"({G} CTAs): device {ms:.3f} ms (with the host's enqueue "
              f"{call_ms:.3f} ms), bound {b:.5f} ms ({by}), "
              f"barrier floor {floor:.3f} ms ({st['grid_barriers']} grid "
              f"barriers, {st['search_barriers']} of further reclamation "
              f"rounds, {st['wide_epochs']} epochs), plain fleet loop "
              f"{plain_ms:.1f} ms ({s.n_epochs} global epochs, {tasks} "
              f"tasks, {forks} forks)")
        row[f"fleet_mixed4_{d}_ms"] = ms
        row[f"fleet_mixed4_{d}_call_ms"] = call_ms
        row[f"fleet_mixed4_{d}_plain_ms"] = plain_ms
        row[f"fleet_mixed4_{d}_bound_ms"] = b
        row[f"fleet_mixed4_{d}_floor_ms"] = floor
        row[f"fleet_mixed4_{d}_stats"] = st

    # a solo carry is the one-region case of a fleet: fib(28) through the
    # fleet kernel (J = 1) against the solo kernel, the same bits and the
    # chunk's device time beside the solo kernel's
    from repro_torch.core import DeviceEngine

    fib_case = {c.name: c for c, _ in path_cases()}["fib"]
    one = fleet_mux([(fib_case, fib_case.capacity)], "masked", True)
    one_fresh = one._carry.clone()
    solo = DeviceEngine(fib_case.program, capacity=fib_case.capacity,
                        dispatch="masked", megakernel=True, device="cuda")
    solo_fresh = solo.initial_carry(fib_case.initial)
    got, one_st = counted(one, one_fresh)
    want = solo.loop.run_chunk(solo_fresh.clone(), 1 << 16, 1)
    ta, tb = _carry_tensors(got), _carry_tensors(want)
    for k in tb:
        if k in ta and not torch.equal(ta[k], tb[k]):
            fail(f"fib(28) as a one-region fleet: {k} differs from the solo "
                 "kernel's")
    one_ms = chunk_ms(loop_chunk(one), one_fresh)
    print(f"[kernels] fib(28) as a one-region fleet (masked): equal to the "
          f"solo kernel's carry; device {one_ms:.3f} ms against the solo "
          f"kernel's {row['ms']:.3f} ms ({one_st['grid_barriers']} grid "
          f"barriers, {one_st['wide_epochs']} epochs all on the whole grid; "
          f"solo: {row['stats']['grid_barriers']} grid + "
          f"{row['stats']['group_barriers']} group barriers, "
          f"{row['stats']['narrow_epochs']} narrow epochs on one CTA)")
    row["fleet_fib_one_region_ms"] = one_ms
    row["fleet_fib_one_region_stats"] = one_st
    return row


# ------------------------------------------------------ phase 2, ordered_add
def matmul_payload(dev):
    """The ordered add's inputs at matmul's full-size payload: n^2 C cells
    (and the sink row), n / block terms a cell, in a seeded random order."""
    n, block = APP_FULL["matmul"]
    gen = torch.Generator(device=dev).manual_seed(0)
    cells, per = n * n, n // block
    idx = torch.arange(cells, device=dev, dtype=torch.int32).repeat(per)[
        torch.randperm(cells * per, device=dev, generator=gen)]
    val = torch.randn(cells * per, device=dev, generator=gen)
    base = torch.randn(cells + 1, device=dev, generator=gen)
    return base, idx, val


def phase_ordered_add(dev):
    """ordered_add against ordered_add_ref at matmul's payload, exactly,
    then timed beside its plain version and two yardsticks."""
    from repro_torch.kernels import ordered_add, ref

    base, idx, val = matmul_payload(dev)
    terms, cells = idx.shape[0], base.shape[0] - 1
    want = ref.ordered_add_ref(base.clone(), idx, val)
    err = 0.0
    for _ in range(3):
        got = ordered_add.ordered_add_(base.clone(), idx, val)
        torch.cuda.synchronize()
        e = float((got[:-1] - want[:-1]).abs().max())
        err = max(err, e)
        if not torch.equal(got[:-1], want[:-1]):
            fail(f"ordered_add at matmul's payload: max |kernel - plain| "
                 f"= {e}")
    print(f"[kernels] ordered_add exact x3 against ordered_add_ref at "
          f"{terms} terms into {cells} cells ({terms // cells} a cell)")
    acc = base.clone()
    row = dict(
        name="ordered_add", route="cuda",
        design="count (int atomics) -> fork_scan of the counts -> place "
               "(atomic cursors) -> each cell's run sorted by source "
               "position (one thread's insertion sort up to 32 terms, a "
               "CTA's bitonic sort and merges beyond) and summed serially "
               "from the old value; the device routines of "
               "csrc/ordered_add.cuh, which epoch_chunk runs for matmul",
        source="src/repro_torch/kernels/csrc/ordered_add.cu",
        replaces="none: a port-only kernel for the float scatter-add that "
                 "XLA lowers on the TPU (src/repro/core/tvm.py:688)",
        max_abs_err=err, library_ms=None,
        ms=cuda_ms(lambda: ordered_add.ordered_add_(acc, idx, val)),
        call_ms=call_ms(lambda: ordered_add.ordered_add_(acc, idx, val),
                        iters=20),
        plain_ms=call_ms(lambda: ref.ordered_add_ref(acc, idx, val), iters=3),
        stable_sort_ms=cuda_ms(lambda: torch.sort(idx, stable=True)),
        index_add_ms=cuda_ms(lambda: acc.index_add_(0, idx, val)),
        terms=terms, cells=cells,
    )
    # each term's index and value read once, each cell read and written
    row["bound_ms"], row["bound_by"] = bound_ms(8 * terms + 8 * cells, terms)
    print(f"[kernels] ordered_add {terms} terms: device {row['ms']:.4f} ms "
          f"(eager call {row['call_ms']:.4f} ms), bound "
          f"{row['bound_ms']:.5f} ms ({row['bound_by']}), plain "
          f"{row['plain_ms']:.3f} ms; yardsticks: one stable torch.sort of "
          f"the indices {row['stable_sort_ms']:.4f} ms, index_add_ "
          f"(unordered) {row['index_add_ms']:.4f} ms")
    return row


# ---------------------------------------------------------------- phase 3
INVARIANT = ("epochs", "tasks_executed", "total_forks", "peak_tv_slots",
             "map_launches", "map_elements", "map_lanes_launched",
             "ranges_coalesced")


def _run(case, dispatch, device, tag="path", walls=None, wall_key=None,
         **kw):
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    heap, value, stats = case.run(dispatch=dispatch, device=device, **kw)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if walls is not None:
        walls[wall_key or (case.name, dispatch)] = wall * 1e3
    heap = {k: v.cpu().numpy() for k, v in heap.items()}
    value = value.cpu().numpy()
    print(f"[{tag}] {case.name:9s} {dispatch:9s} {device:4s} "
          f"capacity={case.capacity} epochs={stats.epochs} "
          f"tasks={stats.tasks_executed} peak_tv_slots={stats.peak_tv_slots}"
          f" wall_ms={wall * 1e3:.1f} "
          f"us_per_task={wall * 1e6 / max(1, stats.tasks_executed):.3f}")
    return heap, value, stats


def _same(a, b, what, fields=INVARIANT, fft_bound=None):
    """Heaps, values and the ``fields`` of ``RunStats`` of two runs,
    exactly; with ``fft_bound``, fft's ``re``/``im`` heaps within that
    share of their largest |value|.  Returns the largest such heap
    difference."""
    ha, va, sa = a
    hb, vb, sb = b
    if not np.array_equal(va, vb):
        fail(f"{what}: TV values differ")
    worst = 0.0
    for k in ha:
        if fft_bound is not None and k in ("re", "im"):
            d = float(np.abs(ha[k] - hb[k]).max())
            bound = fft_bound * float(np.abs(hb[k]).max())
            if d > bound:
                fail(f"{what}: heap[{k!r}] differs by {d} > {bound}")
            worst = max(worst, d)
        elif not np.array_equal(ha[k], hb[k]):
            fail(f"{what}: heap[{k!r}] differs")
    da, db = sa.as_dict(), sb.as_dict()
    for k in fields:
        if da[k] != db[k]:
            fail(f"{what}: stats[{k!r}] {da[k]} != {db[k]}")
    return worst


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
        (AppCase("mergesort", mergesort.make_program(n_ms, use_map=True),
                 mergesort.initial(n_ms), dict(inp=inp),
                 capacity=2**20),
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
    # the solo host path's kernels (segmented_fork_scan is the service's)
    launches = {k: fork_compact.LAUNCHES[k] for k in ("fork_scan",
                                                      "type_rank")}
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
    return launches, cases, runs


# ----------------------------------------------------------- phase 3b, apps
# The six remaining paper apps and naive mergesort at sizes the paper's
# users run (§6.2-6.5), each also run on the CPU at that size (each CPU
# run takes seconds on the H100 machine's host).  Capacities: the
# smallest power of two that does not overflow, next_pow2(peak_tv_slots)
# (a fork past the TV is checked against the post-fork cursor, which is
# what peak_tv_slots records), found from the starting points 2^23
# (sssp), 2^21 (nqueens, tsp), 2^20 (fft) and 2^16 (matmul, annealing,
# naive mergesort); the phase fails if one is no longer the smallest.
APP_CAPACITY = {"sssp": 2**21, "nqueens": 2**20, "tsp": 2**18,
                "fft": 2**19, "matmul": 2**16, "annealing": 2**16,
                "naive": 2**11}
APP_FULL = {"sssp": 2**17, "nqueens": 12, "tsp": 10, "fft": 2**18,
            "matmul": (512, 16), "annealing": (16, 256, 200),
            "naive": 2**10}
FFT_REF_RTOL = 1e-4   # relative L2 error of the fft against np.fft
FFT_CPU_RTOL = 1e-5   # fft heap, card vs CPU, of the largest |CPU value|
MATMUL_RTOL = 1e-5    # max |C - A@B| over max |A@B|, A@B in float64
# the stats every run of one program shares, whatever its dispatch or
# engine (lanes, dispatches, transfers and map lanes are the mode's own)
APP_INVARIANT = ("epochs", "tasks_executed", "total_forks", "peak_tv_slots",
                 "map_launches", "map_elements")


def app_case(name, size):
    """``(AppCase, check)`` of one app at ``size``; ``check(heap, value)``
    returns ``(ok, detail)`` against the app's reference."""
    from repro_torch.apps import (
        annealing, fft, matmul, mergesort, nqueens, sssp, tsp,
    )
    from repro_torch.apps.registry import AppCase

    cap = APP_CAPACITY[name]
    if name == "sssp":
        n = size
        adj_off, adj = sssp.random_graph(n, avg_degree=4, seed=0)
        wgt = sssp.random_weights(len(adj), seed=1)
        case = AppCase("sssp", sssp.make_program(n, len(adj)),
                       sssp.initial(0),
                       sssp.heap_init(adj_off, adj, wgt, n), capacity=cap)

        def check(h, v):
            ref = sssp.sssp_reference(adj_off, adj, wgt, 0, n)
            return (np.allclose(h["dist"], ref, rtol=1e-5),
                    f"{int((ref < sssp.INF_F).sum())} of {n} reached")
    elif name == "nqueens":
        case = AppCase("nqueens", nqueens.make_program(size),
                       nqueens.initial(), capacity=cap)

        def check(h, v):
            got = int(h["count"][0])
            return got == nqueens.SOLUTIONS[size], f"{got} solutions"
    elif name == "tsp":
        dist = tsp.random_instance(size, seed=3)
        case = AppCase("tsp", tsp.make_program(size), tsp.initial(),
                       tsp.heap_init(dist), capacity=cap)

        def check(h, v):
            got, want = int(h["best"][0]), tsp.tsp_reference(dist)
            return got == want, (f"best {got}, brute force {want}, greedy "
                                 f"bound {tsp.greedy_bound(dist)}")
    elif name == "fft":
        xr, xi = fft.random_input(size, seed=0)
        case = AppCase("fft", fft.make_program(size), fft.initial(size),
                       dict(xr=xr, xi=xi), capacity=cap)

        def check(h, v):
            got = (h["re"][:size].astype(np.float64)
                   + 1j * h["im"][:size].astype(np.float64))
            want = fft.fft_reference(xr, xi)
            err = np.linalg.norm(got - want) / np.linalg.norm(want)
            return err <= FFT_REF_RTOL, f"relative L2 error {err:.3e}"
    elif name == "matmul":
        n, block = size
        A, B = matmul.random_inputs(n, seed=0)
        case = AppCase("matmul", matmul.make_program(n, block=block),
                       matmul.initial(n), dict(A=A.ravel(), B=B.ravel()),
                       capacity=cap)

        def check(h, v):
            want = A.astype(np.float64) @ B.astype(np.float64)
            err = np.abs(h["C"].reshape(n, n) - want).max() / np.abs(
                want).max()
            return err <= MATMUL_RTOL, f"max error {err:.3e} of max |A@B|"
    elif name == "annealing":
        nb, chains, steps = size
        Q = annealing.random_qubo(nb, seed=5)
        case = AppCase("annealing",
                       annealing.make_program(nb, n_steps=steps,
                                              n_chains=chains),
                       annealing.initial(), dict(Q=Q.ravel()), capacity=cap)

        def check(h, v):
            got, opt = int(h["best"][0]), annealing.brute_force_min(Q)
            return got >= opt, f"best {got}, optimum {opt}"
    else:
        x = mergesort.random_input(size, seed=0)
        case = AppCase("naive", mergesort.make_program(size, use_map=False),
                       mergesort.initial(size), dict(inp=x), capacity=cap)

        def check(h, v):
            return np.array_equal(h["src"][:size], np.sort(x)), "sorted"
    return case, check


def _wall_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _resident_runs(name, case, check, mask, walls, runs):
    """The plain resident DeviceEngine and DeviceEngine(megakernel=True),
    masked and gather, against the masked HostEngine run ``mask`` (heaps,
    values, APP_INVARIANT) and the app's reference."""
    from repro_torch.core import DeviceEngine

    for d in ("masked", "gather"):
        runs[name, "resident " + d] = r = _run(
            case, d, "cuda", tag="apps-resident", walls=walls,
            wall_key=(name, "resident " + d), engine_cls=DeviceEngine)
        _same(r, mask, f"{name} resident {d} vs masked",
              fields=APP_INVARIANT)
    for d in ("masked", "gather"):
        key = (name, "megakernel " + d)
        runs[key] = r = _run(case, d, "cuda", tag="apps-megakernel",
                             walls=walls, wall_key=key,
                             engine_cls=DeviceEngine, megakernel=True)
        _same(r, mask, f"{name} megakernel {d} vs masked",
              fields=APP_INVARIANT)
        ok, detail = check(r[0], r[1])
        if not ok:
            fail(f"{name} megakernel {d}: result differs from the "
                 f"reference ({detail})")
        print(f"[apps] {name} {d}: megakernel wall "
              f"{walls[key]:.1f} ms, plain resident "
              f"{walls[name, 'resident ' + d]:.1f} ms")


def phase_apps(path_cases):
    """The six remaining apps and naive mergesort on the card: every
    HostEngine dispatch, the plain resident DeviceEngine and
    DeviceEngine(megakernel=True), against the references, each other and
    the CPU; treewalk in both orders on phase 7's tree on the masked
    HostEngine and both resident engines; then the paper's yardsticks."""
    from repro_torch.apps import get_case
    from repro_torch.kernels import epoch_megakernel, fork_compact, ordered_add

    # first use of each app's operations (the registry's small cases), so
    # the first timed run is not charged for it
    for name in APP_FULL:
        get_case("mergesort" if name == "naive" else name).run(
            dispatch="masked", device="cuda")
    torch.cuda.synchronize()
    fork_compact.reset_launches()
    epoch_megakernel.reset_launches()
    ordered_add.reset_launches()
    walls, runs, over_cap = {}, {}, []
    for name in APP_FULL:
        case, check = app_case(name, APP_FULL[name])
        mask = runs[name, "masked"] = _run(case, "masked", "cuda",
                                           tag="apps", walls=walls)
        ok, detail = check(mask[0], mask[1])
        print(f"[apps] {name}: {detail}")
        if not ok:
            fail(f"{name}: result differs from the reference ({detail})")
        fb = FFT_CPU_RTOL if name == "fft" else None
        for d in ("compacted", "gather"):
            runs[name, d] = r = _run(case, d, "cuda", tag="apps",
                                     walls=walls)
            _same(r, mask, f"{name} {d} vs masked")
        _resident_runs(name, case, check, mask, walls, runs)
        peak = mask[2].peak_tv_slots
        smallest = 1 << max(0, (peak - 1).bit_length())
        print(f"[apps] {name}: capacity {case.capacity}, peak_tv_slots "
              f"{peak}, smallest capacity that does not overflow "
              f"{smallest}")
        if smallest != case.capacity:
            over_cap.append((name, case.capacity, smallest))
        # the card against the CPU, at full size
        cpu = _run(case, "masked", "cpu", tag="apps")
        worst = _same(mask, cpu, f"{name} cuda vs cpu",
                      fields=tuple(mask[2].as_dict()), fft_bound=fb)
        if fb is not None:
            top = max(float(np.abs(cpu[0][k]).max()) for k in ("re", "im"))
            print(f"[apps] fft: heap max |card - CPU| {worst:.3e} = "
                  f"{worst / top:.3e} of the largest |value| ({top:.1f}); "
                  f"bound {fb:g}")
        print(f"[apps] {name}: card == CPU")
    for order in ("post", "pre"):
        case, check = tree_case(order)
        mask = _run(case, "masked", "cuda", tag="apps", walls=walls)
        ok, detail = check(mask[0], mask[1])
        if not ok:
            fail(f"{case.name}: result differs from the reference")
        _resident_runs(case.name, case, check, mask, walls, runs)
    torch.cuda.synchronize()
    launches = {k: fork_compact.LAUNCHES[k] for k in ("fork_scan",
                                                      "type_rank")}
    launches["epoch_chunk"] = epoch_megakernel.LAUNCHES["epoch_chunk"]
    launches["ordered_add"] = ordered_add.LAUNCHES["ordered_add"]
    print(f"[apps] kernel launches during the apps phase: {launches}")
    for k, n in launches.items():
        if n <= 0:
            fail(f"kernel {k} was not launched on the apps path")
    if over_cap:
        fail(f"capacities are not the smallest that fit: {over_cap}")
    app_yardsticks(path_cases, walls)
    return launches


def app_yardsticks(path_cases, walls):
    """The paper's comparisons on the card (Figs. 6-9, §4.4), printed as
    yardsticks: each TREES run's wall beside the native baseline's."""
    from repro_torch.apps import bfs, fft, mergesort, nqueens, sssp
    from repro_torch.apps.baselines import bitonic, worklist
    from repro_torch.apps.registry import AppCase
    from repro_torch.core import compare, run_oracle

    # Figs. 7/8: bfs and sssp against the Lonestar-style worklists, on the
    # bfs cell's graph (2^17 vertices)
    bcase = path_cases[1][0]
    h = bcase.heap_init
    n = h["dist"].shape[0]
    bfs_ms = _wall_ms(lambda: bcase.run(dispatch="masked", device="cuda"))
    worklist.bfs_worklist(h["adj_off"], h["adj"], 0, n)  # warm
    out = {}
    wl_ms = _wall_ms(lambda: out.setdefault("bfs", worklist.bfs_worklist(
        h["adj_off"], h["adj"], 0, n)))
    if not np.array_equal(out["bfs"][0].cpu().numpy(),
                          bfs.bfs_reference(h["adj_off"], h["adj"], 0, n)):
        fail("bfs_worklist differs from the reference")
    print(f"[yardstick] bfs n={n}: TREES masked {bfs_ms:.1f} ms, worklist "
          f"{wl_ms:.1f} ms ({out['bfs'][1]} rounds), ratio "
          f"{bfs_ms / wl_ms:.2f}")
    scase, _ = app_case("sssp", APP_FULL["sssp"])
    s = scase.heap_init
    n = s["dist"].shape[0]
    wl_ms = _wall_ms(lambda: out.setdefault("sssp", worklist.sssp_worklist(
        s["adj_off"], s["adj"], s["wgt"], 0, n)))
    ref = sssp.sssp_reference(s["adj_off"], s["adj"], s["wgt"], 0, n)
    if not np.allclose(out["sssp"][0].cpu().numpy(), ref, rtol=1e-5):
        fail("sssp_worklist differs from the reference")
    print(f"[yardstick] sssp n={n}: TREES masked "
          f"{walls['sssp', 'masked']:.1f} ms, worklist {wl_ms:.1f} ms "
          f"({out['sssp'][1]} rounds), ratio "
          f"{walls['sssp', 'masked'] / wl_ms:.2f}")
    # Fig. 9: naive vs map mergesort vs bitonic at 2^10, map vs bitonic at
    # 2^18 (phase 3's case)
    n = APP_FULL["naive"]
    x = mergesort.random_input(n, seed=0)
    mcase = AppCase("mergesort", mergesort.make_program(n, use_map=True),
                    mergesort.initial(n), dict(inp=x), capacity=2**12)
    map_ms = _wall_ms(lambda: mcase.run(dispatch="masked", device="cuda"))
    xt = torch.as_tensor(x, device="cuda")
    bit_ms = call_ms(lambda: bitonic.bitonic_sort(xt), iters=10)
    if not np.array_equal(bitonic.bitonic_sort(xt).cpu().numpy(),
                          np.sort(x)):
        fail("bitonic_sort differs from np.sort")
    naive_ms = walls["naive", "masked"]
    print(f"[yardstick] sort n={n}: naive {naive_ms:.1f} ms, map "
          f"{map_ms:.1f} ms, bitonic {bit_ms:.3f} ms (naive/map "
          f"{naive_ms / map_ms:.1f}, map/bitonic {map_ms / bit_ms:.0f})")
    big = path_cases[2][0]
    n = big.heap_init["inp"].shape[0]
    map_ms = _wall_ms(lambda: big.run(dispatch="masked", device="cuda"))
    xt = torch.as_tensor(big.heap_init["inp"], device="cuda")
    bit_ms = call_ms(lambda: bitonic.bitonic_sort(xt), iters=10)
    print(f"[yardstick] sort n={n}: map {map_ms:.1f} ms, bitonic "
          f"{bit_ms:.3f} ms (map/bitonic {map_ms / bit_ms:.0f})")
    # Fig. 6: fft against torch.fft.fft
    n = APP_FULL["fft"]
    xr, xi = fft.random_input(n, seed=0)
    xc = torch.complex(torch.as_tensor(xr), torch.as_tensor(xi)).cuda()
    lib_ms = call_ms(lambda: torch.fft.fft(xc), iters=20)
    mk_ms = walls["fft", "megakernel masked"]
    print(f"[yardstick] fft n={n}: TREES masked "
          f"{walls['fft', 'masked']:.1f} ms, megakernel {mk_ms:.2f} ms, "
          f"torch.fft.fft {lib_ms:.3f} ms (ratios "
          f"{walls['fft', 'masked'] / lib_ms:.0f} and {mk_ms / lib_ms:.0f})")
    # §4.4: nqueens(7)'s V1 / V_inf against the sequential oracle
    prog = nqueens.make_program(7)
    _, _, ostats = run_oracle(prog, nqueens.initial(), capacity=1 << 14)
    qcase = AppCase("nqueens7", prog, nqueens.initial(), capacity=1 << 14)
    q_ms = _wall_ms(lambda: out.setdefault("q", qcase.run(
        dispatch="masked", device="cuda")))
    rep = compare(ostats, out["q"][2])
    print(f"[yardstick] nqueens7 overhead: wall {q_ms:.1f} ms, "
          f"T1={rep.t1_tasks} Tinf={rep.t_inf_epochs} "
          f"parallelism={rep.parallelism:.1f} "
          f"V1_lanes={rep.v1_lane_factor:.2f} "
          f"Vinf_dispatches={rep.v_inf_dispatches} "
          f"Vinf_transfers={rep.v_inf_transfers} "
          f"utilization={rep.utilization:.3f} "
          f"greedy_bound_P256={rep.greedy_bound(256):.0f}")


# ---------------------------------------------------------------- phase 4
def phase_profile(label, run):
    """Where the time goes: one run under ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, stats = run()
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
    print(f"[profile] {label} (profiled): wall {wall_us:.0f} us, "
          f"device busy {busy_us:.0f} us ({100 * busy_us / wall_us:.1f}%), "
          f"{n_kernels} device ops, "
          f"{n_kernels / stats.epochs:.1f} per epoch")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"[profile]   {e.self_device_time_total:10.0f} us "
              f"x{e.count:<6d} {e.key[:90]}")
    return busy_us, wall_us, events


def device_us(events, *names):
    """Device time of the kernels whose names contain one of ``names``."""
    return sum(e.self_device_time_total for e in events
               if any(n in e.key for n in names))


# ---------------------------------------------------------------- phase 5
def phase_resident(cases, host_runs):
    """DeviceEngine(megakernel=True) on the card: the epoch_chunk path."""
    from repro_torch.core import DeviceEngine
    from repro_torch.kernels import epoch_megakernel

    torch.cuda.synchronize()
    epoch_megakernel.reset_launches()
    runs, walls = {}, {}
    for case, correct in cases:
        for d in ("masked", "gather"):
            runs[case.name, d] = r = _run(
                case, d, "cuda", tag="resident", walls=walls,
                engine_cls=DeviceEngine, megakernel=True)
            if not correct(r[0], r[1]):
                fail(f"resident {case.name} {d}: result differs from the "
                     "reference")
            hh, hv, _ = host_runs[case.name, "masked"]
            if not np.array_equal(r[1], hv) or any(
                    not np.array_equal(r[0][k], hh[k]) for k in hh):
                fail(f"resident {case.name} {d}: heap or values differ "
                     "from the masked HostEngine run")
    torch.cuda.synchronize()
    launches = dict(epoch_megakernel.LAUNCHES)
    print(f"[resident] kernel launches during the resident phase: "
          f"{launches}")
    if launches["epoch_chunk"] <= 0:
        fail("kernel epoch_chunk was not launched on the resident path")
    for (name, d), ms in walls.items():
        print(f"[resident] {name:9s} {d:6s} wall {ms:.1f} ms (one-CTA "
              f"kernel: {ONE_CTA_RESIDENT_WALL_MS[name, d]} ms)")
    # the plain resident loop on the card and on the CPU, for comparison
    for case, _ in cases:
        for d in ("masked", "gather"):
            mega = runs[case.name, d]
            for dev in ("cuda", "cpu"):
                plain = _run(case, d, dev, tag="resident-plain",
                             engine_cls=DeviceEngine)
                if plain[2].as_dict() != mega[2].as_dict():
                    fail(f"resident {case.name} {d}: RunStats differ from "
                         f"the plain resident run on {dev}: "
                         f"{mega[2]} vs {plain[2]}")
                if not np.array_equal(plain[1], mega[1]) or any(
                        not np.array_equal(plain[0][k], mega[0][k])
                        for k in mega[0]):
                    fail(f"resident {case.name} {d}: heap or values differ "
                         f"from the plain resident run on {dev}")
    print("[resident] all runs match their references, the host path, and "
          "the plain resident loop on CUDA and on the CPU")
    return launches


# ---------------------------------------------------------------- phase 7
def _tenant(h):
    r = h.result
    return ({k: v.cpu().numpy() for k, v in r.heap.items()},
            r.value.cpu().numpy(), r.stats)


def _same_tenant(got, want, what):
    """Heap, values and the solo-comparable stats of a tenant."""
    hg, vg, sg = got
    hw, vw, sw = want
    if not np.array_equal(vg, vw):
        fail(f"{what}: TV values differ")
    if hg.keys() != hw.keys() or any(
            not np.array_equal(hg[k], hw[k]) for k in hw):
        fail(f"{what}: heap differs")
    sd = sg.solo_dict()
    want_sd = {k: getattr(sw, k) for k in sd}
    if sd != want_sd:
        fail(f"{what}: solo_dict {sd} != {want_sd}")


def service_cases(cases, runs):
    """The full-size mixed4 wave, in the registry's order: phase 3's fib,
    bfs and mergesort cases with their capacities as quotas, and treewalk
    post-order on random_tree(2^16, seed=11) at the least power of two at
    or above its solo peak (tree_case; its solo runs go into ``runs``)."""
    tw, check = tree_case("post")
    correct = {c.name: ok for c, ok in cases}
    correct["treewalk"] = lambda h, v: check(h, v)[0]
    for d in ("masked", "compacted", "gather"):
        runs["treewalk", d] = r = _run(tw, d, "cuda", tag="service")
        if not correct["treewalk"](r[0], r[1]):
            fail(f"treewalk {d}: result differs from the reference")
    by_name = {c.name: c for c, _ in cases}
    wave = [by_name["fib"], tw, by_name["bfs"], by_name["mergesort"]]
    return wave, correct


def run_wave(wave, dispatch, **kw):
    """One JobService wave of ``wave`` on the card (``kw``: the engine,
    chunk and megakernel of a device wave); (service, handles, wall s)."""
    from repro_torch.service import JobService

    svc = JobService(capacity=sum(c.capacity for c in wave),
                     dispatch=dispatch, device="cuda", **kw)
    handles = [svc.submit_case(c, quota=c.capacity) for c in wave]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    svc.drain()
    torch.cuda.synchronize()
    return svc, handles, time.perf_counter() - t0


# the device waves of phase 7: (megakernel, K) of each, masked and gather
DEVICE_WAVES = ((False, 4), (True, 1), (True, 4), (True, None))


def device_waves(wave, runs, tenants, host_stats):
    """JobService(engine="device") on the full-size mixed4 wave: the plain
    resident fleet loop at K=4 and the fleet epoch_chunk at K = 1, 4 and
    inf, masked and gather; each tenant against its solo run on the card
    and the host wave's tenant.  Returns the epoch_chunk launches."""
    from repro_torch.kernels import epoch_megakernel

    epoch_megakernel.reset_launches()
    for d in ("masked", "gather"):
        hs = host_stats[d]
        walls = {}
        for megakernel, K in DEVICE_WAVES:
            label = (f"device {d} {'epoch_chunk' if megakernel else 'plain'}"
                     f" K={'inf' if K is None else K}")
            svc, handles, wall = run_wave(wave, d, engine="device", chunk=K,
                                          megakernel=megakernel)
            fs = svc.stats()
            for c, h in zip(wave, handles):
                if h.status.value != "done":
                    fail(f"service {label} {c.name}: {h.status} {h.error}")
                got = _tenant(h)
                _same_tenant(got, runs[c.name, d],
                             f"service {label} {c.name} vs its solo run")
                _same_tenant(got, tenants[c.name, d],
                             f"service {label} {c.name} vs the host wave")
            want = 1 if K is None else -(-fs.epochs // K)
            if fs.epochs != hs.epochs or fs.dispatches != want:
                fail(f"service {label}: {fs.epochs} global epochs (host "
                     f"wave {hs.epochs}), {fs.dispatches} dispatches "
                     f"(ceil(epochs / K) = {want})")
            print(f"[service] mixed4 {label:28s}: global epochs {fs.epochs} "
                  f"(host wave {hs.epochs}), dispatches {fs.dispatches} / "
                  f"transfers {fs.scalar_transfers} (host wave "
                  f"{hs.dispatches} / {hs.scalar_transfers}), tasks "
                  f"{fs.tasks_executed}, wall_ms={wall * 1e3:.1f}")
            walls[megakernel, K] = wall
        # what a chunk boundary costs: K = 1 takes epochs chunks, K = inf one
        per = (walls[True, 1] - walls[True, None]) / (hs.epochs - 1)
        print(f"[service] mixed4 device {d} epoch_chunk: a chunk boundary "
              f"costs {per * 1e3:.3f} ms ((K=1 wall - K=inf wall) / "
              f"{hs.epochs - 1})")
    torch.cuda.synchronize()
    n = epoch_megakernel.LAUNCHES["epoch_chunk"]
    if n <= 0:
        fail("kernel epoch_chunk was not launched on the service path")
    print(f"[service] epoch_chunk launches during the device waves: {n}")
    return n


def phase_service(cases, runs):
    """JobService on the card: engine="host" (the JobArena commit's
    segmented_fork_scan path) and engine="device" (the plain resident
    fleet loop and the fleet epoch_chunk)."""
    from repro_torch.apps import bfs, fib
    from repro_torch.apps.registry import AppCase
    from repro_torch.kernels import fork_compact
    from repro_torch.service import JobService

    wave, correct = service_cases(cases, runs)
    torch.cuda.synchronize()
    fork_compact.reset_launches()
    tenants = {}
    host_stats = {}
    for d in ("masked", "compacted", "gather"):
        svc, handles, wall = run_wave(wave, d)
        fs = svc.stats()
        solo = [runs[c.name, d][2] for c in wave]
        for c, h in zip(wave, handles):
            if h.status.value != "done":
                fail(f"service {d} {c.name}: {h.status} {h.error}")
            got = tenants[c.name, d] = _tenant(h)
            _same_tenant(got, runs[c.name, d], f"service {d} {c.name} vs "
                         "its solo run")
            if not correct[c.name](got[0], got[1]):
                fail(f"service {d} {c.name}: differs from the reference")
            _same_tenant(got, tenants[c.name, "masked"],
                         f"service {c.name} {d} vs masked")
        host_stats[d] = fs
        print(f"[service] mixed4 {d:9s} capacity={sum(c.capacity for c in wave)}"
              f": global epochs {fs.epochs} (solo {'+'.join(str(s.epochs) for s in solo)}"
              f" = {sum(s.epochs for s in solo)}), fleet dispatches "
              f"{fs.dispatches} / transfers {fs.scalar_transfers} (solo "
              f"{sum(s.dispatches for s in solo)} / "
              f"{sum(s.scalar_transfers for s in solo)}), tasks "
              f"{fs.tasks_executed}, lanes {fs.lanes_launched}, wall_ms="
              f"{wall * 1e3:.1f}")
    chunk_launches = device_waves(wave, runs, tenants, host_stats)
    torch.cuda.synchronize()
    launches = dict(fork_compact.LAUNCHES)
    print(f"[service] kernel launches during the service waves (host and "
          f"plain device waves): {launches}")
    for k in ("segmented_fork_scan", "type_rank"):
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched on the service path")

    # streaming: six fib jobs through four regions; the two queued jobs
    # seat mid-flight in the regions of the two short jobs; on the host
    # engine and on the device engine's fleet epoch_chunk at K=4
    q = MEDIUM_QUOTA
    ns = MEDIUM_FIBS
    solo = {}
    for kw in ({}, dict(engine="device", chunk=4, megakernel=True)):
        label = "device epoch_chunk K=4" if kw else "host"
        svc = JobService(capacity=4 * q, max_jobs=4, device="cuda", **kw)
        hs = [svc.submit(fib.PROGRAM, fib.initial(n), quota=q,
                         name=f"fib{n}") for n in ns]
        muxes, order = [], []
        t0 = time.perf_counter()
        for h in svc.completions():
            if svc._mux not in muxes:
                muxes.append(svc._mux)
            order.append(h.job.name)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        first_done = min(h.finished_at for h in hs)
        if len(muxes) != 1 or not all(h.started_at > first_done
                                      for h in hs[4:]):
            fail(f"streaming {label}: the queued jobs were not seated "
                 "mid-flight")
        for h, n in zip(hs, ns):
            if n not in solo:
                solo[n] = _run(AppCase(f"fib{n}", fib.PROGRAM,
                                       fib.initial(n), capacity=q),
                               "masked", "cuda", tag="service")
            _same_tenant(_tenant(h), solo[n], f"streaming {label} fib({n})")
            if int(h.result.value[0, 0]) != fib.fib_reference(n):
                fail(f"streaming {label} fib({n}): wrong value")
        fs = svc.stats()
        print(f"[service] streaming {label}: 6 fib jobs (n={ns}) through 4 "
              f"regions of {q} slots in one wave, completion order {order}, "
              f"{fs.epochs} global epochs, {fs.dispatches} dispatches, "
              f"wall_ms={wall * 1e3:.1f}")

    # preempt/resume of a bfs tenant, against its uninterrupted solo run:
    # after 4 host epochs, and after 2 device chunks of 4 epochs
    n = MEDIUM_BFS
    adj_off, adj = bfs.random_graph(n, avg_degree=4, seed=1)
    bcase = AppCase("bfs", bfs.make_program(n, len(adj)), bfs.initial(0),
                    bfs.heap_init(adj_off, adj, n), capacity=8 * n)
    fcase = AppCase("fib", fib.PROGRAM, fib.initial(22), capacity=2**17)
    b_solo = _run(bcase, "masked", "cuda", tag="service")
    for kw, pumps in (({}, 4),
                      (dict(engine="device", chunk=4, megakernel=True), 2)):
        label = "device epoch_chunk K=4" if kw else "host"
        svc = JobService(capacity=bcase.capacity + fcase.capacity,
                         device="cuda", **kw)
        hb = svc.submit_case(bcase, quota=bcase.capacity)
        hf = svc.submit_case(fcase, quota=fcase.capacity)
        for _ in range(pumps):
            svc._pump()
        if not svc.preempt(hb):
            fail(f"preempt {label}: the bfs tenant could not be preempted")
        svc.drain()
        if hb.preemptions != 1 or hb.status.value != "done":
            fail(f"preempt {label}: bfs tenant {hb.status} after "
                 f"{hb.preemptions} preemptions")
        got = _tenant(hb)
        _same_tenant(got, b_solo, f"preempted bfs ({label}) vs its "
                     "uninterrupted run")
        if not np.array_equal(got[0]["dist"],
                              bfs.bfs_reference(adj_off, adj, 0, n)):
            fail(f"preempted bfs ({label}): differs from the reference")
        if int(hf.result.value[0, 0]) != fib.fib_reference(22):
            fail(f"preempt {label}: the fib neighbour's value is wrong")
        print(f"[service] preempt/resume {label}: bfs on {n} vertices "
              f"preempted after {pumps} pumps and resumed, equal to its "
              "uninterrupted run")
    print("[service] every tenant matches its solo run on the card, its "
          "numpy reference, the other dispatches and the host wave")
    return launches, chunk_launches, wave


# ------------------------------------------------------ phase 2, attention
# B, Hq, Hkv, Sq, Skv, D, causal, q_offset, window: the prefill shape, then
# ragged shapes (lengths off the tile, q_offset, window, group 1/4/7, D 16)
FLASH_PREFILL = (16, 32, 8, 1024, 1024, 128, True, 0, 0)
FLASH_RAGGED = (
    (2, 8, 8, 100, 100, 128, True, 0, 0),       # group 1
    (2, 32, 8, 77, 333, 128, True, 256, 0),     # group 4, q_offset
    (1, 32, 8, 300, 300, 128, True, 0, 64),     # window
    (2, 8, 2, 50, 200, 64, False, 0, 0),        # non-causal
    (1, 32, 8, 129, 129, 128, False, 0, 40),    # window, non-causal
    (1, 4, 2, 40, 40, 16, True, 0, 0),          # the reduced configs' D
    (1, 56, 8, 200, 200, 128, True, 0, 0),      # group 7: yi-34b's heads
)
# hymba-1.5b's prefill bucket: group 5, D 64, its sliding window and the
# window 0 of its global layers
HYMBA_PREFILL = ((16, 25, 5, 1024, 1024, 64, True, 0, 2048),
                 (16, 25, 5, 1024, 1024, 64, True, 0, 0))
DECODE_SHAPE = (16, 32, 8, 2048, 128)  # B, Hq, Hkv, S, D
HYMBA_DECODE_SHAPE = (16, 25, 5, 2048, 64)
# decode's other checked shapes: yi-34b's group 7 over the serving cache,
# and the reduced configs' D = 16
DECODE_MORE = ((16, 56, 8, 2048, 128), (4, 8, 2, 600, 16))
L2_BYTES = 50e6  # the H100's L2: decode is timed over caches twice its size
ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _attn_err(got, want, dtype, what, tols=ATTN_TOL):
    """max |kernel - plain|, failing past tol * max(1, max |plain|)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{what}: {got.dtype}{tuple(got.shape)} vs "
             f"{want.dtype}{tuple(want.shape)}")
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        fail(f"{what}: non-finite output")
    err = float((g - w).abs().max())
    if err > tols[dtype] * max(1.0, float(w.abs().max())):
        fail(f"{what}: max |kernel - plain| = {err}")
    return err


def _flash_inputs(case, dtype, gen):
    """q as the strided transpose the attention block hands over."""
    B, Hq, Hkv, Sq, Skv, D = case[:6]
    q = torch.randn((B, Sq, Hq, D), generator=gen, device="cuda",
                    dtype=dtype).transpose(1, 2)
    k, v = (torch.randn((B, Skv, Hkv, D), generator=gen, device="cuda",
                        dtype=dtype).transpose(1, 2) for _ in range(2))
    return q, k, v


def _flash_work(case):
    """(bytes, flops) the function needs: q, k, v read and the output
    written once; 4 D flops per visible (query, key) pair."""
    B, Hq, Hkv, Sq, Skv, D, causal, qo, win = case
    qpos = torch.arange(Sq)[:, None] + qo
    kpos = torch.arange(Skv)[None, :]
    vis = torch.ones((Sq, Skv), dtype=torch.bool)
    if causal:
        vis &= qpos >= kpos
    if win > 0:
        vis &= qpos - kpos < win
    pairs = int(vis.sum())
    n_bytes = 2 * (2 * B * Hq * Sq * D + 2 * B * Hkv * Skv * D)
    return n_bytes, 4 * D * B * Hq * pairs


def _decode_work(lengths, S, B, Hq, Hkv, D, window=0):
    """(bytes, flops): each visible cache row's K and V once, q and the
    output once; 4 D flops per (q head, visible row)."""
    lens = lengths.cpu().long()
    hi = lens.clamp(max=S)
    lo = (lens - window).clamp(min=0) if window > 0 else torch.zeros_like(lens)
    rows = int((hi - lo).clamp(min=0).sum())
    n_bytes = 2 * (2 * rows * Hkv * D + 2 * B * Hq * D) + 4 * B
    return n_bytes, 4 * D * Hq * rows


def phase_attention(dev):
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention, flash_attention, ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    err = {"flash_attention": 0.0, "decode_attention": 0.0}
    for case in (FLASH_PREFILL,) + FLASH_RAGGED + HYMBA_PREFILL:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = _flash_inputs(case, dtype, gen)
            causal, qo, win = case[6:]
            got = flash_attention.flash_attention(
                q, k, v, causal=causal, q_offset=qo, window=win)
            want = ref.mha_ref(q, k, v, causal=causal, q_offset=qo,
                               window=win)
            e = _attn_err(got, want, dtype, f"flash_attention {case} {dtype}")
            err["flash_attention"] = max(err["flash_attention"], e)
            del q, k, v, got, want
    torch.cuda.synchronize()
    print(f"[kernels] flash_attention within tolerance at the prefill shape "
          f"{FLASH_PREFILL[:6]}, {len(FLASH_RAGGED)} ragged shapes and "
          f"hymba's {HYMBA_PREFILL[0][:6]} (group 5) with windows "
          f"{HYMBA_PREFILL[0][8]} and 0, bf16 and float32: max |kernel - plain| = {err['flash_attention']:.3g}")

    def check_decode(shape, windows, lengths, what):
        B, Hq, Hkv, S, D = shape
        for window in windows:
            for dtype in (torch.bfloat16, torch.float32):
                lens = torch.randint(1, S + 1, (B,), generator=gen,
                                     device=dev, dtype=torch.int32)
                lens[:len(lengths)] = torch.tensor(lengths)
                q = torch.randn((B, Hq, D), generator=gen, device=dev,
                                dtype=dtype)
                kc, vc = (torch.randn((B, Hkv, S, D), generator=gen,
                                      device=dev, dtype=dtype)
                          for _ in range(2))
                got = decode_attention.decode_attention(q, kc, vc, lens,
                                                        window=window)
                want = ref.decode_attention_ref(q, kc, vc, lens,
                                                window=window)
                e = _attn_err(got, want, dtype, f"decode_attention {what} "
                              f"{shape} window={window} {dtype}")
                err["decode_attention"] = max(err["decode_attention"], e)

    S = DECODE_SHAPE[3]
    check_decode(DECODE_SHAPE, (0, 256), (1, S - 1, S, S + 1, S + 200),
                 "granite")
    S5 = HYMBA_DECODE_SHAPE[3]
    check_decode(HYMBA_DECODE_SHAPE, (S5, 0), (1, S5 - 1, S5), "group 5")
    for shape in DECODE_MORE:
        S = shape[3]
        check_decode(shape, (0, 256), (1, S - 1, S, S + 1), "more")
    torch.cuda.synchronize()
    print(f"[kernels] decode_attention within tolerance at {DECODE_SHAPE} "
          f"(lengths 1, S-1, S, S+1, S+200 and random), window 0 and 256, "
          f"at hymba's {HYMBA_DECODE_SHAPE} (group 5), windows {S5} and 0, "
          f"and at {DECODE_MORE[0]} (yi-34b's group 7) and "
          f"{DECODE_MORE[1]} (D = 16), windows 0 and 256, bf16 and float32: "
          f"max |kernel - plain| = {err['decode_attention']:.3g}")

    rows = []
    # the prefill shape, bf16: the main path's widest flash launch
    case = FLASH_PREFILL
    q, k, v = _flash_inputs(case, torch.bfloat16, gen)
    b, by = bound_ms(*_flash_work(case), ops_per_s=TENSOR_BF16_FLOPS)
    t = {"ms": cuda_ms(lambda: flash_attention.flash_attention(q, k, v),
                       iters=5, reps=2),
         "plain_ms": cuda_ms(lambda: ref.mha_ref(q, k, v), iters=2, reps=2),
         "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
             q, k, v, is_causal=True, enable_gqa=True), iters=5, reps=2)}
    rows.append(dict(
        name="flash_attention", route="cuda",
        design="bf16 at D 64/128: persistent wgmma + TMA; D 16/32: mma.sync "
               "+ cp.async; float32: CUDA cores",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:98",
        max_abs_err=err["flash_attention"], bound_ms=b, bound_by=by, **t))
    del q, k, v
    # decode over the serving cell's cache: 16 slots of 2048 rows, lengths
    # of a prompt (64-1024) plus the tokens made so far (up to 128).  On
    # the path each layer's cache slice is read once per epoch and evicted
    # by the weights, so the row's times are over enough copies of the
    # caches that the rows read between two uses of a copy exceed twice
    # the L2 (cold); the warm times, one copy read again and again, are
    # printed beside them.
    B, Hq, Hkv, S, D = DECODE_SHAPE
    lens = torch.randint(64, 1024 + 128, (B,), generator=gen, device=dev,
                         dtype=torch.int32)
    q = torch.randn((B, Hq, D), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    n_bytes, n_ops = _decode_work(lens, S, B, Hq, Hkv, D)
    n_copies = 2 + int(2 * L2_BYTES // n_bytes)
    caches = [tuple(torch.randn((B, Hkv, S, D), generator=gen, device=dev,
                                dtype=torch.bfloat16) for _ in range(2))
              for _ in range(n_copies)]
    mask = (torch.arange(S, device=dev)[None] < lens[:, None])[:, None, None]
    b, by = bound_ms(n_bytes, n_ops, ops_per_s=TENSOR_BF16_FLOPS)

    def kernel(kc, vc):
        return decode_attention.decode_attention(q, kc, vc, lens)

    def plain(kc, vc):
        return ref.decode_attention_ref(q, kc, vc, lens)

    def library(kc, vc):
        return F.scaled_dot_product_attention(q[:, :, None], kc, vc,
                                              attn_mask=mask, enable_gqa=True)

    def cold(fn):
        """``fn`` over the copies in turn: each call finds its caches out
        of L2."""
        turn = itertools.count()
        return cuda_ms(lambda: fn(*caches[next(turn) % n_copies]),
                       iters=4 * n_copies)

    t = {"ms": cold(kernel), "plain_ms": cold(plain),
         "library_ms": cold(library),
         "warm_ms": cuda_ms(lambda: kernel(*caches[0])),
         "library_warm_ms": cuda_ms(lambda: library(*caches[0]))}
    rows.append(dict(
        name="decode_attention", route="cuda",
        design="split-K (256-row splits) over a cp.async ring, mma.sync in "
               "bf16, CUDA cores in float32, a merge launch",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:78",
        max_abs_err=err["decode_attention"], bound_ms=b, bound_by=by, **t))
    del caches
    r = rows[0]
    print(f"[kernels] flash_attention at {FLASH_PREFILL[:6]} causal bf16: "
          f"device {r['ms']:.5f} ms, bound {r['bound_ms']:.5f} ms "
          f"({r['bound_by']}; {100 * r['bound_ms'] / r['ms']:.1f}% of it), "
          f"plain {r['plain_ms']:.5f} ms, library (SDPA) "
          f"{r['library_ms']:.5f} ms (kernel / SDPA "
          f"{r['ms'] / r['library_ms']:.2f})")
    r = rows[1]
    print(f"[kernels] decode_attention at {DECODE_SHAPE} bf16, lengths "
          f"{lens.tolist()}, caches cold in L2 ({n_copies} copies, "
          f"{n_bytes / 1e6:.1f} MB read a call): device {r['ms']:.5f} ms, "
          f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}; kernel / bound "
          f"{r['ms'] / r['bound_ms']:.2f}), plain {r['plain_ms']:.5f} ms, "
          f"library (SDPA) {r['library_ms']:.5f} ms (kernel / SDPA "
          f"{r['ms'] / r['library_ms']:.2f}); warm in L2: kernel "
          f"{r['warm_ms']:.5f} ms, SDPA {r['library_warm_ms']:.5f} ms")
    return rows


# ------------------------------------------------------------ phase 2, SSD
# Bt, S, H, P, N: the mamba2-1.3b prefill bucket, then hymba-1.5b's heads
SSD_BUCKET = (16, 1024, 64, 64, 128)
SSD_HYMBA = (16, 1024, 50, 64, 16)
SSD_LENGTHS = (1, 65, 1000, 8192)  # at 2 sequences of the mamba2 heads
SSD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
SSD_REF_CHUNK = 128  # the reference's chunk, for the operation count


def _ssd_inputs(case, dtype, gen, with_h0=False):
    """x, B and C as strided slices of one (Bt, S, H * P + 2N) tensor, as
    the SSM block hands them over; dt in 0.01-0.2, A in -2..-0.5."""
    Bt, S, H, P, N = case
    conv = torch.randn((Bt, S, H * P + 2 * N), generator=gen,
                       device="cuda").to(dtype)
    x = conv[..., :H * P].reshape(Bt, S, H, P)
    B, C = conv[..., H * P:H * P + N], conv[..., H * P + N:]
    dt = (torch.rand((Bt, S, H), generator=gen, device="cuda") * 0.19
          + 0.01).to(dtype)
    A = -(torch.rand((H,), generator=gen, device="cuda") * 1.5 + 0.5)
    h0 = (torch.randn((Bt, H, P, N), generator=gen, device="cuda")
          if with_h0 else None)
    return x, dt, A, B, C, h0


def _ssd_err(got, want, dtype, what):
    """max |kernel - plain| over y and h, failing past tol * max(1, max
    |plain|)."""
    return max(_attn_err(g, w, dtype, f"{what} {name}", SSD_TOL)
               for g, w, name in zip(got, want, "yh"))


def _ssd_work(case, elem=2, with_h0=False):
    """(bytes, flops): x, dt, B and C read and y written once in ``elem``
    bytes, A and h0 read and h written once in float32; the chunked
    form's 2 T (N + P) + 4 P N flops per (step, head) at the reference's
    chunk T = 128."""
    Bt, S, H, P, N = case
    n_bytes = elem * (2 * Bt * S * H * P + 2 * Bt * S * N + Bt * S * H) \
        + 4 * H + 4 * Bt * H * P * N * (2 if with_h0 else 1)
    T = SSD_REF_CHUNK
    return n_bytes, Bt * S * H * (2 * T * (N + P) + 4 * P * N)


def phase_ssd(dev):
    from repro_torch.kernels import ref, ssd_scan

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    err = 0.0
    checks = [(SSD_BUCKET, torch.bfloat16, False),
              (SSD_HYMBA, torch.bfloat16, False)]
    H, P, N = SSD_BUCKET[2:]
    checks += [((2, S, H, P, N), dtype, h0) for S in SSD_LENGTHS
               for dtype in (torch.float32, torch.bfloat16)
               for h0 in (False, True)]
    for case, dtype, with_h0 in checks:
        x, dt, A, B, C, h0 = _ssd_inputs(case, dtype, gen, with_h0)
        got = ssd_scan.ssd_scan(x, dt, A, B, C, h0)
        want = ref.ssd_chunked(x, dt, A, B, C, h0)
        err = max(err, _ssd_err(got, want, dtype, f"ssd_scan {case} {dtype} "
                                f"h0={with_h0}"))
        del x, dt, B, C, h0, got, want
    # a sequence split in two, the state carried across, equals the whole
    for dtype in (torch.float32, torch.bfloat16):
        x, dt, A, B, C, _ = _ssd_inputs((2, 1000, H, P, N), dtype, gen)
        y, h = ssd_scan.ssd_scan(x, dt, A, B, C)
        y1, h1 = ssd_scan.ssd_scan(x[:, :333], dt[:, :333], A, B[:, :333],
                                   C[:, :333])
        y2, h2 = ssd_scan.ssd_scan(x[:, 333:], dt[:, 333:], A, B[:, 333:],
                                   C[:, 333:], h1)
        err = max(err, _ssd_err((torch.cat([y1, y2], 1), h2), (y, h), dtype,
                                f"ssd_scan split at 333 {dtype}"))
    torch.cuda.synchronize()
    print(f"[kernels] ssd_scan within tolerance at the mamba2 bucket "
          f"{SSD_BUCKET}, hymba's {SSD_HYMBA} (bf16, strided), S in "
          f"{list(SSD_LENGTHS)} with and without h0, float32 and bf16, and "
          f"a split at 333 of 1000 steps: max |kernel - plain| = {err:.3g}")

    # both buckets, the design the kernel picks (tensor cores) and the
    # CUDA-core one beside it, in turns
    t = {}
    for name, case in (("mamba2", SSD_BUCKET), ("hymba", SSD_HYMBA)):
        x, dt, A, B, C, _ = _ssd_inputs(case, torch.bfloat16, gen)

        def run(design):
            return cuda_ms(lambda: ssd_scan.ssd_scan(x, dt, A, B, C,
                                                     design=design),
                           iters=5, reps=2)
        tc = [run("tensor_core"), run("cuda_core"), run("cuda_core"),
              run("tensor_core")]
        t[name] = {"ms": min(tc[0], tc[3]), "cuda_core_ms": min(tc[1:3]),
                   "bound": bound_ms(*_ssd_work(case),
                                     ops_per_s=TENSOR_BF16_FLOPS)}
        if name == "mamba2":
            plain_ms = cuda_ms(lambda: ref.ssd_chunked(x, dt, A, B, C),
                               iters=2, reps=2)
        del x, dt, B, C
    (b, by), m, hy = t["mamba2"]["bound"], t["mamba2"], t["hymba"]
    row = dict(
        name="ssd_scan", route="cuda",
        design="bf16 at P, N multiples of 16: a G = C B^T launch per "
               "(sequence, chunk), then tensor cores over a 2-stage cp.async "
               "ring, two heads a CTA (wgmma at P = 64, N = 64/128; mma.sync "
               "else); float32 and P or N = 8: CUDA cores",
        source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan.py:82", max_abs_err=err,
        bound_ms=b, bound_by=by, ms=m["ms"], plain_ms=plain_ms,
        library_ms=None, cuda_core_ms=m["cuda_core_ms"],
        hymba_ms=hy["ms"], hymba_cuda_core_ms=hy["cuda_core_ms"],
        hymba_bound_ms=hy["bound"][0])
    print(f"[kernels] ssd_scan at {SSD_BUCKET} bf16: device {m['ms']:.5f}"
          f" ms (the CUDA-core design {m['cuda_core_ms']:.5f} ms), bound "
          f"{b:.5f} ms ({by}; {100 * b / m['ms']:.1f}% of it), plain "
          f"{plain_ms:.5f} ms, library none (no PyTorch call computes the "
          "SSD scan)")
    print(f"[kernels] ssd_scan at hymba's {SSD_HYMBA} bf16: device "
          f"{hy['ms']:.5f} ms (the CUDA-core design "
          f"{hy['cuda_core_ms']:.5f} ms), bound {hy['bound'][0]:.5f} ms "
          f"({hy['bound'][1]})")
    return row


# ---------------------------------------------------------------- phase 8
SERVE_SLOTS = 16
SERVE_MAX_LEN = 2048
SERVE_REQUESTS = 48


def serve_requests(n, vocab, seed, plen=(64, 1024), new=(32, 128)):
    """``n`` requests from ``seed``: prompt lengths and new-token counts
    uniform in the closed ranges, token ids uniform in [3, vocab), no
    eos."""
    from repro_torch.serving import Request

    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        p = rng.randint(3, vocab, rng.randint(plen[0], plen[1] + 1))
        out.append(Request(prompt=p.astype(np.int32),
                           max_new_tokens=int(rng.randint(new[0],
                                                          new[1] + 1))))
    return out


def predicted_epochs(max_new, n_slots):
    """Decode epochs the server's bookkeeping gives for requests with these
    ``max_new_tokens`` and no eos: FIFO admission into free slots, each
    request holding its slot for max_new_tokens epochs."""
    queue, left, epochs = list(max_new), [0] * n_slots, 0
    while queue or any(left):
        for s in range(n_slots):
            if not left[s] and queue:
                left[s] = queue.pop(0)
        epochs += 1
        left = [max(0, x - 1) for x in left]
    return epochs


def _serve_run(srv, reqs, vocab):
    """Serve ``reqs`` to completion; check each request and that every
    epoch's logits were finite.  Returns the wall seconds."""
    for r in reqs:
        srv.submit(r)
    finite = torch.ones((), dtype=torch.bool, device=srv.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while srv.queue or srv.active.any():
        srv.step()
        finite &= torch.isfinite(srv.last_logits[:, :vocab]).all()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not bool(finite):
        fail("serve: non-finite logits in a decode epoch")
    for r in reqs:
        if len(r.output) != r.max_new_tokens:
            fail(f"serve: request {r.rid} made {len(r.output)} tokens, "
                 f"asked for {r.max_new_tokens}")
        if not all(0 <= t < vocab for t in r.output):
            fail(f"serve: request {r.rid} made a token outside the vocab")
    return wall


def _serve_cell(cfg, n_requests, tag):
    """Serve ``n_requests`` of the phase 8 mix (seed 0) on ``cfg`` on the
    card, 16 slots of 2048 rows, random weights from seed 0: one short
    request first, so cuBLAS and the kernels' first launches are not
    charged to the timed run, then every kernel's count set to 0 and the
    run.  Checks every output, finite logits and the epochs the
    bookkeeping predicts; returns (server, model, epochs, prefills, the
    run's launches)."""
    from repro_torch.kernels import (
        decode_attention, flash_attention, fork_compact, ssd_scan,
    )
    from repro_torch.models import init_model
    from repro_torch.serving import EpochServer, Request

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_model(cfg, seed=0, device="cuda")
    srv = EpochServer(cfg, model, n_slots=SERVE_SLOTS,
                      max_len=SERVE_MAX_LEN, device="cuda")
    torch.cuda.synchronize()
    mixer = {"attn": f"{cfg.n_heads}/{cfg.n_kv_heads} heads of "
                     f"{cfg.resolved_head_dim}"}.get(cfg.block)
    if mixer is None:
        s = cfg.ssm
        mixer = (f"{cfg.block}: {s.n_heads(cfg.d_model)} SSM heads of P = "
                 f"{s.headdim}, N = {s.d_state}, d_inner "
                 f"{s.d_inner(cfg.d_model)}")
        if cfg.block == "hybrid":
            mixer += (f" ∥ {cfg.n_heads}/{cfg.n_kv_heads} attention heads "
                      f"of {cfg.resolved_head_dim}")
    print(f"[{tag}] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {mixer}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; "
          f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B "
          f"parameters drawn on the card and the {SERVE_SLOTS}-slot cache "
          f"allocated in {time.perf_counter() - t0:.1f} s")
    _serve_run(srv, [Request(prompt=np.arange(3, 67, dtype=np.int32),
                             max_new_tokens=4)], cfg.vocab)
    reqs = serve_requests(n_requests, cfg.vocab, seed=0)
    warm_epochs = srv.epochs
    srv.timings.update(prefill_s=0.0, decode_s=0.0, prefills=0)
    mods = (fork_compact, flash_attention, decode_attention, ssd_scan)
    for mod in mods:
        mod.reset_launches()
    wall = _serve_run(srv, reqs, cfg.vocab)
    launches = {"fork_scan": fork_compact.LAUNCHES["fork_scan"],
                **flash_attention.LAUNCHES, **decode_attention.LAUNCHES,
                **ssd_scan.LAUNCHES}
    epochs = srv.epochs - warm_epochs
    want = predicted_epochs([r.max_new_tokens for r in reqs], SERVE_SLOTS)
    if epochs != want:
        fail(f"{tag}: {epochs} decode epochs, the bookkeeping predicts "
             f"{want}")
    n_pf = srv.timings["prefills"]
    print(f"[{tag}] kernel launches during the run: {launches}")
    n_tok = sum(len(r.output) for r in reqs)
    n_prompt = sum(len(r.prompt) for r in reqs)
    print(f"[{tag}] {n_requests} requests ({n_prompt} prompt tokens, "
          f"{n_tok} generated) in {epochs} decode epochs (predicted {want}) "
          f"and {n_pf} prefills: wall {wall:.3f} s, {n_tok / wall:.1f} "
          f"generated tokens/s, prefill {srv.timings['prefill_s']:.3f} s "
          f"({100 * srv.timings['prefill_s'] / wall:.1f}% of the wall), "
          f"decode {srv.timings['decode_s']:.3f} s "
          f"({1e3 * srv.timings['decode_s'] / epochs:.2f} ms per epoch), "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return srv, model, epochs, n_pf, launches


def _expect_launches(tag, launches, want):
    """Fail unless every kernel's count equals ``want``'s."""
    bad = {k: (launches[k], n) for k, n in want.items() if launches[k] != n}
    if bad:
        fail(f"{tag}: launches (got, want) {bad}")


def _profile_epoch(label, srv, model, cfg):
    """One decode epoch (phase 2 of step) under the profiler."""
    import types

    from repro_torch.models import decode_step

    toks = torch.as_tensor(srv.last_token[:, None], device="cuda")

    def one_epoch():
        logits, _ = decode_step(model, cfg, toks, srv.cache)
        logits.argmax(-1).cpu()
        return None, None, types.SimpleNamespace(epochs=1)

    one_epoch()
    busy, wall, events = phase_profile(label, one_epoch)
    attn = device_us(events, "decode_split", "decode_combine")
    print(f"[profile]   device time per decode epoch {busy / 1e3:.3f} ms "
          f"(wall {wall / 1e3:.3f} ms), decode_attention {attn / 1e3:.3f} "
          f"ms of it ({100 * attn / busy:.1f}%)")


def _profile_prefill(label, srv, model, cfg, kernel="flash_attention",
                     names=("flash_",)):
    """One prefill of the full bucket (every slot, 1024 tokens) into the
    server's cache under the profiler: the share of it of ``kernel``, whose
    device kernels' names contain one of ``names``."""
    import types

    from repro_torch.models import prefill

    gen = torch.Generator(device="cuda").manual_seed(2)
    toks = torch.randint(3, cfg.vocab, (SERVE_SLOTS, 1024), generator=gen,
                         device="cuda")
    slots = torch.arange(SERVE_SLOTS, device="cuda")

    def one_prefill():
        logits, _ = prefill(model, cfg, toks, cache=srv.cache, slots=slots)
        logits.argmax(-1).cpu()
        return None, None, types.SimpleNamespace(epochs=1)

    one_prefill()
    busy, wall, events = phase_profile(label, one_prefill)
    attn = device_us(events, *names)
    print(f"[profile]   {kernel} {attn / 1e3:.3f} ms of the "
          f"prefill's {busy / 1e3:.3f} ms of device time "
          f"({100 * attn / busy:.1f}%) and {wall / 1e3:.3f} ms of wall "
          f"({100 * attn / wall:.1f}%)")


def _card_vs_cpu(cfg, tag):
    """The card against the CPU, float32 compute, 2 layers at full width:
    equal tokens, completion order and epochs, and the first decode
    epoch's logits within 1e-3."""
    import copy
    import dataclasses

    from repro_torch.models import init_model
    from repro_torch.serving import EpochServer

    cfg32 = dataclasses.replace(cfg, n_layers=2, compute_dtype=torch.float32)
    cpu_model = init_model(cfg32, seed=1, device="cpu")
    runs = {}
    for dev in ("cuda", "cpu"):
        m = copy.deepcopy(cpu_model).to(dev) if dev == "cuda" else cpu_model
        srv = EpochServer(cfg32, m, n_slots=4, max_len=256, device=dev)
        reqs = serve_requests(6, cfg.vocab, seed=1, plen=(16, 200),
                              new=(8, 8))
        for r in reqs:
            srv.submit(r)
        t0 = time.perf_counter()
        srv.step()
        first = srv.last_logits[:, :cfg.vocab].cpu()
        srv.run_to_completion()
        runs[dev] = ([(r.rid, r.output) for r in srv.completed], srv.epochs,
                     first, time.perf_counter() - t0)
        del srv, m
    (g_out, g_ep, g_lg, g_s), (c_out, c_ep, c_lg, c_s) = (runs["cuda"],
                                                          runs["cpu"])
    lg_err = float((g_lg - c_lg).abs().max())
    if g_out != c_out or g_ep != c_ep:
        fail(f"{tag} float32: the card's tokens {g_out} (epochs {g_ep}) "
             f"differ from the CPU's {c_out} (epochs {c_ep})")
    if not lg_err <= 1e-3:
        fail(f"{tag} float32: first decode epoch's logits differ by "
             f"{lg_err}")
    print(f"[{tag}] {cfg.name} float32, 2 layers at full width, 6 requests "
          f"in 4 slots: card and CPU give equal tokens per request, "
          f"completion order and {g_ep} epochs; first decode epoch's logits "
          f"within {lg_err:.3g} (card {g_s:.2f} s, CPU {c_s:.2f} s)")


def phase_serve():
    from repro_torch import configs

    cfg = configs.get_config("granite_3_8b")
    srv, model, epochs, n_pf, launches = _serve_cell(cfg, SERVE_REQUESTS,
                                                     "serve")
    L = cfg.n_layers
    _expect_launches("serve", launches, {
        "fork_scan": n_pf, "flash_attention": n_pf * L,
        "decode_attention": epochs * L, "ssd_scan": 0})
    _profile_epoch(f"{cfg.name} decode epoch, 16 slots (one epoch)", srv,
                   model, cfg)
    # after the run and its profile: this overwrites the slots' caches
    _profile_prefill(f"{cfg.name} prefill, 16 x 1024 tokens (one bucket)",
                     srv, model, cfg)
    del srv, model
    torch.cuda.empty_cache()
    _card_vs_cpu(cfg, "serve")
    return launches


# ---------------------------------------------------------------- phase 9
HYMBA_REQUESTS = 16


def phase_ssm_serve():
    """The SSM serving path: mamba2-1.3b (every prefill layer one ssd_scan
    launch, no attention kernel), its float32 card-vs-CPU run, and the
    hybrid hymba-1.5b (attention ∥ SSM in every layer)."""
    from repro_torch import configs

    cfg = configs.get_config("mamba2_1_3b")
    srv, model, epochs, n_pf, launches = _serve_cell(cfg, SERVE_REQUESTS,
                                                     "ssm")
    L = cfg.n_layers
    _expect_launches("ssm", launches, {
        "fork_scan": n_pf, "ssd_scan": n_pf * L, "flash_attention": 0,
        "decode_attention": 0})
    _profile_epoch(f"{cfg.name} decode epoch, 16 slots (one epoch)", srv,
                   model, cfg)
    _profile_prefill(f"{cfg.name} prefill, 16 x 1024 tokens (one bucket)",
                     srv, model, cfg, "ssd_scan", ("ssd_",))
    del srv, model
    torch.cuda.empty_cache()
    _card_vs_cpu(cfg, "ssm")

    hcfg = configs.get_config("hymba_1_5b")
    srv, model, h_epochs, h_pf, h_launches = _serve_cell(
        hcfg, HYMBA_REQUESTS, "hybrid")
    L = hcfg.n_layers
    _expect_launches("hybrid", h_launches, {
        "fork_scan": h_pf, "ssd_scan": h_pf * L, "flash_attention": h_pf * L,
        "decode_attention": h_epochs * L})
    del srv, model
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.core import DeviceEngine

    dev = torch.device("cuda")
    print("[env]", sys.version.split()[0], "torch", torch.__version__,
          "cuda", torch.version.cuda, torch.cuda.get_device_name(0))
    t0 = time.perf_counter()
    phase_build()
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 is float32
    torch.backends.cudnn.allow_tf32 = False
    rows = phase_kernels(dev)
    rows.append(phase_fleet_chunks(dev, phase_chunks(dev)))
    rows.append(phase_ordered_add(dev))
    rows += phase_attention(dev)
    rows.append(phase_ssd(dev))
    launches, cases, host_runs = phase_path()
    app_launches = phase_apps(cases)
    fib_case = cases[0][0]
    phase_profile("fib HostEngine masked",
                  lambda: fib_case.run(dispatch="masked", device="cuda"))
    launches.update(phase_resident(cases, host_runs))
    # epoch_chunk's count: the resident path's launches and the apps'
    chunk_paths = {"resident": launches["epoch_chunk"],
                   "apps": app_launches["epoch_chunk"]}
    launches["epoch_chunk"] += app_launches["epoch_chunk"]
    # the ordered add's: matmul's HostEngine and plain resident runs
    launches["ordered_add"] = app_launches["ordered_add"]
    ordered_paths = {"apps": app_launches["ordered_add"]}
    for case, _ in cases:
        busy, wall, _ = phase_profile(
            f"{case.name} DeviceEngine(megakernel=True) masked",
            lambda: case.run(engine_cls=DeviceEngine, dispatch="masked",
                             device="cuda", megakernel=True))
        print(f"[profile] {case.name} resident busy share "
              f"{100 * busy / wall:.1f}% (one-CTA kernel: "
              f"{ONE_CTA_RESIDENT_BUSY.get(case.name, 'not measured')})")
    svc_launches, svc_chunks, wave = phase_service(cases, host_runs)
    chunk_paths["service"] = svc_chunks
    launches["epoch_chunk"] += svc_chunks
    launches["segmented_fork_scan"] = svc_launches["segmented_fork_scan"]
    # type_rank's count: the host path's launches, the apps' and the
    # service waves'
    type_rank_paths = {"host": launches["type_rank"],
                       "apps": app_launches["type_rank"],
                       "service": svc_launches["type_rank"]}
    launches["type_rank"] += (app_launches["type_rank"]
                              + svc_launches["type_rank"])
    fork_scan_paths = {"host": launches["fork_scan"],
                       "apps": app_launches["fork_scan"]}
    launches["fork_scan"] += app_launches["fork_scan"]

    def masked_wave():
        svc, _, _ = run_wave(wave, "masked")
        return None, None, svc.stats()

    phase_profile("mixed4 JobService masked (global epochs)", masked_wave)

    def device_wave():
        svc, _, _ = run_wave(wave, "masked", engine="device",
                             megakernel=True)
        return None, None, svc.stats()

    busy, wall, _ = phase_profile(
        "mixed4 JobService(engine='device', megakernel=True) masked, one "
        "chunk (global epochs)", device_wave)
    print(f"[profile] mixed4 device wave busy share "
          f"{100 * busy / wall:.1f}%")
    serve_launches = phase_serve()
    # fork_scan's count: the host path's, the apps', the servers'
    fork_scan_paths["serve"] = serve_launches.pop("fork_scan")
    launches["fork_scan"] += fork_scan_paths["serve"]
    launches.update(flash_attention=serve_launches["flash_attention"],
                    decode_attention=serve_launches["decode_attention"])
    ssm_launches = phase_ssm_serve()
    fork_scan_paths["ssm"] = ssm_launches["fork_scan"]
    launches["fork_scan"] += fork_scan_paths["ssm"]
    launches["ssd_scan"] = ssm_launches["ssd_scan"]
    for r in rows:
        r["launches"] = launches[r["name"]]
        if r["name"] == "type_rank":
            r["launches_by_path"] = type_rank_paths
        if r["name"] == "fork_scan":
            r["launches_by_path"] = fork_scan_paths
        if r["name"] == "epoch_chunk":
            r["launches_by_path"] = chunk_paths
        if r["name"] == "ordered_add":
            r["launches_by_path"] = ordered_paths
    print(f"[env] all phases took {time.perf_counter() - t0:.1f} s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    print(smi.stdout.strip())
    keys = ("name", "route", "design", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [
        {**{k: r[k] for k in keys}, **{k: v for k, v in r.items()
                                       if k not in keys}} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
