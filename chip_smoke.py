#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; there is no CPU fallback):
  1. build    — compile the CUDA kernels from src/repro_torch/kernels/csrc
                (fork_compact.cu, epoch_megakernel.cu, ordered_add.cu,
                flash_attention.cu, flash_attention_bwd.cu,
                decode_attention.cu, ssd_scan.cu: one nvcc each, in
                parallel, each timed) into
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
                causal, windows 2048 and 0) in bf16 and float32, and at
                phase 8c's shapes in bf16: whisper's encoder (16 x 20
                heads, 1500 x 1500, non-causal) and cross-attention (1024
                queries over 1500 frames), llama4-scout's 40/8 heads of
                128 (causal), the encoder shape timed beside its bound and
                SDPA;
                decode_attention against decode_attention_ref at 16 x 32 q
                heads over a 2048-row cache with lengths 1, S - 1, S and
                above S, with and without a window, at hymba's group of 5
                (16 x 25 q heads over 5 kv heads, D = 64, windows 2048 and
                0), at yi-34b's group 7 (56 q heads over 8), at D = 16,
                at whisper's cross-attention (16 x 20 heads over 1500
                rows, every length 1500; timed beside its bound and SDPA)
                and at granite-moe's group 2 (16/8 heads of 64);
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
                masked and gather (annealing's and naive's, which take
                seconds, once masked at 20 steps and 2^8 keys; at full
                size phase 2 holds them to epoch_chunk and times both
                sides alike) and DeviceEngine(megakernel=True) masked and
                gather on CUDA, each megakernel wall printed beside the
                plain resident one (treewalk in both orders on phase 7's
                tree too); check each against its reference
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
  4. graphs   — (run after phase 7, on its wave) the host epoch steps as
                CUDA graph replays against the same steps run eagerly
                (graphs=False) on the card: fib(28) on HostEngine masked,
                compacted and gather, annealing masked, and the full-size
                mixed4 host wave masked and gather; each eager and
                graphed: a fresh engine's (or JobService's: phase 7's)
                first run, where a key runs eagerly at its first two uses
                and is captured at its third, a second and third run and
                a warm fourth (no capture: the same engine, or the next
                wave on the same service, which runs on the last wave's
                loop and buffers); heaps, values and RunStats (each
                tenant's, the fleet's) equal; walls (fib's the medians of
                three fresh engines), captures, the graph pool's and
                result buffers'
                bytes, and fib's eager uses, captures and first replays
                timed alone (no profiles: PERF.md keeps the earlier
                runs' busy shares and device ops).  Annealing's eager run runs 20 of its 200
                steps, held exactly to a fresh graphed engine's five runs
                of those 20 steps, and its graphed runs of all 200 steps
                are held to phase 3b's masked run.  A lap is printed after
                each sub-step.
                Phases 3, 3b, 7, 8 and 9 run on graphs, the default;
  4b. control — (run after phase 4) CostModel.calibrated on the card (a
                graph replay's round trip; the per-lane slopes of a masked
                fib epoch and of the gather pack pass between 2^18 and
                2^21 lanes), printed beside the card's name and power
                limit; HostEngine(dispatch="auto") with the calibrated
                model on phase 3's three cases, four runs of one engine
                each, held to the masked and CPU runs (heaps, values, the
                RunStats fields no mode changes), decisions and captures
                per run, then rounds of one warm run of every engine in a
                rotating order (median, min and max of each), and the
                controller's own time (choose and observe) per epoch; the
                full-size mixed4 wave through JobService(engine="host",
                dispatch="auto") and JobService(engine="device",
                chunk="auto", megakernel=True), each tenant against its
                solo run, the decisions and the K trajectory; mode flips
                on graphs: four waves of two fib tenants at the two ends of
                a sparse TV on one JobService(dispatch="auto") under the
                reference's priors (masked -> gather) and under a cheap
                pack limited to masked and compacted, each wave's
                decisions and tenants equal to the same service's on the
                CPU and the tenants to a masked wave, the captures per
                wave; a SpanTracer on a graphed fib(28) engine (the same
                captures and bits as untraced, one epoch/dispatch/readback
                span an epoch, the trees:epoch_step range in
                torch.profiler's events, walls on and off) and on a K=4
                device wave (ceil(E/K) readback spans), both traces valid.
                Every auto run's and traced run's launches are counted
                from 0 around that run alone (paths "control", "trace")
                and must equal what its decisions call for: fork_scan one
                an epoch of a solo run, segmented_fork_scan one an epoch of
                a wave, type_rank one a gather or compacted epoch,
                epoch_chunk one a chunk;
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
                and one unbounded device wave under torch.profiler;
  7b. sharded — JobService(engine="sharded", chunk=4) on two copies of
                phase 7's full-size mixed4 wave (8 jobs, 7,602,176 slots a
                shard): the fleet epoch_chunk at P = 1, 2 and 4, masked and
                gather, and the plain fleet loop at P = 2, gather; then two
                copies each of the registry's mixed3 and fib_fleet at P = 2
                under sticky placement with rebalancing (migrations above
                0); every job held to its solo run on the card (phase 7's,
                held to the CPU), the per-shard task and fork sums to the
                solo totals, one dispatch and readback per collective
                step; for each P the wall, collective steps, epoch_chunk
                launches, set-up and seating time, carry bytes a shard and
                peak device memory, and that epoch_chunk (and, on the plain
                run, segmented_fork_scan and type_rank) was launched;
  8. serve    — drive EpochServer on granite-3-8b at full width and depth
                (40 layers, bf16, random weights from seed 0) with 16 slots
                of 2048 rows: 48 requests, prompts of 64-1024 tokens, 32-128
                new tokens each; check every output, finite logits, the
                epoch count the host bookkeeping predicts, and that
                flash_attention, decode_attention and fork_scan were
                launched during the run; one full-bucket prefill (16 x 1024
                tokens; flash_attention's share) under torch.profiler; 8
                decode epochs of 16 requests on a graphed and an eager
                server (first and second (eager), third (the capture) and
                warm epoch walls, the decode graph's capture and bytes, busy share,
                device ops and
                decode_attention's time per epoch under torch.profiler,
                a graphed profile with fewer device ops than the eager
                one's taken again over the next 8 epochs, up to 3
                windows; equal tokens); then the same model at 2 layers in float32
                on the card (graphed and eager: equal tokens and logits)
                and on the CPU from the same weights (equal tokens, the
                first and fourth (a replay) decode
                epochs' logits within 1e-3; the CPU runs of phases 8, 9
                and 8c in the background process);
  9. ssm      — drive EpochServer on mamba2-1.3b at full width and depth
                (48 layers, bf16, random weights from seed 0) with phase
                8's slots and request mix; check every output, finite
                logits, the predicted epochs, ssd_scan launched once per
                layer of every prefill, fork_scan once per prefill and no
                attention kernel; one full-bucket prefill (16 x 1024
                tokens; ssd_scan's share) under torch.profiler and phase
                8's 8 graphed and eager decode epochs; the same model at 2
                layers in float32 on the card (graphed and eager) and on
                the CPU (equal tokens, the first and fourth decode epochs'
                logits within 1e-3); then hymba-1.5b (attention ∥ SSM,
                32 layers) at full width and depth on 16 requests,
                flash_attention and
                ssd_scan once per layer of every prefill, decode_attention
                once per layer of every epoch, and its 2-layer float32 runs
                on the card (graphed and eager) and the CPU;
  8c. moe and encoder-decoder serve — EpochServer, bf16, random weights
                from seed 0, 16 slots, on granite-moe-1b-a400m at full
                size (24 layers, 32 experts top-8; phase 8's 48
                requests), llama4-scout-17b-a16e at full width and 12 of
                its 48 layers (16 experts top-1 + a shared one; 16
                requests of the mix) and whisper-large-v3 at full size
                (32 encoder and 32 decoder layers, one frame input of 1500
                x 1280 from seed 0 shared by the slots; 32 requests of
                4-64 prompt tokens and 32-128 new, 512 rows): phase 8's
                checks, the launches the code predicts (MoE:
                flash_attention once per layer of a prefill,
                decode_attention once per layer of an epoch; whisper: a
                prefill's encoder, self- and cross-attention, an epoch's
                self and cross decodes; fork_scan once per prefill,
                ssd_scan never), granite-moe's 8 graphed and eager decode
                epochs (one capture, equal tokens, profiles), and each
                model's float32 card-vs-CPU runs (granite-moe and whisper
                at 2 layers, llama4-scout at 1 layer on 2 requests of
                16-32 prompt tokens and 4 new);
  8d. train  — train_granite_d12: make_train_step on granite-3-8b at
                full width and 12 of its 40 layers (2.59 B float32
                parameters, bf16 compute, remat "full"), 5 steps of
                SyntheticLM batches of 4 x 2048 (seed 0) under AdamW over
                cosine_schedule(3e-3, 10, 5): every kernel's count set to
                0 before the steps and read after (flash_attention twice a
                layer a step, forward and remat; flash_attention_bwd's
                three launches once a layer a step; fork_scan,
                decode_attention and ssd_scan never); each step's loss and
                grad norm finite, every parameter's gradient present and
                finite and every parameter moved; ms a step, tokens/s,
                peak memory (under 72 GiB); a sixth step under
                torch.profiler (the backward kernels' share of device
                time); then one layer at full width in float32, 1 x 256
                tokens, 2 steps from the same weights on the card and on
                the CPU (the background process): losses and grad norms
                within 1e-4, each step-1 gradient within 1e-3 of its max
                |CPU value|, the parameters after step 2 within the bound
                Adam's sign steps allow (TRAIN_MOVED_FRACTION);
                phase 2 also holds flash_attention_bwd to
                mha_backward_ref (and the forward's lse to the plain
                logsumexp) at the training shape (4 x 32/8 heads x 2048,
                D 128, causal, bf16), granite-moe's 16/8 heads of 64 with
                a window of 512 (bf16) and 1 x 32/8 x 256 in float32, and
                times it beside its bound, its plain version and SDPA's
                backward;
  10. examples — the twins of the examples (examples/*_torch.py) on the
                card, each a subprocess with its default arguments, all
                started at once: quickstart, graph_analytics, serve_llm
                (the toy decode program on the device engine), serve_llm
                --legacy (reduced granite-3-8b: flash_attention and
                decode_attention), --legacy --arch mamba2_1_3b
                (ssd_scan), --legacy --arch granite_moe_1b_a400m (the
                MoE layer) and --legacy --arch whisper_large_v3 (the
                encoder and cross-attention); each must exit 0 and print
                its checks' lines.
The full-size CPU runs of phases 3, 3b and 5 are computed in one
background process (CPU_REF_THREADS threads) while the card runs phases
2-5, and the float32 CPU runs of phases 8, 9, 8c and 8d in the same
process beside the serving phases.
A kernel's launches count what ran on the card: a graph's capture adds
none, each replay adds the launches the graph holds.  Profiles whose
first attempt recorded no device activity are run again and named at
the end.
Then it prints the card's name and power limit, one JSON line describing
each kernel (with its design), and, last, ``{"ok": true, "device":
{...}}``.
It imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import functools
import io
import itertools
import json
import multiprocessing
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


_T0 = [0.0, 0.0]  # the script's start, the last lap


def lap(what: str) -> None:
    """Print the script's elapsed time after ``what``, and the time since
    the last lap."""
    now = time.perf_counter() - _T0[0]
    print(f"[env] {what} done at {now:.1f} s (+{now - _T0[1]:.1f} s)")
    _T0[1] = now


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


# ----------------------------------------------------- the CPU references
# The full-size CPU runs that the card's runs are held to take seconds
# each on the host: phase 3's masked HostEngine runs, phase 3b's, and
# phase 5's plain resident runs.  One background process computes them,
# on CPU_REF_THREADS intra-op threads, from the end of phase 1 on, while
# the card runs phases 2-5; each phase waits for its own and prints the
# run's line where the run used to be.  The card's walls of phases 2-5
# are taken with that process running beside them.  The servers' float32
# CPU runs (phases 8, 9, 8c: ("serve", arch, "float32"), CARD_VS_CPU) are
# queued when phase 8 starts, so they run beside the serving phases and
# not beside the host-bound phases 4, 4b and 7.
CPU_REF_THREADS = 3
CPU_REF_KEYS = (
    [("path", n, "masked") for n in ("fib", "bfs", "mergesort")]
    + [("apps", n, "masked") for n in ("sssp", "nqueens", "tsp", "fft",
                                       "matmul", "annealing", "naive")]
    + [("resident-plain", n, d) for n in ("fib", "bfs", "mergesort")
       for d in ("masked", "gather")])


def _cpu_ref(key):
    """(In the background process.)  One CPU reference run, ``key`` =
    ``(tag, case name, dispatch)``: its result and its printed line."""
    from repro_torch.core import DeviceEngine

    torch.set_num_threads(CPU_REF_THREADS)
    tag, name, dispatch = key
    if tag == "serve":
        return _cpu_float32_run(name)
    if tag == "train":
        return _cpu_train_run()
    kw = {}
    if tag == "apps":
        case, _ = app_case(name, APP_FULL[name])
    else:
        case = {c.name: c for c, _ in path_cases()}[name]
        if tag == "resident-plain":
            kw["engine_cls"] = DeviceEngine
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        r = _run(case, dispatch, "cpu", tag=tag, **kw)
    return r, out.getvalue()


class CpuRefs:
    """The background process of the CPU references (``CPU_REF_KEYS``,
    submitted in the order the phases need them)."""

    def __init__(self):
        self.pool = concurrent.futures.ProcessPoolExecutor(
            max_workers=1, mp_context=multiprocessing.get_context("spawn"))
        self.futures = {}
        self.submit(CPU_REF_KEYS)

    def submit(self, keys) -> None:
        """Queue more runs behind those submitted."""
        self.futures.update({k: self.pool.submit(_cpu_ref, k) for k in keys})

    def get(self, tag, name, dispatch):
        """The run of ``(tag, name, dispatch)``, its line printed now."""
        r, text = self.futures.pop((tag, name, dispatch)).result()
        print(text, end="")
        return r

    def close(self) -> None:
        """Stop the process, whatever it is running."""
        for p in list(getattr(self.pool, "_processes", {}).values()):
            p.terminate()
        self.pool.shutdown(wait=True, cancel_futures=True)


CPU_REFS = []  # the running CpuRefs, once phase 1 is done


def cpu_ref(tag, name, dispatch):
    return CPU_REFS[0].get(tag, name, dispatch)


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
    builds = [m.build for m in (fork_compact, epoch_megakernel, ordered_add,
                                flash_attention, decode_attention, ssd_scan)]
    builds.append(flash_attention.build_bwd)

    def timed_build(build):
        t = time.perf_counter()
        path, log = build(ptxas_info=True)
        return path, log, time.perf_counter() - t

    with ThreadPoolExecutor(len(builds)) as pool:
        built = list(pool.map(timed_build, builds))
    dt = time.perf_counter() - t0
    for path, log, secs in built:
        print(f"[build] {path.name} in {secs:.2f} s")
        for name, info in ptxas_kernels(log):
            print(f"[build]   {name}: {info}")
    print(f"[build] {len(builds)} libraries built in {dt:.2f} s (in "
          "parallel)")


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
# The profiler loses the first and the last few device records of a
# session, the more the later in the process (seven minutes into a run on
# the H100: 28 of an eager 8-epoch decode window's 28,608 records, its
# first and last operations).  Every window runs between
# PROFILE_PAD_KERNELS spin kernels at each edge, outside its wall time and
# left out of its records, so that the losses fall on them; a profile's
# line prints how many of them were recorded.  They are one CUDA graph's
# replay (launched one by one under the profiler they cost up to a second
# a window), each spinning PAD_CYCLES, about 5 us.  Now and then a whole
# stretch of ~1,040 records goes at an edge: with 1,024 pads an edge, the
# windows it hit lost 5-39 records of their own.
PROFILE_PAD_KERNELS = 4096
PAD_CYCLES = 10_000
PAD_KERNEL = "spin_kernel"  # torch.cuda._sleep's
_PAD_GRAPH = []


def _pad_graph():
    """The graph of PROFILE_PAD_KERNELS spin kernels, captured at its first
    use (call it before the profiler starts)."""
    if not _PAD_GRAPH:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(PROFILE_PAD_KERNELS):
                torch.cuda._sleep(PAD_CYCLES)
        torch.cuda.synchronize()
        _PAD_GRAPH.append(g)
    return _PAD_GRAPH[0]


def _pad_kernels() -> None:
    _pad_graph().replay()
    torch.cuda.synchronize()


def device_ops(fn):
    """Names of the device operations (kernels, memsets, copies) one
    ``fn()`` call puts on the card, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    _pad_graph()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _pad_kernels()
        fn()
        torch.cuda.synchronize()
        _pad_kernels()
    return [e.name for e in prof.events()
            if e.device_type == DeviceType.CUDA and PAD_KERNEL not in e.name]


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
            out = {}
            wall = _wall_ms(lambda: out.setdefault(
                "r", run_chunks(plain, fresh.clone(), None)))
            want = out["r"][0]
            if size == "full" and case.name in PLAIN_IN_PHASE_2:
                # phase 3b's walls of these two: both sides timed alike
                RESIDENT_CHUNK_MS[case.name, d] = (
                    _wall_ms(lambda: run_chunks(kern, fresh.clone(), None)),
                    wall)
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
        cpu = runs[case.name, "cpu"] = cpu_ref("path", case.name, "masked")
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


# the apps whose plain resident runs take seconds at full size (annealing
# 14 s, naive 6.6 s a dispatch): phase 2 holds epoch_chunk to their plain
# loop carry tensor for carry tensor at full size and times both there
# alike, one unbounded chunk by run_chunks (RESIDENT_CHUNK_MS: (epoch_chunk
# ms, plain ms)); phase 3b runs the plain DeviceEngine once each, masked,
# at PLAIN_3B_SIZE, against the host path and the reference
RESIDENT_CHUNK_MS = {}
PLAIN_IN_PHASE_2 = ("annealing", "naive")
PLAIN_3B_SIZE = {"annealing": (16, 256, 20), "naive": 2**8}


def _resident_runs(name, case, check, mask, walls, runs):
    """The plain resident DeviceEngine (for PLAIN_IN_PHASE_2: once, masked,
    at PLAIN_3B_SIZE) and DeviceEngine(megakernel=True), masked and gather,
    against the masked HostEngine run ``mask`` (heaps, values,
    APP_INVARIANT) and the app's reference."""
    from repro_torch.core import DeviceEngine

    if name in PLAIN_IN_PHASE_2:
        small, small_check = app_case(name, PLAIN_3B_SIZE[name])
        want = _run(small, "masked", "cuda", tag="apps-resident")
        got = _run(small, "masked", "cuda", tag="apps-resident",
                   engine_cls=DeviceEngine)
        _same(got, want, f"{name} {PLAIN_3B_SIZE[name]} resident masked vs "
              "masked", fields=APP_INVARIANT)
        ok, detail = small_check(got[0], got[1])
        if not ok:
            fail(f"{name} {PLAIN_3B_SIZE[name]} resident masked: result "
                 f"differs from the reference ({detail})")
    for d in ("masked", "gather"):
        if name in PLAIN_IN_PHASE_2:
            continue
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
        if name in PLAIN_IN_PHASE_2:
            kern_ms, plain_ms = RESIDENT_CHUNK_MS[name, d]
            print(f"[apps] {name} {d}: megakernel wall {walls[key]:.1f} ms; "
                  f"phase 2's one-chunk run_chunks walls: epoch_chunk "
                  f"{kern_ms:.1f} ms, plain resident {plain_ms:.1f} ms")
            continue
        print(f"[apps] {name} {d}: megakernel wall "
              f"{walls[key]:.1f} ms, plain resident "
              f"{walls[name, 'resident ' + d]:.1f} ms")


def phase_apps(path_cases):
    """The six remaining apps and naive mergesort on the card: every
    HostEngine dispatch, the plain resident DeviceEngine and
    DeviceEngine(megakernel=True), against the references, each other and
    the CPU; treewalk in both orders on phase 7's tree on the masked
    HostEngine and both resident engines; then the paper's yardsticks.
    Returns the phase's launches and annealing's masked run (the graphs
    phase holds its graphed runs to it)."""
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
        cpu = cpu_ref("apps", name, "masked")
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
    return launches, runs["annealing", "masked"]


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
# the profiles that were taken again (the first attempt recorded no device
# activity, or a graphed one fewer device ops than its eager twin), printed
# at the end of the run
PROFILE_RETRIES = []
GRAPHED_PROFILE_ATTEMPTS = 3
def phase_profile(label, run, cpu=True):
    """Where the time goes: one run under ``torch.profiler`` (``cpu``:
    host operations traced too, else the device's alone)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    # a profile that records no device activity at all is run once more
    # and named in PROFILE_RETRIES (one of a 4 ms resident run, the first
    # profile after phase 5, once recorded none; the cause is not known);
    # a second empty one fails.  Partial records are caught where an
    # eager profile gives a floor (_decode_graphs)
    _pad_graph()
    for attempt in (1, 2):
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            _pad_kernels()
            t0 = time.perf_counter()
            _, _, stats = run()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
            _pad_kernels()
        # device-side events only (kernels, memcpy, memset): the host ops
        # that launched them carry the same time and would count it twice
        device = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        pads = sum(e.count for e in device if PAD_KERNEL in e.key)
        events = [e for e in device if e.self_device_time_total > 0
                  and PAD_KERNEL not in e.key]
        busy_us = sum(e.self_device_time_total for e in events)
        if busy_us > 0:
            break
        print(f"[profile] {label}: attempt {attempt} recorded no device "
              "activity")
        PROFILE_RETRIES.append(label)
    if busy_us <= 0:
        fail("the profiler saw no device time")
    n_kernels = sum(e.count for e in events)
    print(f"[profile] {label} (profiled): wall {wall_us:.0f} us, "
          f"device busy {busy_us:.0f} us ({100 * busy_us / wall_us:.1f}%), "
          f"{n_kernels} device ops, "
          f"{n_kernels / stats.epochs:.1f} per epoch; "
          f"{pads} of {2 * PROFILE_PAD_KERNELS} pad kernels recorded")
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
                plain = (_run(case, d, dev, tag="resident-plain",
                              engine_cls=DeviceEngine) if dev == "cuda"
                         else cpu_ref("resident-plain", case.name, d))
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
    # the masked and gather services: their first waves are the graphs
    # phase's first graphed waves, which runs two more on each
    host_waves = {}
    for d in ("masked", "compacted", "gather"):
        svc, handles, wall = run_wave(wave, d)
        if d != "compacted":
            host_waves[d] = (svc, wall * 1e3, [_tenant(h) for h in handles],
                             svc._mux.stats())
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
    return launches, chunk_launches, wave, host_waves


# --------------------------------------------------------------- phase 7b
# the sharded fleet on phase 7's full-size mixed4 wave: two copies (8
# jobs) at these shard counts, chunk K
SHARD_COUNTS = (1, 2, 4)
SHARDED_K = 4


def _sharded_run(label, members, quotas, dispatch, shards, want,
                 megakernel=True, **kw):
    """One JobService(engine="sharded") wave on the card: every member
    twice (``members`` AppCases, one copy's quotas the wave's capacity),
    each job held to ``want[name]`` (heap, values, solo-comparable stats),
    the per-shard task and fork sums to the solo totals, one dispatch and
    one readback per collective step.  Returns the fleet, its wall (ms),
    its set-up and seating times (ms: the shards' construction, and every
    boundary's seating, the card synchronised around each), the device
    memory allocated before the wave (GiB) and the epoch_chunk launches of
    the wave."""
    import gc

    from repro_torch.distributed import fleet as dfleet
    from repro_torch.kernels import epoch_megakernel
    from repro_torch.service import JobService

    spent = {"set-up": [], "seating": []}
    init0, seat0 = dfleet.ShardWave.__init__, dfleet.ShardedFleet._seat_pending

    def timed(fn, what):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spent[what].append(time.perf_counter() - t0)
            return out
        return run

    svc = JobService(capacity=sum(quotas), max_jobs=len(members),
                     engine="sharded", shards=shards, chunk=SHARDED_K,
                     dispatch=dispatch, megakernel=megakernel,
                     device="cuda", **kw)
    handles = [svc.submit_case(c, quota=q, name=f"{c.name}#{r}")
               for r in range(2) for c, q in zip(members, quotas)]
    gc.collect()  # the last wave's services
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    k0 = epoch_megakernel.LAUNCHES["epoch_chunk"]
    dfleet.ShardWave.__init__ = timed(init0, "set-up")
    dfleet.ShardedFleet._seat_pending = timed(seat0, "seating")
    try:
        t0 = time.perf_counter()
        svc.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        dfleet.ShardWave.__init__ = init0
        dfleet.ShardedFleet._seat_pending = seat0
    fl = svc._mux
    launches = epoch_megakernel.LAUNCHES["epoch_chunk"] - k0
    for h in handles:
        if h.status.value != "done":
            fail(f"sharded {label} {h.job.name}: {h.status} {h.error}")
        _same_tenant(_tenant(h), want[h.job.name.split("#")[0]],
                     f"sharded {label} {h.job.name} vs its solo run")
    per = fl.shard_stats()
    for f in ("tasks_executed", "total_forks"):
        solo = 2 * sum(getattr(want[c.name][2], f) for c in members)
        if sum(getattr(s, f) for s in per) != solo:
            fail(f"sharded {label}: per-shard {f} "
                 f"{[getattr(s, f) for s in per]} do not sum to the solo "
                 f"total {solo}")
    fs = fl.stats()
    if not fs.dispatches == fs.scalar_transfers == fl.collective_steps:
        fail(f"sharded {label}: {fs.dispatches} dispatches and "
             f"{fs.scalar_transfers} transfers for {fl.collective_steps} "
             "collective steps")
    if megakernel and not (fl.collective_steps <= launches
                           <= shards * fl.collective_steps):
        fail(f"sharded {label}: {launches} epoch_chunk launches for "
             f"{fl.collective_steps} collective steps of {shards} shards")
    return (fl, wall * 1e3, {k: sum(v) * 1e3 for k, v in spent.items()},
            before, launches)


def phase_sharded(wave, runs):
    """JobService(engine="sharded", chunk=4) on the card: two copies of
    phase 7's full-size mixed4 wave at P = 1, 2 and 4 on the fleet
    epoch_chunk, masked and gather, and at P = 2 on the plain fleet loop,
    gather; then two copies each of the registry's mixed3 and fib_fleet at
    P = 2 under sticky placement with rebalancing (migrations above 0).
    Every job is held to its solo run on the card (phase 7's ``runs``,
    held to the CPU there).  Returns the phase's launches of epoch_chunk,
    segmented_fork_scan and type_rank."""
    from repro_torch.apps import get_fleet
    from repro_torch.kernels import epoch_megakernel, fork_compact

    torch.cuda.synchronize()
    epoch_megakernel.reset_launches()
    fork_compact.reset_launches()
    quotas = [c.capacity for c in wave]
    walls = {}
    for d in ("masked", "gather"):
        want = {c.name: runs[c.name, d] for c in wave}
        for P in SHARD_COUNTS:
            fl, wall, spent, before, n = _sharded_run(
                f"mixed4 x2 {d} P={P}", wave, quotas, d, P, want)
            carry = fl._shards[0]._carry
            nbytes = sum(t.numel() * t.element_size()
                         for t in _carry_tensors(carry).values())
            walls[d, P] = wall
            print(f"[sharded] mixed4 x2 epoch_chunk {d:6s} P={P}: wall "
                  f"{wall:.1f} ms, {fl.collective_steps} collective steps, "
                  f"{n} epoch_chunk launches, set-up {spent['set-up']:.1f} "
                  f"ms ({spent['set-up'] / P:.1f} a shard), seating "
                  f"{spent['seating']:.1f} ms, migrations {fl.migrations}, "
                  f"carry {nbytes / 2**20:.1f} MiB a shard, peak device "
                  f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
                  f"GiB ({before:.2f} GiB before the wave); every job "
                  "equal to its solo run")
        print(f"[sharded] mixed4 x2 {d}: wall P=2 / P=1 "
              f"{walls[d, 2] / walls[d, 1]:.3f}, P=4 / P=1 "
              f"{walls[d, 4] / walls[d, 1]:.3f} (the shards run one after "
              "another on one card)")
    want = {c.name: runs[c.name, "gather"] for c in wave}
    s0 = dict(fork_compact.LAUNCHES)
    fl, wall, spent, _, _ = _sharded_run(
        "mixed4 x2 plain gather P=2", wave, quotas, "gather", 2, want,
        megakernel=False)
    plain = {k: fork_compact.LAUNCHES[k] - s0[k]
             for k in ("segmented_fork_scan", "type_rank")}
    print(f"[sharded] mixed4 x2 plain fleet loop gather P=2: wall "
          f"{wall:.1f} ms, {fl.collective_steps} collective steps, set-up "
          f"{spent['set-up']:.1f} ms, seating {spent['seating']:.1f} ms, "
          f"kernel launches {plain}; every job equal to its solo run")
    for k, n in plain.items():
        if n <= 0:
            fail(f"kernel {k} was not launched by the plain sharded wave")
    for name in ("mixed3", "fib_fleet"):
        fleet = get_fleet(name)
        members = [c for c, _ in fleet]
        qs = [q for _, q in fleet]
        want = {}
        for c, q in fleet:
            if c.name not in want:
                want[c.name] = _run(dataclasses.replace(c, capacity=q),
                                    "masked", "cuda", tag="sharded")
        fl, wall, _, _, n = _sharded_run(
            f"{name} x2 sticky P=2", members, qs, "masked", 2, want,
            placement="sticky", rebalance=True)
        if fl.migrations <= 0:
            fail(f"sharded {name} x2 sticky: no job migrated")
        print(f"[sharded] {name} x2 sticky+rebalance epoch_chunk masked "
              f"P=2: wall {wall:.1f} ms, {fl.collective_steps} collective "
              f"steps, {n} epoch_chunk launches, migrations "
              f"{fl.migrations}; every job equal to its solo run")
    torch.cuda.synchronize()
    launches = dict(epoch_chunk=epoch_megakernel.LAUNCHES["epoch_chunk"],
                    **plain)
    print(f"[sharded] kernel launches during the sharded phase: {launches}")
    if launches["epoch_chunk"] <= 0:
        fail("kernel epoch_chunk was not launched on the sharded path")
    return launches


# ---------------------------------------------------------------- phase 10
# each twin of the examples, as a user runs it (the card by default)
EXAMPLE_RUNS = (
    ("quickstart_torch.py",),
    ("graph_analytics_torch.py",),
    ("serve_llm_torch.py",),
    ("serve_llm_torch.py", "--legacy"),
    ("serve_llm_torch.py", "--legacy", "--arch", "mamba2_1_3b"),
    ("serve_llm_torch.py", "--legacy", "--arch", "granite_moe_1b_a400m"),
    ("serve_llm_torch.py", "--legacy", "--arch", "whisper_large_v3"),
)
# what each run must print (beside exiting 0): its own checks' lines
EXAMPLE_CHECKS = {
    EXAMPLE_RUNS[0]: ("quickstart OK", "= True"),
    EXAMPLE_RUNS[1]: ("trees==ref: True  worklist==ref: True",
                      "trees~=ref: True  worklist~=ref: True"),
    EXAMPLE_RUNS[2]: ("16 requests, 273 tokens in", "(device engine)"),
    EXAMPLE_RUNS[3]: ("granite-3-8b: 16 requests",),
    EXAMPLE_RUNS[4]: ("mamba2-1.3b: 16 requests",),
    EXAMPLE_RUNS[5]: ("granite-moe-1b-a400m: 16 requests",),
    EXAMPLE_RUNS[6]: ("whisper-large-v3: 16 requests",),
}
EXAMPLE_TIMEOUT = 240


def phase_examples():
    """The examples' twins on the card, each a subprocess with its default
    arguments (``serve_llm_torch.py`` also ``--legacy``: the reduced
    granite-3-8b, flash_attention and decode_attention; ``--legacy --arch
    mamba2_1_3b``: ssd_scan; ``--arch granite_moe_1b_a400m``: the MoE
    layer; ``--arch whisper_large_v3``: the encoder and cross-attention),
    all started at once; each must exit 0 and print its checks' lines."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    procs = {}
    t0 = time.perf_counter()
    try:
        for run in EXAMPLE_RUNS:
            procs[run] = subprocess.Popen(
                [sys.executable, os.path.join(ROOT, "examples", run[0]),
                 *run[1:]], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
        for run, p in procs.items():
            out, err = p.communicate(
                timeout=max(1.0, EXAMPLE_TIMEOUT - (time.perf_counter()
                                                    - t0)))
            what = " ".join(run)
            if p.returncode != 0:
                fail(f"examples {what}: exit {p.returncode}: {err[-2000:]}")
            missing = [c for c in EXAMPLE_CHECKS[run] if c not in out]
            if missing:
                fail(f"examples {what}: no {missing} in its output:\n{out}")
            lines = out.strip().splitlines()
            print(f"[examples] {what}: exit 0 at "
                  f"{time.perf_counter() - t0:.1f} s, {len(lines)} lines, "
                  f"first: {lines[0].strip()!r}, last: {lines[-1].strip()!r}")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()


# ------------------------------------------------------- phase 4, graphs
def _graph_report(label, walls, captures, memory, run_epochs,
                  eager_what=""):
    """One graphs-phase line: the eager wall, the walls of the first three
    graphed runs (a fresh loop: each key eager at its first two uses,
    captured at its third, in whichever run that falls) and of a warm
    fourth (no capture), the captures in each, the graph pool and
    result-buffer bytes.  ``eager_what`` says what the eager run ran,
    where it is not the graphed runs' case.  (The phase takes no profiles:
    PERF.md keeps the eager and warm runs' busy shares and device ops per
    epoch from the earlier runs.)"""
    eager, *graphed, warm = walls
    pool, res = memory
    runs = ", ".join(
        f"{w:.1f} ms ({c - b} captures)"
        for w, b, c in zip(graphed, [0] + captures[:-1], captures))
    print(f"[graphs] {label}: eager{eager_what} {eager:.1f} ms; graphed "
          f"runs 1-3 {runs}, warm {warm:.1f} ms (no capture), {run_epochs} "
          f"epochs; graph pool {pool / 2**20:.1f} MiB, result buffers "
          f"{res / 2**20:.1f} MiB; bits equal")


def _host_out(r):
    h, v, st = r
    return {k: t.cpu().numpy() for k, t in h.items()}, v.cpu().numpy(), st


def _solo_graphs(label, case, dispatch, short=None, reps=1):
    """``case`` on HostEngine: eager (graphs=False), then a fresh graphed
    engine's first run (what ``AppCase.run``, which builds an engine for
    each call, costs), second, third and warm fourth run (no capture),
    every run's heap, values and RunStats equal, each wall the median of
    ``reps`` (eager: runs of one engine; graphed: ``reps`` fresh engines).

    ``short`` is ``(a shorter run of the same program, the run of
    ``case`` that the graphed runs are held to)``: the graphed runs of
    ``case`` are held to that run (phase 3b's, held to the CPU), and the
    eager run (its wall) is ``short``'s, held exactly to a fresh graphed
    engine's five runs of ``short``."""
    from repro_torch.core import HostEngine

    kw = dict(capacity=case.capacity, dispatch=dispatch, device="cuda")

    def engines(c):
        args = (c.initial, dict(c.heap_init) or None)
        return (HostEngine(c.program, graphs=False, **kw),
                HostEngine(c.program, **kw), args)

    eager_eng, eng, args = engines(case)
    timed, runs = [[] for _ in range(5)], []
    for rep in range(reps):
        if rep:
            eng = engines(case)[1]
        captures = []
        for i, e in enumerate((eager_eng, eng, eng, eng, eng)):
            if i == 0 and short is not None:
                continue
            out = {}
            timed[i].append(
                _wall_ms(lambda: out.setdefault("r", e.run(*args))))
            runs.append(_host_out(out["r"]))
            if e is eng:
                captures.append(eng.loop.captures)
    lap(f"graphs: {label} runs")
    walls = [float(np.median(t)) if t else None for t in timed]
    if captures[3] != captures[2]:
        fail(f"graphs {label}: the fourth run captured "
             f"{captures[3] - captures[2]} more graphs")
    want = runs[0] if short is None else short[1]
    for i, r in enumerate(runs[0 if short else 1:]):
        what = ("first", "second", "third", "warm")[i % 4] if short else (
            "eager", "first", "second", "third", "warm")[(i + 1) % 5]
        _same(r, want, f"graphs {label} {what} vs "
              f"{'the apps phase' if short else 'eager'}",
              fields=tuple(want[2].as_dict()))
    memory = eng.loop.graph_memory()
    eager_what = ""
    if short is not None:
        case = short[0]
        eager_eng, eng, args = engines(case)
        # its captures, then two warm runs
        got = [_host_out(eng.run(*args)) for _ in range(5)]
        label += f" (eager: {case.name}, a shorter run)"
        eager_what = " (the shorter run)"
        out = {}
        walls[0] = _wall_ms(lambda: out.setdefault(
            "r", eager_eng.run(*args)))
        want = _host_out(out["r"])
        for i, r in enumerate(got):
            _same(r, want, f"graphs {label} shorter run {i + 1} vs eager",
                  fields=tuple(want[2].as_dict()))
    _graph_report(label, walls, captures, memory, runs[-1][2].epochs,
                  eager_what=eager_what)
    return dict(walls=walls, captures=captures, memory=memory)


def _capture_costs(label, case, dispatch):
    """Where a graphed run's extra time goes: a fresh engine runs ``case``
    four times with the graph cache's eager uses, captures and first
    replays each timed alone (the card synchronised around each, so these
    runs are not timed themselves); prints their counts and mean times and
    how often each key is used in one run."""
    import collections

    from repro_torch.core import HostEngine
    from repro_torch.core import graphs as cgraphs

    times = collections.defaultdict(list)
    uses = collections.Counter()
    fresh = set()
    orig = (cgraphs.run_eager, cgraphs.capture, cgraphs.run_cached,
            cgraphs.CapturedStep.replay)

    def timed(kind, fn, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        times[kind].append((time.perf_counter() - t0) * 1e3)
        return out

    def capture(*a, **k):
        step = timed("capture", orig[1], *a, **k)
        fresh.add(id(step))
        return step

    def replay(step):
        if id(step) not in fresh:
            return orig[3](step)
        fresh.discard(id(step))
        return timed("first replay", orig[3], step)

    def run_cached(cache, key, *a, **k):
        uses[id(cache), key] += 1
        return orig[2](cache, key, *a, **k)

    eng = HostEngine(case.program, capacity=case.capacity, dispatch=dispatch,
                     device="cuda")
    args = (case.initial, dict(case.heap_init) or None)
    cgraphs.run_eager = lambda fn: timed("eager use", orig[0], fn)
    cgraphs.capture, cgraphs.run_cached = capture, run_cached
    cgraphs.CapturedStep.replay = replay
    try:
        eng.run(*args)
        per_run = collections.Counter(uses.values())
        for _ in range(3):
            eng.run(*args)
    finally:
        (cgraphs.run_eager, cgraphs.capture, cgraphs.run_cached,
         cgraphs.CapturedStep.replay) = orig
    cost = ", ".join(f"{k} {len(v)} x {sum(v) / len(v):.2f} ms (max "
                     f"{max(v):.2f})" for k, v in sorted(times.items()))
    print(f"[graphs] {label} costs, each timed alone: {cost}; keys by uses "
          f"in one run (uses: keys): {dict(sorted(per_run.items()))}")


def _wave_handles(wave):
    from repro_torch.service import Job, JobHandle

    return [JobHandle(job_id=i, job=Job(
        program=c.program, initial=c.initial, heap_init=dict(c.heap_init),
        quota=c.capacity, name=c.name)) for i, c in enumerate(wave)]


def _wave_graphs(label, wave, dispatch, first):
    """The mixed4 host wave: EpochMultiplexer eager (graphs=False) against
    ``first``, phase 7's JobService and its wave of this dispatch (the
    service's first wave: ``(service, wall ms, tenants, stats)``), then the
    second, third and a warm fourth wave on that service (each on the last
    wave's loop and buffers; the fourth captures nothing); every tenant and
    the fleet's RunStats equal."""
    from repro_torch.service import EpochMultiplexer

    kw = dict(capacity=sum(c.capacity for c in wave), dispatch=dispatch,
              device="cuda")
    svc, first_ms, first_tenants, first_stats = first
    loop = svc._mux.loop
    captures = [loop.captures]

    def eager_run(out=None):
        hs = _wave_handles(wave)
        m = EpochMultiplexer(hs, graphs=False, **kw)
        m.run()
        if out is not None:
            out.append(([_tenant(h) for h in hs], m.stats()))
        return None, None, m.stats()

    def service_run(out=None):
        hs = [svc.submit_case(c, quota=c.capacity) for c in wave]
        svc.drain()
        if svc._mux.loop is not loop:
            fail(f"graphs {label}: the wave did not run on the last "
                 "wave's loop")
        if out is not None:
            out.append(([_tenant(h) for h in hs], svc._mux.stats()))
        return None, None, svc._mux.stats()

    graphed = []
    walls = [None, first_ms]
    for _ in range(3):
        walls.append(_wall_ms(lambda: service_run(graphed)))
        captures.append(loop.captures)
    if captures[3] != captures[2]:
        fail(f"graphs {label}: the fourth wave captured "
             f"{captures[3] - captures[2]} more graphs")
    eager = []
    epochs = first_stats.epochs
    walls[0] = _wall_ms(lambda: eager_run(eager))
    (eager_tenants, eager_stats), = eager
    for (ts, st), what in zip([(first_tenants, first_stats)] + graphed,
                              ("first", "second", "third", "warm")):
        for c, got, want in zip(wave, ts, eager_tenants):
            _same_tenant(got, want, f"graphs {label} {what} {c.name}")
        if st.as_dict() != eager_stats.as_dict():
            fail(f"graphs {label} {what}: fleet RunStats differ")
    memory = loop.graph_memory()
    _graph_report(label, walls, captures, memory, epochs)
    lap(f"graphs: {label}")
    return dict(walls=walls, captures=captures, memory=memory)


def phase_graphs(fib_case, wave, host_waves, anneal_run):
    """CUDA graphs of the host epoch steps against the eager steps on the
    card: fib(28) on HostEngine masked, compacted and gather, annealing
    masked (held to phase 3b's masked run, ``anneal_run``), and the mixed4
    host wave masked and gather (the first wave of each phase 7's
    JobService, ``host_waves``, and three more on it).  Each sub-step's
    lap is printed."""
    from repro_torch.kernels import fork_compact

    fork_compact.reset_launches()
    out = {}
    for d in ("masked", "compacted", "gather"):
        out["fib", d] = _solo_graphs(f"fib(28) HostEngine {d}", fib_case, d,
                                     reps=3)
        _capture_costs(f"fib(28) HostEngine {d}", fib_case, d)
        lap(f"graphs: fib(28) {d} capture costs")
    case, _ = app_case("annealing", APP_FULL["annealing"])
    # the eager run and the profiles: 20 of the 200 steps (every epoch
    # traces both types at the same widths), so the eager run takes 10x
    # less time and its profile records 10x fewer operations; the graphed
    # runs of all 200 steps are held to phase 3b's masked run
    n_bits, n_chains, _ = APP_FULL["annealing"]
    short, _ = app_case("annealing", (n_bits, n_chains, 20))
    out["annealing", "masked"] = _solo_graphs(
        "annealing HostEngine masked", case, "masked",
        (short, anneal_run))
    for d in ("masked", "gather"):
        out["mixed4", d] = _wave_graphs(f"mixed4 host wave {d}", wave, d,
                                        host_waves[d])
    torch.cuda.synchronize()
    print(f"[graphs] kernel launches during the graphs phase (replays "
          f"counted): {dict(fork_compact.LAUNCHES)}")
    return out


# ---------------------------------------------------------------- phase 4b
# runs of one engine per case: a key captures at its third use, so the
# fourth run of a case whose keys come once a run is the first warm one
CONTROL_RUNS = 4
# warm rounds of one run of every engine of a case, in an order rotated by
# one engine each round
CONTROL_REPS = 7
# the mode-flip waves: two fib(12) tenants (the registry's fib case) at the
# two ends of a TV of two quotas, FLIP_WAVES waves on one service
FLIP_QUOTA = 2048
FLIP_WAVES = 4


def _smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def _np_run(out):
    h, v, st = out
    return ({k: t.cpu().numpy() for k, t in h.items()}, v.cpu().numpy(), st)


def _run_walls(walls, captures):
    return ", ".join(f"{w:.1f} ms ({c - b} captures)" for w, b, c in
                     zip(walls, [0] + captures[:-1], captures))


def _watch(ctl):
    """Wrap a DispatchController's choose and observe (its resident choice
    goes through choose): the modes it chose and the seconds each call
    took, the controller's own cost on the path."""
    log = {"modes": [], "choose_s": [], "observe_s": []}
    choose, observe = ctl.choose, ctl.observe

    def timed_choose(span_bucket):
        t0 = time.perf_counter()
        d = choose(span_bucket)
        log["choose_s"].append(time.perf_counter() - t0)
        log["modes"].append(d.mode)
        return d

    def timed_observe(n_active, full_span):
        t0 = time.perf_counter()
        observe(n_active, full_span)
        log["observe_s"].append(time.perf_counter() - t0)

    ctl.choose, ctl.observe = timed_choose, timed_observe
    return log


def _runs_of(modes):
    """A mode sequence as runs: 'masked x1, gather x60, masked x18'."""
    return ", ".join(f"{m} x{len(list(g))}"
                     for m, g in itertools.groupby(modes))


def _solo_want(modes):
    """The launches a solo host run's decisions call for."""
    return {"fork_scan": len(modes),
            "type_rank": sum(m != "masked" for m in modes)}


def _fleet_want(modes):
    """The launches a host wave's decisions call for."""
    return {"segmented_fork_scan": len(modes),
            "type_rank": sum(m != "masked" for m in modes)}


def _spread(ws):
    return (f"{np.median(ws):.1f} [{min(ws):.1f}-{max(ws):.1f}]")


def phase_control(cases, runs, wave, graph_out, first_wave_ms):
    """Control and telemetry on the card, on the graphed and resident
    paths: CostModel.calibrated; HostEngine(dispatch="auto") with the
    calibrated model on phase 3's cases, held to the masked and CPU runs;
    the full-size mixed4 wave through JobService(engine="host",
    dispatch="auto") and through JobService(engine="device", chunk="auto",
    megakernel=True); mode flips on graphs (a sparse two-tenant service);
    a SpanTracer on a graphed fib(28) engine and on a chunked device wave.
    Returns the kernel launches of the auto runs ("control") and of the
    traced runs ("trace"), each run counted from 0 alone."""
    import tempfile

    from repro_torch.apps import get_case
    from repro_torch.control import CostModel, DispatchController
    from repro_torch.core import HostEngine
    from repro_torch.kernels import counters
    from repro_torch.obs import (
        SpanTracer, iter_spans, load_trace, validate_chrome_trace)
    from repro_torch.service import JobService

    card = _smi()
    paths = {"control": {}, "trace": {}}

    def counted(path, fn, want, what):
        """``fn()`` with every launch counter set to 0 just before it and
        read just after: its launches go to ``paths[path]``, and each
        kernel of ``want()`` (read after the run) must have launched as
        often as it says."""
        torch.cuda.synchronize()
        counters.add(counters.snapshot(), -1)
        out = fn()
        torch.cuda.synchronize()
        got = counters.snapshot()
        for k, n in got.items():
            if n:
                paths[path][k] = paths[path].get(k, 0) + n
        for k, n in want().items():
            if got[k] != n:
                fail(f"{what}: {k} launched {got[k]} times where the run "
                     f"calls for {n}")
        return out

    # 1. the cost model, measured on this card
    t0 = time.perf_counter()
    cost = CostModel.calibrated(device="cuda")
    probe_s = time.perf_counter() - t0
    if not cost.source.startswith("calibrated:cuda:"):
        fail(f"control: calibration gave {cost}")
    print(f"[control] CostModel.calibrated ({card}; probe "
          f"{probe_s:.2f} s, {cost.source}): dispatch_s={cost.dispatch_s:.4e}"
          f" transfer_s={cost.transfer_s:.4e} lane_s={cost.lane_s:.4e} "
          f"pack_lane_s={cost.pack_lane_s:.4e} (priors 4.0000e-05 "
          "1.5000e-05 6.0000e-08 8.0000e-09)")
    if CostModel.calibrated(device="cuda") is not cost:
        fail("control: a second calibration probed again")

    # 2. HostEngine(dispatch="auto") on phase 3's cases, beside the three
    # static modes (and, for fib, a traced masked engine): every engine
    # run CONTROL_RUNS times, then CONTROL_REPS rounds of one warm run of
    # each engine, the order rotated each round
    tracer = SpanTracer()
    for case, correct in cases:
        ctl = DispatchController(cost=cost, n_types=len(case.program.tasks))
        log = _watch(ctl)
        engines = {"auto": HostEngine(case.program, capacity=case.capacity,
                                      dispatch="auto", controller=ctl,
                                      device="cuda")}
        for d in ("masked", "compacted", "gather"):
            engines[d] = HostEngine(case.program, capacity=case.capacity,
                                    dispatch=d, device="cuda")
        if case is cases[0][0]:
            engines["masked traced"] = HostEngine(
                case.program, capacity=case.capacity, device="cuda",
                tracer=tracer)
        E = runs[case.name, "masked"][2].epochs
        args = (case.initial, dict(case.heap_init) or None)
        per_run, first_masked = [], []

        def run_once(name):
            eng, out = engines[name], {}

            def go():
                out["wall"] = _wall_ms(
                    lambda: out.setdefault("r", eng.run(*args)))

            what = f"control {case.name} {name}"
            if name == "auto":
                n0 = len(log["modes"])
                counted("control", go,
                        lambda: _solo_want(log["modes"][n0:]), what)
                modes = log["modes"][n0:]
                if len(modes) != E:
                    fail(f"{what}: {len(modes)} decisions for {E} epochs")
                per_run.append(dict(collections.Counter(modes)))
            elif name == "masked traced":
                counted("trace", go, lambda: {"fork_scan": E}, what)
            else:
                go()
            return out["r"], out["wall"]

        first = {}
        for name, eng in engines.items():
            walls, captures = [], []
            for i in range(CONTROL_RUNS):
                r, w = run_once(name)
                r = _np_run(r)
                walls.append(w)
                captures.append(eng.loop.captures)
                what = f"control {case.name} {name} run {i + 1}"
                if not correct(r[0], r[1]):
                    fail(f"{what}: differs from the reference")
                _same(r, runs[case.name, "masked"], f"{what} vs masked")
                if name in ("auto", "masked traced"):
                    _same(r, runs[case.name, "cpu"], f"{what} vs the CPU")
                if name == "masked":
                    first_masked.append(r)
                if name == "masked traced":
                    _same(r, first_masked[i], f"{what} vs untraced",
                          fields=tuple(r[2].as_dict()))
            first[name] = (walls, captures)
        if first.get("masked traced", first["masked"])[1] != \
                first["masked"][1]:
            fail(f"control {case.name}: the traced engine captured "
                 f"{first['masked traced'][1]}, the untraced "
                 f"{first['masked'][1]}")
        warm = {name: [] for name in engines}
        names = list(engines)
        for rnd in range(CONTROL_REPS):
            k = rnd % len(names)
            for name in names[k:] + names[:k]:
                warm[name].append(run_once(name)[1])
        med = {name: float(np.median(w)) for name, w in warm.items()}
        best = min(("masked", "compacted", "gather"), key=med.get)
        n_dec = len(log["choose_s"])
        ctl_ms = 1e3 * (sum(log["choose_s"]) + sum(log["observe_s"]))
        line = (f"[control] {case.name} HostEngine auto (calibrated), runs "
                f"1-{CONTROL_RUNS}: {_run_walls(*first['auto'])}; decisions"
                f" per run {per_run[:CONTROL_RUNS]}, in the warm rounds "
                f"{per_run[CONTROL_RUNS:]}; warm ms, median [min-max] of "
                f"{CONTROL_REPS} rotated rounds: " + ", ".join(
                    f"{n} {_spread(w)}" for n, w in warm.items())
                + f"; auto / best static ({best}) "
                f"{med['auto'] / med[best]:.3f}; the controller's own time:"
                f" choose {1e6 * np.mean(log['choose_s']):.2f} us, observe "
                f"{1e6 * np.mean(log['observe_s']):.2f} us an epoch "
                f"({n_dec} epochs), {ctl_ms / len(per_run):.3f} ms a run")
        if "masked traced" in med:
            line += (f"; traced runs 1-{CONTROL_RUNS}: "
                     f"{_run_walls(*first['masked traced'])}, traced / "
                     f"untraced {med['masked traced'] / med['masked']:.3f}")
        if case.name == "fib":
            line += "; phase 4's warm walls: " + ", ".join(
                f"{d} {graph_out['fib', d]['walls'][-1]:.1f} ms"
                for d in ("masked", "compacted", "gather"))
        print(line + "; bits equal to masked and the CPU")
        if case is cases[0][0]:
            n_traced = CONTROL_RUNS + CONTROL_REPS
            for name in ("epoch", "dispatch", "readback"):
                n = len(list(iter_spans(tracer.events, name, "host")))
                if n != n_traced * E:
                    fail(f"control tracing: {n} {name} spans for "
                         f"{n_traced} x {E} epochs")
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                engines["masked traced"].run(*args)
                torch.cuda.synchronize()
            if "trees:epoch_step" not in {e.key for e in
                                          prof.key_averages()}:
                fail("control tracing: no trees:epoch_step range in the "
                     "profile")

    # 3. the full-size mixed4 host wave under dispatch="auto"
    res, wlog = {}, {}

    def host_auto_wave():
        svc = JobService(capacity=sum(c.capacity for c in wave),
                         dispatch="auto", device="cuda")
        wlog.update(_watch(svc.controller))
        handles = [svc.submit_case(c, quota=c.capacity) for c in wave]
        res["wall"] = _wall_ms(svc.drain)
        res["svc"], res["handles"] = svc, handles

    counted("control", host_auto_wave, lambda: _fleet_want(wlog["modes"]),
            "control host auto wave")
    svc = res["svc"]
    for c, h in zip(wave, res["handles"]):
        if h.status.value != "done":
            fail(f"control host auto wave {c.name}: {h.status} {h.error}")
        _same_tenant(_tenant(h), runs[c.name, "masked"],
                     f"control host auto wave {c.name} vs its solo run")
    fs = svc.stats()
    if len(wlog["modes"]) != fs.epochs:
        fail(f"control host auto wave: {len(wlog['modes'])} decisions for "
             f"{fs.epochs} epochs")
    print(f"[control] mixed4 JobService(engine='host', dispatch='auto') "
          f"(a new service's first wave): wall {res['wall']:.1f} ms, "
          f"{fs.epochs} global epochs, decisions {svc.controller.decisions}"
          f" ({_runs_of(wlog['modes'])}), captures {svc._mux.loop.captures}"
          f", dispatches {fs.dispatches}, lanes {fs.lanes_launched}; the "
          "controller's own time "
          f"{1e3 * (sum(wlog['choose_s']) + sum(wlog['observe_s'])):.3f} ms"
          "; first waves of phase 7: " + ", ".join(
              f"{d} {ms:.1f} ms" for d, ms in first_wave_ms.items())
          + "; warm (phase 4, profiled): " + ", ".join(
              f"{d} {graph_out['mixed4', d]['walls'][-1]:.1f} ms"
              for d in ("masked", "gather"))
          + "; every tenant equal to its solo run")

    # 4. the mixed4 device wave with an adaptive chunk
    tr = SpanTracer()
    out = {}

    def chunk_auto_wave():
        out["svc"], out["handles"], out["wall"] = run_wave(
            wave, "auto", engine="device", chunk="auto", megakernel=True,
            tracer=tr)

    counted("control", chunk_auto_wave,
            lambda: {"epoch_chunk": out["svc"].stats().dispatches},
            "control device chunk=auto wave")
    svc = out["svc"]
    for c, h in zip(wave, out["handles"]):
        if h.status.value != "done":
            fail(f"control device auto wave {c.name}: {h.status} {h.error}")
        _same_tenant(_tenant(h), runs[c.name, "masked"],
                     f"control device chunk=auto wave {c.name} vs its solo "
                     "run")
    fs = svc.stats()
    chunks = list(iter_spans(tr.events, "chunk", "resident"))
    ks = [c["args"]["k"] for c in chunks]
    if len(chunks) != fs.dispatches or sum(
            c["args"]["epochs"] for c in chunks) != fs.epochs:
        fail(f"control device chunk=auto: {len(chunks)} chunk spans for "
             f"{fs.dispatches} chunks, {fs.epochs} epochs")
    print(f"[control] mixed4 JobService(engine='device', chunk='auto', "
          f"megakernel=True, dispatch='auto' -> {svc._mux.policy.name}): "
          f"wall {out['wall'] * 1e3:.1f} ms, {fs.epochs} global epochs in "
          f"{len(chunks)} chunks, K trajectory {ks}, epochs per chunk "
          f"{[c['args']['epochs'] for c in chunks]}; every tenant equal to "
          "its solo run")

    # 5. mode flips on graphs: FLIP_WAVES waves of two fib tenants at the
    # two ends of a sparse TV on one service, whose loop (and graphs) each
    # wave takes over; each wave's decisions and tenants held to the same
    # service's on the CPU, the tenants to a masked wave on the card
    sparse = [get_case("fib"), get_case("fib")]
    flips = {
        "gather": lambda: DispatchController(cost=CostModel()),
        "compacted": lambda: DispatchController(
            cost=CostModel(dispatch_s=1e-7, transfer_s=1e-7,
                           per_type_s=0.0),
            modes=("masked", "compacted")),
    }

    def flip_waves(device, make_ctl):
        svc = JobService(capacity=2 * FLIP_QUOTA, dispatch="auto",
                         calibrate=False, device=device)
        svc.controller = make_ctl()
        log = _watch(svc.controller)
        waves = []
        for w in range(FLIP_WAVES):
            n0 = len(log["modes"])

            def one_wave():
                hs = [svc.submit_case(c, quota=FLIP_QUOTA) for c in sparse]
                svc.drain()
                return hs

            if device == "cuda":
                hs = counted("control", one_wave,
                             lambda: _fleet_want(log["modes"][n0:]),
                             f"control flips wave {w + 1}")
            else:
                hs = one_wave()
            waves.append(dict(
                tenants=[_tenant(h) for h in hs], stats=svc._mux.stats(),
                modes=log["modes"][n0:], captures=svc._mux.loop.captures))
        return waves

    svc = JobService(capacity=2 * FLIP_QUOTA, device="cuda")
    masked_hs = [svc.submit_case(c, quota=FLIP_QUOTA) for c in sparse]
    svc.drain()
    masked_tenants = [_tenant(h) for h in masked_hs]
    for flip, make_ctl in flips.items():
        card_waves = flip_waves("cuda", make_ctl)
        cpu_waves = flip_waves("cpu", make_ctl)
        for w, (got, want) in enumerate(zip(card_waves, cpu_waves)):
            what = f"control flips ({flip}) wave {w + 1}"
            if got["modes"] != want["modes"]:
                fail(f"{what}: decisions {_runs_of(got['modes'])} on the "
                     f"card, {_runs_of(want['modes'])} on the CPU")
            if got["stats"].as_dict() != want["stats"].as_dict():
                fail(f"{what}: fleet RunStats differ from the CPU's")
            for i, (g, c, m) in enumerate(zip(got["tenants"],
                                              want["tenants"],
                                              masked_tenants)):
                _same_tenant(g, c, f"{what} tenant {i} vs the CPU")
                _same_tenant(g, m, f"{what} tenant {i} vs masked")
        seen = {m for w in card_waves for m in w["modes"]}
        if seen != {"masked", flip} or card_waves[-1]["captures"] == 0:
            fail(f"control flips ({flip}): modes {sorted(seen)}, "
                 f"{card_waves[-1]['captures']} captures")
        print(f"[control] mode flips on graphs, JobService(dispatch='auto')"
              f" on two fib(12) tenants in a TV of {2 * FLIP_QUOTA}, "
              f"{flip}: per wave " + "; ".join(
                  f"{_runs_of(w['modes'])} ({w['captures']} captures so far)"
                  for w in card_waves)
              + "; decisions, tenants and fleet RunStats equal to the CPU's,"
              " tenants to the masked wave")

    # 6. tracing a chunked device wave (fib(28)'s traced engine ran in 2)
    K = 4
    dtr = SpanTracer()
    _, _, wall_off = run_wave(wave, "masked", engine="device", chunk=K,
                              megakernel=True)
    traced = {}

    def traced_wave():
        traced["svc"], _, traced["wall"] = run_wave(
            wave, "masked", engine="device", chunk=K, megakernel=True,
            tracer=dtr)

    counted("trace", traced_wave,
            lambda: {"epoch_chunk": -(-traced["svc"].stats().epochs // K)},
            "control traced K=4 wave")
    wall_on = traced["wall"]
    De = traced["svc"].stats().epochs
    n_rb = len(list(iter_spans(dtr.events, "readback", "resident")))
    n_ch = len(list(iter_spans(dtr.events, "chunk", "resident")))
    if n_rb != -(-De // K) or n_ch != n_rb:
        fail(f"control tracing: {n_rb} readback and {n_ch} chunk spans on "
             f"a wave of {De} epochs at K={K}")
    with tempfile.TemporaryDirectory() as d:
        for label, t in (("fib", tracer), ("wave", dtr)):
            path = os.path.join(d, f"{label}.json")
            t.write(path)
            validate_chrome_trace(t.to_dict())
            load_trace(path)
    print(f"[control] tracing: fib(28) one epoch, dispatch and readback "
          f"span an epoch, trees:epoch_step in torch.profiler's ranges; "
          f"mixed4 device wave K={K} epoch_chunk: {n_rb} readback and chunk "
          f"spans for {De} epochs, wall on {wall_on * 1e3:.1f} ms / off "
          f"{wall_off * 1e3:.1f} ms; both traces valid Chrome traces")

    print(f"[control] kernel launches of the auto runs alone (control) and "
          f"the traced runs alone (trace), replays counted: {paths}")
    for k in ("fork_scan", "type_rank", "segmented_fork_scan",
              "epoch_chunk"):
        if paths["control"].get(k, 0) <= 0:
            fail(f"kernel {k} was not launched by the control phase's "
                 "auto runs")
    return paths["control"], paths["trace"]


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
# phase 8c's new prefill shapes, bf16: whisper-large-v3's encoder
# (non-causal over its 1500 frames) and a query bucket's cross-attention
# over them, 20/20 heads of 64 (1500 rows: not a multiple of the key
# tile); llama4-scout's causal 40/8 heads of 128
ENCDEC_PREFILL = ((16, 20, 20, 1500, 1500, 64, False, 0, 0),
                  (16, 20, 20, 1024, 1500, 64, False, 0, 0))
LLAMA4_PREFILL = (16, 40, 8, 1024, 1024, 128, True, 0, 0)
# and its decode shapes: whisper's cross-attention over the 1500 frames
# (group 1, every length 1500: not a multiple of the 256-row split), and
# granite-moe's self-attention (group 2, D 64)
CROSS_DECODE_SHAPE = (16, 20, 20, 1500, 64)
MOE_DECODE_SHAPE = (16, 16, 8, 2048, 64)
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


# the backward (phase 8d's gradient): the training shape (granite-3-8b,
# batch 4 x 2048, 32/8 heads of 128, causal), granite-moe's heads (16/8 of
# 64) with a window of 512, and in float32 the card-vs-CPU check's shape
# (one sequence of 256)
FLASH_TRAIN = (4, 32, 8, 2048, 2048, 128, True, 0, 0)
FLASH_BWD_MORE = ((4, 16, 8, 2048, 2048, 64, True, 0, 512, torch.bfloat16),
                  (1, 32, 8, 256, 256, 128, True, 0, 0, torch.float32))
# each 64-row tile of one (batch, head) of dq (consecutive queries), dk
# and dv (consecutive keys) within tol of its own Frobenius norm (bf16: P
# and dS rounded to bf16 as the products' operands, and each output;
# float32: other sums).  On each tile's own scale, because under a causal
# mask a key's gradient falls off as about 1/sqrt(its position), so a
# tolerance of the tensor's max lets most rows be tens of percent wrong;
# by tiles and not by rows, because dq's first row is zero in exact
# arithmetic (o_0 = v_0, so dS_00 = P_00 (dP_00 - delta_0) = 0) and both
# versions give rounding noise there.  Readings on the H100 at the three
# shapes below: bf16 at most 3.5e-3, float32 at most 2.4e-7; a kernel
# whose dq skips its last key tile, or whose dK/dV leaves one head of the
# group out, reads 0.40 to 1.0, and one whose dV of the last key tile is
# 30 % off reads 0.30 (0.3 % of the tensor's max)
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# the forward's lse against the plain logsumexp: of max(1, max |plain|)
LSE_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-4}


def _flash_bwd_work(case):
    """(bytes, flops) the backward needs: q, k, v, o, dO and lse read and
    dq, dk, dv written once; five products of 2 D flops per visible
    (query, key) pair (S, dP, dV, dK, dQ)."""
    B, Hq, Hkv, Sq, Skv, D = case[:6]
    n_bytes, fwd_flops = _flash_work(case[:9])
    n_bytes = 2 * (4 * B * Hq * Sq * D + 4 * B * Hkv * Skv * D) \
        + 4 * B * Hq * Sq
    return n_bytes, fwd_flops // 4 * 10


def _tile_rel_err(got, want, rows=64):
    """max over tiles of ``rows`` consecutive positions of one (batch,
    head) of ||got - want|| / ||want|| (Frobenius), a tile's norm floored
    at 1e-6 of the largest (a key no query sees has exactly zero
    gradient)."""
    pad = (-want.shape[-2]) % rows

    def tiles(x):
        x = torch.nn.functional.pad(x.float(), (0, 0, 0, pad))
        return x.reshape(*x.shape[:-2], -1, rows * x.shape[-1])

    norm = tiles(want).norm(dim=-1)
    err = tiles(got.float() - want.float()).norm(dim=-1)
    return float((err / norm.clamp_min(1e-6 * float(norm.max()))).max())


def _flash_bwd_check(case, dtype, gen):
    """The backward kernel against ``mha_backward_ref`` on the forward
    kernel's own output and lse, q as the block's strided view, each of
    dq, dk, dv within ``BWD_TOL`` tile by tile (``_tile_rel_err``);
    returns (max |err|, the largest tile error, (q, k, v, o, lse, do))."""
    from repro_torch.kernels import flash_attention, ref

    q, k, v = _flash_inputs(case, dtype, gen)
    do = torch.randn(q.shape, generator=gen, device="cuda", dtype=dtype)
    kw = dict(zip(("causal", "q_offset", "window"), case[6:9]))
    o, lse = flash_attention.flash_attention(q, k, v, return_lse=True, **kw)
    _, want_lse = ref.mha_ref(q, k, v, return_lse=True, **kw)
    e = float((lse - want_lse).abs().max())
    if e > LSE_TOL[dtype] * max(1.0, float(want_lse.abs().max())):
        fail(f"flash_attention {case[:9]} {dtype}: the lse it writes is "
             f"off by {e}")
    del want_lse
    got = flash_attention.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = ref.mha_backward_ref(q, k, v, o, lse, do, **kw)
    err = rel = 0.0
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g, w = g.float(), w.float()
        if not torch.isfinite(g).all():
            fail(f"flash_attention_bwd {case[:9]} {dtype} {name}: "
                 "non-finite")
        e, r = float((g - w).abs().max()), _tile_rel_err(g, w)
        print(f"[kernels] flash_attention_bwd {case[:9]} {dtype} {name}: "
              f"max |kernel - plain| {e:.3g} ({e / float(w.abs().max()):.3g}"
              f" of max |plain|), largest tile error {r:.3g}")
        if r > BWD_TOL[dtype]:
            fail(f"flash_attention_bwd {case[:9]} {dtype} {name}: a tile is"
                 f" off by {r} of its norm (tolerance {BWD_TOL[dtype]})")
        err, rel = max(err, e), max(rel, r)
    del got, want
    return err, rel, (q, k, v, o, lse, do)


def _flash_bwd_row(gen):
    """Phase 2's backward cases, then the training shape timed beside its
    bound, the plain version and SDPA's backward: the kernel's row."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention, ref

    err = rel = 0.0
    for case in FLASH_BWD_MORE:
        e, r, _ = _flash_bwd_check(case, case[9], gen)
        err, rel = max(err, e), max(rel, r)
    e, r, (q, k, v, o, lse, do) = _flash_bwd_check(
        FLASH_TRAIN, torch.bfloat16, gen)
    err, rel = max(err, e), max(rel, r)
    torch.cuda.synchronize()
    print(f"[kernels] flash_attention_bwd within tolerance of "
          f"mha_backward_ref (each 64-row tile of each gradient within "
          f"{BWD_TOL[torch.bfloat16]} of its norm in bf16, "
          f"{BWD_TOL[torch.float32]} in float32) at the training shape "
          f"{FLASH_TRAIN[:6]} causal bf16, granite-moe's "
          f"{FLASH_BWD_MORE[0][:6]} window {FLASH_BWD_MORE[0][8]} bf16 and "
          f"{FLASH_BWD_MORE[1][:6]} float32: max |kernel - plain| = "
          f"{err:.3g}, largest tile error {rel:.3g}")
    b, by = bound_ms(*_flash_bwd_work(FLASH_TRAIN),
                     ops_per_s=TENSOR_BF16_FLOPS)
    qg, kg, vg = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    sdpa = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                          enable_gqa=True)
    t = {"ms": cuda_ms(lambda: flash_attention.flash_attention_bwd(
             q, k, v, o, lse, do), iters=5, reps=2),
         "plain_ms": cuda_ms(lambda: ref.mha_backward_ref(q, k, v, o, lse,
                                                          do),
                             iters=2, reps=2),
         # eager: autograd's backward of one SDPA call (ms-long: the
         # host's launches are not what is timed)
         "library_ms": call_ms(lambda: torch.autograd.grad(
             sdpa, (qg, kg, vg), do, retain_graph=True), iters=10)}
    print(f"[kernels] flash_attention_bwd at {FLASH_TRAIN[:6]} causal bf16:"
          f" device {t['ms']:.5f} ms, bound {b:.5f} ms ({by}; "
          f"{100 * b / t['ms']:.1f}% of it), plain {t['plain_ms']:.5f} ms, "
          f"library (SDPA's backward, eager) {t['library_ms']:.5f} ms "
          f"(kernel / SDPA {t['ms'] / t['library_ms']:.2f})")
    del q, k, v, o, lse, do, qg, kg, vg, sdpa
    return dict(
        name="flash_attention_bwd", route="cuda",
        design="three launches, no float atomics: delta = rowsum(dO o O); "
               "dK/dV per (key tile, kv head), the group's heads summed in "
               "the CTA; dQ per (q tile, q head); mma.sync in bf16, CUDA "
               "cores in float32",
        source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        replaces="none: port-only, the gradient of "
                 "src/repro/kernels/flash_attention.py:98 (the reference "
                 "differentiates ref.mha_ref with XLA; no Pallas backward)",
        max_abs_err=err, max_rel_err=rel, bound_ms=b, bound_by=by, **t)


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
    new_err = 0.0
    for case in ENCDEC_PREFILL + (LLAMA4_PREFILL,):
        q, k, v = _flash_inputs(case, torch.bfloat16, gen)
        got = flash_attention.flash_attention(q, k, v, causal=case[6])
        want = ref.mha_ref(q, k, v, causal=case[6])
        new_err = max(new_err, _attn_err(got, want, torch.bfloat16,
                                         f"flash_attention {case} bf16"))
        del q, k, v, got, want
    err["flash_attention"] = max(err["flash_attention"], new_err)
    torch.cuda.synchronize()
    print(f"[kernels] flash_attention within tolerance at phase 8c's "
          f"shapes, bf16: whisper's encoder {ENCDEC_PREFILL[0][:6]} and "
          f"cross-attention {ENCDEC_PREFILL[1][:6]}, non-causal; llama4's "
          f"{LLAMA4_PREFILL[:6]} causal (group 5, D 128): max |kernel - "
          f"plain| = {new_err:.3g}")
    bwd_row = _flash_bwd_row(gen)

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
    S = CROSS_DECODE_SHAPE[3]
    check_decode(CROSS_DECODE_SHAPE, (0,), (S,) * CROSS_DECODE_SHAPE[0],
                 "whisper cross-attention")
    S = MOE_DECODE_SHAPE[3]
    check_decode(MOE_DECODE_SHAPE, (0,), (1, S - 1, S, S + 1), "granite-moe")
    torch.cuda.synchronize()
    print(f"[kernels] decode_attention within tolerance at {DECODE_SHAPE} "
          f"(lengths 1, S-1, S, S+1, S+200 and random), window 0 and 256, "
          f"at hymba's {HYMBA_DECODE_SHAPE} (group 5), windows {S5} and 0, "
          f"and at {DECODE_MORE[0]} (yi-34b's group 7) and "
          f"{DECODE_MORE[1]} (D = 16), windows 0 and 256, and at phase 8c's "
          f"{CROSS_DECODE_SHAPE} (whisper's cross-attention, every length "
          f"1500) and {MOE_DECODE_SHAPE} (granite-moe, group 2), bf16 and "
          f"float32: max |kernel - plain| = {err['decode_attention']:.3g}")

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
    # phase 8c's widest new launches: whisper's encoder, and its
    # cross-attention decode over the frames (123 MB a call: out of L2)
    case = ENCDEC_PREFILL[0]
    q, k, v = _flash_inputs(case, torch.bfloat16, gen)
    b, by = bound_ms(*_flash_work(case), ops_per_s=TENSOR_BF16_FLOPS)
    rows[0]["encoder"] = dict(
        shape=case, bound_ms=b, bound_by=by,
        ms=cuda_ms(lambda: flash_attention.flash_attention(
            q, k, v, causal=False), iters=5, reps=2),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v),
                           iters=5, reps=2))
    del q, k, v
    B, Hq, Hkv, S, D = CROSS_DECODE_SHAPE
    cross_lens = torch.full((B,), S, dtype=torch.int32, device=dev)
    q = torch.randn((B, Hq, D), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    kc, vc = (torch.randn((B, Hkv, S, D), generator=gen, device=dev,
                          dtype=torch.bfloat16) for _ in range(2))
    b, by = bound_ms(*_decode_work(cross_lens, S, B, Hq, Hkv, D),
                     ops_per_s=TENSOR_BF16_FLOPS)
    rows[1]["cross"] = dict(
        shape=CROSS_DECODE_SHAPE, bound_ms=b, bound_by=by,
        ms=cuda_ms(lambda: decode_attention.decode_attention(
            q, kc, vc, cross_lens)),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], kc, vc)))
    del q, kc, vc
    for r, key, what in ((rows[0], "encoder", "flash_attention, whisper's "
                          "encoder, non-causal"),
                         (rows[1], "cross", "decode_attention, whisper's "
                          "cross-attention, lengths 1500")):
        t = r[key]
        print(f"[kernels] {what} at {t['shape']} bf16: device "
              f"{t['ms']:.5f} ms, bound {t['bound_ms']:.5f} ms "
              f"({t['bound_by']}; {100 * t['bound_ms'] / t['ms']:.1f}% of "
              f"it), library (SDPA) {t['library_ms']:.5f} ms (kernel / SDPA "
              f"{t['ms'] / t['library_ms']:.2f})")
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
    return rows + [bwd_row]


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


def _frames(cfg):
    """An encoder-decoder cell's one frame input (1, T_enc, d), float32,
    from seed 0, as the reference's launcher draws it."""
    return np.random.RandomState(0).normal(
        size=(1, cfg.encoder_len, cfg.d_model)).astype(np.float32)


def _describe(cfg):
    """The config's mixer, FFN and encoder, for the cell's first line."""
    if cfg.block == "attn":
        mixer = (f"{cfg.n_heads}/{cfg.n_kv_heads} heads of "
                 f"{cfg.resolved_head_dim}")
    else:
        s = cfg.ssm
        mixer = (f"{cfg.block}: {s.n_heads(cfg.d_model)} SSM heads of P = "
                 f"{s.headdim}, N = {s.d_state}, d_inner "
                 f"{s.d_inner(cfg.d_model)}")
        if cfg.block == "hybrid":
            mixer += (f" ∥ {cfg.n_heads}/{cfg.n_kv_heads} attention heads "
                      f"of {cfg.resolved_head_dim}")
    m = cfg.moe
    ffn = (f"{m.n_experts} experts top-{m.top_k} of d_ff {m.d_ff_expert}"
           + (f" + {m.n_shared_experts} shared" if m.n_shared_experts
              else "") if m else f"d_ff {cfg.d_ff}")
    enc = (f"{cfg.n_encoder_layers} encoder layers over "
           f"{cfg.encoder_len} frames, " if cfg.encdec else "")
    return f"{enc}{mixer}, {ffn}"


def _serve_cell(cfg, n_requests, tag, max_len=SERVE_MAX_LEN, **mix):
    """Serve ``n_requests`` of the phase 8 mix (seed 0; ``mix``: other
    ``serve_requests`` ranges) on ``cfg`` on the card, 16 slots of
    ``max_len`` rows, random weights from seed 0 (an encoder-decoder
    config: ``_frames``' input, encoded once): one short request first, so
    cuBLAS and the kernels' first launches are not charged to the timed
    run, then every kernel's count set to 0 and the run.  Checks every
    output, finite logits and the epochs the bookkeeping predicts; returns
    (server, model, epochs, prefills, the run's launches)."""
    from repro_torch.kernels import (
        decode_attention, flash_attention, fork_compact, ssd_scan,
    )
    from repro_torch.models import init_model
    from repro_torch.serving import EpochServer, Request

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_model(cfg, seed=0, device="cuda")
    srv = EpochServer(cfg, model, n_slots=SERVE_SLOTS, max_len=max_len,
                      device="cuda",
                      enc_frames=_frames(cfg) if cfg.encdec else None)
    torch.cuda.synchronize()
    print(f"[{tag}] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {_describe(cfg)}, vocab {cfg.vocab}; "
          f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B "
          f"parameters drawn on the card and the {SERVE_SLOTS}-slot cache "
          f"of {max_len} rows allocated in {time.perf_counter() - t0:.1f} s")
    _serve_run(srv, [Request(prompt=np.arange(3, 67, dtype=np.int32),
                             max_new_tokens=4)], cfg.vocab)
    reqs = serve_requests(n_requests, cfg.vocab, seed=0, **mix)
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


DECODE_EPOCHS = 8  # the graphs phase's timed and profiled decode epochs


def _decode_graphs(cfg, model, tag):
    """8 decode epochs of ``cfg`` at the served width (16 slots of 2048
    rows, 16 requests of the phase 8 mix, seed 3), eager (graphs=False)
    and graphed: the first two epochs (eager on both), the third (the
    capture), 8 timed epochs and 8 under the profiler (device ops, busy
    share, decode_attention's share), then every request's tokens equal
    between the two servers.  A replay runs every operation of the eager
    step and the copy into its result buffer, so a graphed profile that
    records fewer device ops than the eager one missed some: the next 8
    epochs are profiled instead, up to GRAPHED_PROFILE_ATTEMPTS windows in
    all.  Every request lasts past the last window, so each window is 8
    epochs of 16 busy slots."""
    from repro_torch.serving import EpochServer

    res = {}
    new = 3 + DECODE_EPOCHS * (1 + GRAPHED_PROFILE_ATTEMPTS)
    for graphs in (False, True):
        srv = EpochServer(cfg, model, n_slots=SERVE_SLOTS,
                          max_len=SERVE_MAX_LEN, device="cuda",
                          graphs=graphs)
        for r in serve_requests(SERVE_SLOTS, cfg.vocab, seed=3,
                                new=(new,) * 2):
            srv.submit(r)
        # the prefill and the first decode epoch, the second (both eager),
        # the third (graphed: the capture)
        ts = []
        for _ in range(3):
            srv.step()
            ts.append(srv.timings["decode_s"] * 1e3)
        first, second, third = ts[0], ts[1] - ts[0], ts[2] - ts[1]
        d0 = srv.timings["decode_s"]
        for _ in range(DECODE_EPOCHS):
            srv.step()
        torch.cuda.synchronize()
        warm = (srv.timings["decode_s"] - d0) * 1e3 / DECODE_EPOCHS

        def epochs():
            for _ in range(DECODE_EPOCHS):
                srv.step()
            return None, None, types.SimpleNamespace(epochs=DECODE_EPOCHS)

        kind = "graphed" if graphs else "eager"
        for attempt in range(1, GRAPHED_PROFILE_ATTEMPTS + 1):
            again = "" if attempt == 1 else f", attempt {attempt}"
            busy, wall, events = phase_profile(
                f"{cfg.name} {DECODE_EPOCHS} decode epochs, {kind}{again}",
                epochs, cpu=False)
            ops = sum(e.count for e in events)
            if not graphs or ops >= res[False]["ops"]:
                break
            print(f"[profile] {tag} graphs: the graphed profile recorded "
                  f"{ops} device ops, fewer than the eager one's "
                  f"{res[False]['ops']}")
            PROFILE_RETRIES.append(f"{cfg.name} decode graphed (short, "
                                   f"attempt {attempt})")
        else:
            fail(f"{tag} graphs: the graphed profile recorded fewer device "
                 f"ops than the eager one's {res[False]['ops']} in each of "
                 f"{GRAPHED_PROFILE_ATTEMPTS} windows")
        attn = device_us(events, "decode_split", "decode_combine")
        srv.run_to_completion()
        if srv.queue or srv.active.any():
            fail(f"{tag} graphs: requests left after the run")
        memory = srv.graph_memory() if graphs else (0, 0)
        res[graphs] = dict(
            first=first, second=second, third=third, warm=warm, busy=busy,
            wall=wall,
            ops=ops, attn=attn,
            captures=srv.captures, memory=memory,
            tokens=[(r.rid, r.output) for r in srv.completed])
        del srv
        torch.cuda.empty_cache()
    e, g = res[False], res[True]
    if e["tokens"] != g["tokens"]:
        fail(f"{tag} graphs: the graphed server's tokens differ from the "
             "eager server's")
    if g["captures"] != 1 or e["captures"] != 0:
        fail(f"{tag} graphs: {g['captures']} decode captures")
    for k, r in (("eager", e), ("graphed", g)):
        print(f"[graphs] {cfg.name} decode, {k}: first epoch "
              f"{r['first']:.2f} ms, second {r['second']:.2f} ms, third "
              f"{r['third']:.2f} ms, warm "
              f"{r['warm']:.2f} ms per epoch; "
              f"profiled {DECODE_EPOCHS} epochs: busy "
              f"{100 * r['busy'] / r['wall']:.1f}% ({r['busy'] / 1e3:.3f} of "
              f"{r['wall'] / 1e3:.3f} ms), {r['ops'] / DECODE_EPOCHS:.1f} "
              f"device ops per epoch, decode_attention "
              f"{r['attn'] / DECODE_EPOCHS / 1e3:.3f} ms per epoch")
    pool, resb = g["memory"]
    print(f"[graphs] {cfg.name} decode: {g['captures']} capture, graph pool "
          f"{pool / 2**20:.1f} MiB, result buffers {resb / 2**20:.2f} MiB; "
          f"{len(g['tokens'])} requests, tokens equal to the eager server's")
    return res


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


# the float32 card-vs-CPU runs of phases 8, 9 and 8c, at full width from
# weights of seed 1 (``_float32_model``) on 4 slots of 256 rows: arch ->
# (layers (decoder and encoder), requests, prompt lengths, new tokens
# each).  llama4-scout
# runs one layer and a short mix: its full-capacity expert buffer (16 x
# 128 rows of 5120 x 8192 x 3) is ~0.5 TFLOP a decode epoch on the CPU
CARD_VS_CPU = {
    "granite_3_8b": (2, 6, (16, 200), 8),
    "mamba2_1_3b": (2, 6, (16, 200), 8),
    "hymba_1_5b": (2, 6, (16, 200), 8),
    "granite_moe_1b_a400m": (2, 6, (16, 200), 8),
    "llama4_scout_17b_a16e": (1, 2, (16, 32), 4),
    "whisper_large_v3": (2, 6, (4, 64), 8),
}


def _cfg32(arch):
    """``arch`` at full width, float32 compute, cut to its card-vs-CPU
    depth."""
    from repro_torch import configs

    cfg = configs.get_config(arch)
    n = CARD_VS_CPU[arch][0]
    return dataclasses.replace(
        cfg, n_layers=n, compute_dtype=torch.float32,
        n_encoder_layers=n if cfg.encdec else cfg.n_encoder_layers)


def _float32_run(arch, model, device, graphs):
    """One card-vs-CPU server run: (each request's tokens in completion
    order, epochs, the first and fourth decode epochs' logits, on the
    host, seconds).  On the card the graphed server's fourth epoch is a
    replay, its logits read before the next replay overwrites them."""
    from repro_torch.serving import EpochServer

    cfg32 = _cfg32(arch)
    _, n_req, plen, new = CARD_VS_CPU[arch]
    srv = EpochServer(cfg32, model, n_slots=4, max_len=256, device=device,
                      graphs=graphs,
                      enc_frames=_frames(cfg32) if cfg32.encdec else None)
    for r in serve_requests(n_req, cfg32.vocab, seed=1, plen=plen,
                            new=(new, new)):
        srv.submit(r)
    t0 = time.perf_counter()
    logits = []
    for _ in range(4):
        srv.step()
        logits.append(srv.last_logits[:, :cfg32.vocab].cpu())
    srv.run_to_completion()
    return ([(r.rid, r.output) for r in srv.completed], srv.epochs,
            torch.stack([logits[0], logits[3]]), time.perf_counter() - t0)


def _float32_model(arch):
    """``_cfg32(arch)``'s weights from seed 1, drawn on the CPU (one
    thread: llama4-scout's 4.3 G values take ~40 s), then every random
    per-layer matrix (and the encoder's) rescaled from the reference's
    std, ``n_layers ** -0.5``, to ``fan_in ** -0.5`` (its input width,
    the second-last axis).  Cut to one or two layers, the reference's rule
    draws std 0.71-1.0 at widths of 1024-5120: attention scores run to
    thousands, the softmax saturates, and a one-ulp change of the weights
    moves the float32 logits by as much as the check allows, so no two
    devices could be held to it; at fan-in scale they move about a
    hundred times less."""
    from repro_torch.models import init_model

    return _fan_in(init_model(_cfg32(arch), seed=1, device="cpu"))


def _fan_in(model):
    """``model`` with every random per-layer matrix (and the encoder's)
    rescaled from the reference's std, ``n_layers ** -0.5``, to
    ``fan_in ** -0.5`` (see ``_float32_model``), in place."""
    cfg = model.cfg
    with torch.no_grad():
        for layers, n in ((model.layers, cfg.n_layers),
                          (model.encoder, cfg.n_encoder_layers)):
            for p in (t for layer in layers for t in layer.values()):
                if p.dim() >= 2 and not bool((p == p.flatten()[0]).all()):
                    p.mul_(n ** 0.5 * p.shape[-2] ** -0.5)
    return model


def _cpu_float32_run(arch):
    """(In the background process.)  The CPU half of ``arch``'s
    card-vs-CPU check."""
    torch.set_num_threads(CPU_REF_THREADS)
    t0 = time.perf_counter()
    model = _float32_model(arch)
    drawn = time.perf_counter() - t0
    run = _float32_run(arch, model, "cpu", False)
    return run, (f"[cpu] {arch} float32 reference run: weights drawn in "
                 f"{drawn:.2f} s, served in {run[3]:.2f} s\n")


def _card_vs_cpu(arch, tag, model=None):
    """The card against the CPU, float32 compute, at ``CARD_VS_CPU``'s
    depth and mix, full width, the same weights (``_float32_model``'s,
    or ``model``, drawn so beforehand, moved to the card): equal tokens,
    completion order and epochs, and the first and fourth decode epochs'
    logits within 1e-3; on the card the graphed server and the eager one,
    with equal tokens and logits.  The CPU run is the background
    process's (``CpuRefs``)."""
    cfg32 = _cfg32(arch)
    model = (_float32_model(arch) if model is None else model).to("cuda")
    runs = [_float32_run(arch, model, "cuda", g) for g in (True, False)]
    del model
    torch.cuda.empty_cache()
    (g_out, g_ep, g_lg, g_s), (e_out, e_ep, e_lg, _) = runs
    c_out, c_ep, c_lg, c_s = cpu_ref("serve", arch, "float32")
    if g_out != e_out or g_ep != e_ep or not torch.equal(g_lg, e_lg):
        fail(f"{tag} float32: the graphed server's tokens or logits differ "
             "from the eager server's on the card")
    lg_err = float((g_lg - c_lg).abs().max())
    if g_out != c_out or g_ep != c_ep:
        fail(f"{tag} float32: the card's tokens {g_out} (epochs {g_ep}) "
             f"differ from the CPU's {c_out} (epochs {c_ep})")
    if not lg_err <= 1e-3:
        fail(f"{tag} float32: the first or fourth decode epoch's logits "
             f"differ by {lg_err}")
    n_layers, n_req = CARD_VS_CPU[arch][:2]
    print(f"[{tag}] {cfg32.name} float32, {n_layers} layers at full width, "
          f"{n_req} requests in 4 slots: card (graphed and eager) and CPU "
          f"give equal tokens per request, completion order and {g_ep} "
          f"epochs; first and fourth decode epochs' logits within "
          f"{lg_err:.3g} (card {g_s:.2f} s, CPU {c_s:.2f} s)")


def phase_serve():
    from repro_torch import configs

    CPU_REFS[0].submit([("serve", arch, "float32") for arch in CARD_VS_CPU]
                       + [("train", "granite_3_8b", "float32")])

    cfg = configs.get_config("granite_3_8b")
    srv, model, epochs, n_pf, launches = _serve_cell(cfg, SERVE_REQUESTS,
                                                     "serve")
    L = cfg.n_layers
    _expect_launches("serve", launches, {
        "fork_scan": n_pf, "flash_attention": n_pf * L,
        "decode_attention": epochs * L, "ssd_scan": 0})
    # after the run: this overwrites the slots' caches
    _profile_prefill(f"{cfg.name} prefill, 16 x 1024 tokens (one bucket)",
                     srv, model, cfg)
    del srv
    torch.cuda.empty_cache()
    _decode_graphs(cfg, model, "serve")
    del model
    torch.cuda.empty_cache()
    _card_vs_cpu("granite_3_8b", "serve")
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
    _profile_prefill(f"{cfg.name} prefill, 16 x 1024 tokens (one bucket)",
                     srv, model, cfg, "ssd_scan", ("ssd_",))
    del srv
    torch.cuda.empty_cache()
    _decode_graphs(cfg, model, "ssm")
    del model
    torch.cuda.empty_cache()
    _card_vs_cpu("mamba2_1_3b", "ssm")

    hcfg = configs.get_config("hymba_1_5b")
    srv, model, h_epochs, h_pf, h_launches = _serve_cell(
        hcfg, HYMBA_REQUESTS, "hybrid")
    L = hcfg.n_layers
    _expect_launches("hybrid", h_launches, {
        "fork_scan": h_pf, "ssd_scan": h_pf * L, "flash_attention": h_pf * L,
        "decode_attention": h_epochs * L})
    del srv, model
    torch.cuda.empty_cache()
    _card_vs_cpu("hymba_1_5b", "hybrid")
    return launches, h_launches


# --------------------------------------------------------------- phase 8c
MOE_REQUESTS = 48          # granite-moe: phase 8's mix
LLAMA4_LAYERS = 12         # of 48: ~4.40 GB of bf16 weights a layer
LLAMA4_REQUESTS = 16
WHISPER_REQUESTS = 32
WHISPER_MAX_LEN = 512      # prompt + output under the decoder's 448
WHISPER_MIX = dict(plen=(4, 64), new=(32, 128))


def phase_moe_encdec_serve():
    """The MoE and encoder-decoder serving path, bf16, random weights from
    seed 0, 16 slots: granite-moe-1b at full size (phase 8's mix),
    llama4-scout at full width and 12 of 48 layers (16 requests of the
    mix) and whisper-large-v3 at full size (32 requests of 4-64 prompt
    tokens and 32-128 new, 512 rows, one frame input shared by the slots),
    each with the launches its code predicts; granite-moe's decode graph
    (one capture, tokens equal to eager); each model's float32 card-vs-CPU
    run.  Returns each cell's launches."""
    from repro_torch import configs

    # llama4-scout's float32 weights for its card-vs-CPU run, drawn on the
    # CPU beside the card's work (one thread, ~40 s)
    drawing = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    llama4_f32 = drawing.submit(_float32_model, "llama4_scout_17b_a16e")
    drawing.shutdown(wait=False)
    out = {}
    cfg = configs.get_config("granite_moe_1b_a400m")
    srv, model, epochs, n_pf, launches = _serve_cell(cfg, MOE_REQUESTS,
                                                     "moe")
    L = cfg.n_layers
    _expect_launches("moe", launches, {
        "fork_scan": n_pf, "flash_attention": n_pf * L,
        "decode_attention": epochs * L, "ssd_scan": 0})
    out["moe"] = launches
    del srv
    torch.cuda.empty_cache()
    _decode_graphs(cfg, model, "moe")
    del model
    torch.cuda.empty_cache()
    _card_vs_cpu("granite_moe_1b_a400m", "moe")
    lap("8c granite-moe")

    cfg = dataclasses.replace(configs.get_config("llama4_scout_17b_a16e"),
                              n_layers=LLAMA4_LAYERS)
    srv, model, epochs, n_pf, launches = _serve_cell(
        cfg, LLAMA4_REQUESTS, "llama4")
    L = cfg.n_layers
    _expect_launches("llama4", launches, {
        "fork_scan": n_pf, "flash_attention": n_pf * L,
        "decode_attention": epochs * L, "ssd_scan": 0})
    out["llama4"] = launches
    del srv, model
    torch.cuda.empty_cache()
    lap("8c llama4-scout")

    cfg = configs.get_config("whisper_large_v3")
    srv, model, epochs, n_pf, launches = _serve_cell(
        cfg, WHISPER_REQUESTS, "whisper", max_len=WHISPER_MAX_LEN,
        **WHISPER_MIX)
    L, Le = cfg.n_layers, cfg.n_encoder_layers
    # a prefill: the encoder's self-attention, the decoder's self- and
    # cross-attention; an epoch: the decoder's self and cross decodes
    _expect_launches("whisper", launches, {
        "fork_scan": n_pf, "flash_attention": n_pf * (Le + 2 * L),
        "decode_attention": epochs * 2 * L, "ssd_scan": 0})
    out["whisper"] = launches
    del srv, model
    torch.cuda.empty_cache()
    _card_vs_cpu("whisper_large_v3", "whisper")
    lap("8c whisper")
    # last: its weights' draw and its CPU half take the longest
    _card_vs_cpu("llama4_scout_17b_a16e", "llama4", llama4_f32.result())
    return out


# --------------------------------------------------------------- phase 8d
# train_granite_d12: granite-3-8b at full width and 12 of its 40 layers
# (2.59 B float32 parameters: with their gradients and AdamW's two moments
# about 41 GB, as much as one card holds beside the activations), bf16
# compute, remat "full"; SyntheticLM batches of 4 x 2048 from seed 0;
# AdamW over cosine_schedule(3e-3, 10 warmup steps, 5 steps), the
# reference build's schedule and rate
TRAIN_LAYERS = 12
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 4, 2048, 5, 3e-3
# the card against the CPU: one layer at full width, float32, one sequence
# of 256, two steps from the same parameters
TRAIN_CHECK_SEQ, TRAIN_CHECK_STEPS = 256, 2
TRAIN_VALUE_TOL = 1e-4  # loss and grad norm, relative
TRAIN_GRAD_TOL = 1e-3   # each step-1 gradient: of its max |CPU value|
# after step 2: Adam moves an element by about lr at each step whatever
# its gradient's size, so an element whose tiny gradient has the other
# sign on the other device ends up to 2 (lr1 + lr2) away; every element
# must be within that, and at most 1% of each parameter's elements more
# than 1e-5 of its max |value| away
TRAIN_MOVED_FRACTION = 1e-2


class _Watched:
    """An optimiser that shows each step's parameters and gradients to
    ``look`` before it updates them (the train step calls ``update``)."""

    def __init__(self, opt, look):
        self.opt, self.look = opt, look

    def update(self, params, grads, state):
        self.look(params, grads)
        return self.opt.update(params, grads, state)


def _train_setup(cfg, params, steps, look, seq, batch, seed):
    """(step function, optimiser state, data) for ``params``, as the
    port's ``build`` makes them."""
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.train import init_opt_state, make_train_step
    from repro_torch.optim import AdamW, cosine_schedule

    opt = AdamW(lr=cosine_schedule(TRAIN_LR, warmup_steps=10,
                                   total_steps=steps))
    return (make_train_step(cfg, _Watched(opt, look)),
            init_opt_state(opt, params),
            SyntheticLM(cfg.vocab, seq, batch, seed=seed))


def _train_check_cfg():
    from repro_torch import configs

    return dataclasses.replace(configs.get_config("granite_3_8b"),
                               n_layers=1, compute_dtype=torch.float32)


def _train_check_run(device):
    """Two float32 steps of one full-width granite layer on ``device``,
    from weights drawn on the CPU from seed 1 at fan-in scale
    (``_fan_in``): (each step's loss and grad norm, step 1's gradients and
    the parameters after step 2, on the host)."""
    from repro_torch.data import place_batch
    from repro_torch.models import init_model

    cfg = _train_check_cfg()
    model = _fan_in(init_model(cfg, seed=1, device="cpu", trainable=True))
    model = model.to(device)
    seen = {}

    def look(params, grads):
        seen.setdefault("grads", {k: g.detach().float().cpu().clone()
                                  for k, g in grads.items()})

    step, state, data = _train_setup(cfg, model, TRAIN_STEPS, look,
                                     TRAIN_CHECK_SEQ, 1, 2)
    metrics = []
    for s in range(TRAIN_CHECK_STEPS):
        model, state, mt = step(model, state,
                                place_batch(data.batch_at(s), device))
        metrics.append({k: float(mt[k]) for k in ("loss", "grad_norm",
                                                  "lr")})
    return metrics, seen["grads"], {
        n: p.detach().cpu() for n, p, _ in model.named_leaves()}


def _cpu_train_run():
    """(In the background process.)  The CPU half of phase 8d's
    card-vs-CPU check."""
    torch.set_num_threads(CPU_REF_THREADS)
    t0 = time.perf_counter()
    run = _train_check_run("cpu")
    return run, (f"[cpu] granite-3-8b one layer float32 training reference"
                 f": {TRAIN_CHECK_STEPS} steps in "
                 f"{time.perf_counter() - t0:.2f} s\n")


def _train_vs_cpu():
    """Phase 8d's check of the card against the CPU (module constants)."""
    from repro_torch.kernels import flash_attention

    t0 = time.perf_counter()
    flash_attention.reset_launches()
    c_metrics, c_grads, c_params = _train_check_run("cuda")
    card_s = time.perf_counter() - t0
    L = 1
    if (flash_attention.LAUNCHES["flash_attention"],
            flash_attention.LAUNCHES["flash_attention_bwd"]) != (
            TRAIN_CHECK_STEPS * 2 * L, TRAIN_CHECK_STEPS * 3 * L):
        fail(f"train float32: launches {dict(flash_attention.LAUNCHES)}")
    h_metrics, h_grads, h_params = cpu_ref("train", "granite_3_8b",
                                           "float32")
    worst = {}
    for s, (c, h) in enumerate(zip(c_metrics, h_metrics)):
        for k in ("loss", "grad_norm"):
            e = abs(c[k] - h[k]) / abs(h[k])
            worst[k] = max(worst.get(k, 0.0), e)
            if not e <= TRAIN_VALUE_TOL:
                fail(f"train float32 step {s + 1} {k}: card {c[k]}, CPU "
                     f"{h[k]}")
    worst["grad"] = 0.0
    for k, h in h_grads.items():
        e = float((c_grads[k] - h).abs().max()) / float(h.abs().max())
        worst["grad"] = max(worst["grad"], e)
        if not e <= TRAIN_GRAD_TOL:
            fail(f"train float32 step 1 grad {k}: max |card - CPU| is "
                 f"{e:.3g} of its max |CPU value|")
    lr_sum = sum(m["lr"] for m in h_metrics)
    worst["param"] = worst["moved"] = 0.0
    for k, h in h_params.items():
        d = (c_params[k] - h).abs()
        moved = float((d > 1e-5 * float(h.abs().max())).float().mean())
        worst["param"] = max(worst["param"], float(d.max()))
        worst["moved"] = max(worst["moved"], moved)
        if float(d.max()) > 2 * lr_sum * 1.01 or moved > TRAIN_MOVED_FRACTION:
            fail(f"train float32 params {k} after step 2: max |card - CPU| "
                 f"{float(d.max())} (bound {2 * lr_sum}), {moved:.3g} of "
                 "the elements apart")
    print(f"[train] granite-3-8b float32, one layer at full width, 1 x "
          f"{TRAIN_CHECK_SEQ} tokens, {TRAIN_CHECK_STEPS} steps, card "
          f"(FlashAttention, the kernels) against CPU (the plain path): "
          f"loss within {worst['loss']:.3g} and grad norm within "
          f"{worst['grad_norm']:.3g} (relative; tolerance "
          f"{TRAIN_VALUE_TOL}), every step-1 gradient within "
          f"{worst['grad']:.3g} of its max |CPU value| (tolerance "
          f"{TRAIN_GRAD_TOL}), parameters after step 2 within "
          f"{worst['param']:.3g} (bound 2 x the two steps' lr = "
          f"{2 * lr_sum:.3g}), at most {100 * worst['moved']:.3f}% of a "
          f"parameter's elements more than 1e-5 of its max apart (limit "
          f"{100 * TRAIN_MOVED_FRACTION:.0f}%); card {card_s:.2f} s")


def phase_train():
    """Phase 8d: ``train_granite_d12`` through ``make_train_step`` (module
    constants), every kernel's count set to 0 before the five steps and
    read after; each step's loss and grad norm finite, every parameter's
    gradient present and finite and every parameter moved; ms a step,
    tokens/s, peak memory; one more step profiled (the backward kernels'
    share of device time); then the card against the CPU.  Returns the
    five steps' launches."""
    from types import SimpleNamespace

    from repro_torch import configs
    from repro_torch.data import place_batch
    from repro_torch.kernels import (
        decode_attention, flash_attention, fork_compact, ssd_scan,
    )
    from repro_torch.models import init_model

    cfg = dataclasses.replace(configs.get_config("granite_3_8b"),
                              n_layers=TRAIN_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_model(cfg, seed=0, device="cuda", trainable=True)
    leaves = [p for _, p, _ in params.named_leaves()]
    seen = {}

    def look(p, grads):
        seen["n_grads"] = sum(g is not None for g in grads.values())
        seen["finite"] = torch.stack(
            [torch.isfinite(g).all() for g in grads.values()]).all()
        seen["sums"] = torch.stack([x.sum(dtype=torch.float64)
                                    for x in p.values()])

    step, state, data = _train_setup(cfg, params, TRAIN_STEPS, look,
                                     TRAIN_SEQ, TRAIN_BATCH, 0)
    batches = [place_batch(data.batch_at(s), "cuda")
               for s in range(TRAIN_STEPS + 1)]
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in leaves)
    print(f"[train] {cfg.name}: {cfg.n_layers} of 40 layers at full width "
          f"(d_model {cfg.d_model}, {_describe(cfg)}, vocab {cfg.vocab}), "
          f"{n_params / 1e9:.3f} B float32 parameters, bf16 compute, remat "
          f"{cfg.remat!r}; parameters and AdamW state on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    mods = (fork_compact, flash_attention, decode_attention, ssd_scan)
    for mod in mods:
        mod.reset_launches()
    walls = []
    for s in range(TRAIN_STEPS):
        t = time.perf_counter()
        params, state, mt = step(params, state, batches[s])
        m = {k: float(v) for k, v in mt.items()}
        walls.append(time.perf_counter() - t)
        after = torch.stack([x.sum(dtype=torch.float64) for x in leaves])
        if not all(np.isfinite(m[k]) for k in ("loss", "grad_norm")):
            fail(f"train step {s + 1}: loss {m['loss']}, grad norm "
                 f"{m['grad_norm']}")
        if seen["n_grads"] != len(leaves) or not bool(seen["finite"]):
            fail(f"train step {s + 1}: {seen['n_grads']} of {len(leaves)} "
                 "gradients, or one not finite")
        unmoved = int((after == seen["sums"]).sum())
        if unmoved:
            fail(f"train step {s + 1}: {unmoved} parameters did not move")
        print(f"[train] step {s + 1}: loss {m['loss']:.4f} (xent "
              f"{m['xent']:.4f}, aux {m['aux']:.3g}, {m['n_tokens']:.0f} "
              f"tokens), grad norm {m['grad_norm']:.4f}, lr {m['lr']:.3g}, "
              f"{1e3 * walls[-1]:.1f} ms")
    launches = {"fork_scan": fork_compact.LAUNCHES["fork_scan"],
                **flash_attention.LAUNCHES, **decode_attention.LAUNCHES,
                **ssd_scan.LAUNCHES}
    L = cfg.n_layers
    print(f"[train] kernel launches during the {TRAIN_STEPS} steps: "
          f"{launches}")
    _expect_launches("train", launches, {
        "flash_attention": TRAIN_STEPS * L * 2,
        "flash_attention_bwd": TRAIN_STEPS * L * 3,
        "fork_scan": 0, "decode_attention": 0, "ssd_scan": 0})
    peak = torch.cuda.max_memory_allocated() / 2**30
    warm = float(np.mean(walls[1:]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"[train] train_granite_d12: {TRAIN_STEPS} steps of {TRAIN_BATCH}"
          f" x {TRAIN_SEQ} tokens, every loss and grad norm finite, every "
          f"parameter's gradient present and finite, every parameter "
          f"moved; step 1 {1e3 * walls[0]:.1f} ms, steps 2-{TRAIN_STEPS} "
          f"{1e3 * warm:.1f} ms a step ({tokens / warm:.0f} tokens/s), peak "
          f"memory {peak:.2f} GiB")
    if peak > 72:
        fail(f"train: peak memory {peak:.2f} GiB over 72")

    def one_step():
        step(params, state, batches[TRAIN_STEPS])
        return None, None, SimpleNamespace(epochs=1)

    busy, wall, events = phase_profile(
        f"train_granite_d12, one step (step {TRAIN_STEPS + 1})", one_step,
        cpu=False)
    bwd = device_us(events, "dkdv_kernel", "dq_kernel", "delta_kernel")
    fwd = device_us(events, "flash_wg_kernel")
    print(f"[train] one profiled step: device busy {busy / 1e3:.1f} of "
          f"{wall / 1e3:.1f} ms ({100 * busy / wall:.1f}%); "
          f"flash_attention_bwd {bwd / 1e3:.2f} ms ({100 * bwd / busy:.1f}% "
          f"of device time), flash_attention forward {fwd / 1e3:.2f} ms "
          f"({100 * fwd / busy:.1f}%)")
    del params, state, batches, leaves, seen, step
    torch.cuda.empty_cache()
    lap("8d train cell")
    _train_vs_cpu()
    return {"train": launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print("[env]", sys.version.split()[0], "torch", torch.__version__,
          "cuda", torch.version.cuda, torch.cuda.get_device_name(0))
    t0 = _T0[0] = time.perf_counter()
    phase_build()
    lap("build")
    CPU_REFS.append(CpuRefs())
    try:
        return _main(dev, t0)
    finally:
        CPU_REFS.pop().close()


def _main(dev, t0) -> int:
    from repro_torch.core import DeviceEngine

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 is float32
    torch.backends.cudnn.allow_tf32 = False
    rows = phase_kernels(dev)
    lap("kernels (scans)")
    rows.append(phase_fleet_chunks(dev, phase_chunks(dev)))
    lap("kernels (epoch_chunk)")
    rows.append(phase_ordered_add(dev))
    rows += phase_attention(dev)
    rows.append(phase_ssd(dev))
    lap("kernels")
    launches, cases, host_runs = phase_path()
    lap("path")
    app_launches, anneal_run = phase_apps(cases)
    lap("apps")
    fib_case = cases[0][0]
    launches.update(phase_resident(cases, host_runs))
    lap("resident")
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
    lap("resident profiles")
    svc_launches, svc_chunks, wave, host_waves = phase_service(cases,
                                                               host_runs)
    lap("service")
    shard_launches = phase_sharded(wave, host_runs)
    lap("sharded")
    chunk_paths["service"] = svc_chunks
    chunk_paths["sharded"] = shard_launches["epoch_chunk"]
    launches["epoch_chunk"] += svc_chunks + shard_launches["epoch_chunk"]
    seg_paths = {"service": svc_launches["segmented_fork_scan"],
                 "sharded": shard_launches["segmented_fork_scan"]}
    launches["segmented_fork_scan"] = sum(seg_paths.values())
    # type_rank's count: the host path's launches, the apps', the service
    # waves' and the plain sharded wave's
    type_rank_paths = {"host": launches["type_rank"],
                       "apps": app_launches["type_rank"],
                       "service": svc_launches["type_rank"],
                       "sharded": shard_launches["type_rank"]}
    launches["type_rank"] += (app_launches["type_rank"]
                              + svc_launches["type_rank"]
                              + shard_launches["type_rank"])
    fork_scan_paths = {"host": launches["fork_scan"],
                       "apps": app_launches["fork_scan"]}
    launches["fork_scan"] += app_launches["fork_scan"]

    first_wave_ms = {d: host_waves[d][1] for d in host_waves}
    graph_out = phase_graphs(fib_case, wave, host_waves, anneal_run)
    del host_waves
    lap("graphs")
    ctl_launches, trace_launches = phase_control(cases, host_runs, wave,
                                                 graph_out, first_wave_ms)
    lap("control")
    # the control phase's launches, each auto run and each traced run
    # counted alone: the solo host runs (fork_scan, type_rank), the host
    # waves (segmented_fork_scan, type_rank), the device waves (epoch_chunk)
    for k, paths in (("fork_scan", fork_scan_paths),
                     ("type_rank", type_rank_paths),
                     ("segmented_fork_scan", seg_paths),
                     ("epoch_chunk", chunk_paths)):
        for path, counts in (("control", ctl_launches),
                             ("trace", trace_launches)):
            if counts.get(k, 0):
                paths[path] = counts[k]
                launches[k] += counts[k]

    def device_wave():
        svc, _, _ = run_wave(wave, "masked", engine="device",
                             megakernel=True)
        return None, None, svc.stats()

    busy, wall, _ = phase_profile(
        "mixed4 JobService(engine='device', megakernel=True) masked, one "
        "chunk (global epochs)", device_wave)
    print(f"[profile] mixed4 device wave busy share "
          f"{100 * busy / wall:.1f}%")
    lap("service profile")
    cells = {"serve": phase_serve()}
    lap("serve")
    cells["ssm"], cells["hybrid"] = phase_ssm_serve()
    lap("ssm")
    cells.update(phase_moe_encdec_serve())
    lap("moe and encoder-decoder serve")
    cells.update(phase_train())
    lap("train")
    # the serving kernels' counts by cell; fork_scan's: the host path's,
    # the apps', the servers'
    serve_paths = {k: {cell: n[k] for cell, n in cells.items() if n[k]}
                   for k in ("flash_attention", "flash_attention_bwd",
                             "decode_attention", "ssd_scan")}
    for k, paths in serve_paths.items():
        launches[k] = sum(paths.values())
    for cell, n in cells.items():
        fork_scan_paths[cell] = n["fork_scan"]
        launches["fork_scan"] += n["fork_scan"]
    phase_examples()
    lap("examples")
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
        if r["name"] == "segmented_fork_scan":
            r["launches_by_path"] = seg_paths
        if r["name"] in serve_paths:
            r["launches_by_path"] = serve_paths[r["name"]]
    print(f"[profile] profiles that needed a second attempt: "
          f"{PROFILE_RETRIES or 'none'}")
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
