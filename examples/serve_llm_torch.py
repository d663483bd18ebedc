"""Serving driver on the PyTorch/CUDA port's layered front door: async
submit/stream, quota classes, deadlines, and chunk-boundary preemption
(DESIGN.md §16; ``examples/serve_llm.py`` on ``repro_torch``).

The default path drives a toy autoregressive *decode* Program — each
request is a sequential fork/join chain, one token per epoch, the shape
continuous batching cares about — through the :class:`JobService` async
surface: interactive requests carry a priority and a deadline and may
preempt batch requests at chunk boundaries; completions stream back as
they finish, never blocking on a whole wave.

The model-based continuous-batching server (real transformer/SSM decode
through ``repro_torch.serving.EpochServer``) runs with ``--legacy [--arch
granite_3_8b]``; an encoder-decoder architecture raises
``NotImplementedError`` there, as the port does.  Runs on the card unless
``--device cpu`` is given.

Run:  PYTHONPATH=src python examples/serve_llm_torch.py [--requests 16]
      PYTHONPATH=src python examples/serve_llm_torch.py --legacy \
          --arch mamba2_1_3b
"""
import argparse
import asyncio
import time

import numpy as np
import torch

from repro_torch.core.program import InitialTask, Program, TaskType
from repro_torch.service import JobService, QuotaClass


# ---------------------------------------------------------------- toy decode
# One "token" per chain link: decode(remaining, acc) forks its successor
# until the budget runs out, then the emitted value folds back up the join
# chain — a pure sequential dependency, exactly an LLM decode loop's shape.
def _decode(ctx):
    remaining = ctx.argi(0)
    acc = ctx.argi(1)
    leaf = remaining == 0
    ctx.emit(acc, where=leaf)
    nxt = (acc * 31 + 7) % 997
    ctx.fork("decode", argi=(remaining - 1, nxt), where=~leaf)
    ctx.join("collect", where=~leaf)


def _collect(ctx):
    cv = ctx.child_values(1)
    ctx.emit(cv[0, 0])


DECODE = Program(
    name="decode",
    tasks=(TaskType("decode", _decode), TaskType("collect", _collect)),
    n_arg_i=2,
    value_width=1,
    value_dtype=torch.int32,
)


async def serve(args) -> None:
    svc = JobService(
        engine=args.engine,
        chunk=(args.chunk if args.engine == "device" else None),
        capacity=args.slots * 64,
        max_jobs=args.slots,
        classes=[
            QuotaClass("interactive", priority=10),
            QuotaClass("batch", priority=0),
        ],
        device=args.device,
    )
    rng = np.random.RandomState(0)
    futures = {}
    t0 = time.monotonic()
    for i in range(args.requests):
        interactive = i % 3 == 0
        tokens = int(rng.randint(4, 32))
        fut = svc.submit_async(
            DECODE,
            InitialTask(task="decode", argi=(tokens, int(rng.randint(997)))),
            quota=64,
            name=f"req{i}",
            klass="interactive" if interactive else "batch",
            deadline=(args.deadline if interactive else None),
        )
        futures[fut.job_id] = (fut, tokens)
    done = 0
    total_tokens = 0
    async for h in svc.stream_results():
        fut, tokens = futures[h.job_id]
        done += 1
        total_tokens += tokens
        print(
            f"  {h.job.name:>6s} [{h.klass:>11s}] {tokens:2d} tok "
            f"wait={h.queue_wait * 1e3:6.1f}ms run={h.run_time * 1e3:6.1f}ms"
            f"{'  (preempted x%d)' % h.preemptions if h.preemptions else ''}"
        )
    dt = time.monotonic() - t0
    adm = svc.admission
    print(
        f"{done} requests, {total_tokens} tokens in {dt:.2f}s "
        f"-> {total_tokens / dt:.0f} tok/s ({args.engine} engine)"
    )
    print(
        f"  deadline miss ratio: {adm.miss_ratio():.2f}  "
        f"preemptions: {dict(adm.preempted) or 0}"
    )
    if done != args.requests:
        raise SystemExit(f"{done} of {args.requests} requests finished")


def legacy(args) -> None:
    from repro_torch import configs
    from repro_torch.models import init_model
    from repro_torch.serving import EpochServer, Request

    cfg = configs.get_reduced(args.arch)
    model = init_model(cfg, seed=0, device=args.device)
    rng = np.random.RandomState(0)
    enc = None
    if cfg.encdec:
        enc = torch.as_tensor(
            rng.normal(size=(1, cfg.encoder_len, cfg.d_model)),
            dtype=torch.float32,
        )
    server = EpochServer(
        cfg, model, n_slots=args.slots, max_len=128, enc_frames=enc,
        device=args.device,
    )
    for i in range(args.requests):
        server.submit(
            Request(
                prompt=rng.randint(3, cfg.vocab, rng.randint(4, 20)).astype(
                    np.int32
                ),
                max_new_tokens=int(rng.randint(4, 16)),
            )
        )
    t0 = time.time()
    done = server.run_to_completion()
    if server.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    tok = sum(len(r.output) for r in done)
    print(
        f"{cfg.name}: {len(done)} requests, {tok} tokens, "
        f"{server.epochs} epochs ({args.slots} slots) in {dt:.1f}s "
        f"-> {tok / dt:.1f} tok/s"
    )
    print(f"  epochs per token ~ {server.epochs / max(tok, 1):.2f} "
          f"(continuous batching keeps slots busy across ragged requests)")
    for r in done[:4]:
        print(f"  rid={r.rid:2d} prompt_len={len(r.prompt):2d} -> {r.output}")
    if len(done) != args.requests or any(
            len(r.output) != r.max_new_tokens for r in done):
        raise SystemExit("a request did not receive its tokens")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--engine", default="device",
                    choices=("host", "device"))
    ap.add_argument("--chunk", type=int, default=4,
                    help="K epochs per resident chunk (device engine)")
    ap.add_argument("--deadline", type=float, default=30.0,
                    help="interactive-class deadline in seconds (wall "
                         "clock, so leave headroom for kernel builds)")
    ap.add_argument("--legacy", action="store_true",
                    help="run the model-based EpochServer path instead")
    ap.add_argument("--arch", default="granite_3_8b",
                    help="(--legacy) reduced model config to serve")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.legacy:
        legacy(args)
    else:
        asyncio.run(serve(args))
