"""Serving entry point: the epoch-synchronized (TVM) continuous-batching
engine over an architecture config (dense attention, Mamba-2 SSM or the
hybrid), on the card unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \
      --requests 16 --slots 4 --max-new 24
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b

As in the reference, ``--reduced`` is on by default (it cannot be turned
off), so the model is the architecture's small same-family config.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from .. import configs
from ..models.model import init_model
from ..serving import EpochServer, Request


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="granite_3_8b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = configs.get_reduced(args.arch)
    server = EpochServer(
        cfg, init_model(cfg, seed=args.seed, device=args.device),
        n_slots=args.slots, max_len=args.max_len, device=args.device,
    )
    rng = np.random.RandomState(args.seed)
    for _ in range(args.requests):
        plen = rng.randint(4, 24)
        server.submit(
            Request(
                prompt=rng.randint(3, cfg.vocab, size=plen).astype(np.int32),
                max_new_tokens=args.max_new,
            )
        )
    t0 = time.time()
    done = server.run_to_completion()
    if server.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    n_tok = sum(len(r.output) for r in done)
    print(
        f"arch={cfg.name} served {len(done)} requests / {n_tok} tokens in "
        f"{server.epochs} epochs ({dt:.1f}s, {n_tok/dt:.1f} tok/s, "
        f"slots={args.slots}, device={server.device})"
    )
    for r in done[:3]:
        print(f"  rid={r.rid} len(prompt)={len(r.prompt)} out={r.output[:8]}…")


if __name__ == "__main__":
    main()
