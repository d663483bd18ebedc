"""Epoch-synchronized serving engine: the TVM applied to LLM serving (a
copy of ``repro/serving/engine.py``).

The mapping to the paper's machine (§4):

  TV slot          <-> request slot (fixed batch position + its KV cache)
  task type        <-> {prefill, decode}
  fork             <-> admitting a request's first decode task (prefill
                       forks the decode chain); each decode forks its
                       successor until EOS/max_tokens
  emit             <-> completing a request (slot contents retired)
  epoch (phase 2)  <-> one bulk ``decode_step`` over *all* slots —
                       work-together: every active task executes in one
                       dispatch, load-balanced by the batch dimension
  nextFreeCore     <-> free-slot allocation by prefix sum over the free
                       mask (the ``fork_scan`` kernel on the card)
  phase 1/3 (CPU)  <-> admission + retirement bookkeeping on the host

Prefills are batched per epoch (bucketed padding) and write their K/V, or
their SSM state and conv window, straight into the slots they were
allocated — the analogue of the paper's coalesced TV writes at fork time.
Each epoch reads back one argmax vector.  The server runs any block type
the model code runs: dense attention, Mamba-2 SSM, or the hybrid.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Mapping, Optional, Union

import numpy as np
import torch

from ..core.convert import params_from_numpy
from ..core.engine import resolve_device
from ..kernels import ops as kops
from ..models.common import ModelConfig
from ..models.model import Model, decode_step, init_cache, prefill


@dataclasses.dataclass
class Request:
    prompt: np.ndarray            # (len,) i32
    max_new_tokens: int = 32
    eos: Optional[int] = None
    # filled by the engine
    rid: int = -1
    output: Optional[List[int]] = None


def _bucket(n: int, minimum: int = 8) -> int:
    p = minimum
    while p < n:
        p *= 2
    return p


class EpochServer:
    """Continuous batching over ``n_slots`` request slots of ``max_len``
    cache rows.

    ``params_or_model`` is a :class:`Model` on ``device`` or the
    reference's ``init_model`` dict as numpy arrays (converted with
    ``params_from_numpy``).  ``device`` defaults to CUDA and raises where
    there is none; pass ``device="cpu"`` for the CPU.
    """

    def __init__(self, cfg: ModelConfig,
                 params_or_model: Union[Model, Mapping[str, np.ndarray]],
                 n_slots: int = 8, max_len: int = 256, device=None,
                 enc_frames=None):
        if enc_frames is not None or cfg.encdec:
            raise NotImplementedError(
                "encoder-decoder serving is not ported yet (ROADMAP item 11:"
                " encode, cross-attention)")
        self.device = resolve_device(device)
        if isinstance(params_or_model, Model):
            on = params_or_model.device
            if on.type != self.device.type or (
                    self.device.index is not None
                    and on.index != self.device.index):
                raise ValueError(f"the model lies on {on}, the server on "
                                 f"{self.device}")
            self.params = params_or_model
        else:
            self.params = params_from_numpy(params_or_model, cfg, self.device)
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.cache = init_cache(cfg, n_slots, max_len, device=self.device)
        # host-side TV bookkeeping (paper phase 1/3 state)
        self.active = np.zeros(n_slots, bool)
        self.remaining = np.zeros(n_slots, np.int64)
        self.last_token = np.zeros(n_slots, np.int64)
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self.queue: List[Request] = []
        self.completed: List[Request] = []
        self.epochs = 0
        self._rid = 0
        # the last decode epoch's logits (n_slots, vocab_padded) float32,
        # and host wall seconds spent in prefills and decode epochs
        self.last_logits: Optional[torch.Tensor] = None
        self.timings: Dict[str, float] = {"prefill_s": 0.0, "decode_s": 0.0,
                                          "prefills": 0}

    # ----------------------------------------------------------- frontend
    def submit(self, req: Request) -> int:
        req.rid = self._rid
        req.output = []
        self._rid += 1
        self.queue.append(req)
        return req.rid

    # ----------------------------------------------------- fork: admission
    @torch.no_grad()
    def _admit(self):
        """Allocate free slots to queued requests by prefix sum (fork)."""
        free = ~self.active
        n_free = int(free.sum())
        n_new = min(n_free, len(self.queue))
        if n_new == 0:
            return
        t0 = time.perf_counter()
        # prefix-sum slot allocation: contiguous ranks over the free mask —
        # the same cooperative allocation the engine/kernels use (no atomics)
        offsets, _ = kops.fork_offsets(
            torch.as_tensor(free.astype(np.int32), device=self.device))
        rank = offsets.cpu().numpy()
        slots = np.nonzero(free & (rank < n_new))[0]
        reqs = [self.queue.pop(0) for _ in range(n_new)]

        # bulk prefill at a bucketed length (one epoch-style dispatch),
        # its K/V written straight into the allocated slots
        plens = [len(r.prompt) for r in reqs]
        Lp = _bucket(max(plens))
        toks = np.zeros((n_new, Lp), np.int64)
        for i, r in enumerate(reqs):
            toks[i, : len(r.prompt)] = r.prompt  # right-pad: ragged prompts
        logits, self.cache = prefill(
            self.params, self.cfg, torch.as_tensor(toks, device=self.device),
            last_positions=torch.as_tensor(
                np.asarray(plens, np.int64) - 1, device=self.device),
            cache=self.cache,
            slots=torch.as_tensor(slots, device=self.device),
        )
        next_tok = logits.argmax(-1).cpu().numpy()
        self.timings["prefill_s"] += time.perf_counter() - t0
        self.timings["prefills"] += 1
        for i, r in enumerate(reqs):
            s = slots[i]
            self.active[s] = True
            self.remaining[s] = r.max_new_tokens
            self.last_token[s] = next_tok[i]
            self.slot_req[s] = r
            r.output.append(int(next_tok[i]))

    # ------------------------------------------------------------- epochs
    @torch.no_grad()
    def step(self):
        """One serving epoch: phase 1 admit, phase 2 bulk decode, phase 3
        retire (the paper's three-phase structure)."""
        self._admit()
        if not self.active.any():
            return False
        t0 = time.perf_counter()
        toks = torch.as_tensor(self.last_token[:, None], device=self.device)
        logits, self.cache = decode_step(self.params, self.cfg, toks,
                                         self.cache)
        self.last_logits = logits
        self.epochs += 1
        nxt = logits.argmax(-1).cpu().numpy()
        self.timings["decode_s"] += time.perf_counter() - t0
        for s in range(self.n_slots):
            if not self.active[s]:
                continue
            r = self.slot_req[s]
            self.remaining[s] -= 1
            tok = int(nxt[s])
            done = self.remaining[s] <= 0 or (
                r.eos is not None and tok == r.eos
            )
            if not done:
                r.output.append(tok)
                self.last_token[s] = tok
            if done:
                # emit: retire the slot (entry invalid; reclaimed by admit)
                self.active[s] = False
                self.slot_req[s] = None
                self.completed.append(r)
        return True

    def run_to_completion(self, max_epochs: int = 10_000):
        while (self.queue or self.active.any()) and self.epochs < max_epochs:
            self.step()
        return self.completed
