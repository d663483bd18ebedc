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
Each epoch reads back one argmax vector.  The server runs any model the
model code runs: dense attention, Mamba-2 SSM or the hybrid, with a dense
or MoE FFN, decoder-only or encoder-decoder.  An encoder-decoder server
encodes its frame input once, shares it across the slots as the cache's
``enc_out``, ``cross_k`` and ``cross_v``, and hands every prefill the
frames again (its encoder runs over them, as the reference's does).

On the card the decode step is captured once per server in a CUDA graph
(``graphs=True``, the default), as the reference jits it once: the first
decode epoch runs eagerly, the second captures the step, and each epoch
copies the tokens into the graph's token buffer and replays it; the
argmax and its copy to page-locked host memory are the graph's last
nodes.  Prefills stay eager and write the cache the graph reads in place.
``graphs=False`` decodes eagerly, for comparison.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Mapping, Optional, Union

import numpy as np
import torch

from ..core import graphs as cgraphs
from ..core.convert import params_from_numpy
from ..core.engine import resolve_device
from ..kernels import ops as kops
from ..models.common import ModelConfig
from ..models.model import (
    Model, build_cross_cache, decode_step, encode, init_cache, prefill,
)


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
    there is none; pass ``device="cpu"`` for the CPU.  An encoder-decoder
    config needs ``enc_frames`` (1 or more, T_enc, d; a tensor or a numpy
    array, of which the first is served); other configs ignore it.
    ``graphs`` replays the decode step from a CUDA graph on the card from
    the second decode epoch on (``captures`` counts the captures: one per
    server that decodes twice); it changes nothing on the CPU.  ``last_logits`` is
    then the graph's logits buffer, which the next epoch's replay
    overwrites: read it before the next ``step``.
    """

    def __init__(self, cfg: ModelConfig,
                 params_or_model: Union[Model, Mapping[str, np.ndarray]],
                 n_slots: int = 8, max_len: int = 256, device=None,
                 enc_frames=None, graphs: bool = True):
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
        self._enc_frames = None
        if cfg.encdec:
            self._encode_once(enc_frames)
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
        # the decode graph (core/graphs.py) and its token buffer
        self.graphs = bool(graphs) and self.device.type == "cuda"
        self.captures = 0
        self._decode_graph: Dict[None, Any] = {}  # core/graphs.py's cache
        self._side = None
        self._tokens = torch.zeros((n_slots, 1), dtype=torch.int64,
                                   device=self.device)
        self._next_host = None

    @torch.no_grad()
    def _encode_once(self, enc_frames) -> None:
        """Encode the first frame input once, broadcast it to every slot as
        ``enc_out`` and build the cross-attention K/V from it, in the cache
        the decode step reads (the reference's server shares one input
        across its slots)."""
        if enc_frames is None:
            raise ValueError("an encoder-decoder config needs enc_frames")
        frames = torch.as_tensor(enc_frames, device=self.device)
        self._enc_frames = frames
        enc = encode(self.params, self.cfg, frames[:1])
        self.cache["enc_out"].copy_(enc.expand_as(self.cache["enc_out"]))
        del self.cache["cross_k"], self.cache["cross_v"]  # built anew
        self.cache["cross_k"], self.cache["cross_v"] = build_cross_cache(
            self.params, self.cfg, self.cache["enc_out"])

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
        ef = None
        if self.cfg.encdec:  # every prefill row reads the shared frames
            ef = self._enc_frames[:1].expand(
                (n_new,) + tuple(self._enc_frames.shape[1:]))
        logits, self.cache = prefill(
            self.params, self.cfg, torch.as_tensor(toks, device=self.device),
            last_positions=torch.as_tensor(
                np.asarray(plens, np.int64) - 1, device=self.device),
            enc_frames=ef, cache=self.cache,
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
        nxt = self._decode()
        self.epochs += 1
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

    def _decode(self) -> np.ndarray:
        """The bulk decode step over every slot: this epoch's next token
        per slot, on the host.  On the card with graphs, the first epoch
        runs eagerly (the capture's warm-up), the second captures the
        decode graph on a side stream, and every epoch after replays it."""
        self._tokens.copy_(torch.from_numpy(self.last_token[:, None]))
        if not self.graphs:
            logits, _ = decode_step(self.params, self.cfg, self._tokens,
                                    self.cache)
            self.last_logits = logits
            return logits.argmax(-1).cpu().numpy()

        def step():
            logits, _ = decode_step(self.params, self.cfg, self._tokens,
                                    self.cache)
            nxt = logits.argmax(-1)
            if self._next_host is None:
                self._next_host = cgraphs.pinned_like(nxt)
            self._next_host.copy_(nxt, non_blocking=True)
            return logits

        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        self.last_logits, captured = cgraphs.run_cached(
            self._decode_graph, None, step, self._side)
        self.captures += captured
        torch.cuda.current_stream(self.device).synchronize()
        return self._next_host.numpy().copy()

    def graph_memory(self):
        """``(pool bytes, result-buffer bytes)`` of the decode graph."""
        g = self._decode_graph.get(None)
        if not isinstance(g, cgraphs.CapturedStep):
            return 0, 0
        return (cgraphs.pool_bytes(g.graph.pool()),
                cgraphs.result_bytes([g]))

    def run_to_completion(self, max_epochs: int = 10_000):
        while (self.queue or self.active.any()) and self.epochs < max_epochs:
            self.step()
        return self.completed
