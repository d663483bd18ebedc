"""Mixture-of-Experts layer with *work-together* dispatch (a copy of
``repro/models/moe.py``).

Token->expert routing is the paper's scheduling problem: tokens are tasks,
the expert id is the task type, and each token takes a *contiguous* slot
in its expert's buffer, ranked in flattened ``(batch, seq, k)`` order (no
atomics, deterministic), then one batched product over the expert axis
runs every expert's SwiGLU.  Capacity overflow drops an entry (GShard
semantics); the residual connection carries its token through.

Differences from the reference, none of them in the function computed:

- The reference's dispatch groups (``_n_groups``) are the data-parallel
  shards of a TPU mesh, and are one outside a sharding context; the port
  has no such context, so it has one group (G = 1) and its capacity per
  group is ``_capacity`` itself.  The reference's ``constrain`` calls are
  sharding hints and have no counterpart.
- JAX drops a scatter to an out-of-range row (``mode="drop"``); torch has
  no drop mode, so a dropped entry goes to a trailing sink row of the
  ``[E * C + 1, d]`` expert buffer, which no expert reads.
- The combine gathers each kept entry's row and sums over K as a
  reduction, not a scatter-add, so its sums have a fixed order on the card.

The layer reads no value back to the host and makes no shape from the
data (C depends on the token count alone), so a decode step that runs it
is captured in one CUDA graph.
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from .common import ModelConfig, ParamScope, mm_weight


def init_moe(s: ParamScope, cfg: ModelConfig,
             n_layers: Optional[int] = None):
    m = cfg.moe
    d, L = cfg.d_model, (cfg.n_layers if n_layers is None else n_layers)
    e, f = m.n_experts, m.d_ff_expert
    s.add("router", (L, d, e))
    s.add("w_gate", (L, e, d, f))
    s.add("w_up", (L, e, d, f))
    s.add("w_down", (L, e, f, d))
    if m.n_shared_experts:
        fs = f * m.n_shared_experts
        s.add("ws_gate", (L, d, fs))
        s.add("ws_up", (L, d, fs))
        s.add("ws_down", (L, fs, d))


def _capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Rows of each expert's buffer: at least 128, a multiple of 128."""
    m = cfg.moe
    c = int(m.capacity_factor * m.top_k * n_tokens / m.n_experts)
    return max(128, -(-c // 128) * 128)


def route(p: Mapping, prefix: str, cfg: ModelConfig, xt: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router over tokens xt (T, d): (probs float32 (T, E), gates float32
    (T, K) renormalised, experts int64 (T, K)).  The router product is
    taken in the compute dtype and then cast to float32; the experts are
    ``jax.lax.top_k``'s: probabilities descending, the lower expert first
    on a tie (a stable descending sort)."""
    K = cfg.moe.top_k
    logits = (xt @ mm_weight(p, f"{prefix}/router", cfg)).float()
    probs = torch.softmax(logits, dim=-1)
    gates, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = gates[:, :K], experts[:, :K]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gates, experts


def expert_counts(flat_e: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Entries routed to each expert, int32 (E,): an integer sum, so in no
    particular order and the same on every device."""
    ids = torch.arange(n_experts, device=flat_e.device)
    return (flat_e[:, None] == ids).sum(0, dtype=torch.int32)


def positions(cfg: ModelConfig, flat_e: torch.Tensor,
              counts: torch.Tensor) -> torch.Tensor:
    """Each entry's rank among the entries routed to its expert, in
    flattened ``(token, k)`` order, int64 (T * K,).  ``MoEConfig.dispatch``
    picks how: ``"cumsum"`` is the one-hot exclusive scan, ``"sort"`` a
    stable sort, then each sorted entry's distance from its expert's
    start.  Both give the same ranks."""
    E = cfg.moe.n_experts
    if cfg.moe.dispatch == "cumsum":
        onehot = (flat_e[:, None] == torch.arange(E, device=flat_e.device)
                  ).long()
        pos = torch.cumsum(onehot, 0) - onehot
        return pos.gather(1, flat_e[:, None])[:, 0]
    order = torch.argsort(flat_e, stable=True)
    starts = torch.cumsum(counts.long(), 0) - counts.long()
    pos_sorted = (torch.arange(flat_e.shape[0], device=flat_e.device)
                  - starts[flat_e[order]])
    my_pos = torch.empty_like(pos_sorted)
    my_pos[order] = pos_sorted
    return my_pos


def apply_moe(p: Mapping, prefix: str, cfg: ModelConfig, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux_loss float32 scalar)."""
    m = cfg.moe
    dt = cfg.compute_dtype
    B, S, d = x.shape
    T = B * S
    E, K = m.n_experts, m.top_k
    C = _capacity(cfg, T)
    xt = x.reshape(T, d)

    probs, gates, experts = route(p, prefix, cfg, xt)
    flat_e = experts.reshape(-1)                     # (T*K,) task types
    counts = expert_counts(flat_e, E)

    # load-balancing auxiliary loss (Switch/GShard)
    me = probs.mean(0)
    ce = counts.float() / (T * K)
    aux = E * torch.sum(me * ce)

    # ---- dispatch: each entry's contiguous slot in its expert's buffer
    my_pos = positions(cfg, flat_e, counts)
    keep = my_pos < C
    slot = torch.where(keep, flat_e * C + my_pos,
                       torch.full_like(my_pos, E * C))  # E*C: the sink row
    buf = torch.zeros((E * C + 1, d), dtype=dt, device=x.device)
    buf[slot] = xt[:, None].expand(T, K, d).reshape(T * K, d)
    xb = buf[:E * C].view(E, C, d)

    # ---- per-expert SwiGLU: batched products over the expert axis
    g = torch.bmm(xb, mm_weight(p, f"{prefix}/w_gate", cfg))
    u = torch.bmm(xb, mm_weight(p, f"{prefix}/w_up", cfg))
    h = F.silu(g.float()).to(dt) * u
    yb = torch.bmm(h, mm_weight(p, f"{prefix}/w_down", cfg)).view(
        E * C, d)

    # ---- combine: gather back, weight by gate, sum over K ----------------
    gathered = torch.where(keep[:, None], yb[slot.clamp(max=E * C - 1)],
                           torch.zeros((), dtype=dt, device=x.device))
    y = (gathered.view(T, K, d) * gates.to(dt)[..., None]).sum(1)

    if m.n_shared_experts:
        gs = xt @ mm_weight(p, f"{prefix}/ws_gate", cfg)
        us = xt @ mm_weight(p, f"{prefix}/ws_up", cfg)
        hs = F.silu(gs.float()).to(dt) * us
        y = y + hs @ mm_weight(p, f"{prefix}/ws_down", cfg)

    return y.view(B, S, d), aux
