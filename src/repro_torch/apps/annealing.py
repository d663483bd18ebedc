"""Task-parallel simulated annealing — from the paper's programmability
study (§6.5).

Independent annealing chains over a quadratic pseudo-Boolean objective:
each chain task proposes a bit flip (hash-derived), accepts by Metropolis
with a fixed-point temperature schedule, scatter-mins its energy into the
global best, and forks its successor until the step budget runs out.
Chains are embarrassingly parallel — every epoch runs all live chains as
one bulk step (the regular-parallelism end of the TVM spectrum, like
Fig. 6's FFT).

The hash and the energies are int32 arithmetic that wraps as the JAX
reference's does.  The energy reads the whole ``Q`` once per lane and
sums ``Q[i, j] b_i b_j`` over ``i <= j`` as one tensor reduction (integer
sums are exact in any order, so the bits equal the reference's term by
term loop).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.program import HeapVar, InitialTask, Program, TaskType
from .registry import AppCase, register_case

ESCALE = 1  # energies are already integral


def make_program(n_bits: int, n_steps: int, n_chains: int) -> Program:
    def _energy(ctx, state):
        """E(state) = sum_{i<=j} Q[i,j] b_i b_j  (Q integral, n_bits<=16)."""
        q = ctx.read("Q", torch.arange(n_bits * n_bits, dtype=torch.int32,
                                       device=state.device))
        q = torch.triu(q.reshape(n_bits, n_bits))
        ar = torch.arange(n_bits, dtype=torch.int32, device=state.device)
        b = (state[:, None] >> ar) & 1  # [P, n_bits]
        return (b[:, :, None] * b[:, None, :] * q).sum((1, 2),
                                                        dtype=torch.int32)

    def _seed(ctx):
        # root task forks every chain (static sites), paper-style single seed
        for cid in range(n_chains):
            ctx.fork("step", argi=((cid * 26543 + 7) % 65536, 0, cid))

    def _step(ctx):
        state, t, cid = ctx.argi(0), ctx.argi(1), ctx.argi(2)
        h = (state * 31421 + t * 6927 + cid * 97 + 13) & 0x7FFF
        flip = h % n_bits
        cand = state ^ (1 << flip)
        e_cur = _energy(ctx, state)
        e_new = _energy(ctx, cand)
        # Metropolis with linear temperature ramp-down, integer threshold:
        # accept if dE < 0, or with prob ~ temp/(temp+dE) via hash draw
        d_e = e_new - e_cur
        temp = torch.clamp((n_steps - t) * 4 // n_steps + 1, min=1)
        draw = (h >> 7) % 16
        accept = (d_e < 0) | (draw < temp)
        nxt = torch.where(accept, cand, state)
        e_next = torch.where(accept, e_new, e_cur)
        ctx.write("best", 0, e_next, op="min")
        ctx.fork("step", argi=(nxt, t + 1, cid), where=t + 1 < n_steps)

    return Program(
        name="annealing",
        tasks=(TaskType("seed", _seed), TaskType("step", _step)),
        n_arg_i=3,
        heap=(
            HeapVar("Q", (n_bits * n_bits,), torch.int32),
            HeapVar("best", (1,), torch.int32),
        ),
    )


def initial() -> InitialTask:
    return InitialTask(task="seed")


def random_qubo(n_bits: int, seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    q = rng.randint(-5, 6, size=(n_bits, n_bits))
    return np.triu(q).astype(np.int32)


def brute_force_min(Q: np.ndarray) -> int:
    """The exact minimum energy over all ``2^n`` states, vectorised."""
    n = Q.shape[0]
    s = np.arange(1 << n, dtype=np.int64)
    bits = (s[:, None] >> np.arange(n)) & 1  # [2^n, n]
    e = ((bits @ np.triu(Q).astype(np.int64)) * bits).sum(1)
    return int(e.min())


@register_case("annealing")
def case() -> AppCase:
    nb = 6
    return AppCase(
        name="annealing",
        program=make_program(nb, n_steps=20, n_chains=8),
        initial=initial(),
        heap_init=dict(Q=random_qubo(nb, seed=5).ravel()),
        capacity=1 << 10,
    )
