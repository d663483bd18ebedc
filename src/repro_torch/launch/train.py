"""The train step (a copy of ``make_train_step`` and ``build`` of
``repro/launch/train.py``).

``make_train_step(cfg, opt)`` gives ``step(params, opt_state, batch) ->
(params, opt_state, metrics)``: ``loss_fn`` (the layers recomputed in the
backward pass under ``cfg.remat``), its gradient over every parameter in
the reference's key order (``Model.named_leaves``), then
``AdamW.update``.  The step is eager; it writes the new parameters and
moments into the tensors it was given, as the reference's ``jit`` with
donated arguments reuses their buffers, and returns them.  The metrics are
the reference's: ``loss``, ``xent``, ``aux``, ``n_tokens``, ``grad_norm``
and ``lr``, 0-d tensors.  On the card every attention layer runs the
``flash_attention`` kernel forward and its backward kernel
(``kernels/flash_attention.py``).

``build(arch, ...)`` makes the config, a trainable model, the optimiser
(a cosine schedule over ``steps``), its state, the step and the data, as
the reference's does; on ``device`` (None: CUDA).

Not ported yet: the mesh (``mesh=`` raises; the production mesh, the
sharding rules and ZeRO-1 are the mesh half of ROADMAP item 11), and
``main`` with the fault-tolerant runner and checkpoints
(``runtime/{ft,stragglers}.py``, ``checkpointing/``), the next slice of
that item.
"""
from __future__ import annotations

from typing import Mapping

import torch

from .. import configs
from ..core.engine import resolve_device
from ..data import SyntheticLM
from ..models.model import init_model, loss_fn
from ..optim import AdamW, cosine_schedule


def _leaf_dicts(params, grads=None):
    """The parameters (and gradients) as the optimiser sees them, in the
    reference's key order: a per-layer tensor as its ``(1, ...)`` slice
    of the reference's stack."""
    leaves = params.named_leaves()
    p = {n: (t.detach()[None] if layered else t.detach())
         for n, t, layered in leaves}
    if grads is None:
        return p
    g = {n: (gr[None] if layered else gr)
         for (n, _, layered), gr in zip(leaves, grads)}
    return p, g


def make_train_step(cfg, opt: AdamW, mesh=None, rules=None):
    """The eager train step of ``cfg`` under ``opt`` (see the module
    docstring); ``mesh`` must be None."""
    if mesh is not None or rules is not None:
        raise NotImplementedError(
            "make_train_step: a mesh (sharded training) is not ported to "
            "the PyTorch package yet (ROADMAP item 11)")

    def train_step(params, opt_state, batch: Mapping[str, torch.Tensor]):
        loss, metrics = loss_fn(params, cfg, batch)
        leaves = [t for _, t, _ in params.named_leaves()]
        grads = torch.autograd.grad(loss, leaves)
        p, g = _leaf_dicts(params, grads)
        del grads
        _, new_state, om = opt.update(p, g, opt_state)
        return params, new_state, dict(
            loss=loss.detach(), **{k: v.detach() for k, v in metrics.items()},
            **om)

    return train_step


def init_opt_state(opt: AdamW, params):
    """``opt.init`` over the model's parameters, keyed as the step keys
    them (``Model.named_leaves``)."""
    return opt.init(_leaf_dicts(params))


def build(arch: str, reduced: bool = True, batch: int = 8, seq: int = 128,
          steps: int = 100, lr: float = 3e-3, seed: int = 0,
          use_mesh: bool = False, device=None):
    """``(cfg, params, opt_state, step_fn, data, mesh)`` as the
    reference's ``build``: the reduced or full config, a trainable model
    drawn from ``seed`` on ``device`` (None: CUDA), ``AdamW`` over
    ``cosine_schedule(lr, 10, steps)``, the step, ``SyntheticLM`` over the
    config's vocabulary; ``mesh`` is None (``use_mesh`` raises)."""
    if use_mesh:
        raise NotImplementedError(
            "build: the production mesh is not ported to the PyTorch "
            "package yet (ROADMAP item 11)")
    cfg = configs.get_reduced(arch) if reduced else configs.get_config(arch)
    dev = resolve_device(device)
    params = init_model(cfg, seed, dev, trainable=True)
    opt = AdamW(lr=cosine_schedule(lr, warmup_steps=10, total_steps=steps))
    opt_state = init_opt_state(opt, params)
    step_fn = make_train_step(cfg, opt)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                       seed=seed)
    return cfg, params, opt_state, step_fn, data, None
