"""AdamW (a copy of ``repro/optim/adamw.py`` on torch tensors).

The same defaults, ``init`` and ``update``: the float32 global norm of the
gradients, summed in the order of the dict (the train step hands the
parameters over in the reference's key order), the clip scale with its
1e-9 floor, bias correction from the step, weight decay only where a
parameter has more than one dimension, optional float32 master weights,
and the result cast back to each parameter's dtype.  ``lr`` is a float or
a function of the step.

Two differences, neither in the function computed:

- ``update`` writes the new parameters, moments and masters into the
  tensors it is given, as the reference's donated ``jit`` reuses their
  buffers (``launch/train.py``); it returns them.
- The reference's ``zero1_pspec`` (a ``PartitionSpec`` rule sharding the
  moments over the data axis) has no counterpart on one card; it comes
  with the mesh half of training (ROADMAP item 11).

A model's per-layer parameter is handed over as its ``(1, ...)`` slice of
the reference's stacked tensor (``Model.named_leaves``), so ``ndim > 1``
decides weight decay as it does there: the reference decays its stacked
per-layer norm scales and not the final norm's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch


@dataclasses.dataclass
class OptState:
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]
    step: torch.Tensor  # int32, 0-d
    # float32 master copies when training low-precision parameters; empty
    # otherwise
    master: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Any = 3e-4                 # float or callable(step) -> float
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    master_weights: bool = False   # low-precision params + float32 masters

    def init(self, params: Dict[str, torch.Tensor]) -> OptState:
        dev = next(iter(params.values())).device
        master = {}
        if self.master_weights:
            master = {k: v.detach().float().clone()
                      for k, v in params.items()}
        return OptState(
            m={k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
               for k, v in params.items()},
            v={k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
               for k, v in params.items()},
            step=torch.zeros((), dtype=torch.int32, device=dev),
            master=master)

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor], state: OptState
               ) -> Tuple[Dict[str, torch.Tensor], OptState,
                          Dict[str, torch.Tensor]]:
        step = state.step + 1
        lr = self.lr(step) if callable(self.lr) else self.lr
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for g in grads.values()))
        scale = torch.ones((), dtype=torch.float32, device=gnorm.device)
        if self.clip_norm is not None:
            scale = torch.clamp(
                self.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
        sf = step.float()
        b1c = 1.0 - torch.pow(torch.tensor(self.b1, device=sf.device), sf)
        b2c = 1.0 - torch.pow(torch.tensor(self.b2, device=sf.device), sf)
        for k, p in params.items():
            g = grads[k].float() * scale
            m, v = state.m[k], state.v[k]
            m.copy_(self.b1 * m + (1 - self.b1) * g)
            v.copy_(self.b2 * v + (1 - self.b2) * g * g)
            upd = (m / b1c) / (torch.sqrt(v / b2c) + self.eps)
            ref = state.master[k] if self.master_weights else p.float()
            if self.weight_decay and p.ndim > 1:  # no decay on norms/bias
                upd = upd + self.weight_decay * ref
            newf = ref - lr * upd
            if self.master_weights:
                state.master[k].copy_(newf)
            p.copy_(newf.to(p.dtype))
        lr_t = torch.as_tensor(lr, dtype=torch.float32, device=gnorm.device)
        return params, OptState(m=state.m, v=state.v, step=step,
                                master=state.master), {
            "grad_norm": gnorm, "lr": lr_t}
