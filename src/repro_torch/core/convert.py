"""Carry a Task Vector and heap between the JAX reference and the port.

The system has no weights; what crosses between the two implementations is
the TVM state and the heap.  These functions take the reference's
``TVMState`` leaves and heap dicts as numpy arrays (``{field name:
ndarray}``, ``{heap var: ndarray}``) and turn them into the port's tensors
— adding the trailing sink row every TV and heap array carries here
(``core/tvm.py``) — and back.  The tests use them to hand one state to
both implementations.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np
import torch

from .tvm import TVMState, heap_with_sink, heap_without_sink

FIELDS = tuple(f.name for f in dataclasses.fields(TVMState))


def state_from_numpy(leaves: Mapping[str, np.ndarray], device) -> TVMState:
    """``TVMState`` from the reference's leaves (rows ``[C]``)."""
    missing = set(FIELDS) - set(leaves)
    if missing:
        raise KeyError(f"missing TVMState fields: {sorted(missing)}")
    out = {}
    for name in FIELDS:
        t = torch.as_tensor(np.array(leaves[name]), device=device)
        if name != "next_free":
            t = torch.cat([t, torch.zeros_like(t[:1])])
        out[name] = t
    return TVMState(**out)


def state_to_numpy(state: TVMState) -> Dict[str, np.ndarray]:
    """The reference's leaf layout (sink row dropped)."""
    out = {}
    for name in FIELDS:
        t = getattr(state, name)
        if name != "next_free":
            t = t[:-1]
        out[name] = t.cpu().numpy()
    return out


def heap_from_numpy(heap: Mapping[str, np.ndarray],
                    device) -> Dict[str, torch.Tensor]:
    return heap_with_sink({
        k: torch.as_tensor(np.array(v), device=device) for k, v in heap.items()
    })


def heap_to_numpy(heap: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.cpu().numpy() for k, v in heap_without_sink(heap).items()}
