"""Carry state and weights between the JAX reference and the port.

What crosses between the two implementations is the TVM state and the
heap, the service's ``JobArena``, on the resident path the whole
``ResidentCarry`` (solo, or a fleet's with its arena), and on the serving path a model's weights and a decode
cache.  These functions take the reference's ``TVMState`` leaves and heap
dicts as numpy arrays (``{field name: ndarray}``, ``{heap var: ndarray}``)
and turn them into the port's tensors — adding the trailing sink row every
TV and heap array carries here (``core/tvm.py``) — and back; and the
reference's ``init_model`` dict and cache dict, as numpy arrays, into the
port's ``Model`` and cache.  The tests use them to hand one state to both
implementations.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np
import torch

from ..models.common import ModelConfig, storage_dtype
from ..models.model import Model
from .engine import ResidentCarry, _hilo_value
from .tvm import JobArena, TVMState, heap_with_sink, heap_without_sink

FIELDS = tuple(f.name for f in dataclasses.fields(TVMState))
CARRY_FIELDS = tuple(f.name for f in dataclasses.fields(ResidentCarry))
# the JAX carry's exact i32 (hi, lo) accumulators, int64 tensors here
HILO_FIELDS = ("job_tasks", "job_forks", "map_elements", "map_lanes",
               "hole_lanes")


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


def arena_from_numpy(leaves: Mapping[str, np.ndarray], device) -> JobArena:
    """``JobArena`` from the reference's leaves (``slot_job`` is ``[C]``;
    the port's sink row is tagged ``J``, unowned)."""
    J = np.asarray(leaves["base"]).shape[0]
    slot_job = np.concatenate([np.asarray(leaves["slot_job"], np.int32),
                               np.array([J], np.int32)])
    return JobArena(
        slot_job=torch.as_tensor(slot_job, device=device),
        **{k: torch.as_tensor(np.array(leaves[k], np.int32), device=device)
           for k in ("base", "end", "next")},
    )


def arena_to_numpy(arena: JobArena) -> Dict[str, np.ndarray]:
    """The reference's arena leaves (sink row dropped)."""
    return {
        "slot_job": arena.slot_job[:-1].cpu().numpy(),
        "base": arena.base.cpu().numpy(),
        "end": arena.end.cpu().numpy(),
        "next": arena.next.cpu().numpy(),
    }


def carry_from_numpy(leaves: Mapping[str, object], device) -> ResidentCarry:
    """The port's ``ResidentCarry`` from the reference's, field by field.

    ``leaves`` maps each JAX ``ResidentCarry`` field to numpy: ``state``
    to its ``TVMState`` leaves, ``heap`` to the heap dict, ``arena`` to
    ``None`` (solo) or the ``JobArena`` leaves (a fleet;
    :func:`arena_from_numpy`), every other field to its array.  TV and
    heap arrays gain their sink rows, the hi/lo pairs are decoded to
    int64, and the port's own ``fault`` word starts at 0.
    """
    arena = leaves.get("arena")
    out = {"arena": None if arena is None
           else arena_from_numpy(arena, device),
           "state": state_from_numpy(leaves["state"], device),
           "heap": heap_from_numpy(leaves["heap"], device),
           "fault": torch.zeros((), dtype=torch.int32, device=device)}
    for name in CARRY_FIELDS:
        if name in out:
            continue
        v = np.asarray(leaves[name])
        if name in HILO_FIELDS:
            v = _hilo_value(v)
        out[name] = torch.as_tensor(np.array(v), device=device)
    return ResidentCarry(**out)


def carry_to_numpy(carry: ResidentCarry) -> Dict[str, object]:
    """The reference's carry layout (sink rows dropped, counters int64,
    ``fault`` left out)."""
    out: Dict[str, object] = {
        "arena": None if carry.arena is None
        else arena_to_numpy(carry.arena)}
    for name in CARRY_FIELDS:
        if name in ("arena", "fault"):
            continue
        v = getattr(carry, name)
        if name == "state":
            out[name] = state_to_numpy(v)
        elif name == "heap":
            out[name] = heap_to_numpy(v)
        else:
            out[name] = v.cpu().numpy()
    return out


def params_from_numpy(params_np: Mapping[str, np.ndarray], cfg: ModelConfig,
                      device) -> Model:
    """The port's ``Model`` from the reference's ``init_model`` dict.

    Stacked ``layers/...`` arrays are split along their leading ``L`` axis
    into one tensor per layer; matmul weights and the SSM's ``conv_w`` (2-D
    per layer) are cast once to ``cfg.compute_dtype`` — the same
    round-to-nearest-even cast the reference applies at each use, so the
    values are the same bits — and norm scales and the SSM's ``a_log``,
    ``dt_bias`` and ``d_skip`` stay in the parameter dtype.
    """
    values = {}
    for name, arr in params_np.items():
        arr = np.asarray(arr)
        if name.startswith("layers/"):
            dt = storage_dtype(cfg, arr.ndim - 1)
            values[name] = [torch.as_tensor(np.array(a), device=device)
                            .to(dt) for a in arr]
        else:
            dt = storage_dtype(cfg, arr.ndim)
            values[name] = torch.as_tensor(np.array(arr), device=device).to(dt)
    return Model(cfg, values)


def cache_from_numpy(cache_np: Mapping[str, np.ndarray], cfg: ModelConfig,
                     device) -> Dict[str, torch.Tensor]:
    """The port's decode cache from the reference's: ``lengths``, and
    those of ``k``, ``v`` (L, B, Hkv, S, hd) and ``ssm_conv``
    (L, B, K-1, di+2N) it holds in the compute dtype, ``ssm_state``
    (L, B, nh, P, N) in float32."""
    out = {"lengths": torch.as_tensor(np.array(cache_np["lengths"], np.int32),
                                      device=device)}
    for k in ("k", "v", "ssm_conv", "ssm_state"):
        if k in cache_np:
            dt = torch.float32 if k == "ssm_state" else cfg.compute_dtype
            out[k] = torch.as_tensor(np.array(cache_np[k], np.float32),
                                     device=device).to(dt)
    return out
