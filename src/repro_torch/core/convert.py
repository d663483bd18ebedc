"""Carry state and weights between the JAX reference and the port.

What crosses between the two implementations is the TVM state and the
heap, the service's ``JobArena``, on the resident path the whole
``ResidentCarry`` (solo, or a fleet's with its arena), a sharded fleet's
stacked carry (the reference's P shard carries on a leading axis, one
carry a shard here), and on the serving path a model's weights and a
decode cache.  These functions take the reference's ``TVMState`` leaves
and heap dicts as numpy arrays (``{field name: ndarray}``, ``{heap var:
ndarray}``) and turn them into the port's tensors — adding the trailing
sink row every TV and heap array carries here (``core/tvm.py``) — and
back; and the reference's ``init_model`` dict, cache dict and optimiser
state, as numpy arrays, into the port's ``Model``, cache and ``OptState``.  The tests use them to hand
one state to both implementations.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping

import numpy as np
import torch

from ..models.common import ModelConfig, storage_dtype
from ..models.model import STACKS, Model
from ..optim.adamw import OptState
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


def _shard_leaves(leaves, p: int):
    """Shard ``p`` of a stacked leaf mapping (every array's leading axis)."""
    if isinstance(leaves, Mapping):
        return {k: _shard_leaves(v, p) for k, v in leaves.items()}
    return np.asarray(leaves)[p]


def _stack_leaves(parts):
    """The dual of :func:`_shard_leaves`: per-shard mappings stacked."""
    first = parts[0]
    if isinstance(first, Mapping):
        return {k: _stack_leaves([q[k] for q in parts]) for k in first}
    return np.stack([np.asarray(q) for q in parts])


def fleet_carries_from_numpy(leaves: Mapping[str, object],
                             device) -> List[ResidentCarry]:
    """The port's P shard carries from the reference's stacked fleet carry
    (``ShardedFleet._fcarry``: every leaf with a leading axis of P), in
    :func:`carry_from_numpy`'s layout: shard ``p`` is every leaf's row
    ``p``."""
    P = np.asarray(leaves["sp"]).shape[0]
    return [carry_from_numpy(_shard_leaves(leaves, p), device)
            for p in range(P)]


def fleet_carries_to_numpy(carries) -> Dict[str, object]:
    """The reference's stacked fleet carry from P shard carries (the dual
    of :func:`fleet_carries_from_numpy`; counters int64, ``fault`` left
    out)."""
    return _stack_leaves([carry_to_numpy(c) for c in carries])


def params_from_numpy(params_np: Mapping[str, np.ndarray], cfg: ModelConfig,
                      device, trainable: bool = False) -> Model:
    """The port's ``Model`` from the reference's ``init_model`` dict.

    Stacked ``layers/...`` and ``encoder/...`` arrays are split along their
    leading axis (``n_layers``, ``n_encoder_layers``) into one tensor per
    layer; for serving, matmul weights (the MoE's expert stacks among
    them, and ``enc_pos_embed``) and the SSM's ``conv_w`` (2-D or more per
    layer) are cast once to ``cfg.compute_dtype`` — the same
    round-to-nearest-even cast the reference applies at each use, so the
    values are the same bits — and norm scales and the SSM's ``a_log``,
    ``dt_bias`` and ``d_skip`` stay in the parameter dtype.  A
    ``trainable`` model keeps every parameter in the parameter dtype, with
    ``requires_grad``.
    """
    values = {}
    for name, arr in params_np.items():
        arr = np.asarray(arr)
        if name.startswith(STACKS):
            dt = storage_dtype(cfg, arr.ndim - 1, trainable)
            values[name] = [torch.as_tensor(np.array(a), device=device)
                            .to(dt) for a in arr]
        else:
            dt = storage_dtype(cfg, arr.ndim, trainable)
            values[name] = torch.as_tensor(np.array(arr), device=device).to(dt)
    return Model(cfg, values, trainable)


def opt_state_from_numpy(state_np: Mapping[str, object], model: Model,
                         device) -> OptState:
    """The port's ``OptState`` for ``model`` from the reference's, as numpy:
    ``{"m": {name: array}, "v": ..., "step": int, "master": {...}}`` (the
    reference's ``OptState`` fields).  Each moment and master follows
    ``model.named_leaves()``: a stacked name's array is split into its
    ``(1, ...)`` layer slices (``optim/adamw.py`` says why), float32."""
    def split(d):
        out = {}
        for name, p, layered in model.named_leaves():
            if layered:
                base, i = name[:-1].split("[")
                arr = np.asarray(d[base])[int(i)][None]
            else:
                arr = np.asarray(d[name])
            out[name] = torch.as_tensor(np.array(arr, np.float32),
                                        device=device)
        return out

    master = state_np.get("master") or {}
    return OptState(
        m=split(state_np["m"]), v=split(state_np["v"]),
        step=torch.as_tensor(np.int32(state_np["step"]), device=device),
        master=split(master) if master else {})


def cache_from_numpy(cache_np: Mapping[str, np.ndarray], cfg: ModelConfig,
                     device) -> Dict[str, torch.Tensor]:
    """The port's decode cache from the reference's: ``lengths``, and
    those of ``k``, ``v`` (L, B, Hkv, S, hd), ``ssm_conv``
    (L, B, K-1, di+2N), ``enc_out`` (B, T_enc, d), ``cross_k`` and
    ``cross_v`` (L, B, Hkv, T_enc, hd) it holds in the compute dtype,
    ``ssm_state`` (L, B, nh, P, N) in float32."""
    out = {"lengths": torch.as_tensor(np.array(cache_np["lengths"], np.int32),
                                      device=device)}
    for k in ("k", "v", "ssm_conv", "ssm_state", "enc_out", "cross_k",
              "cross_v"):
        if k in cache_np:
            dt = torch.float32 if k == "ssm_state" else cfg.compute_dtype
            out[k] = torch.as_tensor(np.array(cache_np[k], np.float32),
                                     device=device).to(dt)
    return out
