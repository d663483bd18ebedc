"""The kernels' launch counters, in one registry.

Each kernel module registers its ``LAUNCHES`` dict here (``LAUNCHES =
counters.register({...})``); its wrappers add one to their kernel's entry
where they launch it.  Code that must account for launches it did not
make one by one — a CUDA graph's capture, which runs nothing, and its
replays, which run every launch the capture recorded
(``core/graphs.py``) — reads and adjusts every registered counter through
:func:`snapshot` and :func:`add`, so a kernel module added later is
counted as soon as it registers.
"""
from __future__ import annotations

from typing import Dict, List

_REGISTRY: List[Dict[str, int]] = []


def register(launches: Dict[str, int]) -> Dict[str, int]:
    """Register a kernel module's ``LAUNCHES`` dict; returns it."""
    names = {k for c in _REGISTRY for k in c}
    if names & launches.keys():
        raise ValueError(f"launch counters registered twice: "
                         f"{sorted(names & launches.keys())}")
    _REGISTRY.append(launches)
    return launches


def snapshot() -> Dict[str, int]:
    """Every registered counter's value, by kernel name."""
    return {k: v for c in _REGISTRY for k, v in c.items()}


def add(delta: Dict[str, int], sign: int = 1) -> None:
    """Add ``sign * delta[k]`` to each registered counter ``k`` of
    ``delta``; a name no module registered raises."""
    left = dict(delta)
    for c in _REGISTRY:
        for k in c:
            if k in left:
                c[k] += sign * left.pop(k)
    if left:
        raise KeyError(f"unregistered launch counters: {sorted(left)}")
