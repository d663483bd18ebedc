"""Uniform app registry: one runnable case per ported workload.

Every app module registers a :func:`case` — a fully materialized (program,
initial task, heap init, TV capacity) bundle, the same cases under the
same names as the JAX reference's registry — so the engine equivalence
tests and ``chip_smoke.py`` drive every workload through one entry point.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Tuple

from ..core.program import InitialTask, Program


@dataclasses.dataclass(frozen=True)
class AppCase:
    """One concrete, engine-ready instantiation of a workload."""

    name: str
    program: Program
    initial: InitialTask
    heap_init: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    capacity: int = 1 << 13

    def run(self, engine_cls=None, **engine_kw):
        """Run this case; defaults to ``HostEngine`` built with the given
        kwargs (``device=`` among them; CUDA by default)."""
        from ..core import HostEngine

        cls = engine_cls or HostEngine
        kw = dict(capacity=self.capacity)
        kw.update(engine_kw)
        return cls(self.program, **kw).run(
            self.initial, heap_init=dict(self.heap_init) or None
        )


CASES: Dict[str, Callable[[], AppCase]] = {}


def register_case(name: str):
    """Register an app module's default test case factory."""

    def deco(fn: Callable[[], AppCase]):
        CASES[name] = fn
        return fn

    return deco


def _register_all() -> None:
    from . import (  # noqa: F401  (registration side effects)
        annealing, bfs, fft, fib, matmul, mergesort, nqueens, sssp,
        treewalk, tsp,
    )


def get_case(name: str) -> AppCase:
    _register_all()
    return CASES[name]()


def all_cases() -> Dict[str, AppCase]:
    """Materialize every registered case (imports all app modules)."""
    _register_all()
    return {name: fn() for name, fn in sorted(CASES.items())}


# ---------------------------------------------------------------- fleets
# A *fleet* is a named mix of cases co-scheduled by the job service
# (``repro_torch.service``), the same fleets under the same names and
# quotas as the JAX reference's registry.  ``quota`` is the TV region the
# service grants each member (solo-equivalence runs use it as the solo
# engine's capacity, keeping layouts bit-comparable).
FLEETS: Dict[str, Tuple[Tuple[str, int], ...]] = {}


def register_fleet(name: str, members) -> None:
    """Register a fleet: a tuple of (case_name, quota) pairs."""
    FLEETS[name] = tuple(members)


def get_fleet(name: str) -> List[Tuple[AppCase, int]]:
    """Materialize a fleet as a list of (AppCase, quota) pairs."""
    return [(get_case(case), quota) for case, quota in FLEETS[name]]


# mixed fleets: different programs co-scheduled in one shared TVM
register_fleet("mixed3", (("fib", 512), ("treewalk", 256), ("bfs", 2048)))
# mixed4 adds a map-bearing tenant (mergesort schedules bulk map payloads)
register_fleet(
    "mixed4",
    (("fib", 512), ("treewalk", 256), ("bfs", 2048), ("mergesort", 512)),
)
# homogeneous fleet: the throughput-vs-concurrency scaling case
register_fleet("fib_fleet", (("fib", 512),) * 4)
