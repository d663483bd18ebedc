# Task-parallel applications from the paper's evaluation (§6), rewritten
# over lane vectors: fib, bfs, mergesort (map variant) and treewalk so far.  Each
# registers an engine-ready default case in ``registry`` under the same
# name as the JAX reference's; ``treewalk`` (the paper's running example)
# joins them for the service's mixed fleets.
from . import bfs, fib, mergesort, treewalk  # noqa: F401
from .registry import (  # noqa: F401
    FLEETS, AppCase, all_cases, get_case, get_fleet, register_case,
    register_fleet,
)
