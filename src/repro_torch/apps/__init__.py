# Task-parallel applications from the paper's evaluation (§6) plus the
# programmability-study set (§6.5), rewritten over lane vectors, with the
# hand-coded "native" baselines under apps/baselines/.  Each registers an
# engine-ready default case in ``registry`` under the same name as the JAX
# reference's; ``treewalk`` (the paper's running example) joins them for
# the service's mixed fleets.
from . import (  # noqa: F401
    annealing,
    bfs,
    fft,
    fib,
    matmul,
    mergesort,
    nqueens,
    sssp,
    treewalk,
    tsp,
)
from .registry import (  # noqa: F401
    FLEETS, AppCase, all_cases, get_case, get_fleet, register_case,
    register_fleet,
)
