# Task-parallel applications from the paper's evaluation (§6), rewritten
# over lane vectors: fib, bfs and mergesort (map variant) so far.  Each
# registers an engine-ready default case in ``registry`` under the same
# name as the JAX reference's.
from . import bfs, fib, mergesort  # noqa: F401
from .registry import AppCase, all_cases, get_case, register_case  # noqa: F401
