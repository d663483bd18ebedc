"""The port's ``HostEngine`` on the CPU against the JAX ``HostEngine``: fib.

For n in {0, 1, 2, 10, 12} and each of the masked, compacted and gather
dispatches, the heap, the TV ``values`` and every field of
``RunStats.as_dict()`` must be equal, exactly, and the result must be
``fib_reference(n)``.  (bfs and mergesort: ``test_torch_engine_apps.py``.)
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.apps import fib as jfib
from repro.core import HostEngine as JHostEngine
from repro_torch.apps import fib as tfib
from repro_torch.core import HostEngine as THostEngine

DISPATCHES = ("masked", "compacted", "gather")
CAPACITY = 1 << 13


@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("n", (0, 1, 2, 10, 12))
def test_fib_matches_jax(n, dispatch):
    jheap, jval, jstats = JHostEngine(
        jfib.PROGRAM, capacity=CAPACITY, dispatch=dispatch
    ).run(jfib.initial(n))
    theap, tval, tstats = THostEngine(
        tfib.PROGRAM, capacity=CAPACITY, dispatch=dispatch, device="cpu"
    ).run(tfib.initial(n))
    assert theap == {} and dict(jheap) == {}
    np.testing.assert_array_equal(tval.numpy(), np.asarray(jval))
    assert tstats.as_dict() == jstats.as_dict()
    assert int(tval[0, 0]) == tfib.fib_reference(n)
    assert tstats.scalar_transfers == tstats.dispatches == (
        tstats.epochs * (1 if dispatch == "masked" else 2)
    )
