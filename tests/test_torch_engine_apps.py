"""The port's ``HostEngine`` on the CPU against the JAX ``HostEngine``: the
registry's ``bfs`` and ``mergesort`` (map variant) cases.

Under each of the masked, compacted and gather dispatches the heap arrays,
the TV ``values`` and every field of ``RunStats.as_dict()`` must be equal,
exactly, and the results must match the numpy references
(``bfs_reference``, ``np.sort``).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from _torch_threads import one_torch_thread  # noqa: F401
from repro.apps import get_case as jget_case
from repro_torch.apps import bfs, mergesort
from repro_torch.apps import get_case as tget_case

DISPATCHES = ("masked", "compacted", "gather")


def _run_both(name, dispatch):
    jheap, jval, jstats = jget_case(name).run(dispatch=dispatch)
    case = tget_case(name)
    theap, tval, tstats = case.run(dispatch=dispatch, device="cpu")
    np.testing.assert_array_equal(tval.numpy(), np.asarray(jval))
    assert set(theap) == set(jheap)
    for k in jheap:
        np.testing.assert_array_equal(theap[k].numpy(), np.asarray(jheap[k]))
    assert tstats.as_dict() == jstats.as_dict()
    return case, theap, tstats


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_bfs_matches_jax(dispatch):
    case, heap, _ = _run_both("bfs", dispatch)
    h = case.heap_init
    n = h["dist"].shape[0]
    np.testing.assert_array_equal(
        heap["dist"].numpy(),
        bfs.bfs_reference(h["adj_off"], h["adj"], 0, n),
    )


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_mergesort_matches_jax(dispatch):
    case, heap, stats = _run_both("mergesort", dispatch)
    inp = case.heap_init["inp"]
    n = inp.shape[0]
    np.testing.assert_array_equal(
        heap["src"][mergesort.result_buffer(n)].numpy(), np.sort(inp)
    )
    assert stats.map_launches > 0


def test_mergesort_rejects_non_power_of_two():
    with pytest.raises(ValueError, match="power-of-two"):
        mergesort.make_program(24, use_map=True)
