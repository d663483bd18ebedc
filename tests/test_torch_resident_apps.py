"""The port's plain resident ``DeviceEngine`` on the CPU against the JAX
``DeviceEngine`` on the six remaining paper apps and naive mergesort.

JAX runs on the CPU with its default chunk implementation (the
``lax.while_loop`` oracle); the port runs its plain loop.  Under the
masked and gather dispatches the heap, the TV values and every
``RunStats`` field must be equal, exactly — fft's heap within
``test_torch_apps.FFT_RTOL`` of its largest |JAX value| (its twiddles'
``cos``/``sin`` round differently in the two libraries).  The JAX runs are
cached per module, computed in background processes
(``_jax_refs.JaxRefs``).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from _jax_refs import JaxRefs
from _torch_threads import one_torch_thread  # noqa: F401
from repro.core import DeviceEngine as JDeviceEngine
from repro_torch.apps import get_case, mergesort
from repro_torch.core import DeviceEngine, EngineError
from test_torch_apps import APPS, _programs, assert_same_run

DISPATCHES = ("masked", "gather")


# the JAX runs the module's tests read, in the order they read them
JAX_KEYS = ([(name, d) for name in APPS for d in DISPATCHES]
            + [(("naive", n), d) for n in (8, 16) for d in DISPATCHES]
            + [(("matmul16", 16, 4), "gather")])


def jax_ref(key):
    """``(heap, value, stats)`` of the JAX ``DeviceEngine`` on ``key`` =
    ``(case key, dispatch)`` (case keys as ``test_torch_apps._programs``
    builds them)."""
    key, dispatch = key
    prog, init, heap_init, cap = _programs(key, jax=True)
    heap, value, stats = JDeviceEngine(
        prog, capacity=cap, dispatch=dispatch
    ).run(init, heap_init=heap_init)
    return ({k: np.asarray(v) for k, v in heap.items()}, np.asarray(value),
            stats)


@pytest.fixture(scope="module")
def jax_resident():
    """``(key, dispatch) -> (heap, value, stats)`` of the JAX
    ``DeviceEngine`` (:func:`jax_ref`), each run once per module, in two
    background processes started with the module's first use."""
    refs = JaxRefs(__name__, JAX_KEYS)
    yield refs
    refs.close()


def _run_port(key, dispatch, **kw):
    prog, init, heap_init, cap = _programs(key, jax=False)
    return DeviceEngine(prog, capacity=cap, dispatch=dispatch,
                        device="cpu", **kw).run(init, heap_init=heap_init)


@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("name", APPS)
def test_resident_app_matches_jax(jax_resident, name, dispatch):
    got = _run_port(name, dispatch)
    assert_same_run(got, jax_resident(name, dispatch), name)
    assert got[2].dispatches == got[2].scalar_transfers == 1


@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("n", (8, 16))
def test_resident_naive_mergesort_matches_jax(jax_resident, n, dispatch):
    got = _run_port(("naive", n), dispatch)
    assert_same_run(got, jax_resident(("naive", n), dispatch), "naive")
    np.testing.assert_array_equal(
        got[0]["src"][:n].numpy(),
        np.sort(mergesort.random_input(n, seed=5)))


def test_resident_matmul_adds_in_the_reference_order(jax_resident):
    key = ("matmul16", 16, 4)
    assert_same_run(_run_port(key, "gather"),
                    jax_resident(key, "gather"), "matmul")


@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("name", ("annealing", "fft", "matmul"))
def test_megakernel_flag_matches_jax(jax_resident, name, dispatch):
    """The programs of the last device tables under ``megakernel=True`` (on
    the CPU: the plain loop, which the kernel is held to on the card)
    against the cached JAX runs."""
    got = _run_port(name, dispatch, megakernel=True)
    assert_same_run(got, jax_resident(name, dispatch), name)


@pytest.mark.parametrize("name", ("nqueens", "fft"))
def test_megakernel_flag_runs_the_plain_loop_on_the_cpu(name):
    """On the CPU ``megakernel=True`` runs the plain loop (no device table
    is needed there); the same bits as the flag off."""
    case = get_case(name)
    a = case.run(engine_cls=DeviceEngine, device="cpu", megakernel=True)
    b = case.run(engine_cls=DeviceEngine, device="cpu")
    for k in a[0]:
        assert torch.equal(a[0][k], b[0][k])
    assert a[2].as_dict() == b[2].as_dict()


def test_resident_raises_on_overflow():
    case = get_case("nqueens")
    with pytest.raises(EngineError, match="capacity"):
        DeviceEngine(case.program, capacity=16, device="cpu").run(
            case.initial)
