"""Tier-1 test-suite bootstrap.

Two environment guards so `PYTHONPATH=src python -m pytest -x -q` collects
and runs everywhere (dev laptops, CI, hermetic containers):

1. **hypothesis fallback** — the property tests import ``hypothesis`` (a
   dev dependency, see ``requirements-dev.txt``).  Where it cannot be
   installed, a minimal deterministic stub (``tests/_hypothesis_stub.py``)
   is injected into ``sys.modules`` so the modules still collect and the
   property tests run as seeded-random smoke tests.

2. **multi-device gating** — the distributed tests need >= 4 devices
   (they subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count``,
   the SNIPPETS.md idiom) plus a jax new enough for
   ``jax.sharding.AxisType``.  ``multidevice_skip`` centralizes the check;
   the affected modules apply it as a ``skipif`` marker instead of failing.
"""
from __future__ import annotations

import importlib.util
import pathlib
import sys

_HERE = pathlib.Path(__file__).resolve().parent

# ---------------------------------------------------------------- guard 1
if importlib.util.find_spec("hypothesis") is None:
    sys.path.insert(0, str(_HERE))
    import _hypothesis_stub as _stub

    sys.modules["hypothesis"] = _stub  # type: ignore[assignment]
    sys.modules["hypothesis.strategies"] = _stub.strategies


# ---------------------------------------------------------------- guard 2
def multidevice_skip(required: int = 4):
    """(skip?, reason) for tests that need ``required`` devices.

    The subprocess-based tests can force host devices via XLA_FLAGS, but
    only on a jax recent enough to expose ``jax.sharding.AxisType`` (their
    mesh construction uses it); on older jax or genuinely single-device
    environments they must skip rather than fail.
    """
    import jax

    if not hasattr(jax.sharding, "AxisType"):
        return True, "jax.sharding.AxisType unavailable (jax too old)"
    if jax.device_count() < required and jax.default_backend() != "cpu":
        return True, f"needs >= {required} devices (have {jax.device_count()})"
    return False, ""


# ---------------------------------------------------------------- markers
def pytest_configure(config):
    # tests of the PyTorch port that need a CUDA card; each decides inside
    # a fixture whether one is present and skips where there is none
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips where there is none)"
    )
