"""Background processes for the JAX reference runs of the port's parity
test modules.

Nearly all of such a module's time is the reference's: the port's engine
runs a small registry case in tens of milliseconds, the JAX engine
compiles for seconds first.  :class:`JaxRefs` runs a module's reference
runs in ``workers`` spawned processes, so that they overlap one another
and the port's side.  A module-scoped fixture starts it with the
module's first test (never at import: each pytest worker imports every
module).  Each process imports the test module and calls its
``jax_ref(key)``, which returns picklable values (numpy arrays, the
reference's ``RunStats``); the keys are submitted in the order the
module's tests use them.
"""
from __future__ import annotations

import concurrent.futures
import importlib
import multiprocessing


def _call(module: str, key):
    return importlib.import_module(module).jax_ref(key)


class JaxRefs:
    """``refs(*key)`` waits for and returns ``module.jax_ref(key)``."""

    def __init__(self, module: str, keys, workers: int = 2):
        self.pool = concurrent.futures.ProcessPoolExecutor(
            max_workers=workers,
            mp_context=multiprocessing.get_context("spawn"))
        self.futures = {k: self.pool.submit(_call, module, k) for k in keys}

    def __call__(self, *key):
        return self.futures[key].result()

    def close(self) -> None:
        self.pool.shutdown(wait=True, cancel_futures=True)
