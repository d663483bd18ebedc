"""PyTorch/CUDA port of the TREES task-parallel runtime.

The same module layout as the JAX package ``repro`` (the reference), which
this package never imports: ``core`` (program, effect API, TVM, scheduler,
host engine), ``kernels`` (hand-written CUDA kernels and their plain
PyTorch versions) and ``apps`` (fib, bfs, mergesort).  Entry points run on
the card unless the caller passes ``device="cpu"``.
"""
from . import apps, core, kernels  # noqa: F401
