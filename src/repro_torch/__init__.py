"""PyTorch/CUDA port of the TREES task-parallel runtime.

The same module layout as the JAX package ``repro`` (the reference), which
this package never imports: ``core`` (program, effect API, TVM, scheduler,
host engine), ``kernels`` (hand-written CUDA kernels and their plain
PyTorch versions), ``apps`` (fib, bfs, mergesort, treewalk, and the
service's fleets), ``service`` (the multi-tenant job service on the host
loop), and the LLM serving path: ``configs``, ``models`` (dense GQA,
Mamba-2 SSM and hybrid decoders), ``serving`` (``EpochServer``) and
``launch`` (``serve.py``).
Entry points run on the card unless the caller passes ``device="cpu"``.
"""
from . import (  # noqa: F401
    apps, configs, core, kernels, models, serving, service,
)
