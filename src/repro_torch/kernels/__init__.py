# Hand-written CUDA kernels of the epoch machine — the scans
# (fork_compact.py) and the resident megakernel (epoch_megakernel.py),
# sources in csrc/, built by nvcc.py — their plain PyTorch versions
# (ref.py), and the wrappers that pick one by the tensor's device (ops.py).
# Importing builds nothing.
from . import epoch_megakernel, fork_compact, nvcc, ops, ref  # noqa: F401
from .ops import fork_offsets, lane_pack, type_rank  # noqa: F401
