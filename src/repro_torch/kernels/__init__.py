# Hand-written CUDA kernels for the epoch machine's scans (fork_compact.py,
# source in csrc/), their plain PyTorch versions (ref.py), and the wrappers
# that pick one by the tensor's device (ops.py).  Importing builds nothing.
from . import fork_compact, ops, ref  # noqa: F401
from .ops import fork_offsets, lane_pack, type_rank  # noqa: F401
