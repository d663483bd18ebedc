# Hand-written CUDA kernels — the scans (fork_compact.py), the resident
# megakernel (epoch_megakernel.py), the serving path's attention
# (flash_attention.py, decode_attention.py) and the Mamba-2 scan
# (ssd_scan.py), sources in csrc/, built by
# nvcc.py — their plain PyTorch versions (ref.py), and the wrappers that
# pick one by the tensor's device (ops.py).  Importing builds nothing.
from . import (  # noqa: F401
    decode_attention, epoch_megakernel, flash_attention, fork_compact, nvcc,
    ops, ref, ssd_scan,
)
from .ops import (  # noqa: F401
    attention, fork_offsets, gqa_decode, lane_pack, ssd, type_pack,
    type_rank,
)
