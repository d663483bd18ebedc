"""Native bitonic sort — the paper's "high-performance native OpenCL sort"
baseline (§6.4, Fig. 9), as log^2(n) dense compare-exchange stages of
torch operations.
"""
from __future__ import annotations

import torch


def bitonic_sort(x: torch.Tensor, ascending: bool = True) -> torch.Tensor:
    """Sort a power-of-two-length 1-D tensor on its own device."""
    n = x.shape[0]
    if n & (n - 1):
        raise ValueError("bitonic sort requires power-of-two length")
    idx = torch.arange(n, device=x.device)
    k = 2
    while k <= n:
        up = (idx & k) == 0
        j = k // 2
        while j >= 1:
            partner = idx ^ j
            b = x[partner]
            keep_min = (idx < partner) == up
            x = torch.where(keep_min, torch.minimum(x, b),
                            torch.maximum(x, b))
            j //= 2
        k *= 2
    return x if ascending else x.flip(0)
