"""A fixture the port's service and megakernel CPU test modules share.

``from _torch_threads import one_torch_thread`` in a test module runs that
module on one intra-op thread.
"""
from __future__ import annotations

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the importing module: its tensors are small,
    and torch's thread pool costs more than it gives on them, many times
    more while other test processes load the machine.  The results are the
    same."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
