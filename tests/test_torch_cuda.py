"""The port on a CUDA card: each kernel against its plain PyTorch version,
and whole runs on the card against runs on the CPU.

Every test here is marked ``cuda`` and skips where there is no card.  The
file imports no JAX, so it runs on a GPU machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.apps import all_cases, get_fleet
from repro_torch.kernels import fork_compact, ops, ref
from repro_torch.service import JobService

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("n", (1, 7, 1000, 1024, 1025, 3000, 2**16 + 3))
def test_kernels_match_plain(cuda_device, n):
    rng = np.random.RandomState(n)
    counts = torch.as_tensor(rng.randint(0, 4, n).astype(np.int32),
                             device=cuda_device)
    fork_compact.reset_launches()
    offs, total = ops.fork_offsets(counts)
    r_offs, r_total = ref.fork_scan_ref(counts)
    assert torch.equal(offs, r_offs) and int(total) == int(r_total)
    for n_types in (1, 2, 3, 8):
        types = torch.as_tensor(rng.randint(0, n_types, n).astype(np.int32),
                                device=cuda_device)
        for act in (rng.rand(n) < 0.6, np.zeros(n, bool), np.ones(n, bool)):
            active = torch.as_tensor(act, device=cuda_device)
            rank, cnt = ops.type_rank(types, active, n_types)
            r_rank, r_cnt = ref.type_rank_ref(types, active, n_types)
            assert torch.equal(rank, r_rank) and torch.equal(cnt, r_cnt)
    perm, c = ops.lane_pack(active)
    r_perm, r_c = ref.lane_pack_ref(active)
    assert torch.equal(perm, r_perm) and int(c) == int(r_c)
    torch.cuda.synchronize()
    assert fork_compact.LAUNCHES == {
        "fork_scan": 1, "segmented_fork_scan": 0, "type_rank": 13}


def test_fork_scan_wraps_like_int32(cuda_device):
    counts = torch.full((5001,), 2**30, dtype=torch.int32, device=cuda_device)
    offs, total = ops.fork_offsets(counts)
    r_offs, r_total = ref.fork_scan_ref(counts.cpu())
    assert torch.equal(offs.cpu(), r_offs) and int(total) == int(r_total)


def test_wrappers_check_their_inputs(cuda_device):
    x = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="n_types"):
        fork_compact.type_rank(x, x == 0, 0)
    with pytest.raises(ValueError, match="n_segs"):
        fork_compact.segmented_fork_scan(x, x, 0)
    with pytest.raises(ValueError, match="length"):
        fork_compact.segmented_fork_scan(x, x[:4], 1)
    with pytest.raises(TypeError):
        fork_compact.fork_scan(x.long())
    with pytest.raises(ValueError, match="contiguous"):
        fork_compact.fork_scan(torch.zeros(16, dtype=torch.int32,
                                           device=cuda_device)[::2])
    with pytest.raises(ValueError, match="length"):
        fork_compact.type_rank(x, x[:4] == 0, 1)


@pytest.mark.parametrize("dispatch", ("masked", "compacted", "gather"))
@pytest.mark.parametrize("name", ("bfs", "fib", "mergesort"))
def test_engine_on_cuda_matches_cpu(cuda_device, name, dispatch):
    case = all_cases()[name]
    fork_compact.reset_launches()
    gh, gv, gs = case.run(dispatch=dispatch, device="cuda")
    launches = dict(fork_compact.LAUNCHES)
    ch, cv, cs = case.run(dispatch=dispatch, device="cpu")
    assert torch.equal(gv.cpu(), cv)
    for k in ch:
        assert torch.equal(gh[k].cpu(), ch[k]), k
    assert gs.as_dict() == cs.as_dict()
    assert launches["fork_scan"] >= gs.epochs
    assert (launches["type_rank"] > 0) == (dispatch != "masked")


@pytest.mark.parametrize("n", (1, 7, 1024, 1025, 5000, 2**16 + 3))
@pytest.mark.parametrize("n_segs", (1, 3, 8, 33))
def test_segmented_scan_matches_plain(cuda_device, n, n_segs):
    rng = np.random.RandomState(n + n_segs)
    counts = rng.randint(0, 5, n).astype(np.int32)
    counts[rng.rand(n) < 0.3] = 0
    for seg in (np.sort(rng.randint(0, n_segs, n)),    # contiguous
                rng.randint(0, n_segs, n),             # shuffled
                rng.randint(-1, n_segs + 1, n)):       # ids -1 and J too
        c = torch.as_tensor(counts, device=cuda_device)
        s = torch.as_tensor(seg.astype(np.int32), device=cuda_device)
        fork_compact.reset_launches()
        offs, totals = ops.segmented_fork_offsets(c, s, n_segs)
        assert fork_compact.LAUNCHES["segmented_fork_scan"] == 1
        r_offs, r_totals = ref.segmented_fork_scan_ref(c, s, n_segs)
        assert torch.equal(offs, r_offs) and torch.equal(totals, r_totals)
    torch.cuda.synchronize()


def test_segmented_scan_wraps_like_int32(cuda_device):
    rng = np.random.RandomState(3)
    counts = torch.full((5001,), 2**30 + 7, dtype=torch.int32,
                        device=cuda_device)
    seg = torch.as_tensor(rng.randint(0, 3, 5001).astype(np.int32),
                          device=cuda_device)
    offs, totals = ops.segmented_fork_offsets(counts, seg, 3)
    r_offs, r_totals = ref.segmented_fork_scan_ref(counts.cpu(), seg.cpu(), 3)
    assert torch.equal(offs.cpu(), r_offs)
    assert torch.equal(totals.cpu(), r_totals)


@pytest.mark.parametrize("n_types", (9, 24))
@pytest.mark.parametrize("n", (1, 1025, 2**16 + 3))
def test_type_rank_past_eight_types(cuda_device, n, n_types):
    rng = np.random.RandomState(n * n_types)
    types = torch.as_tensor(rng.randint(0, n_types, n).astype(np.int32),
                            device=cuda_device)
    for act in (rng.rand(n) < 0.6, np.zeros(n, bool), np.ones(n, bool)):
        active = torch.as_tensor(act, device=cuda_device)
        rank, cnt = ops.type_rank(types, active, n_types)
        r_rank, r_cnt = ref.type_rank_ref(types, active, n_types)
        assert torch.equal(rank, r_rank) and torch.equal(cnt, r_cnt)


@pytest.mark.parametrize("dispatch", ("masked", "compacted", "gather"))
def test_service_on_cuda_matches_cpu(cuda_device, dispatch):
    fleet = get_fleet("mixed4")
    runs = {}
    for dev in ("cuda", "cpu"):
        fork_compact.reset_launches()
        svc = JobService(capacity=sum(q for _, q in fleet),
                         dispatch=dispatch, device=dev)
        handles = [svc.submit_case(c, quota=q) for c, q in fleet]
        svc.drain()
        runs[dev] = (handles, svc.stats(), dict(fork_compact.LAUNCHES))
    (gh, gs, launches), (ch, cs, _) = runs["cuda"], runs["cpu"]
    for g, c in zip(gh, ch):
        assert g.status is c.status is g.status.DONE
        assert torch.equal(g.result.value.cpu(), c.result.value)
        for k in c.result.heap:
            assert torch.equal(g.result.heap[k].cpu(), c.result.heap[k]), k
        assert g.result.stats == c.result.stats
    assert gs.as_dict() == cs.as_dict()
    assert launches["segmented_fork_scan"] == gs.epochs
