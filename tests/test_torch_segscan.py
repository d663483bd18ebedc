"""The port's segmented fork scan (and ``type_rank`` past eight types)
against the JAX reference.

On the CPU the port's ``segmented_fork_offsets`` runs its plain PyTorch
version; it must equal, exactly (integers: atol=0), both the JAX
``kernels/ref.py`` oracle and the Pallas ``segmented_fork_scan`` run by
the Pallas interpreter, on contiguous and shuffled segment ids, ids -1
and ``J`` (outside every segment), zero counts and counts that wrap int32.
The CUDA kernel itself is held against the plain version in
``test_torch_cuda.py``.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np

from _torch_threads import one_torch_thread  # noqa: F401
from repro.kernels import fork_compact as jfc
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import fork_compact, ops, ref

LENGTHS = (1, 7, 1024, 1025, 5000)
N_SEGS = (1, 3, 8, 33)
KINDS = ("contiguous", "shuffled", "out_of_range")


def _inputs(n: int, J: int, kind: str):
    rng = np.random.RandomState(1000 * J + n)
    counts = rng.randint(0, 5, n).astype(np.int32)
    counts[rng.rand(n) < 0.3] = 0  # zero counts
    if kind == "contiguous":
        seg = np.sort(rng.randint(0, J, n))
    elif kind == "shuffled":
        seg = rng.randint(0, J, n)
    else:  # ids -1 and J lie outside every segment
        seg = rng.randint(-1, J + 1, n)
    return counts, seg.astype(np.int32)


def _check(counts: np.ndarray, seg: np.ndarray, J: int, impls) -> None:
    offs, totals = ops.segmented_fork_offsets(
        torch.as_tensor(counts), torch.as_tensor(seg), J
    )
    assert offs.dtype == torch.int32 and totals.dtype == torch.int32
    assert tuple(totals.shape) == (J,)
    for impl in impls:
        if impl == "ref":
            j_offs, j_tot = jref.segmented_fork_scan_ref(
                jnp.asarray(counts), jnp.asarray(seg), J)
        else:
            j_offs, j_tot = jfc.segmented_fork_scan(
                jnp.asarray(counts), jnp.asarray(seg), J, interpret=True)
        np.testing.assert_array_equal(offs.numpy(), np.asarray(j_offs))
        np.testing.assert_array_equal(totals.numpy(), np.asarray(j_tot))


@pytest.mark.parametrize("J", N_SEGS)
@pytest.mark.parametrize("n", LENGTHS)
def test_segmented_scan_matches_jax(n, J):
    """Every (length, segments) pair against the jnp oracle and the
    Pallas kernel in interpret mode (one compile each), for each kind of
    segment ids."""
    for kind in KINDS:
        _check(*_inputs(n, J, kind), J, ("ref", "interpret"))


@pytest.mark.parametrize("J", (1, 3))
def test_segmented_scan_wraps_like_int32(J):
    n = 5000
    rng = np.random.RandomState(J)
    counts = (2**31 - 1 - rng.randint(0, 8, n)).astype(np.int32)
    seg = rng.randint(0, J, n).astype(np.int32)
    _check(counts, seg, J, ("ref", "interpret"))


def test_segmented_scan_is_the_solo_scan_per_segment():
    """A lane's offset is the plain exclusive scan of its own segment's
    lanes, wherever they lie."""
    counts, seg = _inputs(1025, 8, "shuffled")
    offs, totals = ref.segmented_fork_scan_ref(
        torch.as_tensor(counts), torch.as_tensor(seg), 8)
    for s in range(8):
        m = seg == s
        solo, total = ref.fork_scan_ref(torch.as_tensor(counts[m]))
        assert torch.equal(offs[torch.as_tensor(m)], solo)
        assert int(totals[s]) == int(total)


@pytest.mark.parametrize("n", (1, 1025))
def test_type_rank_past_eight_types_matches_jax(n):
    """The compacted dispatch of a fused wave reaches ``type_rank`` with as
    many types as its members together (24 for eight naive mergesorts)."""
    rng = np.random.RandomState(n)
    types = rng.randint(0, 24, n).astype(np.int32)
    for active in (rng.rand(n) < 0.6, np.ones(n, bool)):
        rank, counts = ops.type_rank(
            torch.as_tensor(types), torch.as_tensor(active), 24)
        j_rank, j_counts = jops.type_rank(
            jnp.asarray(types), jnp.asarray(active), 24, impl="ref")
        np.testing.assert_array_equal(rank.numpy(), np.asarray(j_rank))
        np.testing.assert_array_equal(counts.numpy(), np.asarray(j_counts))


def test_cpu_path_launches_no_kernel():
    fork_compact.reset_launches()
    x = torch.arange(10, dtype=torch.int32)
    ops.segmented_fork_offsets(x, x % 3, 3)
    assert fork_compact.LAUNCHES["segmented_fork_scan"] == 0


def test_wrapper_takes_cuda_tensors_only():
    x = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        fork_compact.segmented_fork_scan(x, x, 1)


@pytest.mark.parametrize("n,n_segs,words", (
    (0, 1, 1 + 1),            # one tile even for no lanes
    (2048, 1, 1 + 1),
    (2049, 4, 1 + 2 * 4),     # the mixed4 wave's four tenants
    (2**23, 4, 1 + 4096 * 4),
    (5000, 3, 1 + 3 * 4),     # width rounded up to a power of two
    (5000, 32, 1 + 3 * 32),
    (5000, 33, 2 + 2 * 3 * 32),  # past one group: each group a pass
))
def test_seg_scan_scratch_words(n, n_segs, words):
    """The single pass's scratch: a tile counter per group of 32 segments
    and a status word per (group, 2048-lane tile, segment of the group's
    width)."""
    assert fork_compact.seg_scan_scratch_words(n, n_segs) == words


def test_seg_scan_scratch_words_refuses_no_segments():
    with pytest.raises(ValueError, match="n_segs"):
        fork_compact.seg_scan_scratch_words(10, 0)
