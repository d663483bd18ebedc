"""The port's scan kernels against the JAX reference.

On the CPU the port's ``fork_offsets``/``type_rank``/``lane_pack``/
``type_pack`` run their plain PyTorch versions; they must equal, exactly
(integers: atol=0), both the JAX ``kernels/ref.py`` oracle and the Pallas
kernel run by the Pallas interpreter (``type_pack`` against the JAX
``compact_types`` pipeline).  The CUDA kernels themselves are held against
the plain versions in ``test_torch_cuda.py``.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import types as pytypes

import jax.numpy as jnp
import numpy as np

from repro.core import tvm as jtvm
from repro.kernels import ops as jops
from repro_torch.core import tvm
from repro_torch.kernels import fork_compact, ops

LENGTHS = (1, 7, 1024, 1025, 3000)
MASKS = ("random", "none", "all")


def _mask(kind: str, n: int, rng) -> np.ndarray:
    if kind == "none":
        return np.zeros(n, bool)
    if kind == "all":
        return np.ones(n, bool)
    return rng.rand(n) < 0.6


@pytest.mark.parametrize("n", LENGTHS)
def test_fork_offsets_matches_jax(n):
    counts = np.random.RandomState(n).randint(0, 5, n).astype(np.int32)
    offs, total = ops.fork_offsets(torch.as_tensor(counts))
    assert offs.dtype == torch.int32 and total.dtype == torch.int32
    for impl in ("ref", "interpret"):
        j_offs, j_total = jops.fork_offsets(jnp.asarray(counts), impl=impl)
        np.testing.assert_array_equal(offs.numpy(), np.asarray(j_offs))
        assert int(total) == int(j_total)


@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("n_types", (1, 2, 3))
@pytest.mark.parametrize("n", LENGTHS)
def test_type_rank_matches_jax(n, n_types, kind):
    rng = np.random.RandomState(100 * n + n_types)
    types = rng.randint(0, n_types, n).astype(np.int32)
    active = _mask(kind, n, rng)
    rank, counts = ops.type_rank(
        torch.as_tensor(types), torch.as_tensor(active), n_types
    )
    assert rank.dtype == torch.int32 and counts.dtype == torch.int32
    for impl in ("ref", "interpret"):
        j_rank, j_counts = jops.type_rank(
            jnp.asarray(types), jnp.asarray(active), n_types, impl=impl
        )
        np.testing.assert_array_equal(rank.numpy(), np.asarray(j_rank))
        np.testing.assert_array_equal(counts.numpy(), np.asarray(j_counts))


@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("n", LENGTHS)
def test_lane_pack_matches_jax(n, kind):
    active = _mask(kind, n, np.random.RandomState(n + 7))
    perm, count = ops.lane_pack(torch.as_tensor(active))
    assert perm.dtype == torch.int32 and count.dtype == torch.int32
    for impl in ("ref", "interpret"):
        j_perm, j_count = jops.lane_pack(jnp.asarray(active), impl=impl)
        np.testing.assert_array_equal(perm.numpy(), np.asarray(j_perm))
        assert int(count) == int(j_count)


@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("n_types", (1, 2, 7))
@pytest.mark.parametrize("n", LENGTHS)
def test_type_pack_matches_jax(n, n_types, kind):
    """``ops.type_pack`` and the port's ``tvm.compact_types`` against the
    JAX ``compact_types`` with its rank and offsets from the JAX oracle and
    from the Pallas kernels run by the interpreter (7 types: the mixed4
    fleet's)."""
    rng = np.random.RandomState(1000 * n + 10 * n_types + MASKS.index(kind))
    types = rng.randint(0, n_types, n).astype(np.int32)
    active = _mask(kind, n, rng)
    perm, counts = ops.type_pack(
        torch.as_tensor(types), torch.as_tensor(active), n_types
    )
    assert perm.dtype == torch.int32 and counts.dtype == torch.int32
    program = pytypes.SimpleNamespace(tasks=[None] * n_types)
    state = pytypes.SimpleNamespace(task=torch.as_tensor(types), capacity=n)
    t_perm, t_counts = tvm.compact_types(
        program, state, torch.arange(n, dtype=torch.int32),
        torch.as_tensor(active))
    assert torch.equal(t_perm, perm) and torch.equal(t_counts, counts)
    j_state = pytypes.SimpleNamespace(task=jnp.asarray(types), capacity=n)
    for impl in ("ref", "interpret"):
        j_perm, j_counts = jtvm.compact_types(
            program, j_state, jnp.arange(n, dtype=jnp.int32),
            jnp.asarray(active),
            rank_fn=lambda t, a, k: jops.type_rank(t, a, k, impl=impl),
            offsets_fn=lambda c: jops.fork_offsets(c, impl=impl),
        )
        np.testing.assert_array_equal(perm.numpy(), np.asarray(j_perm))
        np.testing.assert_array_equal(counts.numpy(), np.asarray(j_counts))


@pytest.mark.parametrize("n, n_types, words", (
    (0, 1, 2), (1, 1, 2), (2048, 1, 2), (2049, 1, 3),
    (2**21, 2, 1 + 1024 * 2), (2**23, 7, 1 + 4096 * 8),
    (5000, 32, 1 + 3 * 32), (5000, 33, 2 + 2 * 3 * 32),
))
def test_type_rank_scratch_words(n, n_types, words):
    """A tile counter per group of 32 types and a status word per (group,
    2048-lane tile, type of the group's width rounded up to a power of
    two)."""
    assert fork_compact.type_rank_scratch_words(n, n_types) == words


@pytest.mark.parametrize("n_types", (0, -1))
def test_type_rank_scratch_words_rejects_no_types(n_types):
    with pytest.raises(ValueError, match="n_types"):
        fork_compact.type_rank_scratch_words(100, n_types)


@pytest.mark.parametrize("n, n_types", ((0, 1), (7, 1), (4097, 3),
                                        (5000, 33)))
def test_type_work_layout(n, n_types):
    """The one buffer a type entry clears: the scratch, then the counts,
    then the permutation, none overlapping, all inside the buffer."""
    work, counts, perm = fork_compact._type_work(n, n_types, "cpu", True)
    words = fork_compact.type_rank_scratch_words(n, n_types)
    # offsets in int32 elements of the int64 buffer
    c0, p0 = counts.storage_offset(), perm.storage_offset()
    assert counts.shape == (n_types,) and c0 == 2 * words
    assert perm.shape == (n,) and p0 >= c0 + n_types and p0 % 2 == 0
    assert p0 + n <= 2 * work.shape[0]
    _, counts, none = fork_compact._type_work(n, n_types, "cpu", False)
    assert none is None and counts.shape == (n_types,)


def test_cpu_path_launches_no_kernel():
    fork_compact.reset_launches()
    x = torch.arange(10, dtype=torch.int32)
    ops.fork_offsets(x)
    ops.type_rank(x % 2, x > 3, 2)
    ops.lane_pack(x > 3)
    ops.type_pack(x % 2, x > 3, 2)
    ops.segmented_fork_offsets(x, x % 3, 3)
    assert fork_compact.LAUNCHES == {
        "fork_scan": 0, "segmented_fork_scan": 0, "type_rank": 0}


def test_kernel_wrappers_take_cuda_tensors_only():
    x = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        fork_compact.fork_scan(x)
    with pytest.raises(ValueError, match="CUDA"):
        fork_compact.type_rank(x, x > 0, 1)
    with pytest.raises(ValueError, match="CUDA"):
        fork_compact.lane_pack(x > 0)
    with pytest.raises(ValueError, match="CUDA"):
        fork_compact.type_pack(x, x > 0, 1)


def test_library_name_follows_the_source():
    path = fork_compact.library_path()
    assert path.parent == fork_compact.BUILD_DIR
    assert path.name.startswith("fork_compact_") and path.suffix == ".so"
    assert fork_compact.library_path() == path  # stable for one source
