"""The ordered float scatter-add on the CPU: its plain version
``ref.ordered_add_ref`` against the CPU's serial ``index_add_`` (the bits
the ``ordered_add`` kernel must give on the card), the CPU dispatch of
``ops.ordered_add_`` and ``tvm._scatter_heap``, the wrapper's checks, and
the build hash that covers the header the kernels share.  The card tests
are in ``tests/test_torch_cuda.py``.  No JAX here.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch.core import tvm
from repro_torch.kernels import nvcc, ops, ordered_add, ref


def _bits_equal(a, b) -> bool:
    nan = torch.isnan(a)
    return (torch.equal(nan, torch.isnan(b))
            and torch.equal(a[~nan].view(torch.int32),
                            b[~nan].view(torch.int32)))


def _case(kind, g):
    """``(base, idx, val)``; the last row of ``base`` is the sink."""
    if kind == "hot_cell":
        idx = torch.full((5000,), 2, dtype=torch.int32)
        val = torch.randn(5000, generator=g) * 1e4
        rows = 5
    elif kind == "one_term_cells":
        idx = torch.randperm(4096, generator=g).to(torch.int32)
        val = torch.randn(4096, generator=g)
        rows = 4097
    elif kind == "mixed_runs":
        idx = torch.randint(0, 300, (20000,), generator=g).to(torch.int32)
        idx[::7] = 299  # the sink
        val = torch.randn(20000, generator=g) * 100
        rows = 300
    elif kind == "rows_of_three":
        idx = torch.randint(0, 64, (3000,), generator=g)
        val = torch.randn(3000, 3, generator=g)
        rows = 65
    else:  # specials: signed zeros, infinities and a NaN
        vals = torch.tensor([-0.0, 0.0, float("inf"), -float("inf"),
                             float("nan"), 1e30, -1e30, 1.0])
        idx = torch.randint(0, 20, (2000,), generator=g).to(torch.int32)
        val = vals[torch.randint(0, 8, (2000,), generator=g)]
        rows = 21
    base = torch.randn((rows,) + tuple(val.shape[1:]), generator=g)
    return base, idx, val


KINDS = ("hot_cell", "one_term_cells", "mixed_runs", "rows_of_three",
         "specials")


@pytest.mark.parametrize("kind", KINDS)
def test_plain_ordered_add_is_the_serial_index_add(kind):
    base, idx, val = _case(kind, torch.Generator().manual_seed(len(kind)))
    got = ref.ordered_add_ref(base.clone(), idx, val)
    want = base.clone().index_add_(0, idx, val)
    assert _bits_equal(got[:-1], want[:-1])
    assert torch.equal(got[-1], base[-1])  # the sink row is not written


@pytest.mark.parametrize("kind", KINDS)
def test_float_add_on_the_cpu_is_index_add(kind):
    base, idx, val = _case(kind, torch.Generator().manual_seed(3))
    a, b = base.clone(), base.clone()
    tvm._scatter_heap(a, idx, val, "add")
    ops.ordered_add_(b, idx, val)
    want = base.clone().index_add_(0, idx, val)
    assert _bits_equal(a, want) and _bits_equal(b, want)


def test_plain_ordered_add_takes_no_terms():
    base = torch.randn(9)
    got = ref.ordered_add_ref(base.clone(), torch.zeros(0, dtype=torch.int32),
                              torch.zeros(0))
    assert torch.equal(got, base)
    sink_only = ref.ordered_add_ref(
        base.clone(), torch.full((5,), 8, dtype=torch.int32), torch.ones(5))
    assert torch.equal(sink_only, base)


def test_wrapper_checks_before_it_builds():
    arr = torch.zeros(9)
    idx = torch.zeros(4, dtype=torch.int32)
    val = torch.ones(4)
    with pytest.raises(ValueError, match="CUDA"):
        ordered_add.ordered_add_(arr, idx, val)
    with pytest.raises(TypeError, match="float32"):
        ordered_add.ordered_add_(arr.double(), idx, val)
    with pytest.raises(TypeError, match="int32 or int64"):
        ordered_add.ordered_add_(arr, idx.to(torch.int16), val)


def test_build_hash_covers_the_headers(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    first = nvcc.library_path(src)
    (tmp_path / "h.cuh").write_text("// two\n")
    assert nvcc.library_path(src) != first
    assert nvcc.library_path(ordered_add.SOURCE).name.startswith(
        "ordered_add_")
