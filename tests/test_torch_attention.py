"""The port's attention against the JAX reference.

On the CPU the port's ``ops.attention`` and ``ops.gqa_decode`` run their
plain PyTorch versions (``kernels/ref.py``: ``mha_ref``, ``mha_blockwise``,
``decode_attention_ref``).  Each is held against the JAX plain version of
the same name and against the Pallas kernel (``mha_flash``,
``decode_attention``) run by the Pallas interpreter, as
``tests/test_kernels.py`` runs them, on the same inputs drawn from numpy.
Tolerances: 1e-5 in float32 (the sums are taken in another order), 2e-2 in
bfloat16 (one rounding of the output).  The CUDA kernels are held against
the plain versions in ``test_torch_cuda.py``.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np

from _torch_threads import one_torch_thread  # noqa: F401
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as jdecode
from repro.kernels.flash_attention import mha_flash
from repro_torch import configs
from repro_torch.kernels import decode_attention, flash_attention, ops, ref

DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}

# B, Hq, Hkv, Sq, Skv, D, causal, q_offset, window
FLASH = [
    (1, 2, 2, 32, 32, 32, True, 0, 0),     # group 1, square
    (2, 8, 2, 40, 72, 16, True, 32, 0),    # group 4, ragged, q_offset
    (1, 4, 2, 48, 48, 32, False, 0, 0),    # group 2, non-causal
    (1, 4, 1, 50, 50, 16, True, 0, 12),    # causal + window, group 4
    (2, 4, 4, 20, 70, 32, False, 0, 0),    # Skv not a multiple of 32
    (1, 2, 1, 33, 33, 16, True, 0, 5),     # narrow window, 33 rows
    (1, 4, 2, 30, 30, 16, False, 0, 8),    # window without causal
    (1, 10, 2, 40, 40, 16, True, 0, 8),    # group 5 (hymba), window
]
FLASH_IDS = [f"B{c[0]}h{c[1]}x{c[2]}q{c[3]}k{c[4]}d{c[5]}"
             f"{'c' if c[6] else 'n'}o{c[7]}w{c[8]}" for c in FLASH]

# B, Hq, Hkv, S, D, lengths, window.  A length above S reads all S rows;
# the Pallas kernel pads the cache to a multiple of its key block and, for
# such a length, would read the zero rows of that padding too, so S is a
# multiple of the block (32) wherever a length passes it.
DECODE = [
    (3, 4, 4, 64, 16, (1, 64, 80), 0),         # group 1: 1, S, above S
    (3, 8, 2, 96, 32, (1, 96, 150), 0),        # group 4
    (4, 4, 2, 50, 16, (1, 30, 50, 49), 10),    # group 2 with a window
    (2, 10, 2, 64, 16, (1, 40), 0),            # group 5 (hymba)
]


def _inputs(case, dtype_name):
    B, Hq, Hkv, Sq, Skv, D = case[:6]
    rng = np.random.RandomState(sum(case[:6]))
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D))]
    jdt, tdt, tol = DTYPES[dtype_name]
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.as_tensor(a).to(tdt) for a in arrs], tol)


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", FLASH, ids=FLASH_IDS)
def test_mha_ref_matches_jax_ref(case, dtype):
    (jq, jk, jv), (q, k, v), tol = _inputs(case, dtype)
    causal, qo, win = case[6:]
    got = ref.mha_ref(q, k, v, causal=causal, q_offset=qo, window=win)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, jref.mha_ref(jq, jk, jv, causal=causal, q_offset=qo,
                             window=win), tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", FLASH, ids=FLASH_IDS)
def test_mha_blockwise_matches_jax_blockwise(case, dtype):
    (jq, jk, jv), (q, k, v), tol = _inputs(case, dtype)
    causal, qo, win = case[6:]
    got = ref.mha_blockwise(q, k, v, causal=causal, q_offset=qo, window=win,
                            block_k=32)
    _close(got, jref.mha_blockwise(jq, jk, jv, causal=causal, q_offset=qo,
                                   window=win, block_k=32), tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", FLASH, ids=FLASH_IDS)
def test_attention_matches_pallas_flash(case, dtype):
    (jq, jk, jv), (q, k, v), tol = _inputs(case, dtype)
    causal, qo, win = case[6:]
    got = ops.attention(q, k, v, causal=causal, q_offset=qo, window=win)
    _close(got, mha_flash(jq, jk, jv, causal=causal, q_offset=qo,
                          window=win, block_q=32, block_k=32,
                          interpret=True), tol)


def test_attention_switches_to_blockwise_past_1024_keys():
    case = (1, 2, 1, 8, 1100, 16, True, 1092, 0)
    (jq, jk, jv), (q, k, v), tol = _inputs(case, "f32")
    got = ops.attention(q, k, v, causal=True, q_offset=1092)
    _close(got, jops.attention(jq, jk, jv, causal=True, q_offset=1092,
                               impl="ref"), tol)
    _close(got, ref.mha_blockwise(q, k, v, causal=True, q_offset=1092), 0)


def _decode_inputs(case, dtype_name):
    B, Hq, Hkv, S, D, lengths, _ = case
    rng = np.random.RandomState(B * S + D)
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((B, Hq, D), (B, Hkv, S, D), (B, Hkv, S, D))]
    jdt, tdt, tol = DTYPES[dtype_name]
    lens = np.asarray(lengths, np.int32)
    return ([jnp.asarray(a, jdt) for a in arrs] + [jnp.asarray(lens)],
            [torch.as_tensor(a).to(tdt) for a in arrs]
            + [torch.as_tensor(lens)], tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", DECODE,
                         ids=[f"g{c[1] // c[2]}w{c[6]}" for c in DECODE])
def test_decode_ref_matches_jax_ref(case, dtype):
    jargs, targs, tol = _decode_inputs(case, dtype)
    got = ref.decode_attention_ref(*targs, window=case[6])
    assert got.dtype == targs[0].dtype and got.shape == targs[0].shape
    _close(got, jref.decode_attention_ref(*jargs, window=case[6]), tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", DECODE,
                         ids=[f"g{c[1] // c[2]}w{c[6]}" for c in DECODE])
def test_gqa_decode_matches_pallas_decode(case, dtype):
    jargs, targs, tol = _decode_inputs(case, dtype)
    got = ops.gqa_decode(*targs, window=case[6])
    _close(got, jdecode(*jargs, window=case[6], block_k=32, interpret=True),
           tol)


def test_wrappers_accept_every_config_group():
    """Every config's attention shape, full and reduced, passes both
    kernels' shape checks (needs no card): groups 1, 2, 4, 5, 7 and 8, and
    any group of 1 to 8 at every head dim."""
    groups = set()
    for arch in configs.ARCH_IDS:
        for cfg in (configs.get_config(arch), configs.get_reduced(arch)):
            if cfg.block == "ssm":  # attention-free
                continue
            Hq, Hkv = cfg.n_heads_padded, cfg.n_kv_heads_padded
            flash_attention.check_shape(Hq, Hkv, cfg.resolved_head_dim)
            decode_attention.check_shape(Hq, Hkv, cfg.resolved_head_dim)
            groups.add(Hq // Hkv)
    assert {1, 2, 4, 5, 7, 8} <= groups, groups
    for g in range(1, 9):
        for D in flash_attention.HEAD_DIMS:
            decode_attention.check_shape(3 * g, 3, D)
    with pytest.raises(ValueError, match="group"):
        decode_attention.check_shape(9, 1, 128)
    with pytest.raises(ValueError, match="head dim"):
        decode_attention.check_shape(8, 2, 48)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention.check_shape(9, 2, 64)


# B, Hq, Hkv, S, D, lengths, window, split: splits that do not divide S,
# splits wholly past a length or wholly before a window, lengths 1, S and
# S + 5 (S a multiple of the Pallas kernel's 32-row block, see DECODE)
SPLIT = [
    (4, 2, 2, 96, 16, (1, 96, 101, 50), 0, 40),     # group 1
    (3, 10, 2, 64, 16, (1, 64, 69), 0, 24),         # group 5
    (3, 14, 2, 96, 32, (70, 96, 101), 20, 40),      # group 7, window
]


@pytest.mark.parametrize("case", SPLIT,
                         ids=[f"g{c[1] // c[2]}w{c[6]}s{c[7]}" for c in SPLIT])
def test_decode_split_ref_matches_jax(case):
    """The kernel's split-K algorithm (``ref.decode_attention_split_ref``)
    against the Pallas kernel in interpret mode and the plain version, in
    float32 at 1e-5."""
    jargs, targs, tol = _decode_inputs(case[:7], "f32")
    window, split = case[6], case[7]
    got = ref.decode_attention_split_ref(*targs, split=split, window=window)
    assert got.dtype == targs[0].dtype and got.shape == targs[0].shape
    _close(got, jdecode(*jargs, window=window, block_k=32, interpret=True),
           tol)
    _close(got, ref.decode_attention_ref(*targs, window=window), tol)
