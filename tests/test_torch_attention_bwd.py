"""The attention gradient's plain version and its autograd wiring, on the CPU.

- ``ref.mha_backward_ref`` (the plain version of the backward kernels,
  which works from the forward's output and log-sum-exp) against
  PyTorch's autograd through ``ref.mha_ref``: causal and not, a window, a
  q offset, GQA groups 1, 4 and 5, lengths off the kernels' tiles; in
  float32 (the plain versions compute in it), within 1e-5 of each
  gradient's largest |value|.  The lse that
  ``mha_ref(return_lse=True)`` gives is the row's ``logsumexp``.
- ``flash_attention.FlashAttention`` wired with a stub that routes its two
  launches to the plain versions (the CUDA kernels cannot run here): the
  same gradients, each stub called once.  The stub exists only in this
  test; on a CPU tensor ``ops.attention`` never takes the Function.

No JAX: the reference's gradient through attention is XLA's derivative of
its plain ``mha_ref``, the function autograd differentiates here.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch.kernels import flash_attention, ops, ref

# B, Hq, Hkv, Sq, Skv, D, causal, q_offset, window
CASES = (
    (2, 4, 4, 33, 33, 16, True, 0, 0),     # group 1, off the 32/64 tiles
    (1, 8, 2, 70, 70, 32, False, 0, 0),    # group 4, non-causal
    (2, 5, 1, 65, 65, 16, True, 0, 9),     # group 5, a window
    (1, 4, 1, 20, 90, 16, True, 70, 0),    # q offset (a prefill's tail)
    (1, 8, 2, 40, 40, 64, False, 0, 12),   # window, non-causal
)
TOL = 1e-5  # float32 (the plain versions compute in it): other sums


def _inputs(case, dtype=torch.float32, seed=0):
    B, Hq, Hkv, Sq, Skv, D = case[:6]
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((B, Hq, Sq, D), generator=g, dtype=dtype)
    k, v = (torch.randn((B, Hkv, Skv, D), generator=g, dtype=dtype)
            for _ in range(2))
    do = torch.randn((B, Hq, Sq, D), generator=g, dtype=dtype)
    return q, k, v, do


def _kw(case):
    return dict(zip(("causal", "q_offset", "window"), case[6:]))


def _autograd(q, k, v, do, **kw):
    xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = ref.mha_ref(*xs, **kw)
    out.backward(do)
    return out.detach(), [x.grad for x in xs]


def _close(got, want, tol=TOL):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        err = float((g - w).abs().max())
        assert err <= tol * float(w.abs().max()), err


@pytest.mark.parametrize("case", CASES)
def test_backward_ref_matches_autograd(case):
    q, k, v, do = _inputs(case)
    kw = _kw(case)
    out, want = _autograd(q, k, v, do, **kw)
    o, lse = ref.mha_ref(q, k, v, return_lse=True, **kw)
    assert torch.equal(o, out)
    B, Hq, Sq, D = q.shape
    s = torch.einsum("bhqd,bhkd->bhqk", q, k.repeat_interleave(
        Hq // k.shape[1], dim=1)) * D ** -0.5
    mask = ref._attn_mask(Sq, k.shape[2], kw["causal"], kw["q_offset"],
                          kw["window"], q.device)
    want_lse = torch.logsumexp(s.masked_fill(~mask, float("-inf")), -1)
    assert torch.allclose(lse, want_lse, rtol=0, atol=1e-5)
    _close(ref.mha_backward_ref(q, k, v, o, lse, do, **kw), want)


def test_function_wiring_with_plain_stubs(monkeypatch):
    """``FlashAttention`` saves what its backward needs and hands the
    kernels' arguments through: with the launches routed to the plain
    versions, its gradients are autograd's through ``mha_ref``."""
    calls = {"fwd": 0, "bwd": 0}

    def fwd(q, k, v, causal, scale, q_offset, window, return_lse):
        assert return_lse
        calls["fwd"] += 1
        return ref.mha_ref(q, k, v, causal=causal, scale=scale,
                           q_offset=q_offset, window=window, return_lse=True)

    def bwd(q, k, v, o, lse, do, **kw):
        calls["bwd"] += 1
        return ref.mha_backward_ref(q, k, v, o, lse, do, **kw)

    monkeypatch.setattr(flash_attention, "flash_attention",
                        lambda q, k, v, **kw: fwd(q, k, v, **kw))
    monkeypatch.setattr(flash_attention, "flash_attention_bwd", bwd)
    case = CASES[2]
    q, k, v, _ = _inputs(case, seed=1)
    kw = _kw(case)
    # out.sum()'s gradient is an expanded tensor of ones (stride 0): the
    # Function makes it contiguous before the kernel reads it
    out, want = _autograd(q, k, v, torch.ones_like(q), **kw)
    xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    got = flash_attention.FlashAttention.apply(
        *xs, kw["causal"], None, kw["q_offset"], kw["window"])
    assert torch.equal(got.detach(), out)
    got.sum().backward()
    assert calls == {"fwd": 1, "bwd": 1}
    _close([x.grad for x in xs], want)


def test_cpu_attention_stays_plain_under_grad(monkeypatch):
    """On the CPU ``ops.attention`` is the plain version under PyTorch's
    own autograd, whatever needs a gradient."""
    def refuse(*a, **k):
        raise AssertionError("the kernels' Function on a CPU tensor")

    monkeypatch.setattr(flash_attention.FlashAttention, "apply", refuse)
    case = CASES[0]
    q, k, v, do = _inputs(case)
    xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ops.attention(*xs, **_kw(case)).backward(do)
    _, want = _autograd(q, k, v, do, **_kw(case))
    _close([x.grad for x in xs], want, tol=0.0)
