"""The port's SSM path against the JAX reference, on the CPU.

The SSD scan: the port's plain versions (``ref.ssd_scan_ref``, the
sequential oracle, and ``ref.ssd_chunked``, which ``ops.ssd`` runs on the
CPU) are batched over sequences; each sequence is held against JAX's
``ssd_scan_ref``, ``ssd_chunked`` and the Pallas ``ssd_scan`` run by the
Pallas interpreter (as ``tests/test_kernels.py`` runs it), on the same
inputs drawn from numpy, at the JAX sweep's shapes; the kernel's
tensor-core design in plain PyTorch (``ref.ssd_chunked_tc``) against the
JAX oracle at the card's bf16 tolerance.  Tolerances, of
max(1, max |JAX|): 1e-5 in float32 (sums in another order), 2e-2 in
bfloat16 (one rounding of y).

The Mamba-2 block (``apply_ssm``, ``apply_ssm_decode``) and the server on
the reduced mamba2 and hymba configs, from the JAX ``init_model`` weights:
the block within 1e-4 of max |JAX| in float32, the server's tokens,
completion order and epochs equal to the JAX ``EpochServer``'s in float32
compute.  The CUDA kernel is held against the plain versions in
``test_torch_cuda.py``.
"""
from __future__ import annotations

import dataclasses

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import numpy as np

from repro import configs as jconfigs
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as jssd_scan
from repro.models import model as jmodel
from repro.models import ssm as jssm
from repro.serving import EpochServer as JServer
from repro.serving import Request as JRequest
from repro_torch import configs
from repro_torch.core.convert import cache_from_numpy, params_from_numpy
from repro_torch.kernels import ops, ref, ssd_scan
from repro_torch.models import model, ssm
from repro_torch.serving import EpochServer, Request
from repro_torch.serving.engine import _bucket

DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
# S, H, P, N, chunk: the JAX sweep (tests/test_kernels.py)
SWEEP = [(32, 2, 8, 8, 8), (96, 3, 16, 16, 32), (65, 1, 32, 8, 16)]
N_SEQ = 2


def _ssd_inputs(S, H, P, N, seed, n_seq=N_SEQ):
    """x, dt, A, B, C, h0 as float32 numpy, drawn as the JAX sweep draws."""
    rng = np.random.RandomState(seed)
    return (rng.normal(size=(n_seq, S, H, P)).astype(np.float32),
            rng.uniform(0.01, 0.2, (n_seq, S, H)).astype(np.float32),
            -rng.uniform(0.5, 2.0, H).astype(np.float32),
            rng.normal(size=(n_seq, S, N)).astype(np.float32),
            rng.normal(size=(n_seq, S, N)).astype(np.float32),
            rng.normal(size=(n_seq, H, P, N)).astype(np.float32))


def _both(arrs, dtype):
    """(JAX arrays, torch tensors) in ``dtype``; A and h0 stay float32."""
    jdt, tdt, _ = DTYPES[dtype]
    keep = {2, 5}
    j = [jnp.asarray(a, jnp.float32 if i in keep else jdt)
         for i, a in enumerate(arrs)]
    t = [torch.as_tensor(a).to(torch.float32 if i in keep else tdt)
         for i, a in enumerate(arrs)]
    return j, t


def _close(got, want, tol, what):
    got = (got.float().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, np.float32))
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.all(np.isfinite(got)), what
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), (what, err)


def _jax_per_seq(fn, jx, jdt, jA, jB, jC, jh0=None):
    """A per-sequence JAX function's (y, h), mapped over the sequences."""
    if jh0 is None:
        y, h = jax.vmap(lambda *a: fn(*a, None), (0, 0, None, 0, 0))(
            jx, jdt, jA, jB, jC)
    else:
        y, h = jax.vmap(fn, (0, 0, None, 0, 0, 0))(jx, jdt, jA, jB, jC, jh0)
    return np.asarray(y, np.float32), np.asarray(h)


@pytest.mark.parametrize("with_h0", (False, True), ids=("h0none", "h0"))
@pytest.mark.parametrize("dtype", tuple(DTYPES))
@pytest.mark.parametrize("case", SWEEP, ids=[f"S{c[0]}H{c[1]}P{c[2]}N{c[3]}"
                                             for c in SWEEP])
def test_ssd_matches_jax(case, dtype, with_h0):
    S, H, P, N, chunk = case
    (jx, jdt, jA, jB, jC, jh0), (x, dt, A, B, C, h0) = _both(
        _ssd_inputs(S, H, P, N, seed=S + H), dtype)
    if not with_h0:
        jh0 = h0 = None
    tol = DTYPES[dtype][2]
    want_seq = _jax_per_seq(jref.ssd_scan_ref, jx, jdt, jA, jB, jC, jh0)
    want_chk = _jax_per_seq(
        lambda *a: jref.ssd_chunked(*a, chunk=chunk), jx, jdt, jA, jB, jC, jh0)
    # the Pallas kernel, interpreted, on the first sequence
    pal = jssd_scan(jx[0], jdt[0], jA, jB[0], jC[0],
                    None if jh0 is None else jh0[0], chunk=chunk,
                    interpret=True)
    got_seq = ref.ssd_scan_ref(x, dt, A, B, C, h0)
    got_chk = ref.ssd_chunked(x, dt, A, B, C, h0, chunk=chunk)
    got_ops = ops.ssd(x, dt, A, B, C, h0)
    for got in (got_seq, got_chk, got_ops):
        assert got[0].dtype == x.dtype and got[1].dtype == torch.float32
    for name, got, want in (("oracle", got_seq, want_seq),
                            ("chunked", got_chk, want_chk),
                            ("ops.ssd", got_ops, want_seq)):
        _close(got[0], want[0], tol, f"{name} y")
        _close(got[1], want[1], tol, f"{name} h")
    _close(got_ops[0][0], pal[0], tol, "ops.ssd y vs Pallas")
    _close(got_ops[1][0], pal[1], tol, "ops.ssd h vs Pallas")


def test_ssd_chunk_invariance():
    """The chunk is an implementation detail (the kernel takes 64 where the
    plain version takes 128): results agree across chunks, and with the
    Pallas kernel at chunk 8."""
    (jx, jdt, jA, jB, jC, _), (x, dt, A, B, C, _) = _both(
        _ssd_inputs(64, 2, 16, 8, seed=7), "f32")
    pal = jssd_scan(jx[1], jdt[1], jA, jB[1], jC[1], chunk=8, interpret=True)
    outs = [ref.ssd_chunked(x, dt, A, B, C, chunk=c) for c in (8, 32, 64)]
    for y, h in outs:
        _close(y, outs[0][0], 1e-5, "y across chunks")
        _close(h, outs[0][1], 1e-5, "h across chunks")
        _close(y[1], pal[0], 1e-5, "y vs Pallas chunk 8")
        _close(h[1], pal[1], 1e-5, "h vs Pallas chunk 8")


def test_ssd_carries_initial_state():
    """A sequence split in two, the state carried across, equals the whole,
    and the carried second half equals the JAX one."""
    (jx, jdt, jA, jB, jC, _), (x, dt, A, B, C, _) = _both(
        _ssd_inputs(48, 2, 8, 8, seed=11), "f32")
    y_full, h_full = ops.ssd(x, dt, A, B, C)
    y1, h1 = ops.ssd(x[:, :24], dt[:, :24], A, B[:, :24], C[:, :24])
    y2, h2 = ops.ssd(x[:, 24:], dt[:, 24:], A, B[:, 24:], C[:, 24:], h0=h1)
    _close(torch.cat([y1, y2], 1), y_full, 1e-5, "split y")
    _close(h2, h_full, 1e-5, "split h")
    _, jh1 = jref.ssd_chunked(jx[0, :24], jdt[0, :24], jA, jB[0, :24],
                              jC[0, :24])
    jy2, jh2 = jref.ssd_chunked(jx[0, 24:], jdt[0, 24:], jA, jB[0, 24:],
                                jC[0, 24:], h0=jh1)
    _close(y2[0], jy2, 1e-5, "carried y vs JAX")
    _close(h2[0], jh2, 1e-5, "carried h vs JAX")


_JAX_ORACLE = {}


@pytest.mark.parametrize("with_h0", (False, True), ids=("h0none", "h0"))
@pytest.mark.parametrize("S", (65, 1000))
def test_ssd_tensor_core_ref_matches_jax(S, with_h0):
    """The ``ssd_scan`` kernel's tensor-core design (``ref.ssd_chunked_tc``:
    chunks of 64, G = C B^T once per sequence and chunk, W, X' and the
    state operand rounded to bf16) against JAX's sequential oracle, on
    bf16-representable float32 inputs at P and N multiples of 16, within
    the card's bf16 tolerance 2e-2 of max(1, max |JAX|)."""
    arrs = list(_ssd_inputs(S, 3, 16, 32, seed=S))
    for i in (0, 1, 3, 4):  # x, dt, B, C as the kernel sees them
        arrs[i] = np.asarray(torch.as_tensor(arrs[i]).bfloat16().float())
    if not with_h0:
        arrs[5] = np.zeros_like(arrs[5])
    (jx, jdt, jA, jB, jC, jh0), (x, dt, A, B, C, h0) = _both(arrs, "f32")
    if S not in _JAX_ORACLE:  # one compile per length, h0 given as zeros
        _JAX_ORACLE[S] = jax.jit(jax.vmap(jref.ssd_scan_ref,
                                          (0, 0, None, 0, 0, 0)))
    want = _JAX_ORACLE[S](jx, jdt, jA, jB, jC, jh0)
    got = ref.ssd_chunked_tc(x, dt, A, B, C, h0 if with_h0 else None)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.float32
    _close(got[0], want[0], 2e-2, "tensor-core ref y")
    _close(got[1], want[1], 2e-2, "tensor-core ref h")


def test_ssd_design_by_dtype_and_shape():
    """``ssd_scan.pick_design`` is a pure function of dtype and shape (needs
    no card): every ported SSM config at full width takes the tensor-core
    design in bfloat16 and the CUDA-core one in float32; the reduced
    configs' P = 8 takes the CUDA-core one; every shape is one the kernel
    takes."""
    seen = set()
    for arch in configs.ARCH_IDS:
        if arch in configs.NOT_PORTED or configs.get_config(arch).ssm is None:
            continue
        for cfg, full in ((configs.get_config(arch), True),
                          (configs.get_reduced(arch), False)):
            P, N = cfg.ssm.headdim, cfg.ssm.d_state
            assert P in ssd_scan.HEAD_DIMS and N in ssd_scan.STATE_DIMS
            assert ssd_scan.pick_design(torch.float32, P, N) == "cuda_core"
            want = "tensor_core" if full else "cuda_core"
            assert ssd_scan.pick_design(torch.bfloat16, P, N) == want, arch
            seen.add(arch)
    assert {"mamba2_1_3b", "hymba_1_5b"} <= seen, seen


# ------------------------------------------------------------- the block
def _configs(arch):
    """(JAX, port) reduced configs in float32 compute."""
    return (dataclasses.replace(jconfigs.get_reduced(arch),
                                compute_dtype=jnp.float32),
            dataclasses.replace(configs.get_reduced(arch),
                                compute_dtype=torch.float32))


_WEIGHTS = {}


def _weights(arch):
    """The JAX init_model weights of a reduced config (float32), cached."""
    if arch not in _WEIGHTS:
        jc, _ = _configs(arch)
        params, _ = jmodel.init_model(jc, jax.random.PRNGKey(4))
        _WEIGHTS[arch] = (params,
                          {k: np.asarray(v) for k, v in params.items()})
    return _WEIGHTS[arch]


@pytest.mark.parametrize("arch", ("mamba2_1_3b", "hymba_1_5b"))
def test_ssm_block_matches_jax(arch):
    """apply_ssm (prefill, with the state handoff) and two apply_ssm_decode
    steps on layer 0's SSM weights, float32."""
    jc, tc = _configs(arch)
    params, nparams = _weights(arch)
    jp = {k[len("layers/"):]: v[0] for k, v in params.items()
          if k.startswith("layers/ssm/")}
    tp = params_from_numpy(nparams, tc, "cpu").layers[0]
    rng = np.random.RandomState(2)
    u = rng.normal(size=(2, 13, jc.d_model)).astype(np.float32)
    jout, jst, jtail = jssm.apply_ssm(jp, "ssm", jc, jnp.asarray(u),
                                      return_state=True)
    out, st, tail = ssm.apply_ssm(tp, "ssm", tc, torch.as_tensor(u),
                                  return_state=True)
    for got, want, what in ((out, jout, "out"), (st, jst, "state"),
                            (tail, jtail, "conv tail")):
        _close(got, want, 1e-4, what)
    assert st.dtype == torch.float32 and tail.shape == jtail.shape
    jcache = dict(conv=jtail, state=jst)
    conv, state = tail.clone(), st.clone()
    for i in range(2):
        v = rng.normal(size=(2, 1, jc.d_model)).astype(np.float32)
        jy, jcache = jssm.apply_ssm_decode(jp, "ssm", jc, jnp.asarray(v),
                                           jcache)
        y = ssm.apply_ssm_decode(tp, "ssm", tc, torch.as_tensor(v), conv,
                                 state)
        _close(y, jy, 1e-4, f"decode {i} out")
        _close(conv, jcache["conv"], 1e-4, f"decode {i} conv window")
        _close(state, jcache["state"], 1e-4, f"decode {i} state")


def test_prefill_state_carries_the_bucket_padding():
    """The reference scans a short prompt's pad tokens into its SSM state
    and conv window (its prefill runs the whole padded bucket): the same
    5-token prompt alone (bucket 8) and beside a 12-token one (bucket 16)
    leaves different states, and the port leaves the reference's in both."""
    jc, tc = _configs("mamba2_1_3b")
    params, nparams = _weights("mamba2_1_3b")
    port = params_from_numpy(nparams, tc, "cpu")
    rng = np.random.RandomState(6)
    short = rng.randint(3, jc.vocab, 5)
    long_ = rng.randint(3, jc.vocab, 12)
    states = []
    for prompts in ([short], [short, long_]):
        Lp = _bucket(max(len(p) for p in prompts))
        toks = np.zeros((len(prompts), Lp), np.int32)
        for i, p in enumerate(prompts):
            toks[i, :len(p)] = p
        last = np.array([len(p) - 1 for p in prompts])
        jlg, jcache = jmodel.prefill(params, jc, jnp.asarray(toks),
                                     max_len=32,
                                     last_positions=jnp.asarray(last))
        lg, cache = model.prefill(port, tc, torch.as_tensor(toks).long(),
                                  max_len=32,
                                  last_positions=torch.as_tensor(last))
        _close(lg[:, :jc.vocab], np.asarray(jlg)[:, :jc.vocab], 1e-4,
               f"logits, bucket {Lp}")
        for k in ("ssm_state", "ssm_conv"):
            _close(cache[k], jcache[k], 1e-4, f"{k}, bucket {Lp}")
        states.append(cache["ssm_state"][:, 0])
    gap = float((states[0] - states[1]).abs().max())
    assert gap > 1e-2 * float(states[0].abs().max()), gap


# ------------------------------------------------------------ the server
SERVE_LENGTHS = (9, 12, 16, 5, 14, 11, 10)   # one bucket of 16, then reuse
SERVE_NEW = (5, 3, 6, 4, 2, 5, 3)


@pytest.mark.parametrize("arch", ("mamba2_1_3b", "hymba_1_5b"))
def test_server_matches_jax(arch):
    """Ragged prompts within one bucket (the state scans their padding),
    more requests than slots (slot reuse): per request tokens, completion
    order and epochs equal the JAX EpochServer's, float32 compute."""
    jc, tc = _configs(arch)
    params, nparams = _weights(arch)
    assert {_bucket(n) for n in SERVE_LENGTHS[:3]} == {16}
    rng = np.random.RandomState(8)
    prompts = [rng.randint(3, jc.vocab, n).astype(np.int32)
               for n in SERVE_LENGTHS]
    js = JServer(jc, params, n_slots=3, max_len=32)
    ts = EpochServer(tc, nparams, n_slots=3, max_len=32, device="cpu")
    for p, m in zip(prompts, SERVE_NEW):
        js.submit(JRequest(prompt=p, max_new_tokens=m))
        ts.submit(Request(prompt=p, max_new_tokens=m))
    js.run_to_completion()
    ts.run_to_completion()
    assert [r.rid for r in ts.completed] == [r.rid for r in js.completed]
    for a, b in zip(ts.completed, js.completed):
        assert a.output == b.output, a.rid
        assert len(a.output) == SERVE_NEW[a.rid]
    assert ts.epochs == js.epochs
    for k in ("ssm_state", "ssm_conv"):
        _close(ts.cache[k], js.cache[k], 1e-4, k)


# ----------------------------------------------------------- conversion
def test_convert_carries_the_ssm_keys():
    """params_from_numpy stores matmul weights and conv_w in the compute
    dtype and a_log, dt_bias, d_skip in float32; cache_from_numpy carries a
    hybrid cache's k, v, ssm_conv and ssm_state with the port's dtypes and
    shapes."""
    jc = jconfigs.get_reduced("hymba_1_5b")
    tc = configs.get_reduced("hymba_1_5b")
    params, _ = jmodel.init_model(jc, jax.random.PRNGKey(0))
    port = params_from_numpy({k: np.asarray(v) for k, v in params.items()},
                             tc, "cpu")
    lyr = port.layers[1]
    for name in ("ssm/w_in_zx", "ssm/w_in_bc", "ssm/w_in_dt", "ssm/conv_w",
                 "ssm/w_out", "attn/wq"):
        assert lyr[name].dtype == torch.bfloat16, name
        want = np.asarray(params[f"layers/{name}"][1].astype(jnp.bfloat16),
                          np.float32)
        np.testing.assert_array_equal(lyr[name].float().numpy(), want)
    for name in ("ssm/a_log", "ssm/dt_bias", "ssm/d_skip"):
        assert lyr[name].dtype == torch.float32, name
        np.testing.assert_array_equal(lyr[name].numpy(),
                                      np.asarray(params[f"layers/{name}"][1]))
    jcache = jmodel.init_cache(jc, 3, 24)
    rng = np.random.RandomState(1)
    cnp = {k: (rng.normal(size=v.shape).astype(np.float32) if k != "lengths"
               else np.array([1, 5, 9], np.int32))
           for k, v in jcache.items()}
    cache = cache_from_numpy(cnp, tc, "cpu")
    mine = model.init_cache(tc, 3, 24, device="cpu")
    assert cache.keys() == mine.keys() == set(jcache)
    for k, v in cache.items():
        assert v.dtype == mine[k].dtype and v.shape == mine[k].shape, k
    np.testing.assert_array_equal(cache["ssm_state"].numpy(),
                                  cnp["ssm_state"])
    assert mine["ssm_state"].dtype == torch.float32
    assert mine["ssm_conv"].dtype == tc.compute_dtype
