"""The port's training path against the JAX reference, on the CPU.

Reduced granite-3-8b (dense) and granite-moe-1b-a400m (MoE, its aux loss
in the total) with float32 compute, the JAX parameters carried across
(``params_from_numpy(..., trainable=True)``) and the JAX optimiser state
too (``opt_state_from_numpy``):

- ``chunked_xent`` (a chunk that does not divide S, labels of -1) and
  ``loss_fn`` (the loss and every metric): within 1e-5 of max(1, |JAX|);
- the gradient of ``loss_fn`` against ``jax.grad``: every parameter
  within ``GRAD_TOL`` (1e-4, the MoE 1e-3) of that parameter's largest
  |JAX gradient| (the sums run in other orders);
- three steps of the port's ``make_train_step`` against the step function
  of the reference's ``build`` (its reduced config made float32 here, as
  the port's): every metric each step within ``STEP_TOL`` (1e-4, the MoE
  2e-3) of max(1, |JAX|), and
  every parameter and both moments after step 3 within ``STATE_TOL``
  (1e-3, the MoE 3e-3) of that tensor's largest |JAX value| (the
  constants say why);
- ``cfg.remat`` "full", "dots" and "none" give the port the same
  gradients, bit for bit (recomputation repeats the same operations).

The JAX side runs as its own tests run it on the CPU (``impl="ref"``, the
platform default there); its runs are cached per module.
"""
from __future__ import annotations

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import numpy as np

from _torch_threads import one_torch_thread  # noqa: F401
from repro import configs as jconfigs
from repro.launch import train as jtrain
from repro.models import model as jmodel
from repro_torch import configs
from repro_torch.core.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.data import SyntheticLM, place_batch
from repro_torch.launch import train
from repro_torch.models import model

ARCHS = ("granite_3_8b", "granite_moe_1b_a400m")
BATCH, SEQ, STEPS, LR = 2, 24, 3, 3e-3
XENT_CHUNK = 16  # does not divide SEQ: the last chunk is padded with -1
METRICS = ("loss", "xent", "aux", "n_tokens", "grad_norm", "lr")
VALUE_TOL = 1e-5   # chunked_xent and loss_fn on one batch: of max(1, |JAX|)
# each step's metrics: of max(1, |JAX|).  The MoE's gradient norm at step
# 2 moves by 2.3e-4 of itself under a relative 1e-6 perturbation of the
# JAX run's own parameters (the port's differs by 4.5e-4).
STEP_TOL = {"granite_3_8b": 1e-4, "granite_moe_1b_a400m": 2e-3}
# gradients: of the tensor's max |JAX gradient|.  The reduced MoE, at the
# reference's init scale (std n_layers ** -0.5 = 0.71), amplifies float32
# rounding about tenfold (measured 1.9e-4; granite 3.3e-5).
GRAD_TOL = {"granite_3_8b": 1e-4, "granite_moe_1b_a400m": 1e-3}
# parameters and moments after step 3: of the tensor's max |JAX value|.
# The trajectory amplifies any difference of its start: a relative 1e-6
# perturbation of the JAX run's own parameters moves its step-3 moments by
# up to 1.4e-3 (granite) and 3.9e-3 (MoE) of their largest values; the
# port's measured 3.3e-4 and 1.0e-3.
STATE_TOL = {"granite_3_8b": 1e-3, "granite_moe_1b_a400m": 3e-3}


def _f32(get, dtype):
    """A config getter whose configs compute in float32."""
    def f32(arch):
        return dataclasses.replace(get(arch), compute_dtype=dtype)
    return f32


def _cfgs(arch):
    return (_f32(jconfigs.get_reduced, jnp.float32)(arch),
            _f32(configs.get_reduced, torch.float32)(arch))


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    jc, _ = _cfgs(arch)
    params, _ = jmodel.init_model(jc, jax.random.PRNGKey(0))
    return {k: np.asarray(v) for k, v in params.items()}


def _batch(arch):
    jc, _ = _cfgs(arch)
    b = SyntheticLM(jc.vocab, SEQ, BATCH, seed=0).batch_at(0)
    b["labels"][0, :5] = -1  # ignored positions inside a chunk
    return b


def _port_model(arch):
    _, tc = _cfgs(arch)
    return tc, params_from_numpy(_jax_params(arch), tc, "cpu",
                                 trainable=True)


def _stacked(named, layered_slices=False):
    """``(name, tensor)`` pairs in the reference's stacked layout: the
    layers of ``{name}[i]`` stacked (concatenated where each is already a
    ``(1, ...)`` slice)."""
    parts = {}
    for name, t in named:
        parts.setdefault(name.split("[")[0], []).append(
            (t.detach().numpy(), "[" in name))
    join = np.concatenate if layered_slices else np.stack
    return {k: join([a for a, _ in v]) if v[0][1] else v[0][0]
            for k, v in parts.items()}


def _close(got, want, tol, what, value=False):
    """max |got - want| within ``tol`` of max |want| (of max(1, |want|)
    for a ``value``)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) if want.size else 0.0
    scale = max(1.0, scale) if value else max(scale, 1e-30)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol * scale, f"{what}: max |port - JAX| {err} > " \
        f"{tol} * {scale}"


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grad(arch):
    jc, _ = _cfgs(arch)
    batch = {k: jnp.asarray(v) for k, v in _batch(arch).items()}

    def f(p):
        return jmodel.loss_fn(p, jc, batch)

    (loss, metrics), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        {k: jnp.asarray(v) for k, v in _jax_params(arch).items()})
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            {k: np.asarray(v) for k, v in grads.items()})


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_xent_matches_jax(arch):
    jc, tc = _cfgs(arch)
    rng = np.random.RandomState(1)
    hidden = rng.standard_normal((BATCH, SEQ, jc.d_model)).astype(np.float32)
    labels = _batch(arch)["labels"]
    labels[1, -3:] = -1
    jl, jn = jmodel.chunked_xent(
        {k: jnp.asarray(v) for k, v in _jax_params(arch).items()}, jc,
        jnp.asarray(hidden), jnp.asarray(labels), chunk=XENT_CHUNK)
    _, m = _port_model(arch)
    tl, tn = model.chunked_xent(m, tc, torch.as_tensor(hidden),
                                torch.as_tensor(labels), chunk=XENT_CHUNK)
    _close(tl.item(), float(jl), VALUE_TOL, "xent", value=True)
    assert tn.item() == float(jn) == int((labels >= 0).sum())


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_jax(arch):
    loss, metrics, _ = _jax_loss_and_grad(arch)
    tc, m = _port_model(arch)
    batch = place_batch(_batch(arch), "cpu")
    with torch.no_grad():
        tl, tm = model.loss_fn(m, tc, batch)
    _close(tl.item(), loss, VALUE_TOL, "loss", value=True)
    assert set(tm) == set(metrics)
    for k in metrics:
        _close(tm[k].item(), metrics[k], VALUE_TOL, k, value=True)
    if tc.moe is not None:
        assert tm["aux"].item() > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_grad_matches_jax(arch):
    _, _, grads = _jax_loss_and_grad(arch)
    tc, m = _port_model(arch)
    loss, _ = model.loss_fn(m, tc, place_batch(_batch(arch), "cpu"))
    leaves = m.named_leaves()
    got = torch.autograd.grad(loss, [p for _, p, _ in leaves])
    stacked = _stacked((n, g) for (n, _, _), g in zip(leaves, got))
    assert set(stacked) == set(grads)
    for k, g in stacked.items():
        _close(g, grads[k], GRAD_TOL[arch], f"grad {k}")


@functools.lru_cache(maxsize=None)
def _jax_steps(arch):
    """The reference's ``build`` with its reduced config in float32: the
    metrics of each of three steps, and the parameters and moments after
    the third."""
    orig = jtrain.configs.get_reduced
    jtrain.configs.get_reduced = _f32(orig, jnp.float32)
    try:
        cfg, params, opt_state, step_fn, data, _ = jtrain.build(
            arch, reduced=True, batch=BATCH, seq=SEQ, steps=STEPS, lr=LR,
            seed=0)
    finally:
        jtrain.configs.get_reduced = orig
    params = {k: jnp.asarray(v) for k, v in _jax_params(arch).items()}
    start = {"m": {k: np.asarray(v) for k, v in opt_state.m.items()},
             "v": {k: np.asarray(v) for k, v in opt_state.v.items()},
             "step": int(opt_state.step), "master": {}}
    metrics = []
    for s in range(STEPS):
        params, opt_state, mt = step_fn(params, opt_state, data.batch_at(s))
        metrics.append({k: float(v) for k, v in mt.items()})
    return start, metrics, {k: np.asarray(v) for k, v in params.items()}, (
        {k: np.asarray(v) for k, v in opt_state.m.items()},
        {k: np.asarray(v) for k, v in opt_state.v.items()})


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_jax(arch, monkeypatch):
    start, jmetrics, jparams, (jm, jv) = _jax_steps(arch)
    monkeypatch.setattr(train.configs, "get_reduced",
                        _f32(configs.get_reduced, torch.float32))
    cfg, _, _, step_fn, data, mesh = train.build(
        arch, reduced=True, batch=BATCH, seq=SEQ, steps=STEPS, lr=LR,
        seed=0, device="cpu")
    assert mesh is None and cfg.compute_dtype == torch.float32
    _, m = _port_model(arch)
    state = opt_state_from_numpy(start, m, "cpu")
    for s in range(STEPS):
        batch = place_batch(data.batch_at(s), "cpu")
        m, state, mt = step_fn(m, state, batch)
        assert set(mt) == set(METRICS) == set(jmetrics[s])
        for k in METRICS:
            _close(mt[k].item(), jmetrics[s][k], STEP_TOL[arch],
                   f"step {s + 1} {k}", value=True)
    assert int(state.step) == STEPS
    got = _stacked((n, p) for n, p, _ in m.named_leaves())
    assert set(got) == set(jparams)
    for k, want in jparams.items():
        _close(got[k], want, STATE_TOL[arch],
               f"param {k} after step {STEPS}")
    for what, moments, jmom in (("m", state.m, jm), ("v", state.v, jv)):
        got = _stacked(moments.items(), layered_slices=True)
        assert set(got) == set(jmom)
        for k, want in jmom.items():
            _close(got[k], want, STATE_TOL[arch],
                   f"{what} {k} after step {STEPS}")


@functools.lru_cache(maxsize=None)
def _remat_grads(remat):
    arch = ARCHS[0]
    _, tc = _cfgs(arch)
    tc = dataclasses.replace(tc, remat=remat)
    m = params_from_numpy(_jax_params(arch), tc, "cpu", trainable=True)
    loss, _ = model.loss_fn(m, tc, place_batch(_batch(arch), "cpu"))
    return torch.autograd.grad(loss, [p for _, p, _ in m.named_leaves()])


@pytest.mark.parametrize("remat", ("full", "dots"))
def test_remat_gives_the_same_gradients(remat):
    plain = _remat_grads("none")
    got = _remat_grads(remat)
    assert len(got) == len(plain)
    for g, want in zip(got, plain):
        assert torch.equal(g, want)
