"""The port's MoE layer, MoE models and MoE serving against the JAX
reference, on the same weights (the JAX ``init_model`` dict through
``params_from_numpy``), on the CPU.

- The layer (``models/moe.py``) on the reduced granite-moe (4 experts
  top-2) and llama4-scout (4 experts top-1 plus a shared expert) configs,
  float32 and bfloat16, under both dispatches (``"sort"``, ``"cumsum"``):
  the experts and renormalised gates (from the reference's ``top_k``,
  taken by a stand-in for ``jax.lax`` inside the reference's module and
  returned from its jitted run), the counts, the kept/dropped mask (the
  reference's ``keep``, taken the same way), the aux loss and the
  output.  Each entry's position is
  also held to a plain count over the flattened ``(token, k)`` order.
  One case overflows: B = 2 x S = 128 at capacity factor 0.5, where
  entries must be dropped.  Tolerances: ``test_torch_models._close``'s
  (float32 max |err| <= 1e-4 * max |JAX|; bfloat16 L2 <= 2e-2).
- The whole model in float32: ``forward`` (hidden states, the aux loss
  summed over the layers), ragged ``prefill`` and three ``decode_step`` s,
  through ``test_torch_models``'s helpers.  Not in bfloat16: there the
  port's layer equals the reference's run op by op bit for bit, but the
  reference's compiled layer scan rounds bf16 at other places, and a
  router near-tie then sends a token to another expert (a discrete jump
  past any bf16 tolerance).
- The server: float32 granite-moe against the JAX ``EpochServer`` with
  slot reuse and ragged buckets (tokens, completion order, epochs).
- Bucket-mates: the reference ranks expert positions over the whole
  right-padded prefill bucket, so when a bucket overflows a request's
  tokens depend on the requests prefilled beside it; both servers show it
  alike.
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
from test_torch_models import (
    N_DECODE,
    _close,
    _configs,
    check_decode,
    check_forward,
    check_lengths,
    check_prefill,
    model_runs,
)
from test_torch_serving import _prompts, _same, _serve

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.serving import EpochServer as JServer
from repro.serving import Request as JRequest
from repro_torch.core.convert import params_from_numpy
from repro_torch.models import moe
from repro_torch.serving import EpochServer, Request

MOE_ARCHS = ("granite_moe_1b_a400m", "llama4_scout_17b_a16e")


def _moe_configs(name, dispatch="sort", capacity_factor=1.25):
    jc, tc = _configs(name)
    return tuple(dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, dispatch=dispatch, capacity_factor=capacity_factor))
        for c in (jc, tc))


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """(JAX params, numpy params) of a reduced config, seed 3 (float32
    parameters whatever the compute dtype)."""
    params, _ = jmodel.init_model(jconfigs.get_reduced(arch),
                                  jax.random.PRNGKey(3))
    return params, {k: np.asarray(v) for k, v in params.items()}


class _Stand:
    """A stand-in for a module inside the reference's ``moe.py``: every
    attribute is the module's, but those in ``subs``."""

    def __init__(self, mod, **subs):
        self._mod, self._subs = mod, subs

    def __getattr__(self, name):
        return self._subs[name] if name in self._subs else \
            getattr(self._mod, name)


def _jax_moe(p, cfg, x):
    """The reference's ``apply_moe`` on x, jitted, with what it routed:
    (out, aux, top-k values, top-k experts, keep mask), as numpy."""
    seen = {}

    def top_k(a, k):
        seen["top_k"] = jax.lax.top_k(a, k)
        return seen["top_k"]

    def where(cond, *a):
        if "keep" not in seen:  # its first: slot = where(keep, ...)
            seen["keep"] = cond
        return jnp.where(cond, *a)

    def routed(p, x):
        y, aux = jmoe.apply_moe(p, "moe", cfg, x)
        return y, aux, seen["top_k"], seen["keep"]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmoe, "jax", _Stand(jax, lax=_Stand(jax.lax, top_k=top_k)))
        mp.setattr(jmoe, "jnp", _Stand(jnp, where=where))
        y, aux, (vals, idx), keep = jax.jit(routed)(p, x)
    return y, aux, np.asarray(vals), np.asarray(idx), np.asarray(keep)


def _plain_positions(flat_e):
    """Each entry's rank among the earlier entries of its expert."""
    seen, out = {}, []
    for e in flat_e.tolist():
        out.append(seen.get(e, 0))
        seen[e] = out[-1] + 1
    return np.asarray(out)


# arch:dtype, dispatch, capacity factor
LAYER = [(f"{a}:{dt}", disp, 1.25) for a in MOE_ARCHS
         for dt in ("f32", "bf16") for disp in ("sort", "cumsum")]
OVERFLOW = [("granite_moe_1b_a400m:f32", disp, 0.5)
            for disp in ("sort", "cumsum")]


@pytest.mark.parametrize("case", LAYER + OVERFLOW,
                         ids=[f"{c[0]}-{c[1]}-cf{c[2]}"
                              for c in LAYER + OVERFLOW])
def test_moe_layer_matches_jax(case):
    name, dispatch, cf = case
    jc, tc = _moe_configs(name, dispatch, cf)
    jparams, nparams = _weights(name.partition(":")[0])
    jp = {k[len("layers/"):]: v[0] for k, v in jparams.items()
          if k.startswith("layers/")}
    tp = params_from_numpy(nparams, tc, "cpu").layers[0]
    x = np.random.RandomState(0).normal(size=(2, 128, tc.d_model))
    jx = jnp.asarray(x, jnp.float32).astype(jc.compute_dtype)
    tx = torch.as_tensor(x, dtype=torch.float32).to(tc.compute_dtype)
    jy, jaux, jvals, jexp, jkeep = _jax_moe(jp, jc, jx)

    T, E = 2 * 128, tc.moe.n_experts
    probs, gates, experts = moe.route(tp, "moe", tc, tx.reshape(T, -1))
    flat = experts.reshape(-1)
    counts = moe.expert_counts(flat, E)
    pos = moe.positions(tc, flat, counts)
    keep = pos < moe._capacity(tc, T)
    ty, taux = moe.apply_moe(tp, "moe", tc, tx)

    np.testing.assert_array_equal(experts.numpy(), jexp)
    want_g = jvals / np.maximum(jvals.sum(-1, keepdims=True), 1e-9)
    runs = {"f32": tc.compute_dtype == torch.float32}
    _close(runs, gates, want_g, "gates")
    np.testing.assert_array_equal(
        counts.numpy(), np.bincount(jexp.reshape(-1), minlength=E))
    np.testing.assert_array_equal(pos.numpy(),
                                  _plain_positions(jexp.reshape(-1)))
    np.testing.assert_array_equal(keep.numpy(), jkeep.reshape(-1))
    if cf < 1:
        assert not jkeep.all(), "the overflowing case dropped nothing"
    _close(runs, taux, jaux, "aux loss")
    _close(runs, ty, jy, "moe output")


@pytest.fixture(scope="module", params=[f"{a}:f32" for a in MOE_ARCHS])
def runs(request):
    """Both implementations' outputs on one MoE architecture."""
    return model_runs(*_configs(request.param))


def test_forward_hidden_matches_jax(runs):
    check_forward(runs)
    assert float(runs["port"]["aux"]) > 0  # summed over the MoE layers


def test_prefill_matches_jax(runs):
    check_prefill(runs)


@pytest.mark.parametrize("i", range(N_DECODE))
def test_decode_step_matches_jax(runs, i):
    check_decode(runs, i)


def test_decode_lengths_advance(runs):
    check_lengths(runs)


SERVE = "granite_moe_1b_a400m"


def test_server_matches_jax():
    lengths = (3, 9, 17, 30, 5)  # buckets 8, 16, 32; slots reused
    specs = [(p, m, None) for p, m in zip(_prompts(lengths, 0),
                                          (6, 3, 5, 4, 7))]
    js, ts = _serve(_weights(SERVE), specs, n_slots=2, max_len=48,
                    cfgs=_moe_configs(SERVE + ":f32"))
    assert len(ts.completed) == len(specs)
    _same(js, ts)


def test_bucket_mates_change_a_request():
    """A request prefilled alone, then again with three others in one
    bucket of 64 at capacity factor 0.5: the bucket overflows the experts'
    buffers (C = 128 rows for 512 entries), the last request's entries
    come last in the ranking and are dropped first, so its tokens differ
    from those it got alone.  Both servers agree in each run."""
    jcfg, tcfg = _moe_configs(SERVE + ":f32", capacity_factor=0.5)
    jparams, nparams = _weights(SERVE)
    js = JServer(jcfg, jparams, n_slots=4, max_len=80)
    ts = EpochServer(tcfg, nparams, n_slots=4, max_len=80, device="cpu")
    prompts = _prompts((50, 61, 40, 57), 4)
    for wave in ([prompts[-1]], prompts):
        for srv, req in ((js, JRequest), (ts, Request)):
            for p in wave:
                srv.submit(req(prompt=p, max_new_tokens=8))
            srv.run_to_completion()
    _same(js, ts)
    alone, mates = (ts.completed[0].output,
                    next(r.output for r in ts.completed if r.rid == 4))
    assert alone != mates
