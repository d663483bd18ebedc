"""The port's model stack against the JAX reference, on the same weights.

Each architecture's reduced config is initialised by the JAX ``init_model``;
its numpy weights go through ``core.convert.params_from_numpy`` into the
port.  ``forward`` hidden states, ``prefill`` logits, cache and lengths
over ragged prompts, and three ``decode_step`` logits are compared.  In
float32 compute: max |port - JAX| <= 1e-4 * max |JAX| (sums in another
order).  In bfloat16 compute: ||port - JAX||_2 <= 2e-2 * ||JAX||_2 (XLA and
torch round bf16 at other places, so single elements can differ by a few
bf16 ulps).  Logits are compared over the real vocabulary; the padded
entries must be -1e30 in both.  Granite and mamba2 (the SSM block) run in
both dtypes; yi (with its heads padded for a tensor-parallel degree of 8),
command-r (parallel block), chameleon (QK-norm) and hymba (attention ∥ SSM,
sliding windows) in float32, where the check is tightest.  The caches
compared are the block's: K/V for attention, the SSM state and conv window
for the SSM.  The JAX runs are cached per architecture.  ``model_runs`` and
the ``check_*`` helpers also hold the MoE architectures
(``test_torch_moe.py``) and the encoder-decoder one, with its ``enc_out``
and cross-attention cache (``test_torch_encdec.py``), to the reference.
"""
from __future__ import annotations

import dataclasses

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import numpy as np

from _torch_threads import one_torch_thread  # noqa: F401
from repro import configs as jconfigs
from repro.models import model as jmodel
from repro.models.common import finalize as jfinalize
from repro_torch import configs
from repro_torch.core.convert import cache_from_numpy, params_from_numpy
from repro_torch.models import model, ssm
from repro_torch.models.common import finalize

MAX_LEN = 32
LAST = (7, 11)  # ragged prompts: lengths 8 and 12 in a bucket of 12
N_DECODE = 3


def _configs(name):
    """(JAX config, port config) for a test architecture."""
    arch, _, variant = name.partition(":")
    jc, tc = jconfigs.get_reduced(arch), configs.get_reduced(arch)
    if variant.startswith("f32"):
        jc = dataclasses.replace(jc, compute_dtype=jnp.float32)
        tc = dataclasses.replace(tc, compute_dtype=torch.float32)
    if variant.endswith("pad8"):  # heads padded for tensor-parallel degree 8
        jc, tc = jfinalize(jc, 8), finalize(tc, 8)
    return jc, tc


ARCHS = ("granite_3_8b:f32", "granite_3_8b:bf16", "yi_34b:f32pad8",
         "command_r_35b:f32", "chameleon_34b:f32", "mamba2_1_3b:f32",
         "mamba2_1_3b:bf16", "hymba_1_5b:f32")


def model_runs(jc, tc, frames=None):
    """Both implementations' outputs on one (JAX, port) config pair: the
    hidden states and aux loss of ``forward``, the logits and cache of a
    ragged ``prefill`` (``frames``: an encoder-decoder model's encoder
    input, numpy (2, T_enc, d)) and three ``decode_step`` logits from the
    JAX cache, fed the JAX argmax tokens."""
    params, _ = jmodel.init_model(jc, jax.random.PRNGKey(3))
    port = params_from_numpy({k: np.asarray(v) for k, v in params.items()},
                             tc, "cpu")
    rng = np.random.RandomState(5)
    toks = rng.randint(3, jc.vocab, size=(2, 12)).astype(np.int32)
    ttoks = torch.as_tensor(toks).long()
    jf = tf = None
    if frames is not None:
        jf, tf = jnp.asarray(frames), torch.as_tensor(frames)
    out = {"f32": tc.compute_dtype == torch.float32, "vocab": jc.vocab,
           "jax": {}, "port": {}}
    j, t = out["jax"], out["port"]
    j["hidden"], j["aux"] = jmodel.forward(params, jc, jnp.asarray(toks),
                                           enc_frames=jf, remat=False)
    t["hidden"], t["aux"] = model.forward(port, tc, ttoks, enc_frames=tf)
    lp = np.asarray(LAST)
    lg, cache = jmodel.prefill(params, jc, jnp.asarray(toks), max_len=MAX_LEN,
                               enc_frames=jf, last_positions=jnp.asarray(lp))
    tlg, tcache = model.prefill(port, tc, ttoks, max_len=MAX_LEN,
                                enc_frames=tf,
                                last_positions=torch.as_tensor(lp))
    j["prefill"], t["prefill"] = lg, tlg
    j["cache"] = {k: np.asarray(v, np.float32) if k != "lengths"
                  else np.asarray(v) for k, v in cache.items()}
    t["cache"] = {k: v.float().numpy() if k != "lengths" else v.numpy()
                  for k, v in tcache.items()}
    # decode from the JAX cache in both, fed the JAX argmax tokens
    tcache = cache_from_numpy(j["cache"], tc, "cpu")
    for i in range(N_DECODE):
        nxt = np.asarray(jnp.argmax(lg, -1))[:, None].astype(np.int32)
        lg, cache = jmodel.decode_step(params, jc, jnp.asarray(nxt), cache)
        tlg, tcache = model.decode_step(port, tc, torch.as_tensor(nxt).long(),
                                        tcache)
        j[f"decode{i}"], t[f"decode{i}"] = lg, tlg
    j["lengths"] = np.asarray(cache["lengths"])
    t["lengths"] = tcache["lengths"].numpy()
    return out


@pytest.fixture(scope="module", params=ARCHS)
def runs(request):
    """Both implementations' outputs on one architecture."""
    return model_runs(*_configs(request.param))


def _close(runs, got, want, what, logits=False):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    if logits:  # padded vocabulary entries are masked in both
        v = runs["vocab"]
        np.testing.assert_array_equal(got[..., v:], want[..., v:])
        got, want = got[..., :v], want[..., :v]
    assert np.all(np.isfinite(got)), what
    if runs["f32"]:
        err = float(np.abs(got - want).max())
        assert err <= 1e-4 * float(np.abs(want).max()), (what, err)
    else:
        err = float(np.linalg.norm(got - want))
        assert err <= 2e-2 * float(np.linalg.norm(want)), (what, err)


# the checks on a model_runs result, shared with the MoE and
# encoder-decoder test modules
def check_forward(runs):
    _close(runs, runs["port"]["hidden"], runs["jax"]["hidden"], "hidden")
    _close(runs, runs["port"]["aux"], runs["jax"]["aux"], "aux loss")


def check_prefill(runs):
    j, t = runs["jax"], runs["port"]
    _close(runs, t["prefill"], j["prefill"], "logits", logits=True)
    np.testing.assert_array_equal(t["cache"]["lengths"],
                                  j["cache"]["lengths"])
    np.testing.assert_array_equal(t["cache"]["lengths"], np.add(LAST, 1))
    assert t["cache"].keys() == j["cache"].keys()
    for k in ("k", "v", "ssm_state", "ssm_conv", "enc_out", "cross_k",
              "cross_v"):
        if k not in j["cache"]:
            continue
        _close(runs, t["cache"][k], j["cache"][k], k)
        if k in ("k", "v"):  # rows past the prompt bucket are zero in both
            assert not t["cache"][k][..., 12:, :].any()


def check_decode(runs, i):
    _close(runs, runs["port"][f"decode{i}"], runs["jax"][f"decode{i}"],
           f"decode {i}", logits=True)


def check_lengths(runs):
    np.testing.assert_array_equal(runs["port"]["lengths"],
                                  runs["jax"]["lengths"])


def test_forward_hidden_matches_jax(runs):
    check_forward(runs)


def test_prefill_matches_jax(runs):
    check_prefill(runs)


@pytest.mark.parametrize("i", range(N_DECODE))
def test_decode_step_matches_jax(runs, i):
    check_decode(runs, i)


def test_decode_lengths_advance(runs):
    check_lengths(runs)


@pytest.mark.parametrize("arch", ("whisper_large_v3", "granite_moe_1b_a400m",
                                  "llama4_scout_17b_a16e"))
def test_unported_architectures_raise(arch):
    """The MoE and encoder-decoder architectures load, full and reduced,
    and equal the reference's configs field by field (this test asked
    for ``NotImplementedError`` while their model code was missing)."""
    _same_config(arch)


def _same_config(arch):
    for get, jget in ((configs.get_config, jconfigs.get_config),
                      (configs.get_reduced, jconfigs.get_reduced)):
        tc, jc = get(arch), jget(arch)
        for f in dataclasses.fields(tc):
            if f.name in ("param_dtype", "compute_dtype"):
                continue
            got, want = getattr(tc, f.name), getattr(jc, f.name)
            if f.name in ("ssm", "moe") and want is not None:  # two classes
                got, want = (dataclasses.asdict(got),
                             dataclasses.asdict(want))
            assert got == want, (arch, f.name)
        assert tc.n_params() == jc.n_params()
        assert tc.vocab_padded == jc.vocab_padded


def test_configs_match_the_reference():
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    for arch in configs.ARCH_IDS:
        _same_config(arch)
    assert set(configs.SHAPES) == set(jconfigs.SHAPES)
    cfg = configs.get_config("granite_3_8b")
    for s in configs.SHAPES.values():
        assert configs.skip_reason(cfg, s) == jconfigs.skip_reason(
            jconfigs.get_config("granite_3_8b"), jconfigs.SHAPES[s.name])


# the model and cache builders called with no device, as a user calls them
NO_DEVICE = {
    "init_model": lambda cfg: model.init_model(cfg, seed=0),
    "init_cache": lambda cfg: model.init_cache(cfg, 2, 8),
    "init_ssm_cache": lambda cfg: ssm.init_ssm_cache(cfg, 2, torch.float32),
}


@pytest.mark.parametrize("entry", sorted(NO_DEVICE))
def test_builders_default_to_cuda(entry):
    """With no device the builders take CUDA, as every other entry point
    does, and raise where it is absent: nothing falls back to the CPU."""
    cfg = configs.get_reduced("hymba_1_5b")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            NO_DEVICE[entry](cfg)
        return
    built = NO_DEVICE[entry](cfg)
    tensors = ([built["embed/tok_embed"]] if entry == "init_model"
               else list(built.values()))
    assert all(t.device.type == "cuda" for t in tensors)


def test_init_model_follows_the_reference_rule():
    cfg = configs.get_reduced("granite_3_8b")
    m = model.init_model(cfg, seed=0, device="cpu")
    wq = torch.stack([p["attn/wq"] for p in m.layers]).float()
    assert wq.dtype == torch.float32 and m.layers[0]["attn/wq"].dtype == \
        torch.bfloat16
    assert abs(float(wq.std()) - cfg.n_layers ** -0.5) < 0.05
    assert abs(float(m["embed/tok_embed"].float().std()) - 0.02) < 0.002
    assert m["final_norm/scale"].dtype == torch.float32
    assert m.layers[0]["norm1/scale"].dtype == torch.float32
    again = model.init_model(cfg, seed=0, device="cpu")
    assert torch.equal(again.layers[1]["mlp/w_up"], m.layers[1]["mlp/w_up"])
