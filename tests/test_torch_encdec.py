"""The port's encoder-decoder path against the JAX reference, on whisper's
reduced config in float32 compute, on the same weights (the JAX
``init_model`` dict through ``params_from_numpy``), on the CPU.

- ``encode`` over a frame input and ``build_cross_cache`` over its output.
- ``forward(enc_frames=)``, ragged ``prefill`` (the whole cache, its
  ``enc_out``, ``cross_k`` and ``cross_v`` included) and three
  ``decode_step`` s from the JAX cache (``cache_from_numpy`` carrying the
  cross entries), through ``test_torch_models``'s helpers.
- The server: the port's ``EpochServer(enc_frames=)`` against the JAX one
  (one frame input shared by every slot; slot reuse, ragged buckets):
  tokens, completion order, epochs, and the cross entries it built.
- ``launch.serve`` on the architecture, on the CPU.

Tolerances: ``test_torch_models._close``'s float32 check, max |port -
JAX| <= 1e-4 * max |JAX|.
"""
from __future__ import annotations

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

from repro.models import model as jmodel
from repro_torch.core.convert import params_from_numpy
from repro_torch.models import model

NAME = "whisper_large_v3:f32"
JCFG, TCFG = _configs(NAME)


def _frames(n, seed):
    return np.random.RandomState(seed).normal(
        size=(n, JCFG.encoder_len, JCFG.d_model)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _weights():
    """(JAX params, numpy params), seed 3."""
    params, _ = jmodel.init_model(JCFG, jax.random.PRNGKey(3))
    return params, {k: np.asarray(v) for k, v in params.items()}


F32 = {"f32": True}


def test_encode_and_cross_cache_match_jax():
    jparams, nparams = _weights()
    port = params_from_numpy(nparams, TCFG, "cpu")
    assert len(port.encoder) == TCFG.n_encoder_layers
    frames = _frames(2, 7)
    jenc = jmodel.encode(jparams, JCFG, jnp.asarray(frames))
    tenc = model.encode(port, TCFG, torch.as_tensor(frames))
    _close(F32, tenc, jenc, "enc_out")
    jk, jv = jmodel.build_cross_cache(jparams, JCFG, jenc)
    tk, tv = model.build_cross_cache(port, TCFG,
                                     torch.as_tensor(np.array(jenc)))
    assert tk.shape == (TCFG.n_layers, 2, TCFG.n_kv_heads_padded,
                        TCFG.encoder_len, TCFG.resolved_head_dim)
    _close(F32, tk, jk, "cross_k")
    _close(F32, tv, jv, "cross_v")


@pytest.fixture(scope="module")
def runs():
    return model_runs(JCFG, TCFG, frames=_frames(2, 6))


def test_forward_hidden_matches_jax(runs):
    check_forward(runs)


def test_prefill_matches_jax(runs):
    check_prefill(runs)
    assert {"enc_out", "cross_k", "cross_v"} <= runs["port"]["cache"].keys()


@pytest.mark.parametrize("i", range(N_DECODE))
def test_decode_step_matches_jax(runs, i):
    check_decode(runs, i)


def test_decode_lengths_advance(runs):
    check_lengths(runs)


def test_server_matches_jax():
    lengths = (3, 9, 12, 5)  # buckets 16, 16, 8: slots reused twice
    specs = [(p, m, None) for p, m in zip(_prompts(lengths, 3),
                                          (5, 3, 6, 4))]
    js, ts = _serve(_weights(), specs, n_slots=2, max_len=40,
                    cfgs=(JCFG, TCFG), frames=_frames(1, 8))
    assert len(ts.completed) == len(specs)
    _same(js, ts)
    for k in ("enc_out", "cross_k", "cross_v"):
        _close(F32, ts.cache[k], js.cache[k], k)


def test_server_needs_frames():
    from repro_torch.serving import EpochServer

    with pytest.raises(ValueError, match="enc_frames"):
        EpochServer(TCFG, _weights()[1], n_slots=2, max_len=16,
                    device="cpu")


def test_launch_serves_whisper(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", "whisper_large_v3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "arch=whisper-large-v3 served 16 requests / 256 tokens" in out
