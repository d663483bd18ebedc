"""The port's ``EpochServer`` against the JAX ``EpochServer``, on the CPU.

Both serve the same requests from the same weights (the JAX ``init_model``
dict, converted by ``params_from_numpy``) in a float32-compute granite
config, where greedy decoding gives the same tokens: each request's output,
the completion order and the epoch count must be equal.  The scenarios:
more requests than slots (slot reuse), ragged prompts across the prompt
buckets 8/16/32, an eos hit, and an idle slot whose length runs past
``max_len`` (the reference's out-of-range cache write is dropped; the
port's must leave the cache as the reference leaves it).
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
from repro.models.model import init_model as jinit_model
from repro.serving import EpochServer as JServer
from repro.serving import Request as JRequest
from repro_torch import configs
from repro_torch.serving import EpochServer, Request
from repro_torch.serving.engine import _bucket

JCFG = dataclasses.replace(jconfigs.get_reduced("granite_3_8b"),
                           compute_dtype=jnp.float32)
TCFG = dataclasses.replace(configs.get_reduced("granite_3_8b"),
                           compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def weights():
    params, _ = jinit_model(JCFG, jax.random.PRNGKey(1))
    return params, {k: np.asarray(v) for k, v in params.items()}


def _serve(weights, specs, n_slots, max_len, waves=1, cfgs=(JCFG, TCFG),
           frames=None):
    """Serve ``specs`` [(prompt, max_new, eos)] on both servers, split into
    ``waves`` submitted one after another (each run to completion).
    ``cfgs``: the (JAX, port) configs of ``weights``; ``frames``: an
    encoder-decoder model's encoder input, numpy."""
    jparams, nparams = weights
    jcfg, tcfg = cfgs
    jf = None if frames is None else jnp.asarray(frames)
    js = JServer(jcfg, jparams, n_slots=n_slots, max_len=max_len,
                 enc_frames=jf)
    ts = EpochServer(tcfg, nparams, n_slots=n_slots, max_len=max_len,
                     device="cpu", enc_frames=frames)
    for wave in np.array_split(np.arange(len(specs)), waves):
        for i in wave:
            p, m, eos = specs[i]
            js.submit(JRequest(prompt=p, max_new_tokens=m, eos=eos))
            ts.submit(Request(prompt=p, max_new_tokens=m, eos=eos))
        js.run_to_completion()
        ts.run_to_completion()
    return js, ts


def _same(js, ts):
    assert [r.rid for r in ts.completed] == [r.rid for r in js.completed]
    for a, b in zip(ts.completed, js.completed):
        assert a.output == b.output, a.rid
    assert ts.epochs == js.epochs
    assert not ts.queue and not ts.active.any()


def _prompts(lengths, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(3, JCFG.vocab, size=n).astype(np.int32)
            for n in lengths]


def test_slot_reuse_and_ragged_buckets(weights):
    lengths = (3, 8, 9, 16, 17, 30, 5, 12)
    assert {_bucket(n) for n in lengths} == {8, 16, 32}
    specs = [(p, m, None) for p, m in zip(_prompts(lengths, 0),
                                          (6, 3, 5, 4, 7, 2, 6, 5))]
    js, ts = _serve(weights, specs, n_slots=3, max_len=48)
    assert len(ts.completed) == len(specs)
    for r in ts.completed:
        assert len(r.output) == specs[r.rid][1]
    _same(js, ts)


def test_eos_ends_a_request_early(weights):
    prompts = _prompts((4, 11, 7), 1)
    plain = [(p, 8, None) for p in prompts]
    js, _ = _serve(weights, plain, n_slots=2, max_len=32)
    # the third token of request 1 becomes its eos
    eos = js.completed[[r.rid for r in js.completed].index(1)].output[2]
    specs = [(p, 8, eos) for p in prompts]
    js, ts = _serve(weights, specs, n_slots=2, max_len=32)
    got = {r.rid: r.output for r in ts.completed}
    assert len(got[1]) == 2 and eos not in got[1][:2]
    _same(js, ts)


def test_idle_slot_past_max_len(weights):
    max_len = 16
    specs = [(p, 12, None) for p in _prompts((3, 3), 2)]
    # two waves, one request each: both use slot 0, and idle slot 1's length
    # grows by one every epoch to 24, past the cache's 16 rows
    js, ts = _serve(weights, specs, n_slots=2, max_len=max_len, waves=2)
    _same(js, ts)
    lengths = np.asarray(js.cache["lengths"])
    assert lengths[1] > max_len
    np.testing.assert_array_equal(ts.cache["lengths"].numpy(), lengths)
    for k in ("k", "v"):
        np.testing.assert_allclose(ts.cache[k].numpy(),
                                   np.asarray(js.cache[k]),
                                   rtol=1e-4, atol=1e-4)


def test_server_takes_a_model_on_its_device(weights):
    from repro_torch.core.convert import params_from_numpy

    model = params_from_numpy(weights[1], TCFG, "cpu")
    srv = EpochServer(TCFG, model, n_slots=2, max_len=16, device="cpu")
    assert srv.params is model
    srv.submit(Request(prompt=np.array([5, 6, 7], np.int32),
                       max_new_tokens=3))
    (r,) = srv.run_to_completion()
    assert len(r.output) == 3 and srv.epochs == 3
    assert srv.last_logits.shape == (2, TCFG.vocab_padded)
    with pytest.raises(ValueError, match="lies on"):
        EpochServer(TCFG, model, device="meta")


def test_server_defaults_to_cuda(weights):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        EpochServer(TCFG, weights[1], n_slots=2, max_len=16)
