"""The port's optimiser, schedule and data pipeline against the JAX
reference, on the CPU.

- ``AdamW.update`` on fixed numpy gradients, from the same parameters and
  state, two steps: with and without clipping (the first step's gradients
  are scaled so that clipping acts), a constant and a scheduled rate,
  float32 parameters and bfloat16 ones with float32 master weights; a 1-d
  parameter is not decayed.  New parameters, both moments, the masters
  and the metrics within 1e-6 of each tensor's largest |JAX value|
  (bfloat16 parameters: equal, both casting the same float32 masters).
- ``cosine_schedule`` at the first step, inside and at the end of the
  warmup, in the middle and at and past the end: within two float32 ulps
  (XLA may fold ``peak * s / warmup`` into another order).
- ``SyntheticLM.batch_at`` and ``PackedDataset.batch_at`` equal to the
  reference's bit for bit; ``place_batch`` keeps int32.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp

from _torch_threads import one_torch_thread  # noqa: F401
from repro.data import PackedDataset as JPackedDataset
from repro.data import SyntheticLM as JSyntheticLM
from repro.optim import AdamW as JAdamW
from repro.optim import cosine_schedule as jcosine
from repro_torch.data import PackedDataset, SyntheticLM, place_batch
from repro_torch.optim import AdamW, OptState, cosine_schedule

SHAPES = {"w": (6, 5), "stack": (2, 4, 3), "scale": (5,)}
TOL = 1e-6


def _arrays(seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _port(d, dtype=torch.float32):
    return {k: torch.as_tensor(v).to(dtype) for k, v in d.items()}


def _close(got, want, what):
    got = np.asarray(torch.as_tensor(got).float().numpy(), np.float64) \
        if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    want = np.asarray(np.asarray(want, np.float32), np.float64)
    err = float(np.abs(got - want).max())
    assert err <= TOL * max(float(np.abs(want).max()), 1e-30), (what, err)


@pytest.mark.parametrize("case", ("clip", "no-clip", "schedule", "master"))
def test_adamw_update_matches_jax(case):
    kw = {"clip": dict(clip_norm=1.0), "no-clip": dict(clip_norm=None),
          "schedule": dict(lr=None), "master": dict(master_weights=True)}[case]
    jkw, tkw = dict(kw), dict(kw)
    if case == "schedule":
        jkw["lr"], tkw["lr"] = jcosine(1e-2, 2, 10), cosine_schedule(1e-2, 2,
                                                                      10)
    else:
        jkw.setdefault("lr", 1e-2)
        tkw.setdefault("lr", 1e-2)
    jopt, opt = JAdamW(**jkw), AdamW(**tkw)
    dt = torch.bfloat16 if case == "master" else torch.float32
    jdt = jnp.bfloat16 if case == "master" else jnp.float32
    p0 = _arrays(0)
    jp = {k: jnp.asarray(v).astype(jdt) for k, v in p0.items()}
    tp = _port(p0, dt)
    js, ts = jopt.init(jp), opt.init(tp)
    assert isinstance(ts, OptState) and int(ts.step) == 0
    assert set(ts.master) == (set(SHAPES) if case == "master" else set())
    for step, scale in ((1, 3.0), (2, 0.5)):  # step 1's norm clips
        g = _arrays(step, scale)
        jp, js, jm = jopt.update(jp, {k: jnp.asarray(v) for k, v in
                                      g.items()}, js)
        tp, ts, tm = opt.update(tp, _port(g), ts)
        assert int(ts.step) == int(js.step) == step
        _close(tm["grad_norm"], jm["grad_norm"], f"grad_norm {step}")
        _close(tm["lr"], jm["lr"], f"lr {step}")
        for k in SHAPES:
            assert tp[k].dtype == dt
            for what, got, want in (("m", ts.m[k], js.m[k]),
                                    ("v", ts.v[k], js.v[k])):
                _close(got, want, f"{what} {k} step {step}")
            if case == "master":
                _close(ts.master[k], js.master[k], f"master {k}")
                assert np.array_equal(tp[k].float().numpy(), np.asarray(
                    jp[k].astype(jnp.float32))), k
            else:
                _close(tp[k], jp[k], f"param {k} step {step}")


def test_adamw_decays_only_matrices():
    """A zero gradient leaves a 1-d parameter as it was, and shrinks the
    others by lr * weight_decay."""
    opt = AdamW(lr=0.1, weight_decay=0.5, clip_norm=None)
    p = _port(_arrays(3))
    before = {k: v.clone() for k, v in p.items()}
    p, _, _ = opt.update(p, {k: torch.zeros_like(v) for k, v in p.items()},
                         opt.init(p))
    assert torch.equal(p["scale"], before["scale"])
    for k in ("w", "stack"):
        assert torch.allclose(p[k], before[k] * (1 - 0.1 * 0.5))


def test_cosine_schedule_matches_jax():
    jlr, lr = jcosine(3e-3, 10, 100, min_ratio=0.1), cosine_schedule(
        3e-3, 10, 100, min_ratio=0.1)
    for s in (0, 1, 3, 9, 10, 11, 55, 99, 100, 150):
        got, want = lr(s), np.float32(jlr(s))
        assert got.dtype == torch.float32
        assert abs(float(got) - float(want)) <= 2 * np.spacing(want), s
    assert float(lr(0)) == 0.0
    assert float(lr(100)) == pytest.approx(3e-4, rel=1e-6)


@pytest.mark.parametrize("seed", (0, 7))
def test_batches_equal_jax_bit_for_bit(seed):
    for T, J, kw in ((SyntheticLM, JSyntheticLM, {}),
                     (PackedDataset, JPackedDataset, dict(mean_doc_len=9))):
        tds = T(vocab=250, seq_len=40, global_batch=3, seed=seed, **kw)
        jds = J(vocab=250, seq_len=40, global_batch=3, seed=seed, **kw)
        for step in (0, 1, 17):
            got, want = tds.batch_at(step), jds.batch_at(step)
            assert set(got) == set(want) == {"tokens", "labels"}
            for k in got:
                assert got[k].dtype == want[k].dtype == np.int32
                assert np.array_equal(got[k], want[k]), (T, step, k)
    it = iter(SyntheticLM(vocab=250, seq_len=40, global_batch=3, seed=seed))
    assert np.array_equal(next(it)["tokens"],
                          JSyntheticLM(250, 40, 3, seed).batch_at(0)["tokens"])


def test_place_batch_keeps_int32():
    batch = PackedDataset(vocab=100, seq_len=32, global_batch=2,
                          mean_doc_len=5).batch_at(0)
    placed = place_batch(batch, "cpu")
    for k in ("tokens", "labels"):
        assert placed[k].dtype == torch.int32 and placed[k].device.type == \
            "cpu"
        assert np.array_equal(placed[k].numpy(), batch[k])
    assert int(placed["labels"].min()) == -1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            place_batch(batch)
