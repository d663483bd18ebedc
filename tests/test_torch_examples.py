"""The port's twins of the examples (``examples/*_torch.py``) on the CPU.

Each twin runs as a user runs it, ``--device cpu`` added, and must exit 0
and pass its own checks.  ``quickstart_torch.py`` and
``graph_analytics_torch.py`` must print what the JAX examples print, line
for line, with each wall time masked (the quickstart's device-engine line
says "resident on the device" where the JAX one says "in one XLA
program").  ``serve_llm_torch.py`` serves its toy decode program through
the device engine and, with ``--legacy``, a reduced granite-3-8b, or the
encoder-decoder whisper's.  The JAX examples run once per module, in the
background while the port's twins run.
"""
from __future__ import annotations

import argparse
import os
import pathlib
import re
import runpy
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
TIMEOUT = 300


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env.update(extra)
    return env


def _twin(name, *args):
    """Run ``examples/{name}_torch.py --device cpu *args``; its stdout."""
    out = subprocess.run(
        [sys.executable, str(EXAMPLES / f"{name}_torch.py"), "--device",
         "cpu", *args], capture_output=True, text=True, cwd=ROOT,
        env=_env(OMP_NUM_THREADS="1"), timeout=TIMEOUT)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


@pytest.fixture(scope="module", autouse=True)
def jax_examples():
    """The JAX quickstart and graph analytics, started at once; each
    one's stdout on first use."""
    procs = {}
    try:
        import jax  # noqa: F401
    except ImportError:
        procs = None
    if procs is not None:
        for name in ("quickstart", "graph_analytics"):
            procs[name] = subprocess.Popen(
                [sys.executable, str(EXAMPLES / f"{name}.py")],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                cwd=ROOT, env=_env(JAX_PLATFORMS="cpu"))
    outs = {}

    def get(name):
        if procs is None:
            pytest.skip("jax is not installed")
        if name not in outs:
            out, err = procs[name].communicate(timeout=TIMEOUT)
            assert procs[name].returncode == 0, err[-3000:]
            outs[name] = out
        return outs[name]

    yield get
    for p in (procs or {}).values():
        if p.poll() is None:
            p.kill()
        p.communicate()


def _masked(text: str):
    """Every line, wall times masked."""
    return [re.sub(r"\d+\.\d+s\b", "<t>s", ln) for ln in text.splitlines()]


def test_serve_llm_twin_serves_the_toy_decode():
    out = _twin("serve_llm")
    assert "16 requests, 273 tokens in" in out
    assert "(device engine)" in out
    assert sum(1 for ln in out.splitlines() if " tok wait=" in ln) == 16


def test_serve_llm_twin_legacy_server():
    out = _twin("serve_llm", "--legacy")
    assert out.startswith("granite-3-8b: 16 requests, ")
    assert "epochs per token ~ " in out


def test_serve_llm_twin_refuses_encoder_decoder(capsys):
    """The twin's ``legacy`` serves the encoder-decoder whisper (reduced)
    on the CPU, every request its tokens (it raised while the port had no
    encoder-decoder path)."""
    twin = runpy.run_path(str(EXAMPLES / "serve_llm_torch.py"))
    args = argparse.Namespace(arch="whisper_large_v3", slots=2, requests=2,
                              device="cpu")
    twin["legacy"](args)
    out = capsys.readouterr().out
    assert out.startswith("whisper-large-v3: 2 requests, ")


def test_quickstart_twin_prints_the_jax_output(jax_examples):
    out = _twin("quickstart")
    assert out.rstrip().endswith("quickstart OK")
    want = jax_examples("quickstart").replace(
        "in one XLA program", "resident on the device")
    assert _masked(out) == _masked(want)


def test_graph_analytics_twin_prints_the_jax_output(jax_examples):
    out = _twin("graph_analytics")
    assert out.count("==ref: True") == 2 and out.count("~=ref: True") == 2
    assert _masked(out) == _masked(jax_examples("graph_analytics"))
