"""Deterministic, step-indexed data pipeline (a copy of
``repro/data/pipeline.py``).

``batch_at(step)`` is a pure function of (seed, step): the batches are
numpy arrays drawn from ``np.random.RandomState`` exactly as the
reference draws them, so both packages see the same tokens bit for bit,
and a restart from step k replays the same data.  ``SyntheticLM`` draws
Zipf-ish token streams with induced bigram structure (so a model can
reduce its loss on them); ``PackedDataset`` packs variable-length
documents into fixed (batch, seq) windows with -1 labels across document
boundaries.  :func:`place_batch` puts a batch on the step's device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from ..core.engine import resolve_device


@dataclasses.dataclass
class SyntheticLM:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + step) % (2**31 - 1))
        B, S, V = self.global_batch, self.seq_len, self.vocab
        # zipf-ish unigram draw
        base = rng.zipf(1.3, size=(B, S)).astype(np.int64)
        toks = (base % max(V - 2, 1)) + 1
        # induced structure: token t is often followed by (t*7+3) % V
        follow = (toks * 7 + 3) % max(V - 2, 1) + 1
        use_follow = rng.rand(B, S) < 0.5
        toks[:, 1:] = np.where(use_follow[:, 1:], follow[:, :-1], toks[:, 1:])
        tokens = toks.astype(np.int32)
        labels = np.concatenate(
            [tokens[:, 1:], np.full((B, 1), -1, np.int32)], axis=1)
        return {"tokens": tokens, "labels": labels}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


@dataclasses.dataclass
class PackedDataset:
    """Packs variable-length documents into fixed (batch, seq) windows.

    Documents end with an EOS token; labels are -1 across document
    boundaries so the loss never crosses documents.
    """

    vocab: int
    seq_len: int
    global_batch: int
    eos: int = 2
    mean_doc_len: int = 256
    seed: int = 0

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState(
            (self.seed * 2_000_003 + step) % (2**31 - 1))
        B, S = self.global_batch, self.seq_len
        tokens = np.zeros((B, S), np.int32)
        labels = np.full((B, S), -1, np.int32)
        for b in range(B):
            pos = 0
            while pos < S:
                doc_len = min(
                    S - pos, max(2, int(rng.exponential(self.mean_doc_len))))
                doc = rng.randint(3, max(self.vocab, 4), size=doc_len)
                doc[-1] = self.eos
                tokens[b, pos:pos + doc_len] = doc
                labels[b, pos:pos + doc_len - 1] = doc[1:]
                pos += doc_len
        return {"tokens": tokens, "labels": labels}


def place_batch(batch: Dict[str, np.ndarray],
                device=None) -> Dict[str, torch.Tensor]:
    """A host batch on ``device`` (None: CUDA, raising where it is absent),
    each array as a tensor of its own dtype (int32 tokens; labels int32,
    -1 where ignored).  The reference's mesh placement (the batch dim
    sharded over the data axes) comes with the mesh half of training
    (ROADMAP item 11)."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.asarray(v), device=dev)
            for k, v in batch.items()}
