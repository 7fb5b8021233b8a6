"""Synthetic LM token pipeline (no corpora): the port's copy of the JAX
package's, byte-equal for a seed.

Sequences come from a sparse random Markov chain over the vocabulary plus
copy/induction segments, so cross-entropy has real, learnable structure.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

from ..configs.base import ArchConfig


@dataclasses.dataclass
class SyntheticLM:
    vocab_size: int
    branching: int = 8           # successors per token
    induction_prob: float = 0.3  # fraction of sequence that is copied spans
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = min(self.vocab_size, 4096)   # transition table on a sub-vocab
        self.active_vocab = v
        self.successors = rng.integers(0, v, size=(v, self.branching))
        self.rng = rng

    def sample_batch(self, batch: int, seq_len: int) -> np.ndarray:
        rng = self.rng
        out = np.empty((batch, seq_len + 1), np.int32)
        for b in range(batch):
            t = int(rng.integers(0, self.active_vocab))
            seq = np.empty(seq_len + 1, np.int32)
            i = 0
            while i < seq_len + 1:
                if i > 16 and rng.random() < self.induction_prob:
                    # induction span: copy an earlier window
                    span = int(rng.integers(4, 16))
                    start = int(rng.integers(0, i - span)) if i > span \
                        else 0
                    span = min(span, seq_len + 1 - i)
                    seq[i: i + span] = seq[start: start + span]
                    i += span
                    t = int(seq[i - 1])
                else:
                    t = int(self.successors[t, rng.integers(
                        0, self.branching)])
                    seq[i] = t
                    i += 1
            out[b] = seq
        return out

    def batches(self, batch: int, seq_len: int,
                cfg: Optional[ArchConfig] = None) -> Iterator[dict]:
        """Yields {'tokens','targets'[, 'prefix']} numpy batches; a modality
        ``cfg`` adds (batch, num_prefix_embeddings, d_model) fp32 normal
        draws from the same generator, after the batch's tokens."""
        while True:
            seq = self.sample_batch(batch, seq_len)
            # targets[i] = tokens[i+1] (pre-shifted, same length)
            item = {"tokens": seq[:, :-1], "targets": seq[:, 1:]}
            if cfg is not None and cfg.modality:
                item["prefix"] = self.rng.normal(
                    size=(batch, cfg.num_prefix_embeddings,
                          cfg.d_model)).astype(np.float32)
            yield item
