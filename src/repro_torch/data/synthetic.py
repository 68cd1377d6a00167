"""Deterministic synthetic LM data with learnable structure: a copy of
``repro.data.synthetic`` (the same numpy generator, so the same seed and
step give the JAX package's batches bit for bit).

Sequences mix a Zipf-distributed token stream with induction patterns
(a random span repeated later in the sequence), so a model trained on this
pipeline shows a real, monotone loss decrease — enough signal to validate
the full training stack end-to-end without external datasets.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int = 512
    seq_len: int = 128
    global_batch: int = 8
    seed: int = 0
    zipf_a: float = 1.2
    repeat_frac: float = 0.5   # fraction of the sequence that is a repeat


class SyntheticLM:
    """Infinite deterministic iterator of {"tokens", "labels"} batches."""

    def __init__(self, cfg: DataConfig, start_step: int = 0):
        self.cfg = cfg
        self.step = start_step

    def state(self) -> dict:
        return {"step": self.step, "seed": self.cfg.seed}

    def _batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step]))
        b, s = cfg.global_batch, cfg.seq_len
        # Zipf body (clipped into vocab, reserving 0 for padding/bos)
        toks = rng.zipf(cfg.zipf_a, size=(b, s)).astype(np.int64)
        toks = (toks % (cfg.vocab_size - 1)) + 1
        # Induction: copy an early span later in the sequence.
        span = max(4, int(s * cfg.repeat_frac / 2))
        if 2 * span < s:
            start = rng.integers(0, s - 2 * span, size=b)
            for i in range(b):
                src = slice(start[i], start[i] + span)
                dst = slice(s - span, s)
                toks[i, dst] = toks[i, src]
        toks = toks.astype(np.int32)
        return {"tokens": toks, "labels": toks.copy()}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            batch = self._batch_at(self.step)
            self.step += 1
            yield batch

    def next(self) -> Dict[str, np.ndarray]:
        batch = self._batch_at(self.step)
        self.step += 1
        return batch
