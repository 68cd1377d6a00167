"""Vectorized token sampling shared by both serving engines.

A copy of ``repro.serve.sampling``: the noise is numpy, so greedy and
keyed streams are byte-identical to the JAX package's.

Temperature sampling uses the Gumbel-max trick — ``argmax(z + g)`` with
``g ~ Gumbel(0, 1)`` samples exactly from ``softmax(z)`` — which replaces
the per-row ``np.random.choice`` Python loop with one batched argmax.

Two keying schemes derive the noise:

* :func:`sample` (wave engine) keys on ``(seed, step)``: a given engine
  configuration replays identically regardless of how many requests came
  before, but the draw a token gets depends on *when* its decode step
  ran relative to everything else in the batch.
* :func:`sample_keyed` (continuous engine) keys on ``(seed, uid,
  position)`` per row: a token's randomness is a pure function of which
  request it belongs to and where in that request's stream it sits —
  independent of slot assignment, batch composition, scheduling history,
  and of whether the token was produced by a plain decode step, a draft
  step, or a speculative verify chunk.  That last invariance is what
  keeps self-speculative decoding (``serve/speculative.py``) exact under
  temperature sampling: the verify chunk samples position ``p`` with the
  *same* noise the non-speculative decode step would have used at ``p``.

Greedy (``temperature <= 0``) is a pure argmax under both schemes.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

_TINY = 1e-20


def step_rng(seed: int, step: int) -> np.random.Generator:
    """Deterministic per-step generator: independent of call history."""
    return np.random.default_rng([seed, step])


def _gumbel(rng: np.random.Generator, shape) -> np.ndarray:
    u = rng.random(size=shape)
    return -np.log(-np.log(u + _TINY) + _TINY)


def sample(logits: np.ndarray, temperature: float,
           rng: np.random.Generator) -> np.ndarray:
    """Greedy (temperature<=0) or Gumbel-max temperature sampling.

    logits: (b, vocab) float; returns (b,) int32 token ids.
    """
    logits = np.asarray(logits, np.float32)
    if temperature <= 0.0:
        return np.argmax(logits, axis=-1).astype(np.int32)
    z = logits / temperature
    return np.argmax(z + _gumbel(rng, z.shape), axis=-1).astype(np.int32)


def keyed_gumbel(seed: int, uids: Sequence[int], positions: Sequence[int],
                 vocab: int) -> np.ndarray:
    """Per-row Gumbel(0, 1) noise keyed by ``(seed, uid, position)``:
    row ``i`` draws from ``default_rng([seed, uids[i], positions[i]])``,
    so the noise a (request, position) pair gets is independent of batch
    shape, row order, and call history.  Returns ``(len(uids), vocab)``
    float32."""
    g = np.empty((len(uids), vocab), np.float32)
    for i, (u, p) in enumerate(zip(uids, positions)):
        g[i] = _gumbel(np.random.default_rng([seed, int(u), int(p)]), vocab)
    return g


def sample_keyed(logits: np.ndarray, temperature: float, seed: int,
                 uids: Sequence[int], positions: Sequence[int]) -> np.ndarray:
    """Gumbel-max sampling with per-row ``(seed, uid, position)`` noise
    (see module docstring; greedy when ``temperature <= 0``).

    logits: (b, vocab) float; ``uids`` / ``positions``: length-b ints —
    the owning request id and the *output* position being sampled (the
    number of tokens the row will have consumed once this token is fed
    back).  Returns (b,) int32 token ids."""
    logits = np.asarray(logits, np.float32)
    if temperature <= 0.0:
        return np.argmax(logits, axis=-1).astype(np.int32)
    z = logits / temperature
    g = keyed_gumbel(seed, uids, positions, z.shape[-1])
    return np.argmax(z + g, axis=-1).astype(np.int32)
