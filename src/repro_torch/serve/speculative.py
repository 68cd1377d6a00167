"""Self-speculative decoding: the accept rule, as host math on numpy (port
of ``repro.serve.speculative``).

The speculative loop drafts ``k`` tokens per burst with the cheap params
(W8 by default), then verifies all ``k`` in ONE batched ``verify_chunk``
call with the full-precision params.  SSMs make the rollback side
trivial: a rejected draft is undone by restoring an O(1)-byte state
snapshot (``export_state`` / ``StatePool.insert_rows``) instead of
truncating a KV cache.

Notation, per batch row (vectors below are whole-batch):

* ``t0``           — the pending next-input token before the burst;
* ``d_1 .. d_k``   — the draft stream: token ``d_j`` sampled from the
  draft logits after consuming ``d_{j-1}`` (``d_0`` := ``t0``);
* ``g_0 .. g_{k-1}`` — the verify stream: token ``g_j`` sampled from the
  verify logits at position ``j`` after the chunk consumed inputs
  ``[t0, d_1 .. d_{k-1}]``.  ``g_j`` is exactly what sequential
  full-precision decode would emit after consuming ``d_j``, so as long
  as the drafts match, the verify stream IS the target stream.

Accept rule: ``m = lcp(d, g)`` (:func:`accept_lengths`) counts drafts
confirmed by the verify stream; the burst emits ``n = min(m + 1, k)``
tokens (:func:`emit_counts`): the ``m`` accepted drafts plus, when a
mismatch happened inside the window, the verify stream's correction
``g_m``.  Every emitted token is ``g_j``, never ``d_j``, so the output
stream is the full-precision stream by construction however bad the
draft is; the draft only controls how *many* verify tokens each burst
can bank.

Rollback (:func:`needs_rollback`) is needed iff ``m < k - 1``: the
verify chunk consumed all ``k`` inputs, which for ``m >= k - 1`` is
precisely the state after emitting ``n = k`` tokens (the last emitted
token is pending, not yet consumed, as in plain decode).  For smaller
``m`` the chunk consumed rejected drafts, so the row's pre-burst
snapshot is restored and the emitted tokens are re-consumed through the
ordinary decode step (the engine's overflow drain), which re-advances
the state on exactly the non-speculative trajectory.  ``k = 1`` never
rolls back.
"""
from __future__ import annotations

import numpy as np


def accept_lengths(draft: np.ndarray, verify: np.ndarray) -> np.ndarray:
    """Per-row longest-common-prefix length of the draft vs verify token
    streams: ``m[i]`` = number of leading positions where
    ``draft[i] == verify[i]`` (both ``(b, k)`` int arrays; returns
    ``(b,)`` int64 in ``[0, k]``)."""
    draft = np.asarray(draft)
    verify = np.asarray(verify)
    if draft.shape != verify.shape or draft.ndim != 2:
        raise ValueError(
            f"draft/verify must share a (b, k) shape: "
            f"{draft.shape} vs {verify.shape}")
    neq = draft != verify
    k = draft.shape[1]
    # argmax of a boolean row is the index of its first True; all-False
    # rows (a full match) report 0, so gate on any().
    return np.where(neq.any(axis=1), neq.argmax(axis=1), k).astype(np.int64)


def emit_counts(m: np.ndarray, k: int) -> np.ndarray:
    """Tokens emitted per row for accept lengths ``m``: the accepted
    prefix plus one verify correction, capped at the window
    (``min(m + 1, k)``: a full match has no correction to add)."""
    return np.minimum(np.asarray(m) + 1, k)


def needs_rollback(m: np.ndarray, k: int) -> np.ndarray:
    """Rows whose post-verify state must be discarded: ``m < k - 1``
    means the chunk consumed at least one rejected draft token beyond
    the emitted stream.  ``m >= k - 1`` consumed exactly the emitted
    stream's prefix, so the post-verify state is already right."""
    return np.asarray(m) < (k - 1)
