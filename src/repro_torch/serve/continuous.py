"""Continuous-batching engine: slot-level refill under static shapes (port
of the core of ``repro.serve.continuous``).

The engine keeps ``max_batch`` persistent slots in a
:class:`~repro_torch.serve.state_pool.StatePool`; the moment a slot's
request finishes (EOS or token budget), the next queued request is
admitted into it mid-decode.  Every call keeps the JAX engine's shapes:

* **decode** at ``(slots, 1)``: every slot steps each poll; dead slots
  keep decoding their last token into their own rows (their tokens are
  dropped), so each step runs the same shapes;
* **prefill**, monolithic: per bucket, always at batch ``slots`` (unused
  rows are padding), from a zeroed scratch cache; the request rows are
  copied into their slots;
* **prefill**, chunked (``ServeConfig.prefill_chunk``): admitted prompts
  left-pad to a chunk multiple (``chunk_span``) and advance one chunk
  call at ``(slots, chunk)`` per poll (or more, up to
  ``prefill_token_budget`` tokens) in a second pool; slot i stages in row
  i, so a request reserves its decode slot at admission.  A fully
  consumed row moves to the decode pool and its first token is sampled
  from the chunk's last logits.

Tokens are sampled with noise keyed on ``(seed, uid, position)``
(``EngineBase._sample_rows``), so greedy and sampled outputs do not
depend on slot assignment: greedy outputs are those of the JAX
``ContinuousEngine`` on the same weights and requests.

Not ported: speculative bursts, the prefix cache, tracing and the flight
recorder, the program registry and budgets, step monitors and the
watchdog, fault injection, poison probes, overload and in-flight
shedding, retries, and the JAX engine's backend fallback: a failed kernel
launch raises here.
"""
from __future__ import annotations

import logging
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.serve.engine import EngineBase, ServeConfig
from repro_torch.serve.scheduler import Request, bucket_for, chunk_span
from repro_torch.serve.state_pool import StatePool

log = logging.getLogger("repro_torch.serve")


class ContinuousEngine(EngineBase):
    """Slot-scheduled serving over a shared per-slot state pool."""

    def __init__(self, model, params, cfg: ServeConfig):
        super().__init__(model, params, cfg)
        self.slots = cfg.max_batch
        self.buckets = tuple(sorted(cfg.prefill_buckets))
        self.chunk = cfg.prefill_chunk or None
        max_prompt = (chunk_span(self.buckets, self.chunk, self.buckets[-1])
                      if self.chunk else self.buckets[-1])
        self.max_seq = max_prompt + cfg.max_new_tokens
        dtype = model.cfg.dtype
        self.pool = StatePool(model, self.slots, self.max_seq, dtype)
        # Zeroed prefill input cache, reused by every monolithic admission
        # (prefill writes a new cache; its rows are copied into the pool).
        self._scratch = model.init_cache(self.slots, self.max_seq, dtype)
        self._slot_req: List[Optional[Request]] = [None] * self.slots
        self._pos = np.zeros(self.slots, np.int64)
        self._next_tok = np.full(self.slots, cfg.pad_id, np.int64)
        self._finished: List[Request] = []
        if self.chunk:
            # Staging pool: row i accumulates slot i's prompt state chunk
            # by chunk until the prompt is consumed.
            self._ppool = StatePool(model, self.slots, self.max_seq, dtype)
            self._pref_req: List[Optional[Request]] = [None] * self.slots
            self._pref_toks: List[Optional[np.ndarray]] = [None] * self.slots
            self._pref_off = np.zeros(self.slots, np.int64)

    @property
    def busy(self) -> bool:
        return (len(self._scheduler) > 0 or
                any(r is not None for r in self._slot_req) or
                (self.chunk is not None and
                 any(r is not None for r in self._pref_req)))

    def _tokens(self, tokens: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(tokens).to(self.device)

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self._slot_req)
                if r is None and
                (self.chunk is None or self._pref_req[i] is None)]

    def _finish(self, req: Request, now: float) -> None:
        req.done = True
        req.finish_s = now
        req.latency_s = now - req.arrival_s
        self.metrics.record_finish(req.latency_s, len(req.out_tokens))
        self._finished.append(req)

    def _start_tenant(self, slot: int, req: Request, span: int, tok: int,
                      t_first: float) -> None:
        """Clamp the output budget to the slot's remaining cache, stamp
        the first token and emit it; then either finish (EOS on the
        prefill token, or a 1-token budget: the slot stays free) or
        install the request as the slot's decoding tenant at ``span``."""
        cfg = self.cfg
        budget = max(1, min(req.max_new_tokens, self.max_seq - span))
        if budget < req.max_new_tokens:
            log.warning("request %d: max_new_tokens %d exceeds slot budget; "
                        "clamping to %d", req.uid, req.max_new_tokens, budget)
            req.max_new_tokens = budget
        req.first_token_s = t_first
        self.metrics.record_first_token(t_first - req.arrival_s)
        self.metrics.record_token()
        req.emit(tok)
        if (cfg.eos_id >= 0 and tok == cfg.eos_id) or \
                len(req.out_tokens) >= req.max_new_tokens:
            self._finish(req, t_first)
        else:
            self._slot_req[slot] = req
            self._pos[slot] = span
            self._next_tok[slot] = tok

    def _pop_ready(self, now: float, free: List[int]) -> List[tuple]:
        """(slot, request) pairs for as many free slots as the queue
        fills; requests shed on their deadline are counted."""
        n_shed0 = len(self._scheduler.expired)
        batch = []
        while free and len(self._scheduler):
            req = self._scheduler.pop_ready(now)
            if req is None:
                break
            batch.append((free.pop(0), req))
        for _ in range(len(self._scheduler.expired) - n_shed0):
            self.metrics.record_shed()
        return batch

    def _admit(self, now: float) -> int:
        """Monolithic admission: fill free slots from the queue, one
        bucketed prefill at batch ``slots`` per bucket; returns the
        requests admitted."""
        cfg = self.cfg
        batch = self._pop_ready(now, self._free_slots())
        groups = {}
        for slot, req in batch:
            b, _ = bucket_for(self.buckets, len(req.prompt))
            groups.setdefault(b, []).append((slot, req))
        for bucket, group in groups.items():
            tokens = np.full((self.slots, bucket), cfg.pad_id, np.int64)
            for row, (_, req) in enumerate(group):
                p = req.prompt[-bucket:]
                tokens[row, bucket - len(p):] = p
            t0 = time.perf_counter()
            logits, cache = self.model.prefill(
                self.params, {"tokens": self._tokens(tokens)}, self._scratch)
            # First tokens sample at position = bucket (tokens consumed).
            uids = np.zeros(self.slots, np.int64)
            for row, (_, req) in enumerate(group):
                uids[row] = req.uid
            first = self._sample_rows(logits, uids,
                                      np.full(self.slots, bucket, np.int64))
            self.metrics.record_prefill(bucket * len(group),
                                        time.perf_counter() - t0)
            self.pool.insert_rows(cache, range(len(group)),
                                  [slot for slot, _ in group])
            t_first = time.time()
            for row, (slot, req) in enumerate(group):
                req.bucket = bucket
                self._start_tenant(slot, req, bucket, int(first[row]),
                                   t_first)
        return len(batch)

    def _admit_chunked(self, now: float) -> int:
        """Reserve free slots for queued requests and stage their padded
        prompts; the chunks run in :meth:`_prefill_step`."""
        batch = self._pop_ready(now, self._free_slots())
        for slot, req in batch:
            p = req.prompt[-self.buckets[-1]:]
            span = chunk_span(self.buckets, self.chunk, len(p))
            toks = np.full(span, self.cfg.pad_id, np.int64)
            toks[span - len(p):] = p
            req.bucket = span
            # The row's previous tenant left state behind; the chunk calls
            # accumulate into the row, so it starts from zero.
            self._ppool.reset_rows([slot])
            self._pref_req[slot] = req
            self._pref_toks[slot] = toks
            self._pref_off[slot] = 0
        return len(batch)

    def _prefill_step(self) -> int:
        """Advance every staging row by one chunk (one call at ``(slots,
        chunk)``); finished prompts sample their first token and move
        their rows into the decode pool.  Returns the prompt tokens
        advanced (0 when nothing is staging)."""
        rows = [i for i, r in enumerate(self._pref_req) if r is not None]
        if not rows:
            return 0
        C = self.chunk
        tokens = np.full((self.slots, C), self.cfg.pad_id, np.int64)
        for i in rows:
            off = self._pref_off[i]
            tokens[i] = self._pref_toks[i][off:off + C]
        t0 = time.perf_counter()
        logits, self._ppool.cache = self.model.prefill_chunk(
            self.params, self._tokens(tokens), self._ppool.cache,
            self._pref_off)
        host = logits.float().cpu()           # the call ends on the device
        self.metrics.record_prefill(C * len(rows), time.perf_counter() - t0)
        done_rows = []
        for i in rows:
            self._pref_off[i] += C
            if self._pref_off[i] >= len(self._pref_toks[i]):
                done_rows.append(i)
        if done_rows:
            uids = np.zeros(self.slots, np.int64)
            poss = np.zeros(self.slots, np.int64)
            for i in done_rows:
                uids[i] = self._pref_req[i].uid
                poss[i] = len(self._pref_toks[i])
            first = self._sample_rows(host, uids, poss)
            # Staging row i becomes slot i's decode state.
            self.pool.insert_rows(self._ppool.cache, done_rows, done_rows)
            t_first = time.time()
            for i in done_rows:
                req = self._pref_req[i]
                span = len(self._pref_toks[i])
                self._pref_req[i] = None
                self._pref_toks[i] = None
                self._start_tenant(i, req, span, int(first[i]), t_first)
        return C * len(rows)

    def _row_uids(self) -> List[int]:
        """Per-slot owning-request uids (0 for dead and staging rows,
        whose sampled tokens are dropped)."""
        return [r.uid if r is not None else 0 for r in self._slot_req]

    def poll(self) -> List[Request]:
        """Admit waiting requests (monolithic: prefill them; chunked: stage
        them and advance the staging rows by a chunk, or by the token
        budget), then run one decode step across all slots; returns the
        requests completed this poll."""
        cfg = self.cfg
        done0 = len(self._finished)
        now = time.time()
        if self.chunk:
            self._admit_chunked(now)
            spent = self._prefill_step()
            while spent and cfg.prefill_token_budget > spent:
                # An EOS-on-prefill finish frees its slot for the queue.
                self._admit_chunked(time.time())
                adv = self._prefill_step()
                if not adv:
                    break
                spent += adv
        else:
            # Re-admit until the slots are full or the queue drains (a
            # request that ends on its prefill token frees its slot).
            while self._free_slots() and len(self._scheduler):
                if not self._admit(now):
                    break
                now = time.time()

        live = [i for i, r in enumerate(self._slot_req) if r is not None]
        if live:
            t0 = time.perf_counter()
            tok = self._tokens(self._next_tok[:, None])
            logits, self.pool.cache = self.model.decode_step(
                self.params, tok, self.pool.cache, self._pos)
            nxt = self._sample_rows(logits, self._row_uids(), self._pos + 1)
            self.metrics.record_step(len(live), time.perf_counter() - t0)
            # A dead slot's position pins to the last cache column until a
            # refill overwrites its row.
            self._pos = np.minimum(self._pos + 1, self.max_seq - 1)
            now = time.time()
            for i in live:
                req = self._slot_req[i]
                tok_i = int(nxt[i])
                req.emit(tok_i)
                self.metrics.record_token()
                self._next_tok[i] = tok_i
                if (cfg.eos_id >= 0 and tok_i == cfg.eos_id) or \
                        len(req.out_tokens) >= req.max_new_tokens:
                    self._finish(req, now)
                    self._slot_req[i] = None
        return self._finished[done0:]

    def run(self) -> List[Request]:
        """Serve until the queue and the slots drain; returns the
        completed requests."""
        t0 = time.perf_counter()
        done: List[Request] = []
        with torch.inference_mode():
            while self.busy:
                done.extend(self.poll())
        self.metrics.record_wall(time.perf_counter() - t0)
        return done

    def stats(self, requests: Optional[List[Request]] = None) -> dict:
        """The metrics' summary (``requests`` is accepted for parity with
        the wave engine's ``stats``)."""
        del requests
        return self.metrics.summary()
