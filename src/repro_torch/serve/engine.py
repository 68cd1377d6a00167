"""Wave-mode serving engine (port of ``repro.serve.engine``'s ``Engine``).

Requests are grouped into fixed-size batches that prefill together
(bucketed, left-padded with ``pad_id``) and decode in lockstep; EOS'd
rows keep decoding into a sink but stop being reported.  Left-padding
keeps every live request of a wave at the same position.

The model runs on its own device; the engine moves token ids there and
logits back to the host for sampling (``serve/sampling.py``, numpy), so
greedy outputs are those of the JAX engine on the same weights.  The
continuous engine (``serve/continuous.py``) shares :class:`EngineBase`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.serve import sampling
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.scheduler import (Request, Scheduler, bucket_for,
                                         build_request)
from repro_torch.serve.state_pool import StatePool


@dataclasses.dataclass
class ServeConfig:
    """The JAX package's ``ServeConfig`` fields that the port serves.  The
    robustness, tracing, speculation and prefix-cache fields are not
    ported, so passing one is a ``TypeError``; in particular there is no
    ``backend_fallback``: a failed kernel launch raises."""

    max_batch: int = 8
    prefill_buckets: Sequence[int] = (32, 128, 512)
    max_new_tokens: int = 32
    eos_id: int = -1            # -1: never stops early
    pad_id: int = 0
    temperature: float = 0.0    # 0 => greedy
    seed: int = 0
    policy: str = "fcfs"        # admission order: fcfs | priority
    # -- chunked prefill (continuous engine only; the wave engine ignores
    # both) -------------------------------------------------------------
    # Chunk size in tokens: prompts left-pad to a chunk multiple and
    # prefill one chunk call per poll, interleaved with the decode step.
    # None keeps the monolithic bucketed prefill.
    prefill_chunk: Optional[int] = None
    # Prompt tokens per poll, counted as chunk per prefilling slot per
    # chunk call; 0 = exactly one chunk call per poll.
    prefill_token_budget: int = 0


class EngineBase:
    """Plumbing the engines share: the model and params, uid and
    sampling-step counters, submit-time bookkeeping and metrics."""

    def __init__(self, model, params, cfg: ServeConfig):
        self.model = model
        # Built once: every layer's kernel operands in fp32.
        self.params = model.decode_view(params)
        self.cfg = cfg
        self.device = model.device
        self._scheduler = Scheduler(cfg.policy)
        self._uid = 0
        self._step = 0              # sampling-rng step counter
        self.metrics = ServeMetrics(cfg.max_batch)

    def submit(self, prompt: Sequence[int],
               max_new_tokens: Optional[int] = None, *,
               priority: int = 0, deadline_s: Optional[float] = None,
               on_token=None) -> int:
        """Queue a request; returns its uid."""
        self._uid += 1
        req = build_request(
            self._uid, prompt, max_new_tokens or self.cfg.max_new_tokens,
            priority=priority, deadline_s=deadline_s, on_token=on_token,
            buckets=self.cfg.prefill_buckets, metrics=self.metrics)
        self._scheduler.submit(req)
        return req.uid

    def _host_logits(self, logits: torch.Tensor) -> np.ndarray:
        """Logits on the host as fp32 numpy, rows counted (non-finite
        ones apart) in the metrics."""
        host = logits.float().cpu().numpy()
        self.metrics.record_logits(
            host.shape[0], int((~np.isfinite(host).all(axis=-1)).sum()))
        return host

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        out = sampling.sample(self._host_logits(logits),
                              self.cfg.temperature,
                              sampling.step_rng(self.cfg.seed, self._step))
        self._step += 1
        return out

    def _sample_rows(self, logits: torch.Tensor, uids: Sequence[int],
                     positions: Sequence[int]) -> np.ndarray:
        """Keyed sampling (continuous engine): a row's noise is a function
        of ``(seed, uid, position)`` alone (``sampling.sample_keyed``)."""
        return sampling.sample_keyed(self._host_logits(logits),
                                     self.cfg.temperature, self.cfg.seed,
                                     uids, positions)

    @property
    def expired(self) -> List[Request]:
        """Requests shed because their deadline passed while queued."""
        return self._scheduler.expired

    def reset_stats(self) -> None:
        """Drop accumulated metrics (e.g. after a warmup run)."""
        self.metrics.reset()


class Engine(EngineBase):
    def __init__(self, model, params, cfg: ServeConfig):
        super().__init__(model, params, cfg)
        self._wall_s = 0.0          # summed sequential wave wall time

    def reset_stats(self) -> None:
        self._wall_s = 0.0
        super().reset_stats()

    def run(self) -> List[Request]:
        """Serve everything in the queue; returns completed requests."""
        done: List[Request] = []
        with torch.inference_mode():
            while len(self._scheduler):
                wave: List[Request] = []
                now = time.time()
                n_shed0 = len(self._scheduler.expired)
                while len(wave) < self.cfg.max_batch and \
                        len(self._scheduler):
                    req = self._scheduler.pop_ready(now)
                    if req is None:
                        break
                    wave.append(req)
                for _ in range(len(self._scheduler.expired) - n_shed0):
                    self.metrics.record_shed()
                if wave:
                    done.extend(self._run_wave(wave))
        return done

    def _run_wave(self, wave: List[Request]) -> List[Request]:
        cfg = self.cfg
        t0 = time.time()
        b = cfg.max_batch
        bucket = bucket_for(cfg.prefill_buckets,
                            max(len(r.prompt) for r in wave))[0]
        max_new = max(r.max_new_tokens for r in wave)

        # Left-pad prompts into the bucket (static shape).
        tokens = np.full((b, bucket), cfg.pad_id, np.int64)
        for i, r in enumerate(wave):
            r.bucket = bucket
            p = r.prompt[-bucket:]
            tokens[i, bucket - len(p):] = p

        pool = StatePool(self.model, b,
                         bucket + max(cfg.max_new_tokens, max_new),
                         self.model.cfg.dtype)
        logits, cache = self.model.prefill(
            self.params, {"tokens": torch.from_numpy(tokens).to(self.device)},
            pool.cache)
        next_tok = self._sample(logits)

        def finish(r: Request) -> None:
            r.done = True
            r.finish_s = time.time()
            r.latency_s = r.finish_s - r.arrival_s
            self.metrics.record_finish(r.latency_s, len(r.out_tokens))

        alive = np.array([True] * len(wave) + [False] * (b - len(wave)))
        t_first = time.time()
        for i, r in enumerate(wave):
            r.first_token_s = t_first
            self.metrics.record_first_token(t_first - r.arrival_s)
            self.metrics.record_token()
            r.emit(int(next_tok[i]))
            if (cfg.eos_id >= 0 and next_tok[i] == cfg.eos_id) or \
                    r.max_new_tokens == 1:
                alive[i] = False
                finish(r)

        for t in range(1, max_new):
            if not alive[:len(wave)].any():
                break
            ts0 = time.perf_counter()
            tok = torch.from_numpy(next_tok[:, None].astype(np.int64))
            logits, cache = self.model.decode_step(
                self.params, tok.to(self.device), cache, bucket + t - 1)
            next_tok = self._sample(logits)
            ts1 = time.perf_counter()
            self.metrics.record_step(int(alive[:len(wave)].sum()), ts1 - ts0)
            for i, r in enumerate(wave):
                if alive[i] and len(r.out_tokens) < r.max_new_tokens:
                    r.emit(int(next_tok[i]))
                    self.metrics.record_token()
                    if (cfg.eos_id >= 0 and next_tok[i] == cfg.eos_id) or \
                            len(r.out_tokens) >= r.max_new_tokens:
                        alive[i] = False
                        finish(r)

        for r in wave:
            if not r.done:
                finish(r)
        dt = time.time() - t0
        self._wall_s += dt
        self.metrics.record_wall(dt)
        return wave

    def stats(self, requests: List[Request]) -> Dict[str, float]:
        """Throughput over the summed sequential wave time."""
        toks = sum(len(r.out_tokens) for r in requests)
        wall = self._wall_s or (max((r.latency_s for r in requests),
                                    default=0.0))
        return {"requests": len(requests), "generated_tokens": toks,
                "tokens_per_s": toks / wall if wall else 0.0,
                "wall_s": wall}
