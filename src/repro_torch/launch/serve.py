"""Serving CLI: ``python -m repro_torch.launch.serve --arch mamba2-130m``
(or ``mamba-130m``, ``recurrentgemma-2b``, ``gemma-2b``, ``qwen1.5-4b``)
— batched random requests through the wave or continuous engine on the
GPU (or ``--device cpu``), with weights drawn from ``--seed``.

Takes the JAX CLI's flags for what the port serves: ``--engine``,
``--decode-mode`` / ``--prefill-mode`` (``naive`` = the unfused op
chains), ``--prefill-chunk`` / ``--prefill-token-budget`` (the continuous
engine's chunked prefill), ``--speculate-k`` (self-speculative bursts
with a W8 draft), ``--prefix-cache-mb`` / ``--prefix-chunk`` /
``--shared-prefix`` (the prefix-state cache, and requests that share a
prompt prefix to exercise it) and ``--quant`` (W8 weights through the
``qmatmul`` kernel, every family).  ActiBA has no flag, as in the JAX
CLI: it comes with the ``XambaConfig`` presets; nor has the flash
attention kernel (``use_flash``, a config override).

``--trace PATH`` records per-request span traces (Chrome/Perfetto JSON at
PATH plus a ``.jsonl`` event log beside it; fold them with ``python -m
repro_torch.launch.trace_report PATH``); ``--metrics-every N`` emits a
metrics snapshot every N polls; ``--strict-recompile`` makes a program
that meets a new signature or builds a kernel after warmup raise.

The robustness flags are the JAX CLI's: ``--fault-plan SPEC`` (chaos
faults on the continuous engine's poll clock, e.g. ``'poison@4:slot=1'``),
``--poison-probe off|logits|state`` and ``--poison-check-every``,
``--watchdog-s`` / ``--watchdog-action log|recover`` with
``--max-retries`` and ``--retry-backoff-s``, ``--max-queue-depth``,
``--overload-queue-depth`` / ``--overload-ttft-p95-s``,
``--shed-inflight``, and ``--flight-records N`` / ``--flight-path PATH``
(render the dumps with ``python -m repro_torch.launch.trace_report
--flight PATH``).  ``--no-backend-fallback`` is accepted and changes
nothing: the port has no fallback, a failed kernel raises.
"""
from __future__ import annotations

import argparse
import logging
import os

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.xamba import DECODE_MODES, PREFILL_MODES, QUANT_MODES
from repro_torch.models import build_model
from repro_torch.nn import quant
from repro_torch.nn.params import init_params
from repro_torch.serve import ContinuousEngine, Engine, ServeConfig
from repro_torch.serve.engine import require_servable

log = logging.getLogger("repro_torch.serve")


def main(argv=None):
    """Run the CLI; returns ``(engine, completed requests)``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--engine", choices=("wave", "continuous"),
                    default="wave")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--policy", choices=("fcfs", "priority"),
                    default="fcfs")
    ap.add_argument("--decode-mode", default=None, choices=DECODE_MODES,
                    help="XambaConfig.decode mode for the single-token "
                         "step (naive = the unfused op chain)")
    ap.add_argument("--prefill-mode", default=None, choices=PREFILL_MODES,
                    help="XambaConfig.prefill mode for the multi-token "
                         "prefill (naive = the unfused op chain)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked prefill: prompts advance this many tokens "
                         "per engine step, interleaved with decode "
                         "(continuous engine only; default: monolithic "
                         "bucketed prefill)")
    ap.add_argument("--prefill-token-budget", type=int, default=0,
                    help="max prefill tokens per engine step under "
                         "--prefill-chunk (0 = one chunk call per step)")
    ap.add_argument("--prefix-cache-mb", type=float, default=0.0,
                    help="prefix-state cache budget in MB: admissions "
                         "reuse chunk-boundary state snapshots of "
                         "previously served prompt prefixes (continuous "
                         "engine, requires --prefill-chunk; 0 = off)")
    ap.add_argument("--prefix-chunk", type=int, default=None,
                    help="snapshot granularity in tokens (multiple of "
                         "--prefill-chunk; default: one snapshot per "
                         "prefill chunk)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend this many shared 'system prompt' tokens "
                         "to every request (exercises the prefix cache)")
    ap.add_argument("--speculate-k", type=int, default=0, metavar="K",
                    help="self-speculative decoding: draft K tokens per "
                         "burst with w8 params, verify them in one batched "
                         "full-precision step, roll back rejected drafts "
                         "via state snapshots (continuous engine only; "
                         "outputs are plain decode's up to rounding: the "
                         "verify window and the decode step round apart, "
                         "so greedy picks may part where the top two "
                         "logits lie within that gap; 0 = off)")
    ap.add_argument("--quant", default="none", choices=QUANT_MODES,
                    help="W8 weight-only quantization of the big linear "
                         "weights (every w8 mode runs the qmatmul kernel "
                         "on the GPU)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; 'cpu' "
                         "runs the kernels' plain PyTorch versions)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record a span trace: Chrome/Perfetto JSON at "
                         "PATH + a JSONL event log at PATH with a .jsonl "
                         "suffix (analyze with "
                         "repro_torch.launch.trace_report)")
    ap.add_argument("--metrics-every", type=int, default=0, metavar="N",
                    help="emit a metrics snapshot every N engine polls "
                         "(0 = off; snapshots also land in the trace)")
    ap.add_argument("--strict-recompile", action="store_true",
                    help="raise RecompileError if a compile-once program "
                         "(decode / prefill_chunk) retraces after warmup "
                         "(here: meets a new signature or builds a kernel)")
    ap.add_argument("--watchdog-s", type=float, default=0.0,
                    help="flag the run as hung if no engine step completes "
                         "for this many seconds (0 = off)")
    ap.add_argument("--watchdog-action", choices=("log", "recover"),
                    default="log",
                    help="hang-watchdog escalation: 'recover' aborts the "
                         "stuck burst at the next poll and requeues its "
                         "requests with bounded retries")
    ap.add_argument("--fault-plan", default=None, metavar="SPEC",
                    help="chaos fault-injection schedule, e.g. "
                         "'poison@5:slot=1;fail@8:program=decode;"
                         "stall@12:stall_s=0.2' (continuous engine; see "
                         "repro_torch.runtime.faults.parse_plan)")
    ap.add_argument("--max-queue-depth", type=int, default=0,
                    help="bounded admission queue: submit() rejects once "
                         "this many requests queue (0 = unbounded)")
    ap.add_argument("--overload-queue-depth", type=int, default=0,
                    help="enter degraded overload mode at this queue depth "
                         "(prefill budget 0, speculation paused; 0 = off)")
    ap.add_argument("--overload-ttft-p95-s", type=float, default=0.0,
                    help="also enter degraded mode when TTFT p95 crosses "
                         "this many seconds (0 = off)")
    ap.add_argument("--poison-probe", choices=("off", "logits", "state"),
                    default="off",
                    help="NaN/Inf quarantine probes: 'logits' checks the "
                         "step's host logits, 'state' adds a per-row state "
                         "finiteness reduction on the device")
    ap.add_argument("--poison-check-every", type=int, default=1,
                    help="run poison probes every N polls (amortizes the "
                         "'state' probe)")
    ap.add_argument("--no-backend-fallback", action="store_true",
                    help="accepted for the JAX CLI's sake and changes "
                         "nothing: the port has no backend fallback, a "
                         "failed kernel raises")
    ap.add_argument("--max-retries", type=int, default=1,
                    help="watchdog-recovery requeue budget per request")
    ap.add_argument("--retry-backoff-s", type=float, default=0.0,
                    help="base for exponential retry backoff (0 = requeue "
                         "immediately)")
    ap.add_argument("--shed-inflight", action="store_true",
                    help="also shed staged/decoding requests whose deadline "
                         "passed (default: deadlines only shed queued work)")
    ap.add_argument("--flight-records", type=int, default=0, metavar="N",
                    help="keep a flight-recorder ring of the last N "
                         "request timelines, dumped to --flight-path on "
                         "fault events (0 = off; continuous engine only)")
    ap.add_argument("--flight-path", default=None, metavar="PATH",
                    help="JSONL file for flight-recorder fault dumps "
                         "(render with repro_torch.launch.trace_report "
                         "--flight PATH)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    if args.prefill_chunk and args.engine != "continuous":
        log.warning("--prefill-chunk only applies to --engine continuous; "
                    "the wave engine keeps monolithic bucketed prefill")
    if args.speculate_k and args.engine != "continuous":
        log.warning("--speculate-k only applies to --engine continuous")
    if args.speculate_k and args.quant != "none":
        log.warning("--speculate-k with --quant %s: the draft params are "
                    "a re-quantization of already-quantized weights: the "
                    "draft/verify gap (and the speedup) collapses",
                    args.quant)
    if args.prefix_cache_mb and args.engine != "continuous":
        log.warning("--prefix-cache-mb only applies to --engine continuous")

    cfg = get_config(args.arch, reduced=args.reduced)
    require_servable(cfg)
    if args.decode_mode:
        cfg = cfg.with_decode_mode(args.decode_mode)
    if args.prefill_mode:
        cfg = cfg.with_prefill_mode(args.prefill_mode)
    if args.quant != "none":
        cfg = cfg.with_quant(args.quant)
    model = build_model(cfg, args.device)
    params = init_params(model.param_specs(), args.seed, cfg.dtype,
                         model.device)
    if args.quant != "none":
        params = quant.quantize_params_for_mode(params, args.quant)
        s = quant.quant_summary(params)
        log.info("quant %s: %d tensors int8, %.1f MB (%.2fx vs fp32)",
                 args.quant, s["quantized_tensors"], s["bytes"] / 1e6,
                 s["compression"])
    scfg = ServeConfig(max_batch=args.batch, prefill_buckets=(32, 128),
                       max_new_tokens=args.max_new,
                       temperature=args.temperature, seed=args.seed,
                       policy=args.policy,
                       prefill_chunk=(args.prefill_chunk
                                      if args.engine == "continuous"
                                      else None),
                       prefill_token_budget=args.prefill_token_budget,
                       prefix_cache_mb=(args.prefix_cache_mb
                                        if args.engine == "continuous"
                                        else 0.0),
                       prefix_chunk=args.prefix_chunk,
                       speculate_k=(args.speculate_k
                                    if args.engine == "continuous" else 0),
                       trace=args.trace, metrics_every=args.metrics_every,
                       strict_recompile=args.strict_recompile,
                       watchdog_s=args.watchdog_s,
                       watchdog_action=args.watchdog_action,
                       fault_plan=(args.fault_plan
                                   if args.engine == "continuous" else None),
                       max_queue_depth=args.max_queue_depth,
                       overload_queue_depth=args.overload_queue_depth,
                       overload_ttft_p95_s=args.overload_ttft_p95_s,
                       poison_probe=(args.poison_probe
                                     if args.engine == "continuous"
                                     else "off"),
                       poison_check_every=args.poison_check_every,
                       max_retries=args.max_retries,
                       retry_backoff_s=args.retry_backoff_s,
                       shed_inflight=args.shed_inflight,
                       flight_records=(args.flight_records
                                       if args.engine == "continuous"
                                       else 0),
                       flight_path=args.flight_path)
    engine_cls = ContinuousEngine if args.engine == "continuous" else Engine
    engine = engine_cls(model, params, scfg)

    rng = np.random.default_rng(args.seed)
    shared = rng.integers(1, cfg.vocab_size, args.shared_prefix).tolist()
    for _ in range(args.requests):
        plen = int(rng.integers(4, args.prompt_len + 1))
        # Suffix lengths in whole prefill chunks keep the padded streams
        # aligned, so that the shared prefix hits.
        if args.shared_prefix and args.prefill_chunk:
            plen = max(args.prefill_chunk,
                       plen - plen % args.prefill_chunk)
        engine.submit(shared + rng.integers(1, cfg.vocab_size,
                                            plen).tolist())
    try:
        done = engine.run()
    finally:
        engine.close()
    for r in done[:4]:
        log.info("req %d: %d prompt toks -> %s%s", r.uid, len(r.prompt),
                 r.out_tokens[:8], "..." if len(r.out_tokens) > 8 else "")
    log.info("stats: %s", engine.stats(done))
    m = engine.metrics.summary()
    log.info("occupancy: %.2f  ttft_mean_s: %.4f  ttft_p99_s: %.4f  "
             "goodput_tok_s: %.1f  (wall source: %s)",
             m["slot_occupancy"], m["ttft_mean_s"], m["ttft_p99_s"],
             m["goodput_tokens_per_s"], m["wall_source"])
    if m["spec_bursts"]:
        log.info("speculative: %d bursts  accept_rate %.3f  "
                 "tokens_per_verify %.2f  rollbacks %d",
                 m["spec_bursts"], m["spec_accept_rate"],
                 m["spec_tokens_per_verify"], m["spec_rollbacks"])
    if m["prefix_hits"] or m["prefix_misses"]:
        log.info("prefix cache: %d hits  %d misses  %d hit tokens",
                 m["prefix_hits"], m["prefix_misses"],
                 m["prefix_hit_tokens"])
    if m["stragglers_decode"] or m["stragglers_prefill"] or \
            m["watchdog_fires"]:
        log.warning("health: %d decode stragglers, %d prefill stragglers, "
                    "%d watchdog fires", m["stragglers_decode"],
                    m["stragglers_prefill"], m["watchdog_fires"])
    if m["rejected"] or m["quarantined"] or m["shed"] or \
            m["watchdog_recoveries"]:
        log.warning("robustness: %d rejected, %d quarantined, %d shed %s, "
                    "%d backend fallbacks, %d watchdog recoveries, "
                    "%d retries", m["rejected"], m["quarantined"], m["shed"],
                    m["shed_reasons"], m["backend_fallbacks"],
                    m["watchdog_recoveries"], m["retries"])
    trips = {k: s.trips for k, s in engine.sentinels.items() if s.trips}
    if trips:
        log.warning("recompile sentinels tripped: %s", trips)
    log.info("compile counters: %s", engine.counters)
    if args.trace:
        engine.tracer.save(args.trace)
        jsonl = os.path.splitext(args.trace)[0] + ".jsonl"
        engine.tracer.save_jsonl(jsonl)
        log.info("trace: %d events -> %s (+ %s); analyze with "
                 "python -m repro_torch.launch.trace_report %s",
                 len(engine.tracer.events), args.trace, jsonl, args.trace)
    return engine, done


if __name__ == "__main__":
    main()
