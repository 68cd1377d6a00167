"""Serving CLI: ``python -m repro_torch.launch.serve --arch mamba2-130m``
(or ``mamba-130m``, ``recurrentgemma-2b``, ``gemma-2b``, ``qwen1.5-4b``)
— batched random requests through the wave or continuous engine on the
GPU (or ``--device cpu``), with weights drawn from ``--seed``.

Takes the JAX CLI's flags for what the port serves: ``--engine``,
``--decode-mode`` / ``--prefill-mode`` (``naive`` = the unfused op
chains), ``--prefill-chunk`` / ``--prefill-token-budget`` (the continuous
engine's chunked prefill) and ``--quant`` (W8 weights through the
``qmatmul`` kernel; not ported for recurrentgemma and the transformer,
where any mode but ``none`` raises ``NotImplementedError``).  ActiBA has
no flag, as in the JAX CLI: it comes with the ``XambaConfig`` presets;
nor has the flash attention kernel (``use_flash``, a config override).
"""
from __future__ import annotations

import argparse
import logging

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.xamba import DECODE_MODES, PREFILL_MODES, QUANT_MODES
from repro_torch.models import build_model
from repro_torch.nn import quant
from repro_torch.nn.params import init_params
from repro_torch.serve import ContinuousEngine, Engine, ServeConfig

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
    ap.add_argument("--quant", default="none", choices=QUANT_MODES,
                    help="W8 weight-only quantization of the big linear "
                         "weights (every w8 mode runs the qmatmul kernel "
                         "on the GPU)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; 'cpu' "
                         "runs the kernels' plain PyTorch versions)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    if args.prefill_chunk and args.engine != "continuous":
        log.warning("--prefill-chunk only applies to --engine continuous; "
                    "the wave engine keeps monolithic bucketed prefill")

    cfg = get_config(args.arch, reduced=args.reduced)
    if args.quant != "none" and cfg.family in ("recurrentgemma",
                                               "transformer"):
        raise NotImplementedError(
            f"--quant {args.quant}: W8 weights for {args.arch} are not "
            f"ported yet")
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
                       prefill_token_budget=args.prefill_token_budget)
    engine_cls = ContinuousEngine if args.engine == "continuous" else Engine
    engine = engine_cls(model, params, scfg)

    rng = np.random.default_rng(args.seed)
    for _ in range(args.requests):
        plen = int(rng.integers(4, args.prompt_len + 1))
        engine.submit(rng.integers(1, cfg.vocab_size, plen).tolist())
    done = engine.run()
    for r in done[:4]:
        log.info("req %d: %d prompt toks -> %s%s", r.uid, len(r.prompt),
                 r.out_tokens[:8], "..." if len(r.out_tokens) > 8 else "")
    log.info("stats: %s", engine.stats(done))
    m = engine.metrics.summary()
    log.info("occupancy: %.2f  ttft_mean_s: %.4f  ttft_p99_s: %.4f  "
             "goodput_tok_s: %.1f  (wall source: %s)",
             m["slot_occupancy"], m["ttft_mean_s"], m["ttft_p99_s"],
             m["goodput_tokens_per_s"], m["wall_source"])
    return engine, done


if __name__ == "__main__":
    main()
