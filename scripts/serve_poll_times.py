#!/usr/bin/env python3
"""The untraced continuous serve loop of one tree of the port on one GPU:
``python3 scripts/serve_poll_times.py [--src DIR] [--runs N]``.

Serves, through the engine of the port found under ``--src`` (default:
this checkout's ``src``), ``chip_smoke.py`` phase 4h's workload with
tracing off: mamba2-130m at full width, bf16, random weights from seed
0, the continuous engine with chunk 64, batch 4, 12 requests of 4-128
prompt tokens, 16 greedy tokens each.  One warm run, then ``--runs``
runs, each timing every ``poll()`` on the host clock (a poll ends on the
logits' copy to the host, so its wall holds its device work).  To compare
two trees, unpack the other one (``git archive``) into a git-ignored
directory and run the script once per tree in one call, in turns (old,
new, new, old).  Prints one JSON line per tree, with the tree's ``src``
and the card's name and power limit: ``tokens_per_s`` and
``poll_ms_median`` of each run, and ``decode_poll_ms_median``, the
median over every run of the polls that ran no prefill chunk.

Exits 1 without a GPU.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the tree's src directory (repro_torch inside)")
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("serve_poll_times: no CUDA device", file=sys.stderr)
        return 1
    src = pathlib.Path(args.src).resolve()
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import build_model
    from repro_torch.nn.params import init_params
    from repro_torch.serve import ContinuousEngine, ServeConfig
    dev = torch.device("cuda", 0)
    build.build_all()
    cfg = get_config("mamba2-130m")
    model = build_model(cfg, dev)
    params = init_params(model.param_specs(), 0, cfg.dtype, dev)
    engine = ContinuousEngine(model, params, ServeConfig(
        max_batch=4, prefill_buckets=(32, 128), max_new_tokens=16,
        prefill_chunk=64))
    prompts = cs._trace_prompts(cfg, shared=False)
    rates, medians, decode_polls = [], [], []
    with torch.inference_mode():
        for run in range(args.runs + 1):
            for p in prompts:
                engine.submit(p)
            polls, tokens = [], 0
            t0 = time.perf_counter()
            while engine.busy:
                chunks = engine.metrics.prefill_chunks
                t = time.perf_counter()
                done = engine.poll()
                dt = time.perf_counter() - t
                polls.append(dt)
                if run and engine.metrics.prefill_chunks == chunks:
                    decode_polls.append(dt)
                tokens += sum(len(r.out_tokens) for r in done)
            wall = time.perf_counter() - t0
            if run:                                 # run 0 warms
                rates.append(tokens / wall)
                medians.append(statistics.median(polls) * 1e3)
    print(json.dumps({
        "src": str(src), "card": cs._nvidia_smi(), "runs": args.runs,
        "tokens_per_s": [round(r, 1) for r in rates],
        "poll_ms_median": [round(m, 4) for m in medians],
        "decode_poll_ms_median":
            round(statistics.median(decode_polls) * 1e3, 4)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
