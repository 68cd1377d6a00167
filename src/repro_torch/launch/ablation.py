"""XAMBA technique ablation (the paper's Fig. 4a; the port of
``examples/xamba_ablation.py``): ``MambaLM.forward`` under baseline ->
+CumBA -> +ReduBA -> +CumBA+ReduBA -> +ActiBA, and the kernel-backed
``pallas()`` preset, with the time per forward and top-1 agreement with
the baseline's (exact) logits.

    python -m repro_torch.launch.ablation                  # on the GPU
    python -m repro_torch.launch.ablation --device cpu --reduced

The default sequence length, 300, is not a multiple of the 256-token
chunk, so every variant runs the unfused prefill chain (padded to 512
inside ``core/ssd.py: ssd``), where the techniques act.  Weights are
random, drawn from ``--seed``, in fp32.  Times on the GPU are CUDA-event
medians; on the CPU they are host-clock medians of the plain versions.
"""
from __future__ import annotations

import argparse
import statistics
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.xamba import XambaConfig
from repro_torch.models import build_model
from repro_torch.nn.params import init_params

VARIANTS: Tuple[Tuple[str, XambaConfig], ...] = (
    ("baseline", XambaConfig.baseline()),
    ("+CumBA", XambaConfig(cumba="cumba", reduba="naive")),
    ("+ReduBA", XambaConfig(cumba="naive", reduba="reduba")),
    ("+CumBA+ReduBA", XambaConfig.optimized()),
    ("+ActiBA (k=32)", XambaConfig.full(segments=32)),
    ("pallas", XambaConfig.pallas()),
)


def time_forward(model, params, tokens: torch.Tensor, iters: int) -> float:
    """Median milliseconds per ``forward`` after one warm-up call."""
    cuda = tokens.is_cuda
    model.forward(params, tokens)
    times = []
    for _ in range(iters):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            model.forward(params, tokens)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            model.forward(params, tokens)
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def run(cfg, device, *, batch: int, seqlen: int, seed: int, iters: int,
        first_forward: Optional[Callable] = None) -> Dict[str, dict]:
    """Every variant's logits (on the host) and ms per forward, keyed by
    name, in ``VARIANTS`` order.  ``first_forward(name, model, params,
    tokens)``, if given, runs each variant's first (untimed) forward in
    place of ``model.forward`` and returns its logits: the caller's place
    to count, trace or record that call."""
    cfg = cfg.replace(param_dtype="float32")
    probe = build_model(cfg, device)
    params = init_params(probe.param_specs(), seed, torch.float32,
                         probe.device)
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, size=(batch, seqlen)).astype(np.int64)).to(
            probe.device)
    out = {}
    with torch.inference_mode():
        for name, xamba in VARIANTS:
            model = build_model(cfg.replace(xamba=xamba), probe.device)
            fwd = first_forward or (lambda _, m, p, t: m.forward(p, t))
            logits = fwd(name, model, params, tokens).cpu()
            ms = time_forward(model, params, tokens, iters)
            out[name] = dict(logits=logits, ms=ms)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seqlen", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the "
                         "kernels' plain PyTorch versions)")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch, reduced=args.reduced)
    res = run(cfg, args.device, batch=args.batch, seqlen=args.seqlen,
              seed=args.seed, iters=args.iters)
    exact = res["baseline"]
    print(f"{'variant':18s} {'ms/fwd':>9s} {'speedup':>8s} "
          f"{'top1 vs exact':>14s}")
    for name, r in res.items():
        top1 = float((r["logits"].argmax(-1) ==
                      exact["logits"].argmax(-1)).float().mean())
        print(f"{name:18s} {r['ms']:9.3f} {exact['ms'] / r['ms']:7.2f}x "
              f"{top1:14.4f}")
    return res


if __name__ == "__main__":
    main()
