#!/usr/bin/env python3
"""The decode-step kernels of one tree of the port on one GPU:
``python3 scripts/step_kernel_times.py [--src DIR]``.

Times, through the wrappers of the port found under ``--src`` (default:
this checkout's ``src``), at b = 4, bf16, full width: TPU kernel 5
(``mamba1_step``, mamba-130m's shapes), kernel 6 (``rglru_step``,
recurrentgemma-2b's, warm and with its gates cold), kernel 10's GEMV
(mamba2-130m's W8 in_proj and out_proj) and kernel 11's GEMV
(recurrentgemma-2b's gated MLP), then mamba-130m's and
recurrentgemma-2b's decode steps at full width and depth.  Inputs,
seeds, the cold rotation and the timers are ``chip_smoke.py``'s (phase
7), so two trees see the same numbers: unpack the other tree (``git
archive``) into a git-ignored directory and run the script once per tree
in one call, in turns (old, new, new, old).  Prints one JSON line per
reading, each with the tree's ``src`` and the card's name and power
limit:

* a kernel: ``ms``, the call (CUDA events, median of 30); ``device_ms``,
  every kernel the call launches (``torch.profiler``, 10 calls);
  ``host_us``, the wrapper's host time a call (1000 calls, no
  synchronisation); kernel 6 also ``cold_ms`` and ``cold_device_ms``;
* a decode step: ``wall_ms`` (median of five runs of 10 steps, host
  clock around synchronised runs) and ``device_ms`` (profiler), with the
  kernel's share of the device time and its launches.

Exits 1 without a GPU.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _kernel_rows(cs, emit, dev):
    import torch
    from repro_torch.core.pwl import table_for
    from repro_torch.core.xamba import XambaConfig
    from repro_torch.kernels import decode_step as ds, matmul_pwl, qmatmul
    bf16 = torch.bfloat16

    def row(kernel, call, **extra):
        emit(kernel=kernel, b=4, ms=cs.time_call(call),
             device_ms=sum(cs.device_profile(call).values()),
             host_us=cs.host_us(call), **extra)

    m1 = cs.mamba1_inputs(4, dev, bf16, seed=70)
    row("mamba1_step", lambda: ds.mamba1_step(**m1, dt_rank=cs.M1_DT_RANK))
    rg = cs.rglru_inputs(4, dev, bf16, seed=100)
    cold, mb = cs.rglru_cold(ds.rglru_step, rg)
    row("rglru_step", lambda: ds.rglru_step(**rg),
        cold_ms=cs.time_call(cold, n=30),
        cold_device_ms=sum(cs.device_profile(cold, n=30).values()),
        cold_mb=mb)
    del cold
    for proj, k, n in (("in_proj", cs.D_MODEL, cs.D_IN_PROJ),
                       ("out_proj", cs.D_INNER, cs.D_MODEL)):
        args, _ = cs.qmatmul_inputs(4, k, n, dev, bf16, seed=44 + n)
        row(f"qmatmul gemv {proj}", lambda: qmatmul.qmatmul(*args))
    x, w, v = cs.mpwl_inputs(4, dev, bf16, seed=106, gated=True)
    gelu = table_for("gelu", XambaConfig.pallas())
    row("matmul_pwl gemv gated",
        lambda: matmul_pwl.matmul_pwl(x, w, gelu, v))


def _step_rows(cs, emit, dev):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_step as ds
    from repro_torch.models import build_model
    from repro_torch.nn.params import init_params
    for arch, kernel in (("mamba-130m", "mamba1_step"),
                         ("recurrentgemma-2b", "rglru_step")):
        cfg = get_config(arch)
        model = build_model(cfg, dev)
        params = model.decode_view(init_params(model.param_specs(), 0,
                                               torch.bfloat16, dev))
        toks = torch.ones((4, 16), dtype=torch.long, device=dev)
        _, cache = model.prefill(params, {"tokens": toks},
                                 model.init_cache(4, 17, torch.bfloat16))
        tok = toks[:, :1]
        step = lambda: model.decode_step(params, tok, cache, 16)  # noqa
        step()
        torch.cuda.synchronize()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(10):
                step()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) / 10 * 1e3)
        before = getattr(ds, kernel).launches
        step()
        launches = getattr(ds, kernel).launches - before
        by = cs.device_profile(step)
        emit(step=arch, b=4, wall_ms=sorted(walls)[2], walls_ms=walls,
             device_ms=sum(by.values()), kernel=kernel,
             kernel_device_ms=sum(v for k, v in by.items() if kernel in k),
             launches_a_step=launches)
        del model, params, cache
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the tree's src directory (repro_torch inside)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("step_kernel_times: no CUDA device", file=sys.stderr)
        return 1
    src = pathlib.Path(args.src).resolve()
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = cs._nvidia_smi()

    def emit(**row):
        print(json.dumps(dict(src=str(src), card=card, **row)), flush=True)
    build.build_all()
    with torch.inference_mode():
        _kernel_rows(cs, emit, dev)
        _step_rows(cs, emit, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
