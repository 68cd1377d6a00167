#!/usr/bin/env python3
"""What a fresh process pays before its first full-width train step runs
at speed: ``python3 scripts/rank_warmup.py`` on a machine with a GPU.

Builds the port's kernels, then starts 1 and then 4 ranks
(``distributed/launch.py: spawn``, all on card 0).  Each rank builds
mamba2-130m at full width (bf16, ``remat`` full), draws its params from
seed 0 and a b = 4, l = 512 batch, and times, synchronised: the set-up,
one ``loss`` forward without gradients, the first forward and backward
(``train/step.py: compute_grads``) and the second.  Prints one line per
world size with each rank's four seconds and the spawn's wall seconds
(phase 4n of ``chip_smoke.py`` pays the first backward's cost once in
every rank).  Exits 1 without a GPU.
"""
from __future__ import annotations

import pathlib
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))


def rank_times(rank, world, _):
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM, to_device_batch
    from repro_torch.models import build_model
    from repro_torch.train import TrainConfig, init_state
    from repro_torch.train.step import compute_grads
    dev = torch.device("cuda", 0)
    marks = [time.perf_counter()]

    def mark():
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
    cfg = get_config("mamba2-130m")
    model = build_model(cfg, dev)
    params = init_state(model, 0, TrainConfig())["params"]
    batch = to_device_batch(SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=512, global_batch=4)).next(), dev)
    mark()
    with torch.no_grad():
        model.loss(params, batch)
    mark()
    compute_grads(model, params, batch)
    mark()
    compute_grads(model, params, batch)
    mark()
    return [round(b - a, 3) for a, b in zip(marks, marks[1:])]


def main() -> int:
    if not torch.cuda.is_available():
        print("rank_warmup: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.distributed import launch
    from repro_torch.kernels import build
    build.build_all()
    import subprocess
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for world in (1, 4):
        t0 = time.perf_counter()
        got = launch.spawn(rank_times, world, (None,), device="cuda")
        print(f"{world} ranks (set-up, forward, first forward+backward, "
              f"second): {got}; spawn {time.perf_counter() - t0:.1f} s",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
