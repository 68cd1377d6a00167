"""Training driver: ``python -m repro_torch.launch.train --arch
mamba2-130m ...`` (the port of ``repro.launch.train``).

Wires the training stack together: config registry -> model -> state
(params from ``--seed``, AdamW) -> synthetic data (``SyntheticLM``)
behind a prefetch thread -> train step -> step monitor -> async atomic
checkpoints in the JAX package's layout -> resume from the latest
checkpoint with its data step.  Takes the JAX CLI's flags plus
``--device`` (default ``cuda``; ``--device cpu --reduced`` on a machine
without a card).  ``--mesh SHAPE:AXES`` (JAX's syntax, e.g.
``2x2:data,model``) trains on that mesh: a mesh of n > 1 devices starts
n ranks on ``--device`` (``distributed/launch.py: spawn``, with no
deadline, as a run without ``--mesh`` has none; on ``cuda`` they share
card 0), each holding its shards of the state (placed by the
logical rules, ``train/step.py: shard_state``) and its rows of every
batch (``data/pipeline.py: host_local_slice``), and rank 0 logs and
writes the checkpoints (gathered, synchronously).  ``main`` returns rank
0's ``(state, monitor)`` with the state gathered whole on the CPU.  A
mesh of one device places the state whole on it.

The checkpoint's ``data_step`` is the step of the next batch the loop
would consume, so a resumed run sees the batches the uninterrupted run
saw.  (The JAX driver stores the data iterator's own counter, which the
prefetch thread has already moved ahead.)
"""
from __future__ import annotations

import argparse
import logging
import math
import sys
import time

import torch

from repro_torch.checkpoint import AsyncCheckpointer, ckpt
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, PrefetchIterator, SyntheticLM, \
    host_local_slice, to_device_batch
from repro_torch.distributed import launch as ranks, programs
from repro_torch.distributed.sharding import make_shardings
from repro_torch.launch.mesh import describe, make_mesh
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig, ScheduleConfig
from repro_torch.runtime import StepMonitor
from repro_torch.train import TrainConfig, init_state, make_train_step
from repro_torch.train.step import param_shardings, shard_state

log = logging.getLogger("repro_torch.train")


def main(argv=None):
    """Run the CLI; returns ``(state, monitor)``."""
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default="",
                    help="SHAPE:AXES, e.g. 2x2:data,model (one rank a "
                         "device)")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda; 'cpu' "
                         "runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    mesh = None
    if args.mesh:
        try:
            shape, axes = parse_mesh(args.mesh, args.batch)
        except ValueError as e:
            ap.exit(2, f"--mesh {args.mesh}: {e}\n")
        n = math.prod(shape)
        dist = torch.distributed
        if n > 1 and not dist.is_initialized():
            return ranks.spawn(programs.train_cli_rank, n, (argv,),
                               device=args.device, timeout_s=None)[0]
        mesh = make_mesh(shape, axes, devices=[args.device] * n)
    lead = mesh is None or not mesh.ranked or \
        torch.distributed.get_rank() == 0
    logging.basicConfig(level=logging.INFO if lead else logging.WARNING,
                        format="%(message)s")

    cfg = get_config(args.arch, reduced=args.reduced)
    if cfg.family == "whisper":
        ap.exit(2, f"--arch {args.arch}: the data pipeline yields tokens "
                   f"only, and whisper's loss needs frames\n")
    model = build_model(cfg, args.device)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch, seed=args.seed)
    train_cfg = TrainConfig(
        optimizer=AdamWConfig(),
        schedule=ScheduleConfig(base_lr=args.lr, warmup_steps=args.warmup,
                                total_steps=max(args.steps, 2)),
        microbatches=args.microbatches)
    state = init_state(model, args.seed, train_cfg)
    step_fn = make_train_step(model, train_cfg) if mesh is None else \
        make_train_step(model, train_cfg, mesh)

    start_step, data_start = 0, 0
    ckptr, shardings = None, None
    ranked = mesh is not None and mesh.ranked
    if args.ckpt_dir:
        if not ranked:
            ckptr = AsyncCheckpointer(args.ckpt_dir, cfg=cfg)
        if ckpt.latest_step(args.ckpt_dir) is not None:
            state, start_step, extra = ckpt.restore(args.ckpt_dir, state,
                                                    cfg=cfg)
            data_start = extra.get("data_step", start_step)
            log.info("resumed from step %d", start_step)
    rows = slice(None)
    if mesh is not None:
        _, report = make_shardings(model.param_specs(), mesh)
        log.info("mesh %s; sharding: %s", describe(mesh), report.summary())
        state = shard_state(state, model, train_cfg, mesh)
        shardings = param_shardings(model, train_cfg, mesh)
        if ranked:
            rows = host_local_slice(args.batch, mesh)

    def save(step, extra):
        if ckptr is not None:
            ckptr.save(step, state, extra)
        elif args.ckpt_dir:
            ckpt.save(args.ckpt_dir, step, state, extra, cfg=cfg,
                      shardings=shardings)
    it = PrefetchIterator(iter(SyntheticLM(dcfg, start_step=data_start)))

    def data_step(step):
        """The data step of the batch after training step ``step``."""
        return data_start + step + 1 - start_step

    monitor = StepMonitor()
    for step in range(start_step, args.steps):
        batch = to_device_batch({k: v[rows] for k, v in next(it).items()},
                                model.device)
        t0 = time.time()
        state, metrics = step_fn(state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        rec = monitor.observe(step, time.time() - t0)
        if step % args.log_every == 0 or step == args.steps - 1:
            log.info("step %4d  loss %.4f  acc %.3f  gnorm %.2f  "
                     "%.2fs%s", step, metrics["loss"],
                     metrics["accuracy"], metrics["grad_norm"],
                     rec.seconds, "  [straggler]" if rec.straggler else "")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            save(step + 1, {"data_step": data_step(step)})
    if args.ckpt_dir:
        save(args.steps, {"data_step": data_step(args.steps - 1)})
    if ckptr:
        ckptr.wait()
    if ranked:
        state = ckpt.gathered(state, shardings)
    log.info("done: %s", monitor.summary())
    return state, monitor


def parse_mesh(text: str, batch: int):
    """``SHAPE:AXES`` -> (shape, axes); the batch must split over the
    mesh's batch axes (``pod``, ``data``)."""
    shape_s, axes_s = text.split(":")
    shape = [int(x) for x in shape_s.split("x")]
    axes = axes_s.split(",")
    if len(shape) != len(axes) or min(shape) < 1:
        raise ValueError(f"shape {shape} and axes {axes} do not match")
    unknown = set(axes) - {"pod", "data", "model"}
    if unknown or len(set(axes)) != len(axes):
        raise ValueError(f"axes {axes}: each of pod, data, model at most "
                         f"once")
    n_batch = math.prod(s for s, a in zip(shape, axes) if a != "model")
    if batch % n_batch:
        raise ValueError(f"a batch of {batch} does not split over the "
                         f"batch axes' {n_batch} ranks")
    return shape, axes


if __name__ == "__main__":
    main()
