"""Training driver: ``python -m repro_torch.launch.train --arch
mamba2-130m ...`` (the port of ``repro.launch.train``).

Wires the training stack together: config registry -> model -> state
(params from ``--seed``, AdamW) -> synthetic data (``SyntheticLM``)
behind a prefetch thread -> train step -> step monitor -> async atomic
checkpoints in the JAX package's layout -> resume from the latest
checkpoint with its data step.  Takes the JAX CLI's flags plus
``--device`` (default ``cuda``; ``--device cpu --reduced`` on a machine
without a card).  ``--mesh SHAPE:AXES`` (JAX's syntax, e.g.
``1x1:data,model``) takes the mesh the devices hold: the state is placed
by the logical rules (``runtime/elastic.py: reshard_state``) and the
mesh passed to ``make_train_step``; a mesh wider than the devices exits
with its reason.

The checkpoint's ``data_step`` is the step of the next batch the loop
would consume, so a resumed run sees the batches the uninterrupted run
saw.  (The JAX driver stores the data iterator's own counter, which the
prefetch thread has already moved ahead.)
"""
from __future__ import annotations

import argparse
import logging
import math
import time

from repro_torch.checkpoint import AsyncCheckpointer, ckpt
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, PrefetchIterator, SyntheticLM, \
    to_device_batch
from repro_torch.distributed.sharding import make_shardings
from repro_torch.launch.mesh import describe, make_mesh
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig, ScheduleConfig
from repro_torch.runtime import StepMonitor, reshard_state
from repro_torch.train import TrainConfig, init_state, make_train_step

log = logging.getLogger("repro_torch.train")


def main(argv=None):
    """Run the CLI; returns ``(state, monitor)``."""
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
                    help="SHAPE:AXES, e.g. 1x1:data,model (one device)")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda; 'cpu' "
                         "runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    mesh = None
    if args.mesh:
        try:
            shape_s, axes_s = args.mesh.split(":")
            shape = [int(x) for x in shape_s.split("x")]
            mesh = make_mesh(shape, axes_s.split(","),
                             devices=[args.device] * math.prod(shape))
        except (NotImplementedError, ValueError) as e:
            ap.exit(2, f"--mesh {args.mesh}: {e}\n")
    logging.basicConfig(level=logging.INFO, format="%(message)s")

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
    ckptr = None
    if args.ckpt_dir:
        ckptr = AsyncCheckpointer(args.ckpt_dir, cfg=cfg)
        if ckpt.latest_step(args.ckpt_dir) is not None:
            state, start_step, extra = ckpt.restore(args.ckpt_dir, state,
                                                    cfg=cfg)
            data_start = extra.get("data_step", start_step)
            log.info("resumed from step %d", start_step)
    if mesh is not None:
        _, report = make_shardings(model.param_specs(), mesh)
        log.info("mesh %s; sharding: %s", describe(mesh), report.summary())
        state = reshard_state(state, model.param_specs(), mesh)
    it = PrefetchIterator(iter(SyntheticLM(dcfg, start_step=data_start)))

    def data_step(step):
        """The data step of the batch after training step ``step``."""
        return data_start + step + 1 - start_step

    monitor = StepMonitor()
    for step in range(start_step, args.steps):
        batch = to_device_batch(next(it), model.device)
        t0 = time.time()
        state, metrics = step_fn(state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        rec = monitor.observe(step, time.time() - t0)
        if step % args.log_every == 0 or step == args.steps - 1:
            log.info("step %4d  loss %.4f  acc %.3f  gnorm %.2f  "
                     "%.2fs%s", step, metrics["loss"],
                     metrics["accuracy"], metrics["grad_norm"],
                     rec.seconds, "  [straggler]" if rec.straggler else "")
        if ckptr and (step + 1) % args.ckpt_every == 0:
            ckptr.save(step + 1, state, {"data_step": data_step(step)})
    if ckptr:
        ckptr.save(args.steps, state,
                   {"data_step": data_step(args.steps - 1)})
        ckptr.wait()
    log.info("done: %s", monitor.summary())
    return state, monitor


if __name__ == "__main__":
    main()
