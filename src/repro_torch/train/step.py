"""Train step factory: loss -> grads -> AdamW, with microbatch
accumulation (the port of ``repro.train.step``).

``make_train_step(model, cfg)`` returns ``train_step(state, batch) ->
(new_state, metrics)``, the JAX package's contract: ``state`` is
``{"params", "opt"}``, ``batch`` the model's dict of tensors on its
device, batch first ((b, l) ``tokens`` and ``labels``; whisper's also
(b, 1500, d) ``frames``), and the metrics the model's (``loss``, ``accuracy``,
``tokens``, ``loss_total``, ``moe_aux`` for MoE) plus ``grad_norm`` and
``lr``, as 0-d tensors.  With ``microbatches`` k > 1 the batch splits
into k equal rows, the gradients sum in fp32 and divide by k, and the
metrics are the microbatches' means.  The gradients come from
``torch.autograd.grad`` of ``model.loss`` on the raw params; on the card
kernels 2, 9 (whisper's encoder, decoder and cross-attention too) and 12
run through their ``torch.autograd.Function``
(``kernels/ops.py``).  One card has no pod axis: ``compressed_cross_pod``
raises; ``abstract_state`` (the dry-run's) is not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from repro_torch.nn.params import init_params, tree_leaves, tree_map
from repro_torch.optim import AdamWConfig, ScheduleConfig, adamw, \
    schedule as sched

PyTree = Any


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    schedule: ScheduleConfig = ScheduleConfig()
    microbatches: int = 1
    # The JAX package's cross-pod int8 gradient compression: refused (one
    # card has no pod axis).
    compressed_cross_pod: bool = False


def _check(train_cfg: TrainConfig) -> None:
    if train_cfg.compressed_cross_pod:
        raise NotImplementedError(
            "compressed_cross_pod needs a pod axis; the port trains on one "
            "device")


def init_state(model, seed: int, train_cfg: TrainConfig) -> dict:
    """Params from ``seed`` (``nn/params.py: init_params``, on the model's
    device, in its dtype) and a zero AdamW state."""
    _check(train_cfg)
    params = init_params(model.param_specs(), seed, model.cfg.dtype,
                         model.device)
    return {"params": params,
            "opt": adamw.init(params, train_cfg.optimizer)}


def _split_microbatches(batch: dict, k: int) -> list:
    for x in batch.values():
        if x.shape[0] % k:
            raise ValueError(f"batch {x.shape[0]} not divisible by {k} "
                             f"microbatches")
    return [{n: x.chunk(k)[i] for n, x in batch.items()} for i in range(k)]


def make_train_step(model, train_cfg: TrainConfig):
    _check(train_cfg)
    ocfg, scfg = train_cfg.optimizer, train_cfg.schedule
    k = train_cfg.microbatches

    def grad_fn(params, mb) -> Tuple[PyTree, dict]:
        with torch.enable_grad():
            p = tree_map(lambda t: t.detach().requires_grad_(), params)
            loss, metrics = model.loss(p, mb)
            leaves = tree_leaves(p)
            got = torch.autograd.grad(loss, leaves, allow_unused=True)
        # A leaf the loss never reads gets zeros, as jax.grad gives it.
        it = iter([torch.zeros_like(t) if g is None else g
                   for t, g in zip(leaves, got)])
        return (tree_map(lambda _: next(it), p),
                {n: torch.as_tensor(v).detach() for n, v in metrics.items()})

    def compute_grads(params, batch):
        if k == 1:
            return grad_fn(params, batch)
        acc, stack = None, []
        for mb in _split_microbatches(batch, k):
            grads, metrics = grad_fn(params, mb)
            acc = tree_map(lambda g: g.float(), grads) if acc is None else \
                tree_map(lambda a, g: a + g.float(), acc, grads)
            stack.append(metrics)
        return (tree_map(lambda g: g / k, acc),
                {n: torch.stack([m[n] for m in stack]).float().mean(0)
                 for n in stack[0]})

    def train_step(state, batch):
        grads, metrics = compute_grads(state["params"], batch)
        lr = sched.lr_at(state["opt"]["step"], scfg)
        new_params, new_opt, stats = adamw.update(
            grads, state["opt"], state["params"], lr, ocfg)
        metrics = dict(metrics)
        metrics.update(stats)
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step
