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
(``kernels/ops.py``).  ``compressed_cross_pod`` routes the gradients
through ``distributed/collectives.py: compressed_pod_psum`` on a mesh
with a ``"pod"`` axis (JAX's branch condition): of size 1 on one card,
so the step applies the int8-round-tripped gradients and carries the
error-feedback residual in ``state["err"]``; a pod axis larger than 1
raises.  ``abstract_state`` is :func:`init_state` on ``meta`` (the dry
run's).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from repro_torch.distributed import collectives
from repro_torch.nn.params import abstract_params, init_params, \
    jax_layout, per_layer, tree_leaves, tree_map
from repro_torch.optim import AdamWConfig, ScheduleConfig, adamw, \
    schedule as sched

PyTree = Any


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    schedule: ScheduleConfig = ScheduleConfig()
    microbatches: int = 1
    # Cross-pod int8 gradient compression (meshes with a "pod" axis):
    # the pod-axis gradient reduction runs through
    # distributed/collectives.compressed_pod_psum.
    compressed_cross_pod: bool = False


def init_state(model, seed: int, train_cfg: TrainConfig) -> dict:
    """Params from ``seed`` (``nn/params.py: init_params``, on the model's
    device, in its dtype), a zero AdamW state and, when compressed, zero
    fp32 error-feedback residuals."""
    params = init_params(model.param_specs(), seed, model.cfg.dtype,
                         model.device)
    state = {"params": params,
             "opt": adamw.init(params, train_cfg.optimizer)}
    if train_cfg.compressed_cross_pod:
        state["err"] = collectives.init_errors(params)
    return state


def abstract_state(model, train_cfg: TrainConfig) -> dict:
    """:func:`init_state` on ``meta`` (shapes and dtypes, nothing
    allocated): params, AdamW's ``step``, ``m`` and ``v`` in their
    configured dtypes, and fp32 ``err`` when compressed."""
    params = abstract_params(model.param_specs(), model.cfg.dtype)
    ocfg = train_cfg.optimizer

    def like(dtype: str):
        return tree_map(lambda p: torch.empty(
            p.shape, dtype=getattr(torch, dtype) if dtype else p.dtype,
            device="meta"), params)
    state = {"params": params,
             "opt": {"step": torch.empty((), dtype=torch.int32,
                                         device="meta"),
                     "m": like(ocfg.m_dtype), "v": like(ocfg.v_dtype)}}
    if train_cfg.compressed_cross_pod:
        state["err"] = like("float32")
    return state


def _split_microbatches(batch: dict, k: int) -> list:
    for x in batch.values():
        if x.shape[0] % k:
            raise ValueError(f"batch {x.shape[0]} not divisible by {k} "
                             f"microbatches")
    return [{n: x.chunk(k)[i] for n, x in batch.items()} for i in range(k)]


def make_train_step(model, train_cfg: TrainConfig, mesh=None):
    ocfg, scfg = train_cfg.optimizer, train_cfg.schedule
    k = train_cfg.microbatches
    cfg = model.cfg

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

    podwise = train_cfg.compressed_cross_pod and mesh is not None and \
        "pod" in mesh.shape
    if podwise:
        npods = collectives.pod_size(mesh)

    def train_step(state, batch):
        grads, metrics = compute_grads(state["params"], batch)
        if podwise:
            # The wire's 256-element blocks run over the JAX package's
            # leaves: each trunk stacked, as its gradients are.
            red, new_err = collectives.compressed_pod_psum(
                jax_layout(grads, cfg), jax_layout(state["err"], cfg),
                "pod", mesh)
            grads = tree_map(lambda g: g / npods, per_layer(red))
            new_err = per_layer(new_err)
        else:
            new_err = state.get("err")
        lr = sched.lr_at(state["opt"]["step"], scfg)
        new_params, new_opt, stats = adamw.update(
            grads, state["opt"], state["params"], lr, ocfg)
        new_state = {"params": new_params, "opt": new_opt}
        if new_err is not None:
            new_state["err"] = new_err
        metrics = dict(metrics)
        metrics.update(stats)
        return new_state, metrics

    return train_step
