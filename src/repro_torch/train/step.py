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
with a ``"pod"`` axis (JAX's branch condition): the step applies the
pods' summed int8-round-tripped gradients over the pod count and carries
this pod's error-feedback residual in ``state["err"]``.
``abstract_state`` is :func:`init_state` on ``meta`` (the dry run's).

On a mesh of ranks (``launch/mesh.py``; :func:`shard_state` places a
whole state) each rank holds its shards of the params and of AdamW's
``m`` and ``v`` (``distributed/sharding.py``'s rules; under the
compressed sync the params replicate over ``pod``, JAX's "FSDP
restricted to data"), and ``batch`` is its own rows
(``data/pipeline.py: host_local_slice``).  A step:

1. gathers every param leaf over the batch axes (``pod``, ``data``);
   a leaf split over ``model`` stays split there, except those
   ``sharding.model_split`` gathers over ``model`` too: kernel 2's
   operands (Mamba-2's ``in_proj`` and ``conv``), leaves whose split cuts
   heads (MQA's ``wk`` / ``wv``), and every leaf of a family whose compute
   is not split yet (mamba-130m, recurrentgemma, whisper, the MoE
   transformers: each rank along ``model`` then computes its rows whole);
2. computes the rank's gradients inside ``collectives.model_split`` of
   the mesh's model group: the split layers take the rank's slices
   (column-, row- and vocab-parallel products, the vocab-parallel loss);
   a leaf kept split gets its shard's gradient, a leaf every model rank
   computes whole the same whole gradient on each; microbatches as in
   one process;
3. sums them over the batch axes in rank order in fp32 and divides by
   their count (``collectives.sum_in_rank_order``: the bits of one
   process that computes the ranks' rows apart, adds them in that order
   and halves, as ``microbatches`` does); under the compressed sync over
   ``data`` only, then (the kept leaves gathered over ``model`` first,
   so that the int8 blocks run over whole leaves) ``compressed_pod_psum``
   over ``pod`` divided by the pod count, as JAX's ``shard_map`` branch
   does;
4. takes the clip's global norm of the whole gradient (the same on every
   rank: a kept leaf's sum of squares summed over ``model`` in rank
   order, no replicated dim counted twice, :func:`split_global_norm`),
   cuts each gradient to the rank's shard and runs AdamW on the shards.

The step's ``model_split`` attribute says which leaves ran split and
which families compute whole.  The metrics are the means over the batch
axes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import MODEL, ModelSplit, \
    gather_like, make_shardings, model_split, per_layer_specs, shard_like, \
    step_shardings
from repro_torch.nn.params import abstract_params, init_params, \
    jax_layout, per_layer, tree_leaves, tree_map
from repro_torch.optim import AdamWConfig, ScheduleConfig, adamw, \
    schedule as sched
from repro_torch.runtime.elastic import reshard_state

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


def replicated_axes(train_cfg: TrainConfig, mesh) -> Tuple[str, ...]:
    """The mesh axes params replicate over: ``pod`` under the compressed
    sync."""
    return ("pod",) if train_cfg.compressed_cross_pod and \
        mesh is not None and "pod" in mesh.shape else ()


def param_shardings(model, train_cfg: TrainConfig, mesh):
    """The per-layer params' shardings on ``mesh`` (also ``m``'s and
    ``v``'s)."""
    sh, _ = make_shardings(per_layer_specs(model.param_specs()), mesh,
                           replicated_axes(train_cfg, mesh))
    return sh


def shard_state(state: dict, model, train_cfg: TrainConfig, mesh,
                old_mesh=None) -> dict:
    """``state`` (whole, or sharded on ``old_mesh``) as this rank's
    shards on ``mesh`` (``runtime/elastic.py: reshard_state``)."""
    return reshard_state(state, model.param_specs(), mesh, old_mesh,
                         replicated_axes(train_cfg, mesh))


# Elements of the flat gradient that one gather of the mean moves: the
# gathered operands and their fp32 sums stay a few hundred MB on the card
# (gemma-2b's 0.4 G elements a rank would take ~7 GB at once).
MEAN_CHUNK = 1 << 26


def _flat_mean(tree: PyTree, mesh, axes) -> PyTree:
    """The tree's leaves summed over ``axes`` in rank order in fp32 and
    divided by the count: the leaves of a dtype flat, gathered
    ``MEAN_CHUNK`` elements at a time."""
    n = collectives.axis_size(mesh, axes)
    leaves = tree_leaves(tree)
    out = [None] * len(leaves)
    for dtype in sorted({t.dtype for t in leaves}, key=str):
        idx = [i for i, t in enumerate(leaves) if t.dtype == dtype]
        flat = torch.cat([leaves[i].reshape(-1) for i in idx])
        mean = torch.empty(flat.shape, dtype=torch.float32,
                           device=flat.device)
        for a in range(0, flat.numel(), MEAN_CHUNK):
            mean[a:a + MEAN_CHUNK] = collectives.sum_in_rank_order(
                flat[a:a + MEAN_CHUNK], mesh, axes, torch.float32) / n
        del flat
        for i, part in zip(idx, mean.split([leaves[i].numel()
                                            for i in idx])):
            out[i] = part.view(leaves[i].shape)
    it = iter(out)
    return tree_map(lambda _: next(it), tree)


def split_global_norm(grads: PyTree, dims, group) -> torch.Tensor:
    """:func:`adamw.global_norm` of a gradient whose leaves at ``dims``
    (one entry a leaf, ``None``: whole) are split over ``group``'s model
    ranks: each piece's fp32 sum of squares, a leaf's summed in rank
    order."""
    leaves = tree_leaves(grads)
    ss = [None if d is not None else torch.sum(torch.square(g.float()))
          for g, d in zip(leaves, dims)]
    kept = [i for i, d in enumerate(dims) if d is not None]
    if kept:
        per = [group.pieces(leaves[i], dims[i]) for i in kept]
        total = group.sum_values([torch.stack([
            torch.sum(torch.square(p[r].float())) for p in per])
            for r in range(len(per[0]))], torch.float32)
        for j, i in enumerate(kept):
            ss[i] = total[j]
    return torch.sqrt(torch.stack(ss).sum())


def _split_microbatches(batch: dict, k: int) -> list:
    for x in batch.values():
        if x.shape[0] % k:
            raise ValueError(f"batch {x.shape[0]} not divisible by {k} "
                             f"microbatches")
    return [{n: x.chunk(k)[i] for n, x in batch.items()} for i in range(k)]


def _grad_fn(model, params, mb) -> Tuple[PyTree, dict]:
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


def compute_grads(model, params, batch, k: int = 1
                  ) -> Tuple[PyTree, dict]:
    """The gradients of ``model.loss`` at ``params`` on ``batch`` and its
    metrics; with ``k`` > 1 microbatches summed in fp32 and divided by
    ``k``, the metrics the microbatches' means."""
    if k == 1:
        return _grad_fn(model, params, batch)
    acc, stack = None, []
    for mb in _split_microbatches(batch, k):
        grads, metrics = _grad_fn(model, params, mb)
        acc = tree_map(lambda g: g.float(), grads) if acc is None else \
            tree_map(lambda a, g: a + g.float(), acc, grads)
        stack.append(metrics)
    return (tree_map(lambda g: g / k, acc),
            {n: torch.stack([m[n] for m in stack]).float().mean(0)
             for n in stack[0]})


def make_train_step(model, train_cfg: TrainConfig, mesh=None):
    ocfg, scfg = train_cfg.optimizer, train_cfg.schedule
    cfg = model.cfg

    def grads_of(params, batch):
        return compute_grads(model, params, batch, train_cfg.microbatches)

    podwise = train_cfg.compressed_cross_pod and mesh is not None and \
        "pod" in mesh.shape
    npods = collectives.pod_size(mesh)
    ranked = getattr(mesh, "ranked", False)
    if podwise and npods > 1 and not ranked:
        raise ValueError(f"a 'pod' axis of {npods} on a mesh without "
                         f"ranks: nothing to reduce over")
    plan = ModelSplit(1, False)
    if ranked:
        sh = param_shardings(model, train_cfg, mesh)
        batch_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
        mean_axes = tuple(a for a in batch_axes
                          if not (podwise and a == "pod"))
        plan = model_split(per_layer_specs(model.param_specs()), sh, cfg)
        sh_cut, sh_kept = step_shardings(sh, plan)
        group = collectives.RankGroup(mesh) if plan.split else None

    def train_step(state, batch):
        gnorm = None
        if ranked:
            params = gather_like(state["params"], sh, axes=batch_axes)
            if plan.gathered:
                params = gather_like(params, sh_cut, axes=(MODEL,))
            with collectives.model_split(group):
                grads, metrics = grads_of(params, batch)
            if collectives.axis_size(mesh, mean_axes) > 1:
                grads = _flat_mean(grads, mesh, mean_axes)
            metrics = {n: torch.cat(collectives.all_gather(
                v.reshape(1), mesh, batch_axes)).float().mean(0)
                for n, v in metrics.items()}
            if podwise and plan.kept:
                grads = gather_like(grads, sh_kept)
            elif plan.kept:
                gnorm = split_global_norm(grads, plan.dims, group)
        else:
            grads, metrics = grads_of(state["params"], batch)
        new_err = state.get("err")
        if podwise:
            # The wire's 256-element blocks run over the JAX package's
            # leaves: each trunk stacked, as its gradients are.
            red, new_err = collectives.compressed_pod_psum(
                jax_layout(grads, cfg), jax_layout(new_err, cfg), "pod",
                mesh)
            grads = tree_map(lambda g: g / npods, per_layer(red))
            new_err = per_layer(new_err)
        if gnorm is None:
            gnorm = adamw.global_norm(grads)
        if ranked:
            grads = shard_like(grads, sh if podwise else sh_cut)
        lr = sched.lr_at(state["opt"]["step"], scfg)
        new_params, new_opt, stats = adamw.update(
            grads, state["opt"], state["params"], lr, ocfg, gnorm=gnorm)
        new_state = {"params": new_params, "opt": new_opt}
        if new_err is not None:
            new_state["err"] = new_err
        metrics = dict(metrics)
        metrics.update(stats)
        return new_state, metrics

    train_step.model_split = plan
    return train_step
