"""Pipeline parallelism, the looped (circular) schedule of the JAX
package (the port of ``repro.distributed.pipeline``).

  * stage parameters are stacked on a leading stage axis;
  * one buffer holds the in-flight activation of every stage; every tick
    injects the next microbatch into stage 0's slot, runs all stages at
    once (``torch.func.vmap`` over the stage axis), lets the last stage's
    microbatch exit, and rotates the buffer one stage forward
    (``torch.roll``);
  * microbatch i enters at tick i and exits after S stages; a run of M
    microbatches costs M + S - 1 ticks (the usual bubble).

Without a mesh the stage axis is not sharded: the schedule runs as it
would across stages, on one device.  Differentiable by
``torch.autograd`` (nothing is written in place).

With ``mesh`` (a mesh of ranks, ``launch/mesh.py``) the stage axis is
sharded over its ``axis`` of S ranks, as the JAX package shards it over a
mesh axis: each rank holds its stage's slice of ``stacked_params``
(leading dim 1) and runs that stage, microbatch ``t - s`` at tick ``t``;
the rotation is a send of the stage's output to the next rank along the
axis.  Both ends of a send are ``torch.autograd.Function``s: the
backward sends each cotangent back the way its activation came (tagged
with the microbatch; the autograd engine takes them last microbatch
first on every rank).  The last stage's rank returns the outputs; every
other rank returns zeros that hang on its sends, so that a loss of the
output on every rank, differentiated on every rank, reaches every stage.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.distributed import collectives
from repro_torch.nn.params import tree_leaves, tree_map


class _Recv(torch.autograd.Function):
    """Receive an activation from world rank ``src``; the backward sends
    its cotangent back there."""

    @staticmethod
    def forward(ctx, anchor, src, tag, shape, dtype):
        ctx.src, ctx.tag = src, tag
        return collectives.recv(shape, dtype, src, tag, anchor.device)

    @staticmethod
    def backward(ctx, grad):
        collectives.send(grad, ctx.src, ctx.tag)
        return None, None, None, None, None


class _Send(torch.autograd.Function):
    """Send an activation to world rank ``dst``; returns a 0-d token. The
    backward receives the activation's cotangent from there."""

    @staticmethod
    def forward(ctx, y, dst, tag):
        ctx.dst, ctx.tag = dst, tag
        ctx.shape, ctx.dtype, ctx.device = y.shape, y.dtype, y.device
        collectives.send(y, dst, tag)
        return y.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        return collectives.recv(ctx.shape, ctx.dtype, ctx.dst, ctx.tag,
                                ctx.device), None, None


def _staged_apply(stage_fn, local_params, microbatches, mesh, axis):
    """One rank's stage of the pipeline over ``mesh``'s ``axis``."""
    line = mesh.line((axis,))
    s, n_stages = mesh.coords[axis], len(line)
    lead = tree_leaves(local_params)[0].shape[0]
    if lead != 1:
        raise ValueError(f"a rank holds one stage of the stacked params; "
                         f"its slice has {lead}")
    p = tree_map(lambda a: a[0], local_params)
    m = microbatches.shape[0]
    shape, dtype = microbatches.shape[1:], microbatches.dtype
    anchor = tree_leaves(p)[0]
    outs, tokens = [], []
    for t in range(m + n_stages - 1):
        i = t - s
        if not 0 <= i < m:
            continue
        x = microbatches[i] if s == 0 else _Recv.apply(
            anchor, line[s - 1], i, shape, dtype)
        y = stage_fn(p, x).to(dtype)
        if s == n_stages - 1:
            outs.append(y)
        else:
            tokens.append(_Send.apply(y, line[s + 1], i))
    if s == n_stages - 1:
        return torch.stack(outs)
    return microbatches.new_zeros(microbatches.shape) + \
        torch.stack(tokens).sum() * 0


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stacked_params: Any,
                   microbatches: torch.Tensor, mesh=None,
                   axis: str = "stage") -> torch.Tensor:
    """Run ``stage_fn`` as an S-stage pipeline over M microbatches.

    stage_fn: (stage_params, x) -> x, applied by every stage.
    stacked_params: tree with a leading stage axis S (on ``mesh``: this
        rank's slice, one stage).
    microbatches: (M, mb, ...) inputs.
    Returns (M, mb, ...): microbatch i processed by all S stages, in order
    (on ``mesh``: on the last stage's rank; zeros elsewhere).
    """
    if mesh is not None and getattr(mesh, "ranked", False) and \
            mesh.shape.get(axis, 1) > 1:
        return _staged_apply(stage_fn, stacked_params, microbatches, mesh,
                             axis)
    s_axis = tree_leaves(stacked_params)[0].shape[0]
    m = microbatches.shape[0]
    buf = microbatches.new_zeros((s_axis,) + microbatches.shape[1:])
    vfn = torch.func.vmap(stage_fn, in_dims=(0, 0))
    outs = []
    for t in range(m + s_axis - 1):
        if t < m:       # inject microbatch t into stage 0's slot
            buf = torch.cat([microbatches[t:t + 1].to(buf.dtype), buf[1:]])
        buf = vfn(stacked_params, buf)      # every stage at once
        if t >= s_axis - 1:                 # microbatch t - (S-1) exits
            outs.append(buf[-1])
        buf = torch.roll(buf, 1, dims=0)    # stage s feeds stage s+1
    return torch.stack(outs)


def reference_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                    stacked_params: Any, x: torch.Tensor) -> torch.Tensor:
    """Sequential oracle: apply the S stages in order (no pipeline)."""
    s = tree_leaves(stacked_params)[0].shape[0]
    for i in range(s):
        x = stage_fn(tree_map(lambda a: a[i], stacked_params), x)
    return x
