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

On one card the stage axis is not sharded: the schedule runs as it
would across stages, on one device.  Differentiable by
``torch.autograd`` (nothing is written in place).
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.nn.params import tree_leaves, tree_map


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stacked_params: Any,
                   microbatches: torch.Tensor) -> torch.Tensor:
    """Run ``stage_fn`` as an S-stage pipeline over M microbatches.

    stage_fn: (stage_params, x) -> x, applied by every stage.
    stacked_params: tree with a leading stage axis S.
    microbatches: (M, mb, ...) inputs.
    Returns (M, mb, ...): microbatch i processed by all S stages, in order.
    """
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
