"""Cross-pod gradient compression: int8 block-quantized all-reduce with
error feedback (the port of ``repro.distributed.collectives``).

Across pods the links are the slow axis, so the train step can route the
pod-axis gradient reduction through this module:

    q, scales = quantize_int8(g - err)         # per-block absmax scaling
    sent      = dequantize(q, scales)           # what goes on the wire
    reduced   = psum(sent, 'pod')
    err'      = (g - err) - sent                # error feedback -> next step

Error feedback keeps the compression unbiased over time (residuals are
re-injected).  The port runs on one card: over a ``"pod"`` axis of size 1
the psum is the identity, and :func:`compressed_pod_psum` still returns
the int8-round-tripped gradients and the residual, as the JAX package's
does inside ``shard_map`` on a one-device pod.  A pod axis larger than 1
raises.
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.nn.params import tree_leaves, tree_map

PyTree = Any
BLOCK = 256


# XLA compiles the JAX package's ``absmax / 127.0 + 1e-12`` into a multiply
# by the fp32 reciprocal of 127 fused with the add (one rounding): the
# scale below takes that form, the product exact in fp64.
_RECIP_127 = float(np.float32(1.0 / 127.0))
_EPS = float(np.float32(1e-12))


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block absmax int8 quantization.  x: flat fp32 (padded to
    BLOCK); rounds half to even, as ``jnp.round``."""
    xb = x.reshape(-1, BLOCK)
    amax = torch.amax(torch.abs(xb), dim=1, keepdim=True)
    scale = (amax.double() * _RECIP_127 + _EPS).float()
    q = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (q.float() * scale).reshape(-1)


def pod_size(mesh, axis: str = "pod") -> int:
    """The size of ``axis`` on ``mesh`` (1 without a mesh or the axis);
    above 1 it raises: the port runs on one card."""
    n = 1 if mesh is None else mesh.shape.get(axis, 1)
    if n > 1:
        raise NotImplementedError(
            f"a {axis!r} axis of {n}: the compressed sync reduces over "
            f"{n} pods; the port runs on one card")
    return n


def compressed_pod_psum(grads: PyTree, errors: PyTree, axis: str = "pod",
                        mesh=None) -> Tuple[PyTree, PyTree]:
    """All-reduce ``grads`` over ``axis`` of ``mesh`` in int8 with error
    feedback.  Returns (reduced_grads, new_errors), the sum (psum
    semantics), fp32."""
    pod_size(mesh, axis)

    def one(g, e):
        target = g.float() - e
        flat = target.reshape(-1)
        n = flat.numel()
        q, scale = _quantize(F.pad(flat, (0, (-n) % BLOCK)))
        sent = _dequantize(q, scale)[:n].reshape(g.shape)
        # The residual target - q * scale with one rounding, as XLA fuses
        # it (the product is exact in fp64).
        qs = (q.double() * scale.double()).reshape(-1)[:n].reshape(g.shape)
        return sent, (target.double() - qs).float()   # psum over one: sent

    outs = iter([one(g, e) for g, e in zip(tree_leaves(grads),
                                           tree_leaves(errors))])
    pairs = tree_map(lambda _: next(outs), grads)
    return (tree_map(lambda _, p: p[0], grads, pairs),
            tree_map(lambda _, p: p[1], grads, pairs))


def init_errors(params: PyTree) -> PyTree:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
