"""AdamW with a dtype policy (the port of ``repro.optim.adamw``).

The arithmetic is the JAX package's, in its order: fp32 math, the clip
scale ``min(1, clip / (gnorm + 1e-9))``, bias correction, decoupled
weight decay on every leaf, and each new leaf cast back to its dtype.
The moments are held in ``m_dtype`` / ``v_dtype`` (None: the param's).
Params and moments are trees of tensors (``nn/params.py: tree_map``);
``update`` returns new trees, as the JAX function does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.nn.params import tree_leaves, tree_map

PyTree = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    m_dtype: Optional[str] = "float32"
    v_dtype: Optional[str] = "float32"


def init(params: PyTree, cfg: AdamWConfig) -> dict:
    """Zero moments shaped like ``params`` and a step count of 0 (int32,
    on the params' device)."""
    def zeros_like(p, dtype):
        return torch.zeros(p.shape, dtype=getattr(torch, dtype) if dtype
                           else p.dtype, device=p.device)
    dev = tree_leaves(params)[0].device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "m": tree_map(lambda p: zeros_like(p, cfg.m_dtype), params),
            "v": tree_map(lambda p: zeros_like(p, cfg.v_dtype), params)}


def global_norm(tree: PyTree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares."""
    return torch.sqrt(torch.stack(
        [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    ).sum())


@torch.no_grad()
def update(grads: PyTree, state: dict, params: PyTree, lr,
           cfg: AdamWConfig, gnorm: Optional[torch.Tensor] = None
           ) -> Tuple[PyTree, dict, dict]:
    """One AdamW step -> (new_params, new_state, stats ``grad_norm``,
    ``lr``); ``lr`` a float or a 0-d fp32 tensor.  ``gnorm``: the clip's
    global norm when ``grads`` are one rank's shards of the gradient
    (the whole gradient's norm); default ``global_norm(grads)``."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0) \
        if cfg.grad_clip else torch.ones((), device=gnorm.device)
    step = state["step"] + 1
    c1 = 1.0 - cfg.b1 ** step.float()
    c2 = 1.0 - cfg.b2 ** step.float()

    def upd(p, g, m, v):
        g = g.float() * scale
        m32 = m.float() * cfg.b1 + g * (1 - cfg.b1)
        v32 = v.float() * cfg.b2 + torch.square(g) * (1 - cfg.b2)
        mhat = m32 / c1
        vhat = v32 / c2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * p.float()
        new_p = (p.float() - lr * delta).to(p.dtype)
        return new_p, m32.to(m.dtype), v32.to(v.dtype)

    out = tree_map(upd, params, grads, state["m"], state["v"])

    new_state = {"step": step, "m": _part(out, 1), "v": _part(out, 2)}
    return _part(out, 0), new_state, {"grad_norm": gnorm, "lr": lr}


def _part(out: PyTree, i: int) -> PyTree:
    """Item ``i`` of every ``(new_p, m, v)`` leaf of ``out``."""
    if isinstance(out, dict):
        return {k: _part(v, i) for k, v in out.items()}
    if isinstance(out, list):
        return [_part(v, i) for v in out]
    return out[i]
