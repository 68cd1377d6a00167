"""Mixture-of-Experts layer with static-capacity scatter / gather dispatch
(port of ``repro.nn.moe``).

The router takes fp32 logits from fp32 casts of x and its weight, a
softmax, the top k and (``moe_renormalize``) renormalized gates.  The
Switch-style auxiliary loss is ``sum(mean(probs) * mean(count one-hots))
* e``.  Each (token, slot) pair's position in its expert is an inclusive
prefix sum over the token-major ``(n*k, e)`` one-hots, minus 1; pairs at
or past the capacity ``max(8, ceil8(ceil(n*k/e * capacity_factor)))``
are dropped (GShard semantics), where n is every token of the call.  So
a row's output depends on every other row of the call: padding rows and
the engine's empty slots take capacity too.

Dispatch: the kept rows scatter-add into an ``(e, cap, d)`` buffer (a
dropped row adds exact zeros to slot ``cap-1``, and kept slots are
unique, so the sum does not depend on the order of the adds); the
batched expert products ``hi``, ``hg`` and ``out`` take fp32 sums (the
JAX package's ``preferred_element_type``); ``act(hg) * hi`` (the
config's ``silu`` or ``gelu`` through ``core/pwl.activation``, so ActiBA
applies) is cast to the stream dtype before ``wo``; the gathered rows are
scaled by ``gate * keep`` in the stream dtype and summed over k (in fp32,
rounded once, as ``jnp.sum`` takes a bf16 sum).

The expert products are plain batched products in JAX too.  On the card
they take the stream-dtype operands and give fp32 sums
(``torch.bmm(..., out_dtype=torch.float32)``): no call makes an fp32 copy
of the expert weights.  On the CPU they widen both operands to fp32,
which is exact for bf16 and sums in fp32.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import pwl
from repro_torch.nn.mlp import _ACT_FOR_MLP
from repro_torch.nn.params import ParamSpec


def moe_specs(cfg) -> dict:
    if cfg.mlp_type not in _ACT_FOR_MLP:
        raise NotImplementedError(f"mlp_type {cfg.mlp_type!r} is not ported "
                                  f"for MoE experts")
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    return {
        "router": {"w": ParamSpec((d, e), ("embed", None), scale=0.02)},
        "wi": ParamSpec((e, d, f), ("expert", "embed", "mlp")),
        "wg": ParamSpec((e, d, f), ("expert", "embed", "mlp")),
        "wo": ParamSpec((e, f, d), ("expert", "mlp", "embed")),
    }


def capacity(n_tokens: int, cfg) -> int:
    """Slots per expert for a call of ``n_tokens`` tokens."""
    c = math.ceil(n_tokens * cfg.n_experts_per_token / cfg.n_experts
                  * cfg.capacity_factor)
    return max(8, int(math.ceil(c / 8) * 8))


class Routing(NamedTuple):
    """One call's routing: ``gates`` (n, k) fp32, zero where dropped;
    ``expert_ids`` (n, k) int64; ``pos`` (n, k) int64, each pair's
    position in its expert (unclipped); ``keep`` (n, k) bool; ``aux``
    the load-balancing loss, fp32; ``cap`` the capacity."""
    gates: torch.Tensor
    expert_ids: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    aux: torch.Tensor
    cap: int


def route(router_w: torch.Tensor, cfg, xf: torch.Tensor) -> Routing:
    """The router on ``xf`` (n, d): top-k experts, gates, positions,
    drops and the auxiliary loss."""
    n = xf.shape[0]
    e, k = cfg.n_experts, cfg.n_experts_per_token
    cap = capacity(n, cfg)
    logits = torch.matmul(xf.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)                      # (n, e)
    gates, expert_ids = torch.topk(probs, k, dim=-1)           # (n, k)
    if cfg.moe_renormalize:
        gates = gates / gates.sum(dim=-1, keepdim=True)
    onehot = F.one_hot(expert_ids, e)                          # (n, k, e)
    me = probs.mean(dim=0)
    ce = onehot.sum(dim=1).float().mean(dim=0)
    aux = (me * ce).sum() * e
    # Inclusive prefix sum over the token-major (n*k, e) one-hots: the
    # integer sums equal the JAX package's fp32 ones (exact below 2^24).
    pos = torch.cumsum(onehot.reshape(n * k, e), dim=0)
    pos = pos.gather(1, expert_ids.reshape(n * k, 1)).reshape(n, k) - 1
    keep = pos < cap
    return Routing(gates * keep, expert_ids, pos, keep, aux, cap)


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``a @ b`` with fp32 sums, returned in fp32: on the card
    from the operands as they are, on the CPU from fp32 widenings."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def apply(params: dict, cfg, x: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (b, s, d) -> (y (b, s, d) in x's dtype, aux loss fp32 ())."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.n_experts_per_token
    n = b * s
    xf = x.reshape(n, d)
    r = route(params["router"]["w"], cfg, xf)
    eid = r.expert_ids.reshape(-1)
    pid = r.pos.reshape(-1).clamp(0, r.cap - 1)
    keep = r.keep.reshape(-1, 1).to(x.dtype)
    src = xf.repeat_interleave(k, dim=0) * keep
    buf = x.new_zeros((e, r.cap, d))
    buf.index_put_((eid, pid), src, accumulate=True)

    act = pwl.activation(_ACT_FOR_MLP[cfg.mlp_type], cfg.xamba)
    hi = _bmm_f32(buf, params["wi"])
    hg = _bmm_f32(buf, params["wg"])
    h = (act(hg) * hi).to(x.dtype)
    out = _bmm_f32(h, params["wo"]).to(x.dtype)

    gathered = out[eid, pid] * (r.gates.reshape(-1, 1).to(x.dtype) * keep)
    y = gathered.reshape(n, k, d).float().sum(dim=1).to(x.dtype)
    return y.reshape(b, s, d), r.aux.float()
