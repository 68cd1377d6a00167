"""ReduBA: reductions and contractions under a mode (a port of
``repro.core.reduce``).

``contract`` is the mode-switched two-operand einsum of the SSD chain:

* ``naive`` — broadcast-multiply in fp32, then one ``torch.sum`` per
  contracted index (the op chain the paper measured on the NPU);
* ``reduba`` / ``pallas`` / ``pallas_interpret`` — ``torch.einsum`` with
  fp32 accumulation, as the JAX package's ``jnp.einsum`` outside any
  Pallas kernel.

``reduce_sum`` in a ``pallas`` mode runs kernel 14 (``kernels/ops.py:
reduba_sum``, ``reduce_rows`` of the transpose; its plain version on a
CPU tensor); ``mean`` divides any mode's sum in fp32 at least, as the
JAX package's ``np.float32`` divisor promotes it.
"""
from __future__ import annotations

import re

import torch

_SPEC_RE = re.compile(r"^([a-zA-Z]+),([a-zA-Z]+)->([a-zA-Z]+)$")
_HALF = (torch.bfloat16, torch.float16)


def reduce_sum(x: torch.Tensor, axis: int = 0, mode: str = "reduba"
               ) -> torch.Tensor:
    """Sum over one axis under a ReduBA mode."""
    if mode == "naive":
        return torch.sum(x, dim=axis)
    if mode == "reduba":
        moved = torch.movedim(x, axis, -1)
        acc = torch.float32 if x.dtype in _HALF else x.dtype
        ones = torch.ones((moved.shape[-1],), dtype=acc, device=x.device)
        return torch.matmul(moved.to(acc), ones).to(x.dtype)
    if mode in ("pallas", "pallas_interpret"):
        from repro_torch.kernels import ops
        return ops.reduba_sum(torch.movedim(x, axis, -1))
    raise ValueError(f"unknown reduce mode {mode!r}")


def contract(spec: str, lhs: torch.Tensor, rhs: torch.Tensor,
             mode: str = "reduba") -> torch.Tensor:
    """Two-operand einsum as a contraction (``reduba``) or as a
    broadcast-multiply + ReduceSum chain (``naive``); the result in
    ``lhs``/``rhs``'s promoted dtype."""
    m = _SPEC_RE.match(spec.replace(" ", ""))
    if not m:
        raise ValueError(f"contract() wants 'ab,bc->ac' style spec, got {spec!r}")
    out_dtype = torch.result_type(lhs, rhs)
    if mode in ("reduba", "pallas", "pallas_interpret"):
        return torch.einsum(spec, lhs.float(), rhs.float()).to(out_dtype)
    if mode != "naive":
        raise ValueError(f"unknown contract mode {mode!r}")
    lterms, rterms, oterms = m.group(1), m.group(2), m.group(3)
    contracted = sorted((set(lterms) | set(rterms)) - set(oterms))
    # A common broadcast frame: output dims, then contracted dims.
    frame = oterms + "".join(contracted)

    def align(x, terms):
        order = sorted(range(len(terms)), key=lambda i: frame.index(terms[i]))
        x = x.permute(order)
        present, xi, shape = set(terms), 0, []
        for c in frame:
            if c in present:
                shape.append(x.shape[xi])
                xi += 1
            else:
                shape.append(1)
        return x.reshape(shape)

    prod = align(lhs, lterms).float() * align(rhs, rterms).float()
    for _ in contracted:                 # one ReduceSum per contracted dim
        prod = torch.sum(prod, dim=-1)
    return prod.to(out_dtype)


def mean(x: torch.Tensor, axis: int = -1, mode: str = "reduba"
         ) -> torch.Tensor:
    n = x.shape[axis]
    total = reduce_sum(x, axis=axis, mode=mode)
    return total.to(torch.promote_types(total.dtype, torch.float32)) / n
