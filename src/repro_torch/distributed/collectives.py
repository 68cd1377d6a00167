"""Collectives over a mesh's axes, and the cross-pod gradient compression:
int8 block-quantized all-reduce with error feedback (the port of
``repro.distributed.collectives``).

Every collective of the port goes through this module:
:func:`all_gather`, :func:`all_reduce` and :func:`broadcast` over the
process group of a set of mesh axes (``launch/mesh.py``), the pipeline's
:func:`send` / :func:`recv` and :func:`barrier`.  The backend is
``gloo`` (``distributed/launch.py``), which moves host memory: each
operand is copied to the host, sent, and the result copied back to the
operand's device, on purpose.  No other transport is tried.  Each call
appends ``(op, axes, operand bytes, wire bytes)`` to the open
:func:`recording` log (a ring's wire bytes a rank: (n - 1) operands for a
gather, 2 (n - 1) / n for a reduce), the way ``kernels/cost.py`` records
kernel launches; ``launch/hlo_analysis.py: parse_collectives`` reads it.

Across pods the links are the slow axis, so the train step can route the
pod-axis gradient reduction through :func:`compressed_pod_psum`:

    q, scales = quantize_int8(g - err)         # per-block absmax scaling
    sent      = dequantize(q, scales)           # what goes on the wire
    reduced   = psum(sent, 'pod')               # all_reduce over the pods
    err'      = (g - err) - sent                # stays local, next step

Error feedback keeps the compression unbiased over time (residuals are
re-injected).  Over a ``"pod"`` axis of size 1 the psum is the identity.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.nn.params import tree_leaves, tree_map

PyTree = Any
BLOCK = 256


@dataclasses.dataclass(frozen=True)
class CollectiveRecord:
    op: str
    axes: Tuple[str, ...]
    operand_bytes: int
    wire_bytes: int


_LOG: contextvars.ContextVar = contextvars.ContextVar("collectives",
                                                      default=None)


@contextlib.contextmanager
def recording():
    """Collect the :class:`CollectiveRecord` of every collective inside
    the block into the list it yields."""
    log: List[CollectiveRecord] = []
    token = _LOG.set(log)
    try:
        yield log
    finally:
        _LOG.reset(token)


def _record(op: str, axes, operand_bytes: int, wire_bytes: int) -> None:
    log = _LOG.get()
    if log is not None:
        log.append(CollectiveRecord(op, tuple(axes), int(operand_bytes),
                                    int(wire_bytes)))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _axes(axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_size(mesh, axes) -> int:
    n = 1
    for a in _axes(axes):
        n *= mesh.shape.get(a, 1)
    return n


def _wire(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bytes on the host, flat (gathers and broadcasts move bits
    of any dtype, never round)."""
    return t.detach().to("cpu").contiguous().reshape(-1).view(torch.uint8)


def _unwire(h: torch.Tensor, shape, dtype, device) -> torch.Tensor:
    return h.view(dtype).reshape(shape).to(device)


def all_gather(x: torch.Tensor, mesh, axes) -> List[torch.Tensor]:
    """Every rank's ``x`` along ``axes`` (same shape and dtype on each),
    in the row-major order of their coordinates along ``axes`` as listed,
    on ``x``'s device."""
    axes = _axes(axes)
    n = axis_size(mesh, axes)
    if n == 1:
        return [x]
    dist = torch.distributed
    h = _wire(x)
    parts = [torch.empty_like(h) for _ in range(n)]
    dist.all_gather(parts, h, group=mesh.group(axes))
    _record("all_gather", axes, _nbytes(h), (n - 1) * _nbytes(h))
    # The group's ranks are its sorted world ranks; the line lists them
    # in coordinate order.
    order = sorted(mesh.line(axes))
    by_rank = dict(zip(order, parts))
    return [_unwire(by_rank[r], x.shape, x.dtype, x.device)
            for r in mesh.line(axes)]


def all_reduce(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum of ``x`` over ``axes`` (``psum``), by the backend's ring:
    the same bits on every rank, its order the ring's."""
    axes = _axes(axes)
    n = axis_size(mesh, axes)
    if n == 1:
        return x
    h = x.detach().to("cpu").contiguous().clone()
    torch.distributed.all_reduce(h, group=mesh.group(axes))
    _record("all_reduce", axes, _nbytes(h), 2 * (n - 1) * _nbytes(h) // n)
    return h.to(x.device)


def sum_in_rank_order(x: torch.Tensor, mesh, axes,
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The sum of ``x`` over ``axes`` taken in coordinate order,
    ``((x_0 + x_1) + x_2) + ...`` in ``dtype`` (default ``x``'s): every
    rank gathers the operands and adds them the same way, so the bits are
    a one-process loop's."""
    parts = all_gather(x, mesh, axes)
    acc = parts[0].to(dtype or x.dtype)
    for p in parts[1:]:
        acc = acc + p.to(acc.dtype)
    return acc


def broadcast(x: Optional[torch.Tensor], mesh, src: int,
              like: Tuple[Tuple[int, ...], torch.dtype],
              device) -> torch.Tensor:
    """World rank ``src``'s ``x`` on every rank of the world (``like``:
    its shape and dtype, for ranks that hold none), on ``device``."""
    dist = torch.distributed
    shape, dtype = like
    h = _wire(x if dist.get_rank() == src else
              torch.empty(shape, dtype=dtype))
    dist.broadcast(h, src=src)
    n = dist.get_world_size()
    _record("broadcast", tuple(mesh.shape), _nbytes(h),
            (n - 1) * _nbytes(h) if dist.get_rank() == src else 0)
    return _unwire(h, shape, dtype, device)


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """World rank ``src``'s picklable ``obj`` on every rank."""
    box = [obj]
    torch.distributed.broadcast_object_list(box, src=src)
    return box[0]


def send(x: torch.Tensor, dst: int, tag: int) -> None:
    """``x`` to world rank ``dst`` (JAX's collective-permute, one pair)."""
    h = _wire(x)
    torch.distributed.send(h, dst=dst, tag=tag)
    _record("send", (), _nbytes(h), _nbytes(h))


def recv(shape, dtype: torch.dtype, src: int, tag: int,
         device) -> torch.Tensor:
    """A tensor of ``shape`` and ``dtype`` from world rank ``src``."""
    h = _wire(torch.empty(shape, dtype=dtype))
    torch.distributed.recv(h, src=src, tag=tag)
    return _unwire(h, shape, dtype, device)


def barrier(mesh) -> None:
    """Every rank of ``mesh`` waits for the others."""
    torch.distributed.barrier(group=mesh.group(tuple(mesh.shape)))


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
    """The size of ``axis`` on ``mesh`` (1 without a mesh or the axis)."""
    return 1 if mesh is None else mesh.shape.get(axis, 1)


def quantize_leaf(g: torch.Tensor, e: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One leaf's ``(sent, new_err)``: ``g - e`` through the int8 wire
    format, and what that lost."""
    target = g.float() - e
    flat = target.reshape(-1)
    n = flat.numel()
    q, scale = _quantize(F.pad(flat, (0, (-n) % BLOCK)))
    sent = _dequantize(q, scale)[:n].reshape(g.shape)
    # The residual target - q * scale with one rounding, as XLA fuses it
    # (the product is exact in fp64).
    qs = (q.double() * scale.double()).reshape(-1)[:n].reshape(g.shape)
    return sent, (target.double() - qs).float()


def compressed_pod_psum(grads: PyTree, errors: PyTree, axis: str = "pod",
                        mesh=None) -> Tuple[PyTree, PyTree]:
    """All-reduce ``grads`` over ``axis`` of ``mesh`` in int8 with error
    feedback.  Returns (reduced_grads, new_errors): the sum over the pods
    of each pod's ``sent`` (psum semantics, fp32) and this pod's own
    residual."""
    ranked = pod_size(mesh, axis) > 1
    if ranked and not mesh.ranked:
        raise ValueError(f"a {axis!r} axis of {pod_size(mesh, axis)} on a "
                         f"mesh without ranks: nothing to reduce over")

    def one(g, e):
        sent, new_err = quantize_leaf(g, e)
        if ranked:
            sent = all_reduce(sent, mesh, (axis,))
        return sent, new_err

    outs = iter([one(g, e) for g, e in zip(tree_leaves(grads),
                                           tree_leaves(errors))])
    pairs = tree_map(lambda _: next(outs), grads)
    return (tree_map(lambda _, p: p[0], grads, pairs),
            tree_map(lambda _, p: p[1], grads, pairs))


def init_errors(params: PyTree) -> PyTree:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def summary(log: Sequence[CollectiveRecord]) -> dict:
    """``{op: {"count", "operand_bytes", "wire_bytes"}}`` over a log."""
    out: dict = {}
    for r in log:
        s = out.setdefault(r.op, {"count": 0, "operand_bytes": 0,
                                  "wire_bytes": 0})
        s["count"] += 1
        s["operand_bytes"] += r.operand_bytes
        s["wire_bytes"] += r.wire_bytes
    return out
