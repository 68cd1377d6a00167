"""Activation-sharding context (the port of ``repro.distributed.api``):
models constrain activations without knowing the mesh.

``activation_layout`` installs a (batch_axes, seq_axes) policy, and with
it the mesh the axes name; ``shard_tokens2d`` / ``shard_tokens3d`` /
``constrain_dims`` pin a tensor's batch and sequence dims to those axes.
Outside a policy they are no-ops, as in the JAX package.  On a mesh whose
layout axes have size 1 (or with no mesh) each call returns its input
object.  On a mesh of ranks (``launch/mesh.py``) every rank's model code
holds its own rows of the batch already (``data/pipeline.py:
host_local_slice``), which is what GSPMD's batch sharding gives each
device: a batch-axis constraint moves nothing.  Compute split over
``model`` is the train step's (``train/step.py``: the split layers take
the rank's slices of the params; the activations they exchange go
through ``collectives.py``'s model group, not through these calls).  A
split over ``seq`` axes raises: it is not ported yet (ROADMAP, queue 2).

The port's models do not call these.  The JAX package calls them at 26
sites (its models, ``core/ssd.py`` and ``nn/moe.py``); with the batch
rows already local each call is the identity, and the decode step is
bound by the host's launches, not by its ops (PERF.md §5), so the port
leaves them out.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Any, Optional

_LAYOUT: contextvars.ContextVar = contextvars.ContextVar(
    "activation_layout", default=None)


@contextlib.contextmanager
def activation_layout(batch_axes: Any = ("pod", "data"),
                      seq_axes: Any = None, mesh=None):
    token = _LAYOUT.set({"batch": batch_axes, "seq": seq_axes,
                         "mesh": mesh})
    try:
        yield
    finally:
        _LAYOUT.reset(token)


def current_layout() -> Optional[dict]:
    return _LAYOUT.get()


def _names(axes) -> tuple:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _constrain(x, spec: tuple):
    """``x`` pinned to ``spec`` on the layout's mesh: ``x`` itself.  On a
    mesh of ranks the dims split over the batch axes hold this rank's
    rows already."""
    lay = _LAYOUT.get()
    mesh = lay["mesh"]
    if mesh is None:
        return x
    batch = set(_names(lay["batch"]))
    for d, entry in enumerate(spec):
        names = _names(entry)
        n = math.prod(mesh.shape.get(a, 1) for a in names)
        if n == 1:
            continue
        if not getattr(mesh, "ranked", False):
            raise ValueError(
                f"activation spec {spec} splits dim {d} over {n} devices "
                f"of a mesh without ranks")
        if not set(names) <= batch:
            raise NotImplementedError(
                f"activation spec {spec} splits dim {d} over {names}: "
                f"compute split over sequence axes is not ported yet (the "
                f"train step splits over model itself)")
    return x


def shard_tokens2d(x):
    """(batch, seq) int tensors."""
    lay = _LAYOUT.get()
    if lay is None:
        return x
    return _constrain(x, (lay["batch"], lay["seq"]))


def shard_tokens3d(x):
    """(batch, seq, features) activations."""
    lay = _LAYOUT.get()
    if lay is None:
        return x
    return _constrain(x, (lay["batch"], lay["seq"], None))


def constrain_dims(x, dims: dict):
    """Constrain selected dims by layout role: {dim_index: "batch"|"seq"}
    (dims of size 1 are left alone, as in the JAX package)."""
    lay = _LAYOUT.get()
    if lay is None:
        return x
    spec = [None] * x.ndim
    for d, role in dims.items():
        axes = lay.get(role)
        if axes is None or x.shape[d] <= 1:
            continue
        spec[d] = axes
    if not any(s is not None for s in spec):
        return x
    return _constrain(x, tuple(spec))


def batch_pspec(ndim: int = 2) -> tuple:
    lay = _LAYOUT.get()
    batch = lay["batch"] if lay else None
    seq = lay["seq"] if lay else None
    if ndim == 1:
        return (batch,)
    return (batch, seq) + (None,) * (ndim - 2)
