"""Logical-axis -> mesh-axis sharding with divisibility-aware fallback
(the port of ``repro.distributed.sharding``).

Models declare *logical* axes on every parameter ("vocab", "embed",
"mlp", "qkv", "expert", ...; ``nn/params.py: ParamSpec.axes``).  This
module maps them onto a mesh (``launch/mesh.py``) with the JAX package's
ordered candidate table, checking

  * divisibility  (a dim of size 8 never shards over a 16-way axis), and
  * exclusivity   (each mesh axis used at most once per param),

and falling back to replication otherwise, recording every fallback.  A
spec is a plain tuple, one entry a dim (an axis name, a tuple of them, or
``None``), standing for JAX's ``PartitionSpec``.  :func:`resolve_spec`
reads only ``mesh.shape``, so abstract meshes of any size resolve.
Placement (:func:`shard_like`) happens on one card only: on a mesh whose
axes all have size 1 every dim "shards" over size-1 axes, so each leaf
moves whole to the mesh's device; a spec that would split a dim raises.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.nn.params import ParamSpec, per_layer, tree_leaves, \
    tree_map

# Candidate mesh axes per logical axis, in preference order.  "fsdp" is a
# macro for the compound data axes present in the mesh (("pod","data") or
# ("data",)).
DEFAULT_RULES: Tuple[Tuple[str, Tuple[Any, ...]], ...] = (
    ("vocab", ("model",)),
    ("embed", ("fsdp",)),
    ("mlp", ("model",)),
    ("mlp2", (None,)),
    ("qkv", ("model",)),
    ("heads", ("model",)),
    ("kv_heads", ("model", None)),
    ("expert", ("model", "pod", None)),
    ("layers", (None,)),
)


@dataclasses.dataclass
class ShardingReport:
    """Which params fell back to replication on which dims (and why)."""
    fallbacks: List[Tuple[str, int, str, str]] = dataclasses.field(
        default_factory=list)

    def add(self, path: str, dim: int, logical: str, reason: str):
        self.fallbacks.append((path, dim, logical, reason))

    def summary(self) -> str:
        if not self.fallbacks:
            return "all logical axes mapped"
        lines = [f"  {p} dim{d} ({l}): {r}" for p, d, l, r in self.fallbacks]
        return f"{len(self.fallbacks)} fallback(s):\n" + "\n".join(lines)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A leaf's placement: the mesh and its spec (JAX's
    ``NamedSharding``)."""
    mesh: Any
    spec: tuple


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        return mesh.shape[axes]
    return math.prod(mesh.shape[a] for a in axes)


def _expand_macro(cand, mesh):
    if cand == "fsdp":
        axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
        return axes if axes else None
    return cand


def resolve_spec(spec: ParamSpec, mesh, rules: Dict[str, Tuple[Any, ...]],
                 path: str = "", report: Optional[ShardingReport] = None
                 ) -> tuple:
    used: set = set()
    out = []
    for d, logical in enumerate(spec.axes):
        if logical is None:
            out.append(None)
            continue
        cands = rules.get(logical, (None,))
        chosen = None
        reason = f"no candidate for {logical!r}"
        for cand in cands:
            cand = _expand_macro(cand, mesh)
            if cand is None:
                chosen, reason = None, "rule says replicate"
                break
            axes = (cand,) if isinstance(cand, str) else tuple(cand)
            if any(a not in mesh.shape for a in axes):
                reason = f"axis {axes} not in mesh"
                continue
            if any(a in used for a in axes):
                reason = f"axis {axes} already used"
                continue
            size = _axis_size(mesh, axes)
            if spec.shape[d] % size != 0:
                reason = f"{spec.shape[d]} % {size} != 0"
                continue
            chosen = cand if isinstance(cand, str) else tuple(axes)
            break
        if chosen is None:
            if report is not None and rules.get(logical, (None,))[0] \
                    is not None:
                report.add(path, d, logical, reason)
            out.append(None)
        else:
            used.update((chosen,) if isinstance(chosen, str) else chosen)
            # PartitionSpec's canonical form: a one-axis tuple is the axis.
            out.append(chosen[0] if isinstance(chosen, tuple) and
                       len(chosen) == 1 else chosen)
    return tuple(out)


def _with_paths(specs, prefix: str = ""):
    """(path, spec) of every leaf in sorted-key order; ``path`` as JAX's
    ``keystr`` writes it (``['layers']['mixer']['in_proj']['w']``)."""
    if isinstance(specs, dict):
        for k in sorted(specs):
            yield from _with_paths(specs[k], f"{prefix}[{k!r}]")
    elif isinstance(specs, (list, tuple)):
        for i, v in enumerate(specs):
            yield from _with_paths(v, f"{prefix}[{i}]")
    else:
        yield prefix, specs


def make_pspecs(specs, mesh):
    """specs tree -> spec-tuple tree, by :data:`DEFAULT_RULES`."""
    rules = dict(DEFAULT_RULES)
    return tree_map(lambda s: resolve_spec(s, mesh, rules), specs)


def make_shardings(specs, mesh) -> Tuple[Any, ShardingReport]:
    """specs tree -> :class:`Sharding` tree (+ fallback report), by
    :data:`DEFAULT_RULES`."""
    rules, report = dict(DEFAULT_RULES), ShardingReport()
    it = iter([Sharding(mesh, resolve_spec(spec, mesh, rules, path, report))
               for path, spec in _with_paths(specs)])
    return tree_map(lambda _: next(it), specs), report


def per_layer_specs(specs):
    """The spec tree in the port's params layout (``nn/params.py:
    per_layer``): each stacked trunk as a list of per-layer specs, the
    leading ``layers`` dim dropped."""
    def split(stacked):
        n = tree_leaves(stacked)[0].shape[0]
        one = tree_map(lambda s: dataclasses.replace(
            s, shape=s.shape[1:], axes=s.axes[1:]), stacked)
        return [one] * n
    return per_layer(specs, split)


def _split_axes(spec: tuple) -> List[str]:
    names = []
    for entry in spec:
        if entry is not None:
            names += [entry] if isinstance(entry, str) else list(entry)
    return names


def place(x: torch.Tensor, sharding: Sharding) -> torch.Tensor:
    """``x`` on ``sharding``'s mesh: whole on its one device.  A spec
    whose axes have more than one device between them raises."""
    mesh = sharding.mesh
    n = math.prod(mesh.shape[a] for a in _split_axes(sharding.spec))
    if n > 1:
        raise NotImplementedError(
            f"spec {sharding.spec} splits a dim over {n} devices; the port "
            f"places tensors on one card")
    return x.to(mesh.device)


def shard_like(tree, shardings):
    """Place a concrete tree onto the given shardings (:func:`place` each
    leaf)."""
    return tree_map(place, tree, shardings)
