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
Placement (:func:`place`, :func:`shard_like`) moves each leaf whole to a
one-device mesh's device; on a mesh of ranks (``launch/mesh.py``) it
gives each rank its slice of every split dim, and :func:`gather` puts the
whole leaf back together over the spec's axes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.distributed import collectives
from repro_torch.launch.mesh import coords_of
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


@dataclasses.dataclass(frozen=True)
class _Sizes:
    """A mesh's sizes alone, all :func:`resolve_spec` reads."""
    shape: Dict[str, int]


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


def make_shardings(specs, mesh, replicated: Sequence[str] = ()
                   ) -> Tuple[Any, ShardingReport]:
    """specs tree -> :class:`Sharding` tree (+ fallback report), by
    :data:`DEFAULT_RULES`; ``replicated`` axes are left out of the rules
    (the compressed sync's params replicate over ``"pod"``: JAX's "FSDP
    restricted to data")."""
    rules, report = dict(DEFAULT_RULES), ShardingReport()
    sizes = _Sizes({a: s for a, s in mesh.shape.items()
                    if a not in replicated})
    it = iter([Sharding(mesh, resolve_spec(spec, sizes, rules, path, report))
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


def _entry_axes(entry) -> Tuple[str, ...]:
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _index(shape: Dict[str, int], coords: Dict[str, int],
           axes: Sequence[str]) -> int:
    """The shard of a dim split over ``axes`` that a rank at ``coords``
    holds: the row-major index of its coordinates along them, as JAX
    numbers the shards of a ``PartitionSpec`` entry."""
    i = 0
    for a in axes:
        i = i * shape[a] + coords[a]
    return i


def place(x: torch.Tensor, sharding: Sharding) -> Optional[torch.Tensor]:
    """``x`` (the whole leaf) on ``sharding``'s mesh: whole on a
    one-device mesh; on a mesh of ranks this rank's slice of every split
    dim (``None`` on a rank outside the mesh)."""
    mesh = sharding.mesh
    if not getattr(mesh, "ranked", False):
        n = math.prod(mesh.shape[a] for a in _split_axes(sharding.spec))
        if n > 1:
            raise ValueError(
                f"spec {sharding.spec} splits a dim over {n} devices of a "
                f"mesh without ranks")
        return x.to(mesh.device)
    if not mesh.member:
        return None
    for d, entry in enumerate(sharding.spec):
        if entry is None:
            continue
        axes = _entry_axes(entry)
        n = math.prod(mesh.shape[a] for a in axes)
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not split "
                             f"over {axes} = {n}")
        x = x.chunk(n, dim=d)[_index(mesh.shape, mesh.coords, axes)]
    return x.contiguous().to(mesh.device)


def _split_over(sharding: Sharding) -> Tuple[str, ...]:
    """The mesh axes of more than one rank that ``sharding`` splits
    over, in mesh order."""
    mesh, names = sharding.mesh, set(_split_axes(sharding.spec))
    return tuple(a for a in mesh.shape if a in names and mesh.shape[a] > 1)


def gather_like(tree, shardings):
    """The whole tree from this rank's slices (:func:`place`'s inverse),
    on every rank of each leaf's axes.  The leaves split over the same
    axes travel as one flat all-gather of their bytes; each rank's piece
    of a leaf then lands at its shard's offsets."""
    leaves, shs = tree_leaves(tree), tree_leaves(shardings)
    if not leaves or not getattr(shs[0].mesh, "ranked", False):
        return tree
    mesh = shs[0].mesh
    out = list(leaves)
    by_axes: Dict[Tuple[str, ...], List[int]] = {}
    for i, sh in enumerate(shs):
        axes = _split_over(sh)
        if axes:
            by_axes.setdefault(axes, []).append(i)
    for axes, idx in by_axes.items():
        # Each leaf's bytes padded to 8, so that every piece views as its
        # dtype.
        raw = [leaves[i].detach().contiguous().reshape(-1).view(torch.uint8)
               for i in idx]
        sizes = [-(-r.numel() // 8) * 8 for r in raw]
        flat = torch.cat([torch.nn.functional.pad(r, (0, n - r.numel()))
                          for r, n in zip(raw, sizes)])
        parts = collectives.all_gather(flat, mesh, axes)
        peers = [coords_of(mesh.shape, r) for r in mesh.line(axes)]
        for i, pieces in zip(idx, zip(*(p.split(sizes) for p in parts))):
            local, spec = leaves[i], shs[i].spec
            whole = local.new_empty(tuple(
                n * math.prod(mesh.shape[a] for a in _entry_axes(e))
                if e else n for n, e in zip(local.shape, spec)))
            for c, piece in zip(peers, pieces):
                at = tuple(slice(None) if e is None else slice(
                    _index(mesh.shape, c, _entry_axes(e)) * n,
                    (_index(mesh.shape, c, _entry_axes(e)) + 1) * n)
                    for n, e in zip(local.shape, spec))
                whole[at] = piece[:local.numel() * local.element_size()] \
                    .view(local.dtype).view(local.shape)
            out[i] = whole
    it = iter(out)
    return tree_map(lambda _: next(it), tree)


def gather(x: torch.Tensor, sharding: Sharding) -> torch.Tensor:
    """One leaf whole from this rank's slice (:func:`gather_like`)."""
    return gather_like([x], [sharding])[0]


def shard_like(tree, shardings):
    """Place a concrete tree onto the given shardings (:func:`place` each
    leaf)."""
    return tree_map(place, tree, shardings)
