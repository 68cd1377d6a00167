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
whole leaf back together over the spec's axes (or over some of them:
``axes=``).

:func:`model_split` says how the train step runs over ``model``: which
leaves split over it it keeps split (the split layers compute on the
rank's slice) and which it gathers whole, and why: every leaf of a
family that does not split yet, a kernel's operands the kernel takes
whole (:data:`SPLIT_FAMILIES`), and a leaf whose split does not fall on
head boundaries (MQA's ``wk`` / ``wv``: one kv head cut in two).
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


def _restrict(sharding: Sharding, axes) -> Sharding:
    """``sharding`` with only the dims split over ``axes`` (all of them
    when ``axes`` is ``None``) left split."""
    if axes is None:
        return sharding
    keep = set(axes)
    return Sharding(sharding.mesh, tuple(
        e if e is not None and set(_entry_axes(e)) <= keep else None
        for e in sharding.spec))


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


def gather_like(tree, shardings, axes=None):
    """The whole tree from this rank's slices (:func:`place`'s inverse),
    on every rank of each leaf's axes; with ``axes``, whole along the
    dims split over those axes only (the others stay this rank's
    slices).  The leaves split over the same axes travel as one flat
    all-gather of their bytes; each rank's piece of a leaf then lands at
    its shard's offsets."""
    leaves = tree_leaves(tree)
    shs = [_restrict(sh, axes) for sh in tree_leaves(shardings)]
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


# ---------------------------------------------------------------------------
# Compute split over ``model`` in the train step
# ---------------------------------------------------------------------------

MODEL = collectives.MODEL
# The families whose train step splits its compute over ``model``, each
# with the leaves (a layer's paths) that a kernel of its path takes whole:
# kernel 2 (mamba2_prefill) normalises y over all of d_inner, so it runs
# on the whole in-projection and conv on every rank.
SPLIT_FAMILIES: Dict[str, Tuple[str, ...]] = {
    "mamba2": ("['mixer']['in_proj']['w']", "['mixer']['conv']['w']",
               "['mixer']['conv']['b']"),
    "transformer": (),
}
# The families that still compute whole on every rank along ``model``.
WHOLE_FAMILIES: Dict[str, str] = {
    "mamba": "mamba-130m's in_proj splits x from z, not by channel",
    "recurrentgemma": "the RG-LRU block and its local attention are not "
                      "split yet",
    "whisper": "the encoder-decoder is not split yet",
    "moe": "the experts need a dispatch across model",
}
# Logical axes cut into heads of ``head_dim``.
_HEADED = ("qkv", "heads", "kv_heads")


@dataclasses.dataclass(frozen=True)
class ModelSplit:
    """How the train step runs over a ``model`` axis of ``size`` ranks:
    ``split`` whether its compute splits (``why`` not); ``kept`` the
    leaves split over ``model`` that stay split, as ``(path, dim)``;
    ``gathered`` those gathered whole before the step, as ``(path,
    why)``."""
    size: int
    split: bool
    why: str = ""
    kept: Tuple[Tuple[str, int], ...] = ()
    gathered: Tuple[Tuple[str, str], ...] = ()
    # Each leaf's dim kept split over model (None: whole), in leaf order.
    dims: Tuple[Optional[int], ...] = ()

    def summary(self) -> str:
        if self.size == 1:
            return "no model axis: every rank computes its rows whole"
        if not self.split:
            return (f"compute whole on each of {self.size} model ranks "
                    f"({self.why}); {len(self.gathered)} leaves gathered "
                    f"over model")
        lines = [f"compute split over {self.size} model ranks: "
                 f"{len(self.kept)} leaves split, {len(self.gathered)} "
                 f"gathered over model"]
        lines += [f"  gathered {p}: {w}" for p, w in self.gathered]
        return "\n".join(lines)


def _family(cfg) -> str:
    """The key of ``cfg``'s family in the tables above."""
    return "moe" if getattr(cfg, "moe", False) else cfg.family


def model_split(specs, shardings, cfg) -> ModelSplit:
    """The :class:`ModelSplit` of the per-layer ``specs`` placed on
    ``shardings`` (``per_layer_specs``, ``make_shardings``)."""
    shs = tree_leaves(shardings)
    m = shs[0].mesh.shape.get(MODEL, 1) if shs else 1
    fam = _family(cfg)
    operands = SPLIT_FAMILIES.get(fam)
    why = "" if operands is not None else WHOLE_FAMILIES.get(
        fam, f"family {fam!r} is not split")
    kept, gathered, dims = [], [], []
    for (path, spec), sh in zip(_with_paths(specs), shs):
        on = [d for d, e in enumerate(sh.spec)
              if e is not None and MODEL in _entry_axes(e)]
        dims.append(None)
        if m == 1 or not on:
            continue
        d = on[0]
        if operands is None:
            gathered.append((path, why))
        elif path.endswith(operands):
            gathered.append((path, "a kernel's operand, taken whole"))
        elif spec.axes[d] in _HEADED and not collectives.splits(
                spec.shape[d], m, cfg.head_dim):
            gathered.append((path, f"{spec.shape[d]} over {m} ranks cuts "
                                   f"heads of {cfg.head_dim}"))
        else:
            kept.append((path, d))
            dims[-1] = d
    return ModelSplit(m, operands is not None and m > 1, why, tuple(kept),
                      tuple(gathered), tuple(dims))


def step_shardings(shardings, plan: ModelSplit):
    """``(cut, kept)``: each leaf's sharding for the step's cut of its
    gradient (a leaf kept split over ``model`` without its ``model``
    entry: the rank computed that shard), and the kept leaves' ``model``
    entry alone (the others whole)."""
    shs = tree_leaves(shardings)
    others = tuple(a for a in shs[0].mesh.shape if a != MODEL)
    cut = [_restrict(sh, others) if d is not None else sh
           for sh, d in zip(shs, plan.dims)]
    kept = [_restrict(sh, (MODEL,) if d is not None else ())
            for sh, d in zip(shs, plan.dims)]
    return tuple(tree_map(lambda _: next(it), shardings)
                 for it in (iter(cut), iter(kept)))
