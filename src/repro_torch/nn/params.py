"""Parameter specs, random init, and the bridge from the JAX package's params.

A model's parameters are a nested dict of :class:`ParamSpec`, declared
once (``models/*.py: param_specs``): shape, init and the *logical* axis
names the JAX package declares for the same leaf ("vocab", "embed",
"mlp", ...; ``distributed/sharding.py`` maps them onto a mesh).  As in the JAX package the layer
trunk is declared stacked, so one draw covers every layer of a leaf with
the same init scale as ``repro.nn.params._init_one`` (the fan-in of a
stacked weight is its leading axis):

* the Mamba models' and the transformer's ``layers`` (``stack_specs``: a
  leading ``n_layers`` axis; an MoE layer's expert tensors (e, d, f)
  stack to (n_layers, e, d, f) and take their fan-in from that layer
  axis too);
* RecurrentGemma's ``groups`` (a leading ``n_groups`` axis on each
  pattern position ``"0"``, ``"1"``, ...) and its unstacked ``tail``
  (``"0"``, ``"1"``, ... of the layers past the last whole group).

Whisper declares its two trunks unstacked, as the JAX package does:
``encoder`` and ``decoder``, each ``"0"``, ``"1"``, ...

:func:`per_layer` then turns each trunk into a list of per-layer dicts
(``layers``; whisper's ``encoder`` and ``decoder``), which the port's
Python layer loops read.  :func:`abstract_params` builds the same tree
on ``meta`` (shapes and dtypes, nothing allocated: the dry run's);
:func:`logical_axes`, :func:`count_params` and :func:`param_bytes` read
the spec tree.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.nn.quant import QuantTensor


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    # Logical axis names, one a dim (``None``: never sharded); left out,
    # every dim is ``None``.
    axes: Optional[Tuple[Optional[str], ...]] = None
    init: str = "normal"           # normal | zeros | ones | small_normal
    scale: Optional[float] = None  # stddev; default 1/sqrt(fan-in)

    def __post_init__(self):
        if self.axes is None:
            object.__setattr__(self, "axes", (None,) * len(self.shape))
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def stack_specs(specs: Any, n: int) -> Any:
    """Prepend a stacked-layers dimension (logical axis ``"layers"``) to
    every spec."""
    if isinstance(specs, ParamSpec):
        return dataclasses.replace(specs, shape=(n,) + specs.shape,
                                   axes=("layers",) + specs.axes)
    return {k: stack_specs(v, n) for k, v in specs.items()}


def _init_one(spec: ParamSpec, gen: torch.Generator,
              dtype: torch.dtype) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype)
    # The JAX package's rule, on the (possibly stacked) declared shape.
    fan_in = spec.shape[0] if len(spec.shape) >= 2 else max(spec.shape[-1], 1)
    std = spec.scale if spec.scale is not None else 1.0 / math.sqrt(fan_in)
    if spec.init == "small_normal":
        std = 0.02
    return (torch.randn(spec.shape, generator=gen, dtype=torch.float32)
            * std).to(dtype)


def split_layers(stacked: Any) -> List[Any]:
    """Cut every leaf's leading layer axis into per-layer trees (both
    leaves of a ``QuantTensor``)."""
    def one(tree, i):
        if isinstance(tree, dict):
            return {k: one(v, i) for k, v in tree.items()}
        if isinstance(tree, QuantTensor):
            return tree.apply(lambda a: a[i].contiguous())
        return tree[i].contiguous()
    n = tree_leaves(stacked)[0].shape[0]
    return [one(stacked, i) for i in range(n)]


def _by_int(tree: Dict[str, Any]) -> List[Any]:
    return [tree[k] for k in sorted(tree, key=int)]


def _is_unstacked(layers: Dict[str, Any]) -> bool:
    """Whether a ``layers`` dict is the JAX package's ``scan_layers=False``
    layout (``"0"``, ``"1"``, ...) rather than one stacked block."""
    return bool(layers) and all(k.isdigit() for k in layers)


# Whisper's two trunks, each ``"0"``, ``"1"``, ... (never stacked).
_ENC_DEC = ("encoder", "decoder")


def per_layer(tree: Dict[str, Any], split=None) -> Dict[str, Any]:
    """``tree`` with its layer trunk as ``layers``, a per-layer list: the
    stacked ``layers`` split (or the ``scan_layers=False`` dict ``"0"``,
    ``"1"``, ... in order), or RecurrentGemma's ``groups`` (layer ``g * P
    + j`` is group ``g`` of position ``j``) followed by its ``tail``;
    whisper's ``encoder`` and ``decoder`` each as their own list.
    ``split`` cuts one stacked tree into its layers (default
    :func:`split_layers`)."""
    split = split or split_layers
    if any(k in tree for k in _ENC_DEC):
        return dict(tree, **{k: _by_int(tree[k]) for k in _ENC_DEC
                             if k in tree})
    if "layers" in tree:
        if _is_unstacked(tree["layers"]):
            return dict(tree, layers=_by_int(tree["layers"]))
        return dict(tree, layers=split(tree["layers"]))
    groups = _by_int(tree["groups"]) if "groups" in tree else []
    stacked = [split(g) for g in groups]
    layers = [stacked[j][g] for g in range(len(stacked[0]) if stacked
                                           else 0)
              for j in range(len(stacked))]
    layers += _by_int(tree.get("tail", {}))
    rest = {k: v for k, v in tree.items() if k not in ("groups", "tail")}
    return dict(rest, layers=layers)


def init_params(specs: Dict[str, Any], seed: int,
                dtype: torch.dtype = torch.bfloat16,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Random params from ``seed`` (a ``torch.Generator`` on the CPU, so a
    seed gives the same weights on any device), moved to ``device``.

    Leaves are drawn in sorted-key order.  The draws are not JAX's: the
    same seed gives other numbers than ``repro.nn.params.init_params``;
    tests that compare the packages carry JAX's params across with
    :func:`from_jax_params`.  The stacked trunk (``layers``, or
    ``groups`` and ``tail``) comes back as a per-layer list
    (:func:`per_layer`).
    """
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    return per_layer(tree_map(lambda s: _init_one(s, gen, dtype).to(dev),
                              specs))


def abstract_params(specs: Dict[str, Any],
                    dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    """:func:`init_params`' tree (the trunk a per-layer list) as tensors
    on ``meta``: each leaf's shape and dtype, nothing allocated (the JAX
    package's ``ShapeDtypeStruct`` stand-ins)."""
    return per_layer(tree_map(
        lambda s: torch.empty(s.shape, dtype=dtype,
                              device="meta"), specs))


def logical_axes(specs: Dict[str, Any]) -> Dict[str, Any]:
    """The spec tree with each leaf's logical axis names."""
    return tree_map(lambda s: s.axes, specs)


def count_params(specs: Dict[str, Any]) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(specs))


def param_bytes(specs: Dict[str, Any],
                dtype: torch.dtype = torch.bfloat16) -> int:
    return sum(math.prod(s.shape) * dtype.itemsize
               for s in tree_leaves(specs))


def _tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    """numpy -> torch, keeping the dtype.  A bf16 ``ml_dtypes`` array is
    read as its uint16 bits (numpy has no bf16 of its own)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def from_jax_params(tree: Dict[str, Any], cfg, device: DeviceLike = None
                    ) -> Dict[str, Any]:
    """The JAX package's params (nested dicts of numpy arrays, the stacked
    scan-over-layers layout, or RecurrentGemma's ``groups`` and ``tail``)
    as the port's params: the same leaves with the same dtypes on
    ``device``, the trunk as a per-layer list (:func:`per_layer`).  A W8
    weight (the JAX ``QuantTensor``, its ``q`` and ``scale`` leaves
    numpy) becomes the port's :class:`~repro_torch.nn.quant.QuantTensor`
    with the same backend tag, one per layer."""
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if hasattr(t, "q") and hasattr(t, "scale"):
            return QuantTensor(_tensor_from_numpy(t.q).to(dev),
                               _tensor_from_numpy(t.scale).to(dev),
                               t.backend)
        return _tensor_from_numpy(t).to(dev)

    out = per_layer(conv(tree))
    _check_depths(out, cfg)
    return out


def _depths(cfg) -> Dict[str, int]:
    """Each per-layer trunk's name and the layers the config gives it."""
    if cfg.family == "whisper":
        return {"encoder": cfg.encoder_layers or cfg.n_layers,
                "decoder": cfg.n_layers}
    return {"layers": cfg.n_layers}


def _check_depths(tree: Dict[str, Any], cfg) -> None:
    for name, n in _depths(cfg).items():
        if len(tree[name]) != n:
            raise ValueError(f"params hold {len(tree[name])} {name} "
                             f"layers, the config {n}")


def tree_leaves(tree) -> List[Any]:
    """The leaves of a tree of dicts, lists and tuples, dict keys in
    sorted order (the JAX package's flatten order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same positions of
    ``rest``), keeping its structure; dict keys are visited in sorted
    order, as :func:`tree_leaves` visits them."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def to_numpy(t) -> np.ndarray:
    """A tensor (any device) or array as numpy; bf16 widens to fp32
    (exactly: numpy has no bf16 of its own)."""
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(t)


def jax_layout(tree: Dict[str, Any], cfg, leaf=lambda t: t,
               stack=torch.stack) -> Dict[str, Any]:
    """The JAX package's layout of a tree shaped like the port's params:
    the per-layer list stacked into ``layers`` (``cfg.scan_layers``; else
    ``"0"``, ``"1"``, ...), or for RecurrentGemma into ``groups`` (one
    stack per pattern position over the whole groups) and ``tail``, and
    whisper's ``encoder`` and ``decoder`` as ``"0"``, ``"1"``, ... each;
    ``leaf`` maps every leaf first and ``stack`` stacks a list of them.
    :func:`per_layer` is its inverse."""
    _check_depths(tree, cfg)
    trunks = _depths(cfg)
    host = tree_map(leaf, {k: v for k, v in tree.items() if k not in trunks})
    if cfg.family == "whisper":
        for name in trunks:
            host[name] = {str(i): tree_map(leaf, p)
                          for i, p in enumerate(tree[name])}
        return host
    layers = [tree_map(leaf, p) for p in tree["layers"]]

    def stacked(ps):
        return tree_map(lambda *xs: stack(xs), *ps)

    if cfg.family == "recurrentgemma":
        pattern = cfg.block_pattern or ("recurrent", "recurrent",
                                        "attention")
        P = len(pattern)
        n_groups = cfg.n_layers // P
        if n_groups:
            host["groups"] = {str(j): stacked(layers[j:n_groups * P:P])
                              for j in range(P)}
        host["tail"] = {str(i): p for i, p in
                        enumerate(layers[n_groups * P:])}
    elif cfg.scan_layers:
        host["layers"] = stacked(layers)
    else:
        host["layers"] = {str(i): p for i, p in enumerate(layers)}
    return host


def to_jax_params(tree: Dict[str, Any], cfg) -> Dict[str, Any]:
    """The inverse of :func:`from_jax_params`: the port's params (or a
    tree shaped like them, as AdamW's ``m`` and ``v``) as the JAX
    package's params, nested dicts of numpy arrays in its layout
    (:func:`jax_layout`).  bf16 leaves come back as fp32 (exact), as the
    JAX package's checkpoints store them."""
    return jax_layout(tree, cfg, to_numpy, np.stack)
