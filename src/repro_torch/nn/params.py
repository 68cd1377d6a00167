"""Parameter specs, random init, and the bridge from the JAX package's params.

A model's parameters are a nested dict of :class:`ParamSpec`, declared
once (``models/*.py: param_specs``).  As in the JAX package the layer
trunk is declared stacked, so one draw covers every layer of a leaf with
the same init scale as ``repro.nn.params._init_one`` (the fan-in of a
stacked weight is its leading axis):

* the Mamba models' and the transformer's ``layers`` (``stack_specs``: a
  leading ``n_layers`` axis);
* RecurrentGemma's ``groups`` (a leading ``n_groups`` axis on each
  pattern position ``"0"``, ``"1"``, ...) and its unstacked ``tail``
  (``"0"``, ``"1"``, ... of the layers past the last whole group).

:func:`per_layer` then turns either into ``layers``: the list of
per-layer dicts the port's Python layer loop reads.
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
    init: str = "normal"           # normal | zeros | ones | small_normal
    scale: Optional[float] = None  # stddev; default 1/sqrt(fan-in)


def stack_specs(specs: Any, n: int) -> Any:
    """Prepend a stacked-layers dimension to every spec."""
    if isinstance(specs, ParamSpec):
        return dataclasses.replace(specs, shape=(n,) + specs.shape)
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


def _map_specs(specs: Any, fn) -> Any:
    if isinstance(specs, ParamSpec):
        return fn(specs)
    return {k: _map_specs(specs[k], fn) for k in sorted(specs)}


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def split_layers(stacked: Any) -> List[Any]:
    """Cut every leaf's leading layer axis into per-layer trees (both
    leaves of a ``QuantTensor``)."""
    def one(tree, i):
        if isinstance(tree, dict):
            return {k: one(v, i) for k, v in tree.items()}
        if isinstance(tree, QuantTensor):
            return tree.apply(lambda a: a[i].contiguous())
        return tree[i].contiguous()
    n = next(_leaves(stacked)).shape[0]
    return [one(stacked, i) for i in range(n)]


def _by_int(tree: Dict[str, Any]) -> List[Any]:
    return [tree[k] for k in sorted(tree, key=int)]


def per_layer(tree: Dict[str, Any]) -> Dict[str, Any]:
    """``tree`` with its layer trunk as ``layers``, a per-layer list: the
    stacked ``layers`` split, or RecurrentGemma's ``groups`` (layer
    ``g * P + j`` is group ``g`` of position ``j``) followed by its
    ``tail``."""
    if "layers" in tree:
        return dict(tree, layers=split_layers(tree["layers"]))
    groups = _by_int(tree["groups"]) if "groups" in tree else []
    stacked = [split_layers(g) for g in groups]
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
    return per_layer(_map_specs(
        specs, lambda s: _init_one(s, gen, dtype).to(dev)))


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
    if len(out["layers"]) != cfg.n_layers:
        raise ValueError(f"params hold {len(out['layers'])} layers, the "
                         f"config {cfg.n_layers}")
    return out
