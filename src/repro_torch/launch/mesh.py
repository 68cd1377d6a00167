"""Meshes of the port (the port of ``repro.launch.mesh``).

A :class:`Mesh` is an ordered ``shape`` (axis name -> size) and the
devices it spans; without devices it is abstract, sizes only, for
resolving sharding rules (``distributed/sharding.py``) and for the dry
run.  The port runs on one card, so a mesh with devices spans one: the
production mesh is ``("data", "model") = (1, 1)``, and a request for more
devices than the process has raises ``NotImplementedError`` with its
reason.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    shape: Dict[str, int]
    devices: Optional[Tuple[torch.device, ...]] = None   # None: abstract

    @property
    def device(self) -> torch.device:
        """The one device a concrete mesh spans."""
        if not self.devices:
            raise ValueError("an abstract mesh has no device")
        if len(self.devices) != 1:
            raise NotImplementedError(
                f"a mesh of {len(self.devices)} devices: the port places "
                f"tensors on one")
        return self.devices[0]


def _available(dev: torch.device) -> int:
    if dev.type == "cuda":
        return torch.cuda.device_count()
    return 1


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """A mesh of ``shape`` over ``axes``.  ``devices=None``: abstract
    (sizes only).  With devices, the sizes' product must equal their
    count, and the process must hold that many devices of their kind."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    sizes = dict(zip(axes, shape))
    if devices is None:
        return Mesh(sizes)
    devs = tuple(torch.device(d) for d in devices)
    if math.prod(shape) != len(devs):
        raise ValueError(f"mesh {sizes} needs {math.prod(shape)} devices, "
                         f"given {len(devs)}")
    have = _available(devs[0]) if devs else 0
    if len(devs) > have:
        raise NotImplementedError(
            f"mesh {sizes} needs {len(devs)} {devs[0].type} devices; this "
            f"process has {have}: the port runs on one card")
    for d in devs:
        resolve_device(d)
    return Mesh(sizes, devs)


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None) -> Mesh:
    """The one-card production mesh, ``("data", "model") = (1, 1)`` on
    ``device`` (default ``cuda``).  ``multi_pod`` raises: one card has no
    pod axis."""
    if multi_pod:
        raise NotImplementedError(
            "multi_pod: the (pod, data, model) mesh spans two pods of "
            "chips; the port runs on one card, which has no pod axis")
    return make_mesh((1, 1), ("data", "model"),
                     devices=[resolve_device(device)])


def describe(mesh: Mesh) -> str:
    where = f"{len(mesh.devices)} devices" if mesh.devices else "abstract"
    return " x ".join(f"{k}={v}" for k, v in mesh.shape.items()) + \
        f" ({where})"
