"""Meshes of the port (the port of ``repro.launch.mesh``).

A :class:`Mesh` is an ordered ``shape`` (axis name -> size) and the
devices it spans; without devices it is abstract, sizes only, for
resolving sharding rules (``distributed/sharding.py``) and for the dry
run.  A concrete mesh of one device places tensors whole on it.  A
concrete mesh of n > 1 devices spans n **ranks**, one process each,
joined by ``torch.distributed`` (``distributed/launch.py: spawn``): the
mesh takes world ranks 0 to n - 1, rank r at the row-major coordinate of
the shape (``jax.make_mesh``'s device order), and every rank of the world
builds one process group for each line of every set of axes, in the same
order (``torch.distributed.new_group`` is collective over the world).
A rank past n is outside the mesh: it holds no coordinate and no device.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.distributed import launch

@dataclasses.dataclass(frozen=True)
class Mesh:
    shape: Dict[str, int]
    devices: Optional[Tuple[torch.device, ...]] = None   # None: abstract
    # The world rank of this process (None: abstract, or one device).
    rank: Optional[int] = None
    # Sorted tuple of axis names -> this rank's process group over them.
    groups: Dict[Tuple[str, ...], Any] = dataclasses.field(
        default_factory=dict, compare=False, hash=False, repr=False)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def ranked(self) -> bool:
        """A concrete mesh over more than one rank."""
        return self.rank is not None

    @property
    def member(self) -> bool:
        return self.rank is None or self.rank < self.size

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's row-major coordinate (all 0 off a ranked mesh)."""
        return coords_of(self.shape, self.rank or 0)

    @property
    def device(self) -> torch.device:
        """This rank's device (the one device of a one-device mesh)."""
        if not self.devices:
            raise ValueError("an abstract mesh has no device")
        if not self.member:
            raise ValueError(f"rank {self.rank} is outside the mesh "
                             f"{self.shape}")
        return self.devices[self.rank or 0]

    def group(self, axes: Sequence[str]):
        """This rank's process group over ``axes`` (the ranks that differ
        from it only along them)."""
        return self.groups[tuple(sorted(axes))]

    def line(self, axes: Sequence[str]) -> Tuple[int, ...]:
        """The world ranks of this rank's line over ``axes``, in the
        row-major order of their coordinates along ``axes`` as listed."""
        c = self.coords
        out = []
        for idx in itertools.product(*(range(self.shape[a]) for a in axes)):
            c2 = dict(c, **dict(zip(axes, idx)))
            out.append(rank_of(self.shape, c2))
        return tuple(out)


def coords_of(shape: Dict[str, int], rank: int) -> Dict[str, int]:
    out, rest = {}, rank
    for a in reversed(list(shape)):
        out[a] = rest % shape[a]
        rest //= shape[a]
    return {a: out[a] for a in shape}


def rank_of(shape: Dict[str, int], coords: Dict[str, int]) -> int:
    r = 0
    for a in shape:
        r = r * shape[a] + coords[a]
    return r


def _world() -> Tuple[int, int]:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _groups(sizes: Dict[str, int]) -> Dict[Tuple[str, ...], Any]:
    """One group for each line of every non-empty set of axes, built by
    every rank of the world in the same order; returns this rank's."""
    dist = torch.distributed
    _, me = _world()
    n = math.prod(sizes.values())
    names = list(sizes)
    mine = {}
    for k in range(1, len(names) + 1):
        for axes in itertools.combinations(names, k):
            rest = [a for a in names if a not in axes]
            for fixed in itertools.product(*(range(sizes[a])
                                             for a in rest)):
                base = dict(zip(rest, fixed))
                ranks = sorted(rank_of(sizes, dict(base, **dict(zip(
                    axes, idx)))) for idx in itertools.product(
                        *(range(sizes[a]) for a in axes)))
                g = dist.new_group(ranks, timeout=launch.GROUP_TIMEOUT)
                if me < n and me in ranks:
                    mine[tuple(sorted(axes))] = g
    return mine


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """A mesh of ``shape`` over ``axes``.  ``devices=None``: abstract
    (sizes only).  With devices, the sizes' product must equal their
    count: one device is placed on whole; n > 1 take world ranks 0 to
    n - 1 of ``torch.distributed`` (every rank of the world calls this, in
    the same order), rank r on ``devices[r]``."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    sizes = dict(zip(axes, shape))
    if devices is None:
        return Mesh(sizes)
    devs = tuple(torch.device(d) for d in devices)
    n = math.prod(shape)
    if n != len(devs):
        raise ValueError(f"mesh {sizes} needs {n} devices, given "
                         f"{len(devs)}")
    for d in devs:
        resolve_device(d)
    if n == 1:
        return Mesh(sizes, devs)
    world, rank = _world()
    if world < n:
        raise RuntimeError(
            f"mesh {sizes} spans {n} ranks; this process is one of a world "
            f"of {world}: start the ranks with "
            f"repro_torch.distributed.launch.spawn")
    return Mesh(sizes, devs, rank, _groups(sizes))


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None) -> Mesh:
    """The one-card production mesh, ``("data", "model") = (1, 1)`` on
    ``device`` (default ``cuda``).  ``multi_pod`` raises."""
    if multi_pod:
        raise NotImplementedError(
            "multi_pod: the (pod, data, model) = (2, 16, 16) mesh needs 512 "
            "ranks that each own a card; they wait for the nccl backend on "
            "a machine with more than one card")
    return make_mesh((1, 1), ("data", "model"),
                     devices=[resolve_device(device)])


def describe(mesh: Mesh) -> str:
    if not mesh.devices:
        where = "abstract"
    elif mesh.ranked:
        where = f"{len(mesh.devices)} ranks"
    else:
        where = f"{len(mesh.devices)} devices"
    return " x ".join(f"{k}={v}" for k, v in mesh.shape.items()) + \
        f" ({where})"
