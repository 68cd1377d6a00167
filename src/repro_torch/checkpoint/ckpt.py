"""Atomic checkpoints in the JAX package's on-disk layout (the port of
``repro.checkpoint.ckpt``).

Layout: ``<dir>/step_<N>/`` holding one ``arrays.npz`` (the flattened
tree, keyed by the JAX package's ``jax.tree_util.keystr`` of each leaf's
path, formatted here without JAX: ``['params']['embed']['table']``) plus
``manifest.json`` (step, keys, the caller's ``extra``, e.g. the data
step).  Writes go to ``step_<N>.tmp`` then ``os.rename``: a crash
mid-write never corrupts the latest checkpoint (restore only sees
complete dirs).  bf16 leaves are stored as fp32 (exact); ``restore``
casts each leaf to the target's dtype and device.

With ``cfg`` (the model's ``ModelConfig``) the state's param trees —
``params`` and AdamW's ``m`` / ``v`` — are stored in the JAX layout
(``nn/params.py: to_jax_params``: the trunk stacked as ``cfg.scan_layers``
lays it out, RecurrentGemma's ``groups`` and ``tail``), so a checkpoint
written by either package restores in the other.  Without it the tree
is stored as it is (lists keyed ``[i]``).

With ``shardings`` (the params' :class:`~repro_torch.distributed.sharding.
Sharding` tree on a mesh of ranks, also ``m``'s and ``v``'s) the state
holds this rank's shards: ``save`` gathers each param tree whole (every
rank of the mesh takes part), world rank 0 writes the JAX layout, and
every rank waits at a barrier over the mesh until it is published;
``restore`` reads the whole checkpoint on every rank and keeps the
rank's slices on whatever mesh its ``shardings`` name.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import gather_like, shard_like
from repro_torch.nn.params import from_jax_params, to_jax_params, \
    to_numpy, tree_leaves, tree_map

PyTree = Any
_PARAM_TREES = (("params",), ("opt", "m"), ("opt", "v"))
_KEY = re.compile(r"\['((?:[^'\\]|\\.)*)'\]|\[(\d+)\]")


def host_tree(state: PyTree, cfg=None) -> PyTree:
    """``state`` on the host as numpy, its param trees in the JAX layout
    when ``cfg`` is given: the snapshot a save writes."""
    if cfg is None:
        return tree_map(to_numpy, state)
    out = tree_map(to_numpy, {k: v for k, v in state.items()
                              if k not in ("params", "opt")})
    if "params" in state:
        out["params"] = to_jax_params(state["params"], cfg)
    if "opt" in state:
        opt = state["opt"]
        out["opt"] = dict(tree_map(to_numpy, {k: v for k, v in opt.items()
                                              if k not in ("m", "v")}),
                          **{k: to_jax_params(opt[k], cfg)
                             for k in ("m", "v") if k in opt})
    return out


def _flatten(tree: PyTree, prefix: str = "") -> dict:
    """Leaves keyed by the JAX package's ``keystr`` of their path, dict
    keys in sorted order (its flatten order)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}[{k!r}]"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, t in enumerate(tree):
            out.update(_flatten(t, f"{prefix}[{i}]"))
        return out
    arr = np.asarray(tree)
    if arr.dtype.kind not in "biufc":
        arr = arr.astype(np.float32)
    return {prefix: arr}


def _unflatten(arrays: dict) -> PyTree:
    """The nested dicts of a checkpoint's keys (list positions ``[i]`` as
    int keys, turned back into lists)."""
    root: dict = {}
    for key, arr in arrays.items():
        parts = [m.group(1) if m.group(1) is not None else int(m.group(2))
                 for m in _KEY.finditer(key)]
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr

    def lists(t):
        if not isinstance(t, dict):
            return t
        if t and all(isinstance(k, int) for k in t):
            return [lists(t[i]) for i in range(len(t))]
        return {k: lists(v) for k, v in t.items()}
    return lists(root)


def _ranked(shardings) -> bool:
    if shardings is None:
        return False
    return getattr(tree_leaves(shardings)[0].mesh, "ranked", False)


def _map_param_trees(state: PyTree, fn) -> PyTree:
    """``state`` with ``fn`` applied to ``params`` and AdamW's ``m`` and
    ``v``."""
    out = dict(state)
    if "params" in out:
        out["params"] = fn(out["params"])
    if "opt" in out:
        out["opt"] = dict(out["opt"], **{k: fn(out["opt"][k])
                                         for k in ("m", "v")
                                         if k in out["opt"]})
    return out


def gathered(state: PyTree, shardings) -> PyTree:
    """``state`` with its param trees gathered whole from this rank's
    shards (every rank of the shardings' mesh calls it)."""
    if not _ranked(shardings):
        return state
    return _map_param_trees(state, lambda t: gather_like(t, shardings))


def save(ckpt_dir: str | Path, step: int, state: PyTree,
         extra: Optional[dict] = None, keep: int = 3, cfg=None,
         shardings=None) -> Optional[Path]:
    """Write ``state`` (tensors or numpy) as ``step_<N>`` atomically and
    keep the newest ``keep`` checkpoints.  With ``shardings`` on a mesh
    of ranks every rank of the mesh calls this; rank 0 writes (the others
    get ``None``)."""
    if _ranked(shardings):
        mesh = tree_leaves(shardings)[0].mesh
        state = gathered(state, shardings)
        path = None
        if torch.distributed.get_rank() == 0:
            path = save(ckpt_dir, step, state, extra, keep, cfg)
        collectives.barrier(mesh)
        return path
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    arrays = _flatten(host_tree(state, cfg))
    np.savez(tmp / "arrays.npz", **arrays)
    manifest = {"step": step, "keys": list(arrays.keys()),
                "extra": extra or {}}
    with open(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)                  # atomic publish
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: Path, keep: int):
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(ckpt_dir / f"step_{s:08d}", ignore_errors=True)


def all_steps(ckpt_dir: str | Path):
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return []
    out = []
    for p in ckpt_dir.iterdir():
        if p.is_dir() and p.name.startswith("step_") and \
                not p.name.endswith(".tmp") and \
                (p / "manifest.json").exists():
            out.append(int(p.name[5:]))
    return sorted(out)


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _cast_like(target, arr):
    """``arr`` as ``target`` holds it: a tensor of its dtype on its device,
    or a numpy array of its dtype."""
    if isinstance(arr, torch.Tensor):         # a from_jax_params leaf
        arr = arr if isinstance(target, torch.Tensor) else arr.numpy()
    if isinstance(target, torch.Tensor):
        src = arr if isinstance(arr, torch.Tensor) else \
            torch.from_numpy(np.array(arr))
        return src.to(device=target.device, dtype=target.dtype)
    return np.asarray(arr).astype(getattr(target, "dtype", arr.dtype))


def _restore_like(target: PyTree, tree: PyTree, key: str = "") -> PyTree:
    if isinstance(target, dict):
        out = {}
        for k in target:
            sub = f"{key}[{k!r}]"
            if not isinstance(tree, dict) or k not in tree:
                raise KeyError(f"checkpoint missing {sub}")
            out[k] = _restore_like(target[k], tree[k], sub)
        return out
    if isinstance(target, (list, tuple)):
        if not isinstance(tree, list) or len(tree) != len(target):
            raise KeyError(f"checkpoint missing {key}[...]: has "
                           f"{type(tree).__name__}")
        return type(target)(_restore_like(t, s, f"{key}[{i}]")
                            for i, (t, s) in enumerate(zip(target, tree)))
    if isinstance(tree, (dict, list)):
        raise KeyError(f"checkpoint holds a tree at {key}, not an array")
    return _cast_like(target, tree)


def restore(ckpt_dir: str | Path, target: PyTree,
            step: Optional[int] = None, cfg=None, shardings=None):
    """Restore into the structure, dtypes and devices of ``target`` ->
    ``(state, step, extra)``; ``step`` None takes the latest.  ``cfg`` as
    for :func:`save`; with ``shardings`` each param tree comes back as
    this rank's slices of it."""
    if _ranked(shardings):
        state, step, extra = restore(ckpt_dir, target, step, cfg)
        return (_map_param_trees(state, lambda t: shard_like(t, shardings)),
                step, extra)
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = ckpt_dir / f"step_{step:08d}"
    with np.load(path / "arrays.npz") as data:
        tree = _unflatten({k: data[k] for k in data.files})
    with open(path / "manifest.json") as f:
        manifest = json.load(f)
    if cfg is not None:
        for where in _PARAM_TREES:
            node = tree
            for k in where[:-1]:
                node = node.get(k, {})
            if where[-1] in node:
                node[where[-1]] = from_jax_params(node[where[-1]], cfg,
                                                  device="cpu")
    return _restore_like(target, tree), step, manifest.get("extra", {})
