"""Sharded, prefetching data pipeline (the port of ``repro.data.pipeline``).

Each process materializes only its slice of the global batch
(``host_local_slice``: on a mesh of ranks its rows along the batch axes,
``pod`` and ``data``, the same rows on every rank along ``model``); a
background thread keeps ``prefetch`` batches ready so
input never blocks the step.  ``to_device_batch`` takes the place of the
JAX package's ``device_put_batch``.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch


BATCH_AXES = ("pod", "data")


def host_local_slice(global_batch: int, mesh=None) -> slice:
    """This process's rows of the global batch.  On ``mesh`` (a mesh of
    ranks, ``launch/mesh.py``) the batch splits over its batch axes only,
    as the JAX package shards it (``launch/dryrun.py: batch_axes_for``):
    the row-major index of the rank's ``pod`` and ``data`` coordinates
    picks its part, so ranks that differ only along ``model`` take the
    same rows.  Without a mesh: all rows in one process, else rank r of a
    world of n takes the r-th of n equal parts."""
    if mesh is not None:
        axes = [a for a in BATCH_AXES if a in mesh.shape]
        n, idx, c = 1, 0, mesh.coords
        for a in axes:
            n, idx = n * mesh.shape[a], idx * mesh.shape[a] + c[a]
    else:
        n, idx = 1, 0
        if torch.distributed.is_available() and \
                torch.distributed.is_initialized():
            n, idx = torch.distributed.get_world_size(), \
                torch.distributed.get_rank()
    if global_batch % n:
        raise ValueError(f"a global batch of {global_batch} does not split "
                         f"over {n} ranks")
    per = global_batch // n
    return slice(idx * per, (idx + 1) * per)


class PrefetchIterator:
    """Wrap an iterator with a daemon prefetch thread; an error raised by
    the wrapped iterator surfaces on the ``next()`` that reaches it."""

    def __init__(self, it: Iterator, prefetch: int = 2):
        self._it = it
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        try:
            for item in self._it:
                self._q.put(item)
        except BaseException as e:  # noqa: BLE001 — surfaced on next()
            self._err = e
        self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


def to_device_batch(batch: Dict[str, np.ndarray], device
                    ) -> Dict[str, torch.Tensor]:
    """A host batch as tensors on ``device``; integer arrays (token ids,
    labels) become int64, the index type PyTorch's gathers take."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if not t.is_floating_point():
            t = t.long()
        out[k] = t.to(device)
    return out
