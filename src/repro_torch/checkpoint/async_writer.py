"""Async checkpointing: the step loop never blocks on serialization (the
port of ``repro.checkpoint.async_writer``).

``AsyncCheckpointer.save`` snapshots the state to host memory
synchronously (``ckpt.host_tree``: numpy, the JAX layout under ``cfg``)
— cheap relative to a step — then a single worker thread serializes and
atomically publishes it.  A bounded queue of 1 applies backpressure
instead of accumulating snapshots; ``wait()`` drains before exit /
restore.
"""
from __future__ import annotations

import queue
import threading
from pathlib import Path
from typing import Any, Optional

from repro_torch.checkpoint import ckpt


class AsyncCheckpointer:
    def __init__(self, ckpt_dir: str | Path, keep: int = 3, cfg=None):
        self.ckpt_dir = Path(ckpt_dir)
        self.keep = keep
        self.cfg = cfg
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._err: Optional[BaseException] = None
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                self._done.set()
                return
            step, host_state, extra = item
            try:
                ckpt.save(self.ckpt_dir, step, host_state, extra, self.keep)
            except BaseException as e:  # noqa: BLE001 — raised by save/wait
                self._err = e

    def save(self, step: int, state: Any, extra: Optional[dict] = None):
        if self._err is not None:
            raise self._err
        # Snapshot to host; the step loop may then replace the tensors.
        self._q.put((step, ckpt.host_tree(state, self.cfg), extra))

    def wait(self):
        """Drain pending writes and stop the worker."""
        self._q.put(None)
        self._done.wait()
        self._thread.join(timeout=60)
        if self._err is not None:
            raise self._err
