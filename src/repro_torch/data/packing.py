"""Document packing into static shapes (the paper's Step-1 discipline):
a copy of ``repro.data.packing`` (numpy only).

NPUs (and jit) want fixed input shapes; variable-length documents are packed
greedily into fixed ``seq_len`` rows.  Loss masking uses label ``-1`` on
padding and on positions that cross a document boundary, so no gradient
flows across packed documents.
"""
from __future__ import annotations

from typing import Dict, Iterable, Iterator, List

import numpy as np


def pack_documents(docs: Iterable[List[int]], seq_len: int,
                   pad_id: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Greedy first-fit packing; yields {"tokens", "labels", "segments"}."""
    buf_tokens: List[int] = []
    buf_labels: List[int] = []
    buf_segments: List[int] = []
    seg = 1

    def flush():
        nonlocal buf_tokens, buf_labels, buf_segments, seg
        pad = seq_len - len(buf_tokens)
        tokens = np.asarray(buf_tokens + [pad_id] * pad, np.int32)
        labels = np.asarray(buf_labels + [-1] * pad, np.int32)
        segments = np.asarray(buf_segments + [0] * pad, np.int32)
        buf_tokens, buf_labels, buf_segments = [], [], []
        seg = 1
        return {"tokens": tokens, "labels": labels, "segments": segments}

    for doc in docs:
        doc = list(doc)
        while doc:
            space = seq_len - len(buf_tokens)
            take = doc[:space]
            doc = doc[space:]
            labels = list(take)
            if buf_tokens:
                labels[0] = -1  # no cross-document prediction
            buf_tokens += take
            buf_labels += labels
            buf_segments += [seg] * len(take)
            seg += 1
            if len(buf_tokens) == seq_len:
                yield flush()
    if buf_tokens:
        yield flush()


def batch_packed(packed: Iterator[Dict[str, np.ndarray]], batch: int
                 ) -> Iterator[Dict[str, np.ndarray]]:
    rows: List[Dict[str, np.ndarray]] = []
    for row in packed:
        rows.append(row)
        if len(rows) == batch:
            yield {k: np.stack([r[k] for r in rows]) for k in rows[0]}
            rows = []
