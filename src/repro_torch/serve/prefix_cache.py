"""Prefix-state radix cache: cross-request reuse of recurrent state (port
of ``repro.serve.prefix_cache``).

Re-prefilling shared prompt prefixes (system prompts, few-shot templates,
multi-turn history) is the continuous engine's biggest source of wasted
compute, and SSMs make eliminating it cheap: a prefix of ANY length is
summarized by a small fixed-size recurrent state (SSM state + conv tail,
RG-LRU ``h``), where a transformer needs length-proportional KV rows.
This module caches those states at chunk-boundary snapshots so a new
admission can skip straight past any previously served prefix.

Keying: the padded staged stream, at ``chunk`` granularity
----------------------------------------------------------
The cache is a radix tree whose edges are fixed-stride token chunks: the
node at depth ``d`` holds the state snapshot after consuming the first
``d * chunk`` tokens of a staged prompt.  The key is the stream the chunk
calls actually process, the left-padded prompt
(``serve/continuous.py: _admit_chunked``), not the raw prompt, which is
what makes a restored request bit-identical to recomputing: the snapshot
is the exact state the same stream produced, so greedy outputs with the
cache on and off cannot diverge.  The flip side is an alignment rule: two
prompts share entries only when their padded streams share chunks, i.e.
the shared prefix must sit at the same offset from the pad (prompt
lengths congruent mod ``chunk``).

Mechanics
---------
* **Nodes** are refcounted: the engine pins the matched node at admission
  and every node it traverses or creates while staging, and releases
  them when the request leaves staging.  Eviction only removes *unpinned
  leaves*, so an interior node is protected by its children and a
  snapshot a live slot is restoring from cannot be collected under it.
  Restores COPY the snapshot into the pool row, so even an eviction after
  the release cannot corrupt a live slot.
* **Byte budget**: a snapshot is what ``model.export_state`` returns:
  fresh tensors that stay on the model's device (the card, when serving
  there).  This is where the port differs from the JAX package, which
  copies snapshots to the host.  The budget counts those tensors' bytes,
  a transformer's KV rows clipped to the prefix
  (``nn/attention.py: snapshot_keep_len``).  Inserting past
  ``capacity_bytes`` evicts least-recently-used leaves first; if pins
  block eviction the insert is *refused*, so residency never exceeds the
  budget.
* **Metrics**: hits, misses, hit tokens, inserts, refused inserts,
  evictions, resident and peak bytes (:meth:`PrefixCache.stats`); a
  tracer gets ``prefix_evict`` and ``prefix_insert_refused`` instants.

The trie itself is host Python (dict walks over token tuples); the device
work is the pools' row copies.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.serve.tracing import NULL_TRACER


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def snapshot_nbytes(snapshot) -> int:
    """Bytes of a snapshot's tensors (a tuple, dict or list of them)."""
    total = 0
    for leaf in _leaves(snapshot):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        else:
            total += np.asarray(leaf).nbytes
    return total


def chunk_key(tokens: Sequence[int], chunk: int) -> List[Tuple[int, ...]]:
    """Split a (padded) token stream into the cache's edge labels: one
    tuple per full ``chunk`` tokens.  A trailing partial chunk is dropped:
    snapshots exist only at chunk boundaries."""
    toks = [int(t) for t in tokens]
    return [tuple(toks[i:i + chunk])
            for i in range(0, len(toks) - chunk + 1, chunk)]


class _Node:
    __slots__ = ("chunk", "parent", "children", "snapshot", "nbytes",
                 "refs", "stamp")

    def __init__(self, chunk, parent, snapshot, nbytes, stamp):
        self.chunk = chunk          # edge label from parent (token tuple)
        self.parent = parent
        self.children: Dict[Tuple[int, ...], _Node] = {}
        self.snapshot = snapshot    # batch-1 state rows on the device
        self.nbytes = nbytes
        self.refs = 0               # pins by in-flight stagings
        self.stamp = stamp          # LRU clock at last touch

    @property
    def depth(self) -> int:
        d, n = 0, self
        while n.parent is not None:
            d, n = d + 1, n.parent
        return d


class PrefixCache:
    """Token-keyed radix cache of chunk-boundary state snapshots."""

    def __init__(self, capacity_bytes: int, chunk: int, tracer=NULL_TRACER):
        if chunk <= 0:
            raise ValueError("prefix cache chunk must be positive")
        self.capacity_bytes = int(capacity_bytes)
        self.chunk = int(chunk)
        self.tracer = tracer
        self.root = _Node(None, None, None, 0, 0)
        self._nodes: List[_Node] = []
        self.resident_bytes = 0
        self._clock = 0
        self.reset_stats()

    def reset_stats(self) -> None:
        """Zero the event counters (peak tracks residency from now on);
        the entries are kept: use a fresh cache to drop them."""
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0
        self.inserts = 0
        self.inserts_refused = 0
        self.evictions = 0
        self.peak_bytes = self.resident_bytes

    def _touch(self, node: _Node) -> None:
        self._clock += 1
        node.stamp = self._clock

    def __len__(self) -> int:
        return len(self._nodes)

    def match(self, chunks: Sequence[Tuple[int, ...]],
              max_depth: Optional[int] = None,
              pin: bool = True) -> Tuple[Optional[_Node], int]:
        """Longest cached prefix of ``chunks``: ``(node, depth)`` with
        ``depth * chunk`` tokens already summarized by ``node.snapshot``,
        or ``(None, 0)``.  ``max_depth`` caps the walk (the engine always
        leaves at least one chunk to run: the final chunk's logits give
        the first sampled token).  Touches the whole matched path (LRU)
        and, with ``pin``, takes a reference on the matched node that the
        caller must :meth:`release`."""
        node, depth = self.root, 0
        limit = len(chunks) if max_depth is None else min(len(chunks),
                                                          max_depth)
        while depth < limit and chunks[depth] in node.children:
            node = node.children[chunks[depth]]
            depth += 1
            self._touch(node)
        if depth == 0:
            self.misses += 1
            return None, 0
        self.hits += 1
        self.hit_tokens += depth * self.chunk
        if pin:
            node.refs += 1
        return node, depth

    def child(self, node: Optional[_Node], chunk: Tuple[int, ...],
              pin: bool = True) -> Optional[_Node]:
        """Existing child of ``node`` (the root when None) along
        ``chunk``, touched and optionally pinned; None when absent."""
        got = (node or self.root).children.get(chunk)
        if got is not None:
            self._touch(got)
            if pin:
                got.refs += 1
        return got

    def insert(self, node: Optional[_Node], chunk: Tuple[int, ...],
               snapshot, pin: bool = True) -> Optional[_Node]:
        """Attach a snapshot under ``node`` (the root when None) along
        edge ``chunk``.  Returns the (pinned) new node, the existing child
        if another staging already inserted it, or None when the byte
        budget cannot admit it (nothing evictable): residency never
        exceeds ``capacity_bytes``."""
        parent = node or self.root
        if chunk in parent.children:
            return self.child(parent, chunk, pin=pin)
        nbytes = snapshot_nbytes(snapshot)
        if not self._make_room(nbytes):
            self.inserts_refused += 1
            self.tracer.instant("prefix_insert_refused", nbytes=nbytes,
                                resident_bytes=self.resident_bytes)
            return None
        self._clock += 1
        child = _Node(chunk, parent, snapshot, nbytes, self._clock)
        parent.children[chunk] = child
        self._nodes.append(child)
        self.resident_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.resident_bytes)
        self.inserts += 1
        if pin:
            child.refs += 1
        return child

    def release(self, node: _Node) -> None:
        """Drop one pin (the inverse of ``pin=True`` in match / insert)."""
        node.refs -= 1
        assert node.refs >= 0, "prefix-cache refcount underflow"

    def _make_room(self, need: int) -> bool:
        """Evict LRU unpinned leaves until ``need`` fits; False when pins
        (or the budget itself) make that impossible."""
        if need > self.capacity_bytes:
            return False
        while self.resident_bytes + need > self.capacity_bytes:
            victim = None
            for n in self._nodes:
                if n.children or n.refs:
                    continue
                if victim is None or n.stamp < victim.stamp:
                    victim = n
            if victim is None:
                return False
            self._evict(victim)
        return True

    def _evict(self, node: _Node) -> None:
        node.parent.children.pop(node.chunk)
        self._nodes.remove(node)
        self.resident_bytes -= node.nbytes
        node.snapshot = None
        self.evictions += 1
        self.tracer.instant("prefix_evict", nbytes=node.nbytes,
                            resident_bytes=self.resident_bytes)

    def stats(self) -> dict:
        return {
            "nodes": len(self._nodes),
            "resident_bytes": self.resident_bytes,
            "peak_bytes": self.peak_bytes,
            "capacity_bytes": self.capacity_bytes,
            "hits": self.hits,
            "misses": self.misses,
            "hit_tokens": self.hit_tokens,
            "inserts": self.inserts,
            "inserts_refused": self.inserts_refused,
            "evictions": self.evictions,
        }
