"""The port's prefix-state cache against the JAX package, on the CPU: the
trie (longest-prefix match, LRU leaf eviction under a byte budget,
refcount pins; the JAX suite's unit tests, ``tests/test_prefix_cache.py``,
run against ``repro_torch.serve.PrefixCache`` with torch snapshots), and
the continuous engine with the cache on: greedy-identical to the cache
off for all four families and to the JAX engine with the cache for
mamba2 and mamba1, a repeated prompt running only its last chunk, eviction under
pressure, a coarse ``prefix_chunk``, and the cache with speculation.
The models are the JAX suite's (d_model 32, fp32); the JAX params are
carried across with ``from_jax_params``.
"""
import numpy as np
import pytest
import torch

from repro.serve import ContinuousEngine as JContinuous, \
    ServeConfig as JServeConfig
from repro_torch.serve import ContinuousEngine, PrefixCache, ServeConfig
from repro_torch.serve.prefix_cache import chunk_key, snapshot_nbytes
from test_torch_speculative import FAMILIES, V, _pair


def _snap(nbytes):
    """A snapshot of a known size."""
    return {"s": torch.zeros(nbytes, dtype=torch.uint8)}


# ---------------------------------------------------------------------------
# the trie
# ---------------------------------------------------------------------------
def test_chunk_key_splits_full_chunks_only():
    assert chunk_key([1, 2, 3, 4, 5, 6, 7], 3) == [(1, 2, 3), (4, 5, 6)]
    assert chunk_key([1, 2], 3) == []
    assert chunk_key(np.arange(4), 2) == [(0, 1), (2, 3)]


def test_snapshot_nbytes_counts_tensor_bytes():
    _, _, tm, _ = _pair("mamba2")
    cache = tm.init_cache(3, 16, torch.float32)
    snap = tm.export_state(cache, 8, [1])
    want = sum(leaf[:, :1].numel() * 4 for leaf in cache)
    assert snapshot_nbytes(snap) == want
    assert snapshot_nbytes(_snap(40)) == 40
    assert all(leaf.device == cache[0].device for leaf in snap)


def test_trie_longest_prefix_match_and_depth_cap():
    cache = PrefixCache(1 << 20, chunk=2)
    key = chunk_key([1, 2, 3, 4, 5, 6], 2)
    node = None
    for i, c in enumerate(key):
        node = cache.insert(node, c, _snap(8))
        assert node is not None and node.depth == i + 1
    got, depth = cache.match(key, pin=False)
    assert depth == 3 and got.depth == 3
    got, depth = cache.match(chunk_key([1, 2, 3, 4, 9, 9], 2), pin=False)
    assert depth == 2 and got.depth == 2
    got, depth = cache.match(key, max_depth=1, pin=False)
    assert depth == 1
    got, depth = cache.match(chunk_key([9, 9], 2), pin=False)
    assert got is None and depth == 0
    s = cache.stats()
    assert s["hits"] == 3 and s["misses"] == 1
    assert s["hit_tokens"] == (3 + 2 + 1) * 2


def test_trie_existing_child_insert_is_a_no_op():
    cache = PrefixCache(1 << 20, chunk=2)
    a = cache.insert(None, (1, 2), _snap(8), pin=False)
    b = cache.insert(None, (1, 2), _snap(8), pin=False)
    assert a is b and cache.stats()["inserts"] == 1
    assert cache.resident_bytes == snapshot_nbytes(_snap(8))


def test_lru_eviction_is_leaf_only_and_budget_bounded():
    cache = PrefixCache(100, chunk=1)
    a = cache.insert(None, (1,), _snap(40), pin=False)
    cache.insert(a, (2,), _snap(40), pin=False)
    # Interior node `a` is older but has a child: the leaf goes first.
    c = cache.insert(None, (3,), _snap(40), pin=False)
    assert c is not None
    assert cache.resident_bytes <= 100
    assert cache.stats()["evictions"] == 1
    assert (1,) in cache.root.children
    assert not cache.root.children[(1,)].children
    # A node larger than the whole budget is refused outright.
    assert cache.insert(None, (4,), _snap(200), pin=False) is None
    assert cache.stats()["inserts_refused"] == 1


def test_lru_order_evicts_least_recently_touched():
    cache = PrefixCache(100, chunk=1)
    cache.insert(None, (1,), _snap(40), pin=False)
    cache.insert(None, (2,), _snap(40), pin=False)
    cache.match(chunk_key([1], 1), pin=False)    # touch (1,): (2,) is LRU
    cache.insert(None, (3,), _snap(40), pin=False)
    assert set(cache.root.children) == {(1,), (3,)}


def test_refcount_pins_survive_eviction_pressure():
    cache = PrefixCache(100, chunk=1)
    pinned = cache.insert(None, (1,), _snap(60))
    assert pinned.refs == 1
    assert cache.insert(None, (2,), _snap(60), pin=False) is None
    assert cache.stats()["inserts_refused"] == 1
    got, _ = cache.match(chunk_key([1], 1))
    assert got is pinned and pinned.refs == 2
    cache.release(pinned)
    cache.release(pinned)
    assert cache.insert(None, (2,), _snap(60), pin=False) is not None
    assert set(cache.root.children) == {(2,)}
    assert cache.resident_bytes <= 100
    with pytest.raises(AssertionError, match="underflow"):
        cache.release(pinned)


def test_interleaved_stagings_share_and_extend_paths():
    """Two concurrent stagings: B matches A's partial path mid-insert,
    extends it divergently, and all pins release cleanly."""
    cache = PrefixCache(1 << 20, chunk=2)
    a_key = chunk_key([1, 2, 3, 4, 5, 6], 2)
    b_key = chunk_key([1, 2, 3, 4, 7, 8], 2)
    node = cache.insert(None, a_key[0], _snap(8))
    a_pins = [node]
    b_node, b_depth = cache.match(b_key)
    b_pins = [b_node]
    assert b_depth == 1 and b_node is node
    node = cache.insert(node, a_key[1], _snap(8))
    a_pins.append(node)
    got = cache.child(b_node, b_key[1])
    assert got is node
    b_pins.append(got)
    b_tail = cache.insert(got, b_key[2], _snap(8))
    a_tail = cache.insert(node, a_key[2], _snap(8))
    a_pins.append(a_tail)
    b_pins.append(b_tail)
    assert a_tail is not b_tail and len(cache) == 4
    for n in a_pins + b_pins:
        cache.release(n)
    assert all(n.refs == 0 for n in a_pins + b_pins)


def test_reset_stats_keeps_entries():
    cache = PrefixCache(1 << 20, chunk=1)
    cache.insert(None, (1,), _snap(8), pin=False)
    cache.match([(1,)], pin=False)
    cache.reset_stats()
    s = cache.stats()
    assert s["hits"] == s["inserts"] == 0 and s["nodes"] == 1
    assert s["peak_bytes"] == s["resident_bytes"] == 8
    with pytest.raises(ValueError):
        PrefixCache(100, chunk=0)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
def _shared_prefix_prompts(rng, n, sys_len=24, turn_chunks=(1, 2)):
    """A shared system prompt + per-request turns whose lengths are chunk
    multiples (the alignment rule: padded streams must share chunks)."""
    sys_p = rng.integers(1, V, sys_len).tolist()
    return [sys_p + rng.integers(1, V, 8 * int(rng.choice(turn_chunks)))
            .tolist() for _ in range(n)]


def _run(family, prompts, budgets, engine_cls=ContinuousEngine,
         cfg_cls=ServeConfig, **kw):
    jm, jp, tm, tp = _pair(family)
    model, params = (tm, tp) if engine_cls is ContinuousEngine else (jm, jp)
    eng = engine_cls(model, params, cfg_cls(prefill_chunk=8, **kw))
    for p, m in zip(prompts, budgets):
        eng.submit(p, m)
    done = eng.run()
    if hasattr(eng, "close"):
        eng.close()
    return {r.uid: r.out_tokens for r in done}, eng


@pytest.mark.parametrize("family", FAMILIES)
def test_engine_greedy_identity_cache_on_off(family):
    """Greedy outputs with the cache on equal those with it off, with real
    cross-request hits, and every pin released when staging ends."""
    rng = np.random.default_rng(7)
    prompts = _shared_prefix_prompts(rng, 6)
    budgets = [3, 5, 2, 6, 4, 3]
    kw = dict(max_batch=2, prefill_buckets=(48,), max_new_tokens=6)
    off, _ = _run(family, prompts, budgets, **kw)
    on, eng = _run(family, prompts, budgets, prefix_cache_mb=8.0, **kw)
    assert on == off
    s = eng.prefix_cache.stats()
    assert s["hits"] >= 1
    m = eng.metrics.summary()
    assert m["prefix_hits"] == s["hits"] and \
        m["prefix_misses"] == s["misses"]
    assert m["prefix_hit_tokens"] == s["hit_tokens"] > 0
    assert all(n.refs == 0 for n in eng.prefix_cache._nodes)


def test_engine_repeated_prompt_skips_all_but_last_chunk():
    prompt = np.random.default_rng(9).integers(1, V, 32).tolist()
    on, eng = _run("mamba2", [prompt, prompt], [3, 3], max_batch=1,
                   prefill_buckets=(32,), max_new_tokens=3,
                   prefix_cache_mb=8.0)
    assert on[1] == on[2]
    # The second admission matched span - chunk tokens: the cap leaves one
    # chunk, whose last logits give the first token.
    assert eng.metrics.prefix_hit_tokens == 32 - 8
    assert eng.metrics.summary()["prefill_tokens"] == 32 + 8


def test_engine_eviction_under_pressure_never_corrupts_live_slots():
    """A budget that forces constant eviction changes nothing about the
    outputs: restores copy out of the cache, and pinned paths refuse
    eviction rather than dangle."""
    rng = np.random.default_rng(11)
    prompts = _shared_prefix_prompts(rng, 8, sys_len=24)
    budgets = [3, 4, 2, 5, 3, 4, 2, 3]
    kw = dict(max_batch=3, prefill_buckets=(48,), max_new_tokens=5)
    off, _ = _run("dense", prompts, budgets, **kw)
    # A few dense snapshots of this config fit in 64 KB: hot churn.
    on, eng = _run("dense", prompts, budgets, prefix_cache_mb=0.0625, **kw)
    assert on == off
    s = eng.prefix_cache.stats()
    assert s["evictions"] >= 1 or s["inserts_refused"] >= 1
    assert s["peak_bytes"] <= eng.prefix_cache.capacity_bytes
    assert all(n.refs == 0 for n in eng.prefix_cache._nodes)


def test_engine_prefix_cache_requires_chunked_prefill():
    _, _, tm, tp = _pair("mamba2")
    with pytest.raises(ValueError, match="prefill_chunk"):
        ContinuousEngine(tm, tp, ServeConfig(prefix_cache_mb=1.0))
    with pytest.raises(ValueError, match="multiple"):
        ContinuousEngine(tm, tp, ServeConfig(
            prefill_chunk=8, prefix_cache_mb=1.0, prefix_chunk=12))


def test_engine_coarse_prefix_chunk_grain():
    """prefix_chunk = 2 x prefill_chunk: a snapshot every other chunk,
    hits quantized to the coarser grain, outputs unchanged."""
    rng = np.random.default_rng(13)
    prompts = _shared_prefix_prompts(rng, 4, sys_len=32, turn_chunks=(2,))
    kw = dict(max_batch=2, prefill_buckets=(48,), max_new_tokens=4)
    off, _ = _run("mamba2", prompts, [None] * 4, **kw)
    on, eng = _run("mamba2", prompts, [None] * 4, prefix_cache_mb=8.0,
                   prefix_chunk=16, **kw)
    assert on == off
    s = eng.prefix_cache.stats()
    assert s["hits"] >= 1 and s["hit_tokens"] % 16 == 0


@pytest.mark.parametrize("family", ["mamba2", "mamba1"])
def test_engine_prefix_cache_matches_jax_engine(family):
    """The port's engine with the cache against the JAX engine with it:
    the same tokens and the same hits, misses and hit tokens."""
    rng = np.random.default_rng(21)
    prompts = _shared_prefix_prompts(rng, 6)
    budgets = [4, 6, 3, 5, 6, 2]
    kw = dict(max_batch=2, prefill_buckets=(48,), max_new_tokens=6,
              prefix_cache_mb=8.0)
    jout, jeng = _run(family, prompts, budgets, JContinuous, JServeConfig,
                      **kw)
    tout, teng = _run(family, prompts, budgets, **kw)
    assert tout == jout
    js, ts = jeng.prefix_cache.stats(), teng.prefix_cache.stats()
    for key in ("hits", "misses", "hit_tokens", "inserts", "nodes"):
        assert ts[key] == js[key], key


@pytest.mark.parametrize("family", ["mamba2", "rgemma"])
def test_engine_prefix_cache_with_speculation(family):
    """Both features on together: the outputs of the plain engine."""
    rng = np.random.default_rng(31)
    prompts = _shared_prefix_prompts(rng, 5)
    budgets = [6, 3, 6, 5, 4]
    kw = dict(max_batch=2, prefill_buckets=(48,), max_new_tokens=6)
    off, _ = _run(family, prompts, budgets, **kw)
    on, eng = _run(family, prompts, budgets, prefix_cache_mb=8.0,
                   speculate_k=3, **kw)
    assert on == off
    m = eng.metrics.summary()
    assert m["prefix_hits"] >= 1 and m["spec_bursts"] > 0


def test_engine_snapshots_never_alias_the_pools():
    """Cached snapshots are fresh tensors: none shares storage with the
    staging or decode pool, or with the speculation pools, so a restore
    is a copy and a later chunk or burst cannot write into the cache."""
    prompts = _shared_prefix_prompts(np.random.default_rng(1), 4)
    _, eng = _run("mamba2", prompts, [4] * 4, max_batch=2,
                  prefill_buckets=(48,), max_new_tokens=4,
                  prefix_cache_mb=1.0, speculate_k=2)
    pools = [eng.pool, eng._ppool, eng._dpool, eng._bpool]
    arenas = {leaf.untyped_storage().data_ptr()
              for pool in pools for leaf in pool.cache}
    assert len(arenas) == 2 * len(pools)
    nodes = eng.prefix_cache._nodes
    assert nodes
    for node in nodes:
        for leaf in node.snapshot:
            assert leaf.untyped_storage().data_ptr() not in arenas
