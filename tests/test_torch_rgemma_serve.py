"""The port's RecurrentGemma model, engines and CLI against the JAX
package, on the CPU (its modules and kernels: ``test_torch_rgemma.py``,
whose small model, helpers and tolerances this file shares).

The model's prefill and decode logits at depths 3, 5 and 7 against the
JAX model with per-layer and group-stacked caches, chunked prefill
across the window, ``loss`` under ``optimized()`` and ``pallas()``, the
bf16 rounding points, the wave and continuous engines (monolithic and
chunked prefill, a ring that prompts and decodes wrap) greedy-identical
to the JAX engines, the cache's row operations, and the CLI.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.xamba import XambaConfig as JXamba
from repro.serve import ContinuousEngine as JContinuous, \
    Engine as JEngine, ServeConfig as JServeConfig
from repro_torch.core.xamba import XambaConfig
from repro_torch.launch import serve as tserve
from repro_torch.serve import ContinuousEngine, Engine, ServeConfig
from test_torch_rgemma import BF16_STEP, RG_TOL, RTOL, V, _pair, _rel


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_layers,scan", [(3, True), (5, False), (5, True),
                                           (7, False)])
def test_model_prefill_and_decode_match_jax(n_layers, scan):
    """Prefill of 12 tokens then 8 greedy decode steps (the ring of 8
    wraps) against the JAX model with its per-layer or group-stacked
    caches (``scan_layers``): logits within ``RG_TOL`` at every step."""
    jm, jp, tm, tp = _pair(seed=n_layers, n_layers=n_layers,
                           scan_layers=scan)
    jdecode = jax.jit(jm.decode_step)
    toks = np.random.default_rng(n_layers).integers(1, V, (2, 12))
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)},
                                 jm.init_cache(2, 30, jnp.float32))
    view = tm.decode_view(tp)
    with torch.inference_mode():
        tl, tc = tm.prefill(view, {"tokens": torch.from_numpy(toks)},
                            tm.init_cache(2, 30, torch.float32))
        assert tc.k.shape[2] == 8                           # a ring
        assert _rel(tl, jl) <= RG_TOL
        for t in range(8):
            tok = np.asarray(jl).argmax(-1)[:, None]
            jl, jc = jdecode(jp, jnp.asarray(tok), jc, jnp.int32(12 + t))
            tl, tc = tm.decode_step(view, torch.from_numpy(tok), tc, 12 + t)
            assert _rel(tl, jl) <= RG_TOL


def test_prefill_chunk_equals_one_prefill_across_the_window():
    """A 20-token prompt fed in chunks of 6 (per-row offsets, a ring of
    8 the chunks wrap) gives the one-call prefill's logits and state,
    and the JAX model's chunk by chunk; so does a linear cache."""
    jm, jp, tm, tp = _pair(seed=4)
    jchunk = jax.jit(jm.prefill_chunk)
    toks = np.random.default_rng(4).integers(1, V, (2, 18))
    for max_seq in (24, 6):                      # linear, then a ring
        cache = tm.init_cache(2, max_seq if max_seq > 8 else 40,
                              torch.float32)
        jc = jm.init_cache(2, max_seq if max_seq > 8 else 40, jnp.float32)
        with torch.inference_mode():
            whole, wc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                                   cache)
            c = cache
            for i in range(0, 18, 6):
                tl, c = tm.prefill_chunk(tp, torch.from_numpy(toks[:, i:i + 6]),
                                         c, np.array([i, i]))
                jl, jc = jchunk(jp, jnp.asarray(toks[:, i:i + 6]), jc,
                                jnp.asarray([i, i], jnp.int32))
                assert _rel(tl, jl) <= RG_TOL
        assert _rel(tl, whole) <= RG_TOL
        for a, r in zip(c, wc):
            assert _rel(a, r.numpy()) <= RTOL


@pytest.mark.parametrize("preset", ["optimized", "pallas"])
def test_loss_matches_jax(preset):
    """``loss`` (the cache-less trunk: the associative scan, or under
    ``pallas()`` kernels 8 and 11's plain versions and the ActiBA tables)
    against the JAX model's, with its metrics."""
    jx = JXamba.optimized() if preset == "optimized" else \
        JXamba.pallas(interpret=True)
    tx = XambaConfig.optimized() if preset == "optimized" else \
        XambaConfig.pallas()
    jm, jp, tm, tp = _pair(seed=5, jxamba=jx, txamba=tx, n_layers=7)
    toks = np.random.default_rng(5).integers(0, V, (2, 20))
    labels = toks.copy()
    labels[0, :3] = -1
    jloss, jmet = jax.jit(jm.loss)(jp, {"tokens": jnp.asarray(toks),
                                        "labels": jnp.asarray(labels)})
    with torch.inference_mode():
        tloss, tmet = tm.loss(tp, {"tokens": torch.from_numpy(toks),
                                   "labels": torch.from_numpy(labels)})
    assert abs(float(tloss) - float(jloss)) <= 1e-5
    assert abs(float(tmet["accuracy"]) - float(jmet["accuracy"])) <= 1e-6
    assert int(tmet["tokens"]) == int(jmet["tokens"])


def test_bf16_model_rounds_where_jax_rounds():
    """bf16 weights: the embedding scale rounds to bf16 first (sqrt(32)
    -> 5.65625), and prefill and decode logits stay within a few bf16
    steps of the JAX model's."""
    jm, jp, tm, tp = _pair(seed=6, dtype="bfloat16")
    toks = np.random.default_rng(6).integers(1, V, (2, 10))
    x = tm._embed(tp, torch.from_numpy(toks))
    assert torch.equal(x, tp["embed"]["table"][torch.from_numpy(toks)]
                       * torch.tensor(5.65625, dtype=torch.bfloat16))
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)},
                                 jm.init_cache(2, 16, jnp.bfloat16))
    with torch.inference_mode():
        tl, tc = tm.prefill(tm.decode_view(tp), {"tokens": torch.from_numpy(
            toks)}, tm.init_cache(2, 16, torch.bfloat16))
        jl2, _ = jax.jit(jm.decode_step)(jp, jnp.asarray(toks[:, :1]), jc,
                                         jnp.int32(10))
        tl2, _ = tm.decode_step(tm.decode_view(tp),
                                torch.from_numpy(toks[:, :1]), tc, 10)
    for a, r in ((tl, jl), (tl2, jl2)):
        assert float(np.abs(a.numpy() - np.asarray(r)).max()) <= \
            4 * BF16_STEP * max(1.0, float(np.abs(np.asarray(r)).max()))


# ---------------------------------------------------------------------------
# engines, CLI
# ---------------------------------------------------------------------------
LENGTHS = (5, 14, 3, 11, 28, 9)
SERVE = dict(max_batch=2, prefill_buckets=(16, 32), max_new_tokens=6)


def _serve(engine, prompts):
    for p in prompts:
        engine.submit(p)
    return {r.uid: r.out_tokens for r in engine.run()}


def test_wave_engine_greedy_matches_jax_engine():
    """Same weights and requests (both buckets, more requests than slots,
    prompts past the window): token-identical greedy outputs."""
    jm, jp, tm, tp = _pair(seed=7, scan_layers=False)
    rng = np.random.default_rng(13)
    prompts = [rng.integers(1, V, int(n)).tolist() for n in LENGTHS]
    tout = _serve(Engine(tm, tp, ServeConfig(**SERVE)), prompts)
    assert tout == _serve(JEngine(jm, jp, JServeConfig(**SERVE)), prompts)
    assert all(len(v) == 6 for v in tout.values())


@pytest.mark.parametrize("chunk,max_new", [(None, 6), (4, 6), (8, 12)],
                         ids=["monolithic", "chunk4", "chunk8-ring"])
def test_continuous_engine_greedy_matches_jax_engine(chunk, max_new):
    """Monolithic and chunked prefill (per-row positions and offsets,
    rows refilled mid-decode; with chunk 8 and 12 new tokens every cache
    is a ring that the 28-token prompt and the decode wrap)."""
    jm, jp, tm, tp = _pair(seed=8, scan_layers=False)
    rng = np.random.default_rng(14)
    prompts = [rng.integers(1, V, int(n)).tolist() for n in LENGTHS]
    kw = dict(SERVE, max_new_tokens=max_new, prefill_chunk=chunk)
    teng = ContinuousEngine(tm, tp, ServeConfig(**kw))
    if chunk == 8:
        assert teng.pool.cache.k.shape[2] == 8
    tout = _serve(teng, prompts)
    assert tout == _serve(JContinuous(jm, jp, JServeConfig(**kw)), prompts)
    assert all(len(v) == max_new for v in tout.values())


def test_state_row_ops_round_trip():
    """``export_state`` gathers rows (conv, h, k, v; batch axis 1) as
    fresh tensors, ``import_state`` writes them back into other rows, and
    the state pool's row ops move them between pools unchanged."""
    from repro_torch.serve import StatePool
    _, _, tm, tp = _pair(seed=9)
    toks = torch.from_numpy(np.random.default_rng(9).integers(1, V, (3, 10)))
    with torch.inference_mode():
        _, cache = tm.prefill(tp, {"tokens": toks},
                              tm.init_cache(3, 16, torch.float32))
        snap = tm.export_state(cache, None, [2, 0])
        assert all(a.shape[1] == 2 for a in snap)
        assert all(a.data_ptr() != c.data_ptr() for a, c in zip(snap, cache))
        fresh = tm.import_state(tm.init_cache(3, 16, torch.float32), None,
                                [0, 1], snap)
        for got, full in zip(fresh, cache):
            assert torch.equal(got[:, 0], full[:, 2])
            assert torch.equal(got[:, 1], full[:, 0])
            assert not got[:, 2].any()
        pool = StatePool(tm, 3, 16, torch.float32)
        pool.insert_rows(cache, [1], [2])
        assert all(torch.equal(a[:, 2], c[:, 1])
                   for a, c in zip(pool.cache, cache))
        pool.reset_rows([2])
        assert not any(a.any() for a in pool.cache)


@pytest.mark.parametrize("engine", ["wave", "continuous"])
def test_cli_serves_recurrentgemma_on_cpu(engine):
    argv = ["--arch", "recurrentgemma-2b", "--reduced", "--device", "cpu",
            "--engine", engine, "--requests", "3", "--batch", "2",
            "--max-new", "3"]
    if engine == "continuous":
        argv += ["--prefill-chunk", "16"]
    eng, done = tserve.main(argv)
    assert eng.model.cfg.family == "recurrentgemma"
    assert "kernel" in eng.params["layers"][0]["rglru"]
    assert len(done) == 3 and all(len(r.out_tokens) == 3 for r in done)
    assert all(0 <= t < 512 for r in done for t in r.out_tokens)
    assert eng.metrics.summary()["nonfinite_logit_rows"] == 0
    with pytest.raises(NotImplementedError, match="W8"):
        tserve.main(argv + ["--quant", "w8"])
