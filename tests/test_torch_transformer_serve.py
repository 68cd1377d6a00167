"""The port's dense transformer through the engines and the CLI against
the JAX package, on the CPU (the model and its kernels:
``test_torch_transformer.py``, whose helpers this file shares).

Reduced gemma-2b in fp32 with the JAX params carried across: the wave
engine with ``use_flash`` (kernel 9's plain version here, JAX's kernel in
interpret mode) and without, and the continuous engine with monolithic
and chunked prefill, token-identical to the JAX engines, greedy and at
temperature 0.8 (both packages draw the same keyed noise from numpy);
the cache's row operations; the CLI for gemma-2b and qwen1.5-4b.
"""
import numpy as np
import pytest
import torch

from repro.serve import ContinuousEngine as JContinuous, \
    Engine as JEngine, ServeConfig as JServeConfig
from repro_torch.launch import serve as tserve
from repro_torch.serve import ContinuousEngine, Engine, ServeConfig, \
    StatePool
from test_torch_transformer import _pair

LENGTHS = (5, 14, 3, 11, 28, 9)
SERVE = dict(max_batch=2, prefill_buckets=(16, 32), max_new_tokens=6)


def _serve(engine, prompts):
    for p in prompts:
        engine.submit(p)
    return {r.uid: r.out_tokens for r in engine.run()}


def _prompts(seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 512, int(n)).tolist() for n in LENGTHS]


@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy", "t0.8"])
@pytest.mark.parametrize("flash", [True, False], ids=["flash", "tensor"])
def test_wave_engine_matches_jax_engine(flash, temperature):
    """Same weights and requests (both buckets, more requests than slots):
    token-identical outputs."""
    jm, jp, tm, tp = _pair("gemma-2b", flash=flash, seed=7)
    prompts = _prompts(13)
    kw = dict(SERVE, temperature=temperature, seed=3)
    tout = _serve(Engine(tm, tp, ServeConfig(**kw)), prompts)
    assert tout == _serve(JEngine(jm, jp, JServeConfig(**kw)), prompts)
    assert all(len(v) == 6 for v in tout.values())


@pytest.mark.parametrize("chunk,temperature", [(None, 0.0), (16, 0.0),
                                               (16, 0.8)],
                         ids=["monolithic", "chunk16", "chunk16-t0.8"])
def test_continuous_engine_matches_jax_engine(chunk, temperature):
    """Monolithic and chunked prefill (per-row positions and offsets,
    rows refilled mid-decode), greedy and sampled."""
    jm, jp, tm, tp = _pair("gemma-2b", flash=True, seed=8)
    prompts = _prompts(14)
    kw = dict(SERVE, prefill_chunk=chunk, temperature=temperature, seed=5)
    tout = _serve(ContinuousEngine(tm, tp, ServeConfig(**kw)), prompts)
    assert tout == _serve(JContinuous(jm, jp, JServeConfig(**kw)), prompts)
    assert all(len(v) == 6 for v in tout.values())


def test_state_pool_row_ops_on_the_stacked_kv_cache():
    """The pool's row operations move rows of the stacked (n_layers, b,
    T, n_kv, hd) cache on batch axis 1; a clipped snapshot restores."""
    _, _, tm, tp = _pair("qwen1.5-4b", seed=9)
    toks = torch.from_numpy(np.random.default_rng(9).integers(1, 512, (3, 10)))
    with torch.inference_mode():
        _, cache = tm.prefill(tp, {"tokens": toks},
                              tm.init_cache(3, 16, torch.float32))
        pool = StatePool(tm, 3, 16, torch.float32)
        pool.insert_rows(cache, [1], [2])
        assert all(torch.equal(a[:, 2], c[:, 1])
                   for a, c in zip(pool.cache, cache))
        snap = pool.clone_row(2, index=10)
        assert snap.k.shape == (2, 1, 10, 4, 32)
        pool.reset_rows([2])
        assert not any(a.any() for a in pool.cache)
        pool.restore_row(0, snap, index=10)
        assert all(torch.equal(a[:, 0], c[:, 1])
                   for a, c in zip(pool.cache, cache))
        extracted = pool.extract_rows([0])
        assert all(torch.equal(e[:, 0], c[:, 1])
                   for e, c in zip(extracted, cache))


@pytest.mark.parametrize("arch,engine", [("gemma-2b", "wave"),
                                         ("gemma-2b", "continuous"),
                                         ("qwen1.5-4b", "continuous")])
def test_cli_serves_the_transformer_on_cpu(arch, engine):
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--engine",
            engine, "--requests", "3", "--batch", "2", "--max-new", "3"]
    if engine == "continuous":
        argv += ["--prefill-chunk", "16"]
    eng, done = tserve.main(argv)
    assert eng.model.cfg.family == "transformer"
    assert ("lm_head" in eng.params) == (arch == "qwen1.5-4b")
    assert len(done) == 3 and all(len(r.out_tokens) == 3 for r in done)
    assert all(0 <= t < 512 for r in done for t in r.out_tokens)
    assert eng.metrics.summary()["nonfinite_logit_rows"] == 0
    with pytest.raises(NotImplementedError, match="W8"):
        tserve.main(argv + ["--quant", "w8"])
