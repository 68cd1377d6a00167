"""The MoE transformers (qwen3-moe-30b-a3b, grok-1-314b) through the port's
wave and continuous engines against the JAX engines, and every new arch
through the CLI, on the CPU (the layer and the model calls:
``tests/test_torch_moe.py``, whose weight pairs this file shares).

Reduced configs in fp32 with the JAX params carried across.  An MoE row's
output depends on every token of the call (capacity and drops), so each
engine is held to the JAX engine with the same options, token for token:
the rows it passes (padding rows of a bucket, the continuous engine's
empty slots, chunked prefill, verify windows, prefix-cache hits) are part
of the result.  No test here holds speculation or the cache to plain
decode: for an MoE model they are other calls.
"""
import numpy as np
import pytest

from repro.serve import ContinuousEngine as JContinuous, \
    Engine as JEngine, ServeConfig as JServeConfig
from repro_torch.launch import serve as tserve
from repro_torch.nn import quant as tquant
from repro_torch.serve import ContinuousEngine, Engine, ServeConfig
from test_torch_moe import ARCHS, _pair


LENGTHS = (5, 14, 3, 11, 28, 9)
SERVE = dict(prefill_buckets=(16, 32), max_new_tokens=6)


def _serve(engine, prompts, budgets=None):
    for i, p in enumerate(prompts):
        engine.submit(p, None if budgets is None else budgets[i])
    done = engine.run()
    if hasattr(engine, "close"):
        engine.close()
    return {r.uid: r.out_tokens for r in done}


def _prompts(seed, lengths=LENGTHS):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 512, int(n)).tolist() for n in lengths]


@pytest.mark.parametrize("arch", ARCHS)
def test_wave_engine_matches_jax_engine(arch):
    """Padding rows in both buckets, more requests than slots."""
    jm, jp, tm, tp = _pair(arch)
    prompts = _prompts(13)
    kw = dict(SERVE, max_batch=2)
    tout = _serve(Engine(tm, tp, ServeConfig(**kw)), prompts)
    assert tout == _serve(JEngine(jm, jp, JServeConfig(**kw)), prompts)
    assert all(len(v) == 6 for v in tout.values())


@pytest.mark.parametrize("arch,kw", [
    pytest.param("qwen3-moe-30b-a3b", dict(max_batch=2), id="qwen-mono"),
    pytest.param("qwen3-moe-30b-a3b", dict(max_batch=2, prefill_chunk=8),
                 id="qwen-chunk8"),
    pytest.param("qwen3-moe-30b-a3b", dict(max_batch=4, prefill_chunk=8),
                 id="qwen-chunk8-empty-slots"),
    pytest.param("grok-1-314b", dict(max_batch=4), id="grok-mono-empty"),
    pytest.param("grok-1-314b", dict(max_batch=2, prefill_chunk=8),
                 id="grok-chunk8")])
def test_continuous_engine_matches_jax_engine(arch, kw):
    """Monolithic and chunked prefill, rows refilled mid-decode; with four
    slots for three requests the empty slots ride in every call, as in
    the JAX engine."""
    jm, jp, tm, tp = _pair(arch)
    prompts = _prompts(14, LENGTHS[:3] if kw["max_batch"] == 4 else LENGTHS)
    cfg = dict(SERVE, **kw)
    tout = _serve(ContinuousEngine(tm, tp, ServeConfig(**cfg)), prompts)
    assert tout == _serve(JContinuous(jm, jp, JServeConfig(**cfg)), prompts)
    assert all(len(v) == 6 for v in tout.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_speculative_engine_matches_jax_engine(arch):
    """Bursts of 3 with a W8 draft (both engines quantize their own) and
    chunked prefill: the JAX engine's tokens.  Not held to plain decode:
    an MoE verify window routes its tokens together."""
    jm, jp, tm, tp = _pair(arch)
    prompts = _prompts(17, (5, 14, 9, 12, 7))
    budgets = [8, 5, 8, 4, 6]
    cfg = dict(max_batch=2, prefill_buckets=(16,), max_new_tokens=8,
               prefill_chunk=8, speculate_k=3)
    eng = ContinuousEngine(tm, tp, ServeConfig(**cfg))
    tout = _serve(eng, prompts, budgets)
    assert tout == _serve(JContinuous(jm, jp, JServeConfig(**cfg)), prompts,
                          budgets)
    assert eng.metrics.summary()["spec_bursts"] > 0


@pytest.mark.parametrize("spec", [0, 3], ids=["cache", "cache+spec"])
def test_prefix_cache_engine_matches_jax_engine(spec):
    """A shared 24-token system prompt: the same tokens and the same hits,
    misses and hit tokens as the JAX engine (qwen3-moe)."""
    jm, jp, tm, tp = _pair("qwen3-moe-30b-a3b")
    rng = np.random.default_rng(21)
    sys_p = rng.integers(1, 512, 24).tolist()
    prompts = [sys_p + rng.integers(1, 512, 8 * int(rng.choice((1, 2))))
               .tolist() for _ in range(5)]
    budgets = [4, 6, 3, 5, 6]
    cfg = dict(max_batch=2, prefill_buckets=(48,), max_new_tokens=6,
               prefill_chunk=8, prefix_cache_mb=8.0, speculate_k=spec)
    teng = ContinuousEngine(tm, tp, ServeConfig(**cfg))
    jeng = JContinuous(jm, jp, JServeConfig(**cfg))
    tout = _serve(teng, prompts, budgets)
    assert tout == _serve(jeng, prompts, budgets)
    js, ts = jeng.prefix_cache.stats(), teng.prefix_cache.stats()
    assert ts["hits"] >= 1
    for key in ("hits", "misses", "hit_tokens", "inserts", "nodes"):
        assert ts[key] == js[key], key


@pytest.mark.parametrize("engine", ["wave", "continuous"])
@pytest.mark.parametrize("arch", [
    "qwen3-moe-30b-a3b", "grok-1-314b", "llava-next-mistral-7b",
    "deepseek-7b", "internlm2-20b", "mamba2-2.7b"])
def test_cli_serves_the_new_archs_on_cpu(arch, engine):
    """``--arch`` resolves each new arch; its reduced config serves three
    requests (the continuous engine with chunk 16 and W8 weights),
    finite logits, every token in the vocabulary."""
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--engine",
            engine, "--requests", "3", "--batch", "2", "--max-new", "3"]
    if engine == "continuous":
        argv += ["--prefill-chunk", "16", "--quant", "w8"]
    eng, done = tserve.main(argv)
    assert eng.model.cfg.name == arch
    assert len(done) == 3 and all(len(r.out_tokens) == 3 for r in done)
    assert all(0 <= t < 512 for r in done for t in r.out_tokens)
    assert eng.metrics.summary()["nonfinite_logit_rows"] == 0
    if engine == "continuous":
        assert tquant.is_quantized(eng.params["lm_head"]["w"]
                                   if "lm_head" in eng.params else
                                   eng.params["layers"][0]["mixer"][
                                       "in_proj"]["w"])
