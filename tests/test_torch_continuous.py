"""The port's continuous engine against the JAX package's, on the CPU.

Greedy outputs of ``repro_torch.serve.ContinuousEngine`` and
``repro.serve.ContinuousEngine`` on the same weights (the JAX params
carried across with ``from_jax_params``) and the same requests are
token-identical: monolithic and chunked prefill, with and without a
prefill token budget, W8, more requests than slots, EOS on the prefill
token and one-token budgets, for mamba2 and for the reduced mamba-130m
(Mamba-1; ``Mamba1State`` rows in the same pools).  Also the state
pool's row operations, the model's snapshot API, the scheduler's chunk
span and the CLI.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ModelConfig as JModelConfig, build_model as jbuild
from repro.nn import quant as jquant
from repro.nn.params import init_params as jinit
from repro.serve import ContinuousEngine as JContinuous, \
    ServeConfig as JServeConfig
from repro.serve.scheduler import chunk_span as jchunk_span
from repro_torch.launch import serve as tserve
from repro_torch.models import ModelConfig, build_model
from repro_torch.nn import quant as tquant
from repro_torch.nn.params import from_jax_params
from repro_torch.serve import ContinuousEngine, Engine, ServeConfig, \
    StatePool
from repro_torch.serve.scheduler import chunk_span

V = 64
DIMS = dict(name="mamba2", family="mamba2", vocab_size=V, d_model=32,
            n_layers=2, d_state=8, ssm_head_dim=8, chunk_size=64,
            param_dtype="float32")
# The reduced mamba-130m (configs/mamba_130m.py: REDUCED) in fp32.
MAMBA1_DIMS = dict(name="mamba-130m", family="mamba", vocab_size=512,
                   d_model=128, n_layers=2, d_state=16, d_conv=4, expand=2,
                   dt_rank=8, param_dtype="float32")
FAMILY_DIMS = {"mamba2": DIMS, "mamba1": MAMBA1_DIMS}
# Prompts in both buckets (one truncated past 128), more than the slots.
LENGTHS = (5, 40, 17, 90, 3, 140)
SERVE = dict(max_batch=2, prefill_buckets=(32, 128), max_new_tokens=6)


def _family_cases(cases):
    """``cases`` (pytest.param's) for mamba2 under their own ids, then for
    mamba1 with ids prefixed ``mamba1-``."""
    return [pytest.param(fam, *c.values, id=c.id if fam == "mamba2"
                         else f"mamba1-{c.id}")
            for fam in FAMILY_DIMS for c in cases]


def _pair(w8=False, seed=0, family="mamba2"):
    """(JAX model, JAX params, port model, port params), one weight set;
    ``w8``: quantized in JAX and carried across."""
    dims = FAMILY_DIMS[family]
    jm = jbuild(JModelConfig(**dims))
    jp = jinit(jm.param_specs(), jax.random.PRNGKey(seed), jnp.float32)
    if w8:
        jp = jquant.quantize_params(jp)
    tm = build_model(ModelConfig(**dims), device="cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tm.cfg, device="cpu")
    return jm, jp, tm, tp


def _prompts(seed=3, lengths=LENGTHS):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, V, size=int(n)).tolist() for n in lengths]


def _serve(engine, prompts, budgets=None):
    for i, p in enumerate(prompts):
        engine.submit(p, None if budgets is None else budgets[i])
    return {r.uid: r.out_tokens for r in engine.run()}


@pytest.mark.parametrize("family,chunk,budget,w8", _family_cases(
    [pytest.param(c, b, w, id=f"{cid}-{wid}")
     for w, wid in ((False, "fp32"), (True, "w8"))
     for (c, b), cid in (((None, 0), "monolithic"), ((16, 0), "chunk16"),
                         ((16, 48), "chunk16_budget48"))]))
def test_continuous_greedy_matches_jax_engine(family, chunk, budget, w8):
    """Token-identical greedy outputs; rows are admitted mid-decode (six
    requests, two slots) and the chunked path's prompts span up to eight
    chunks of 16."""
    jm, jp, tm, tp = _pair(w8, family=family)
    kw = dict(SERVE, prefill_chunk=chunk, prefill_token_budget=budget)
    prompts = _prompts()
    jout = _serve(JContinuous(jm, jp, JServeConfig(**kw)), prompts)
    teng = ContinuousEngine(tm, tp, ServeConfig(**kw))
    tout = _serve(teng, prompts)
    assert tout == jout
    assert all(len(v) == 6 for v in tout.values())
    m = teng.metrics.summary()
    assert m["completed"] == len(prompts) and m["truncated"] == 1
    assert m["wall_source"] == "measured" and m["prefill_tokens"] > 0
    if chunk:
        assert m["prefill_tokens"] % chunk == 0


@pytest.mark.parametrize("family,chunk", _family_cases(
    [pytest.param(None, id="monolithic"), pytest.param(16, id="chunk16")]))
def test_continuous_eos_on_prefill_token_and_one_token_budget(family, chunk):
    """A request whose first token is EOS and a request with a one-token
    budget end at prefill and free their slot: the same outputs as the
    JAX engine, the EOS request holding exactly its first token."""
    jm, jp, tm, tp = _pair(seed=2, family=family)
    prompts = _prompts(seed=8, lengths=(12, 33, 7, 20, 50))
    kw = dict(SERVE, prefill_chunk=chunk)
    first = _serve(ContinuousEngine(tm, tp, ServeConfig(**kw)), prompts)
    eos = first[3][0]
    budgets = [None, 1, None, None, None]
    kw["eos_id"] = int(eos)
    jout = _serve(JContinuous(jm, jp, JServeConfig(**kw)), prompts, budgets)
    tout = _serve(ContinuousEngine(tm, tp, ServeConfig(**kw)), prompts,
                  budgets)
    assert tout == jout
    assert tout[3] == [eos] and len(tout[2]) == 1


def test_continuous_monolithic_matches_wave_engine():
    """The port's two engines serve the same greedy tokens, for each
    family.  Each engine left-pads a prompt to its prefill bucket, the
    wave engine to its wave's longest prompt's, so a prompt is padded
    alike in both only where both pick the same bucket; the mamba1
    prompts are all in the 128 bucket (with mamba2's mixed buckets the
    JAX package's two engines also part for mamba1)."""
    lengths = {"mamba2": (5, 40, 17, 90, 3), "mamba1": (40, 90, 33, 100, 60)}
    for family in FAMILY_DIMS:
        _, _, tm, tp = _pair(seed=4, family=family)
        prompts = _prompts(seed=5, lengths=lengths[family])
        wave = _serve(Engine(tm, tp, ServeConfig(**SERVE)), prompts)
        cont = _serve(ContinuousEngine(tm, tp, ServeConfig(**SERVE)),
                      prompts)
        assert cont == wave, family


def test_serve_config_has_no_unported_fields():
    """Options of the JAX engine that the port leaves out are refused,
    not ignored: there is no backend fallback (a failed kernel raises).
    Speculation, the prefix cache, tracing and the robustness layer (the
    fault plan, probes, watchdog, retries, overload, shedding and the
    flight recorder) are ported, with the JAX defaults."""
    fields = {f.name for f in dataclasses.fields(ServeConfig)}
    ported = ("speculate_k", "speculate_draft", "prefix_cache_mb",
              "prefix_chunk", "trace", "metrics_every", "strict_recompile",
              "watchdog_s", "fault_plan", "max_queue_depth",
              "overload_queue_depth", "overload_ttft_p95_s",
              "overload_clear_frac", "poison_probe", "poison_check_every",
              "watchdog_action", "max_retries", "retry_backoff_s",
              "shed_inflight", "flight_records", "flight_path")
    assert {"prefill_chunk", "prefill_token_budget", *ported} <= fields
    for name in ported:
        assert getattr(ServeConfig(), name) == \
            getattr(JServeConfig(), name), name
    assert fields == {f.name for f in dataclasses.fields(JServeConfig)} - \
        {"backend_fallback"}
    assert "backend_fallback" not in fields
    with pytest.raises(TypeError):
        ServeConfig(backend_fallback=True)


def _filled_pool(tm, slots=3):
    pool = StatePool(tm, slots, 64, torch.float32)
    g = torch.Generator().manual_seed(0)
    for leaf in pool.cache:
        leaf.copy_(torch.randn(leaf.shape, generator=g))
    return pool


def test_state_pool_row_ops_round_trip():
    """insert / extract / reset / clone / restore move whole rows on the
    batch axis (1, behind the layer axis), in place on the arena, and
    what comes out is a copy, never a view of the arena; for each
    family's state."""
    for family in FAMILY_DIMS:
        _, _, tm, _ = _pair(family=family)
        _pool_round_trip(tm)


def _pool_round_trip(tm):
    pool = _filled_pool(tm)
    arena = [leaf.data_ptr() for leaf in pool.cache]
    before = [leaf.clone() for leaf in pool.cache]
    rows = pool.extract_rows([2, 0])
    assert all(r.shape[1] == 2 for r in rows)
    for r, b in zip(rows, before):
        assert torch.equal(r, b[:, [2, 0]])
    snap = pool.clone_row(1)
    pool.reset_rows([1])
    assert all(float(leaf[:, 1].abs().max()) == 0.0 for leaf in pool.cache)
    assert all(float(s.abs().max()) > 0 for s in snap)     # not a view
    pool.restore_row(1, snap)
    for leaf, b in zip(pool.cache, before):
        assert torch.equal(leaf, b)
    pool.insert_rows(rows, [0, 1], [0, 2])        # rows 2, 0 -> slots 0, 2
    for leaf, b in zip(pool.cache, before):
        assert torch.equal(leaf[:, 0], b[:, 2])
        assert torch.equal(leaf[:, 2], b[:, 0])
        assert torch.equal(leaf[:, 1], b[:, 1])
    assert [leaf.data_ptr() for leaf in pool.cache] == arena


def test_export_import_state_round_trip():
    """``export_state`` / ``import_state`` are inverses over rows, and a
    chunk carried through an exported row equals one carried in place;
    for each family's state."""
    for family in FAMILY_DIMS:
        _, _, tm, tp = _pair(seed=6, family=family)
        _export_import(tm, tp)


def _export_import(tm, tp):
    pool = _filled_pool(tm, slots=2)
    snap = tm.export_state(pool.cache, 16, [1, 0])
    swapped = tm.import_state(
        tm.init_cache(2, dtype=torch.float32), 16, [0, 1], snap)
    for leaf, s in zip(pool.cache, swapped):
        assert torch.equal(s[:, 0], leaf[:, 1])
        assert torch.equal(s[:, 1], leaf[:, 0])
    toks = torch.from_numpy(np.random.default_rng(1).integers(1, V, (2, 16)))
    with torch.inference_mode():
        la, ca = tm.prefill_chunk(tp, toks, pool.cache, 16)
        lb, cb = tm.prefill_chunk(tp, toks.flip(0), swapped, 16)
    assert torch.equal(la, lb.flip(0))
    assert torch.equal(ca.ssm, cb.ssm.flip(1))


def test_chunk_span_matches_jax():
    for length in (0, 1, 15, 16, 17, 100, 128, 500):
        for chunk in (8, 16, 48):
            assert chunk_span((32, 128), chunk, length) == \
                jchunk_span((32, 128), chunk, length)


def test_cli_continuous_chunked_w8_serves_on_cpu():
    engine, done = tserve.main(["--reduced", "--device", "cpu",
                                "--engine", "continuous", "--prefill-chunk",
                                "16", "--quant", "w8", "--requests", "3",
                                "--batch", "2", "--max-new", "3"])
    assert isinstance(engine, ContinuousEngine) and engine.chunk == 16
    w = engine.params["layers"][0]["mixer"]["in_proj"]["w"]
    assert tquant.is_quantized(w) and w.backend == "xla"
    assert len(done) == 3 and all(len(r.out_tokens) == 3 for r in done)
    assert all(0 <= t < 512 for r in done for t in r.out_tokens)
    m = engine.metrics.summary()
    assert m["prefill_chunks"] > 0 and m["prefill_tokens"] % 16 == 0
