"""Self-speculative decoding in the port against the JAX package, on the
CPU: the accept rule, ``verify_chunk`` on all three model classes, the
reference burst ``speculative_step`` and the continuous engine's bursts.

The invariant under test: speculation is an execution strategy, not a
sampling change.  With ``speculate_k`` on, every request's tokens are
those of the non-speculative engine (greedy and temperature > 0, thanks
to the (seed, uid, position)-keyed sampling), and those of the JAX
``ContinuousEngine`` with the same options.  The models are the JAX
speculative suite's (``tests/test_speculative.py: CFGS``, d_model 32,
fp32); the JAX params are carried across with ``from_jax_params``.

``verify_chunk`` tolerances (relative to the reference's largest
magnitude, at least 1): the Mamba families' logits and states within
``RTOL`` (1e-5), the transformer's within ``MODEL_TOL`` (4e-5) and
RecurrentGemma's within ``RG_TOL`` (2^-12), the rules of the port's
model tests (``tests/test_torch_transformer.py``,
``tests/test_torch_rgemma.py``).

``speculative_step`` is held to sequential greedy decode by token
equality, with W8 drafts for all four families; the rollbacks are
counted over the cases and must be > 0 (at this size the W8 draft
disagrees in RecurrentGemma only).
The JAX suite's own length assertion (``len(o) < n_new + k``) is not
carried over: a fully accepted last burst rightly takes a row to
``n_new + k - 1`` tokens or more, and its rgemma case fails there.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ModelConfig as JModelConfig, build_model as jbuild
from repro.nn.params import init_params as jinit
from repro.serve import ContinuousEngine as JContinuous, \
    ServeConfig as JServeConfig, accept_lengths as jaccept, \
    emit_counts as jemit, needs_rollback as jrollback
from repro_torch.core.xamba import XambaConfig
from repro_torch.models import ModelConfig, build_model
from repro_torch.nn import quant as tquant, ssm as tssm
from repro_torch.nn.params import from_jax_params
from repro_torch.serve import ContinuousEngine, ServeConfig, \
    accept_lengths, emit_counts, needs_rollback
from test_torch_rgemma import RG_TOL, RTOL, _rel
from test_torch_transformer import MODEL_TOL

V = 64
CFG_KW = {
    "dense": dict(name="dense", family="transformer", vocab_size=V,
                  d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
                  head_dim=8, d_ff=64, param_dtype="float32"),
    "mamba2": dict(name="mamba2", family="mamba2", vocab_size=V,
                   d_model=32, n_layers=2, d_state=8, ssm_head_dim=8,
                   chunk_size=8, param_dtype="float32"),
    "mamba1": dict(name="mamba1", family="mamba", vocab_size=V, d_model=32,
                   n_layers=2, d_state=8, param_dtype="float32"),
    "rgemma": dict(name="rgemma", family="recurrentgemma", vocab_size=V,
                   d_model=32, n_layers=3, n_heads=4, n_kv_heads=1,
                   head_dim=8, d_ff=96, mlp_type="geglu", lru_width=32,
                   sliding_window=8, scan_layers=False,
                   param_dtype="float32"),
}
FAMILIES = list(CFG_KW)
TOL = {"dense": MODEL_TOL, "mamba2": RTOL, "mamba1": RTOL, "rgemma": RG_TOL}


@functools.lru_cache(maxsize=None)
def _pair(family, seed=0):
    """(JAX model, JAX params, port model, port params): one weight set
    (built once a family; no test writes to it)."""
    jm = jbuild(JModelConfig(**CFG_KW[family]))
    jp = jinit(jm.param_specs(), jax.random.PRNGKey(seed), jnp.float32)
    tm = build_model(ModelConfig(**CFG_KW[family]), device="cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tm.cfg, device="cpu")
    return jm, jp, tm, tp


def _prompts(rng, n, length):
    return [rng.integers(1, V, length).tolist() for _ in range(n)]


def _greedy(logits):
    return np.argmax(logits.float().numpy(), -1).astype(np.int64)


# ---------------------------------------------------------------------------
# the accept rule
# ---------------------------------------------------------------------------
def test_accept_rule_worked_examples_match_jax():
    draft = np.array([[5, 6, 7, 8],     # all match
                      [5, 6, 9, 8],     # diverges at j = 2
                      [1, 6, 7, 8],     # diverges at j = 0
                      [5, 6, 7, 9]])    # diverges at the last slot
    verify = np.array([[5, 6, 7, 8]] * 4)
    m = accept_lengths(draft, verify)
    np.testing.assert_array_equal(m, [4, 2, 0, 3])
    np.testing.assert_array_equal(emit_counts(m, 4), [4, 3, 1, 4])
    np.testing.assert_array_equal(needs_rollback(m, 4),
                                  [False, True, True, False])
    rng = np.random.default_rng(0)
    for k in (1, 2, 3, 5):
        d = rng.integers(0, 3, (64, k))
        g = rng.integers(0, 3, (64, k))
        m, jm = accept_lengths(d, g), jaccept(d, g)
        np.testing.assert_array_equal(m, jm)
        np.testing.assert_array_equal(emit_counts(m, k), jemit(jm, k))
        np.testing.assert_array_equal(needs_rollback(m, k),
                                      jrollback(jm, k))
    with pytest.raises(ValueError):
        accept_lengths(np.zeros((2, 3)), np.zeros((2, 4)))


def test_accept_rule_k1_never_rolls_back():
    m = accept_lengths(np.array([[3], [4]]), np.array([[3], [9]]))
    np.testing.assert_array_equal(emit_counts(m, 1), [1, 1])
    assert not needs_rollback(m, 1).any()


# ---------------------------------------------------------------------------
# verify_chunk
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("family", FAMILIES)
def test_verify_chunk_matches_jax(family):
    """A 4-token window after an 8-token prefill: every position's logits
    (b, 4, V) against JAX's ``verify_chunk``, and the carried state / KV
    through the logits of one decode step after it (and leaf by leaf
    where the cache layouts agree); its last position and state are the
    port's ``prefill_chunk``'s."""
    jm, jp, tm, tp = _pair(family)
    rng = np.random.default_rng(3)
    b, plen, k = 2, 8, 4
    prompt = rng.integers(1, V, (b, plen))
    win = rng.integers(1, V, (b, k))
    jc = jm.init_cache(b, 16, jnp.float32)
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(prompt, jnp.int32)}, jc)
    jl, jnew = jm.verify_chunk(jp, jnp.asarray(win, jnp.int32), jc,
                               jnp.full((b,), plen, jnp.int32))
    view = tm.decode_view(tp)
    with torch.inference_mode():
        tc = tm.init_cache(b, 16, torch.float32)
        _, tc = tm.prefill(view, {"tokens": torch.from_numpy(prompt)}, tc)
        tl, tnew = tm.verify_chunk(view, torch.from_numpy(win), tc,
                                   np.full(b, plen))
        pl, pnew = tm.prefill_chunk(view, torch.from_numpy(win), tc,
                                    np.full(b, plen))
        nxt = rng.integers(1, V, (b, 1))
        tdl, _ = tm.decode_step(view, torch.from_numpy(nxt), tnew,
                                plen + k)
    jdl, _ = jm.decode_step(jp, jnp.asarray(nxt, jnp.int32), jnew,
                            jnp.int32(plen + k))
    assert tl.shape == (b, k, V) and tl.dtype == torch.float32
    assert _rel(tl, jl) <= TOL[family]
    assert _rel(tdl, jdl) <= TOL[family]
    if family != "rgemma":      # its JAX cache is grouped, the port's flat
        for t, j in zip(tnew, jax.tree.leaves(jnew)):
            assert _rel(t, j) <= TOL[family]
    assert torch.equal(tl[:, -1], pl)
    assert all(torch.equal(a, c) for a, c in zip(tnew, pnew))


@pytest.mark.parametrize("mode", ["cumba", "pallas"])
def test_verify_window_branch_is_counted(mode):
    """A Mamba-2 verify window of 4 tokens takes the fused prefill under
    ``cumba`` (kernel 2's SIMT body on the card) and the unfused chain
    under a ``pallas`` prefill mode (the chunk is not a multiple of 64,
    the JAX package's logged fallback); each layer's branch is counted.
    Both match JAX's ``verify_chunk`` in the same mode (interpret mode
    for ``pallas``)."""
    from repro.core.xamba import XambaConfig as JXamba
    jmode = "pallas_interpret" if mode == "pallas" else mode
    jm = jbuild(JModelConfig(**CFG_KW["mamba2"], xamba=JXamba(
        prefill=jmode)))
    jp = jinit(jm.param_specs(), jax.random.PRNGKey(0), jnp.float32)
    tm = build_model(ModelConfig(**CFG_KW["mamba2"],
                                 xamba=XambaConfig(prefill=mode)),
                     device="cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tm.cfg, device="cpu")
    rng = np.random.default_rng(4)
    win = rng.integers(1, V, (2, 4))
    jl, _ = jm.verify_chunk(jp, jnp.asarray(win, jnp.int32),
                            jm.init_cache(2, 8, jnp.float32), jnp.int32(0))
    before = dict(tssm.PREFILL_BRANCHES)
    with torch.inference_mode():
        tl, _ = tm.verify_chunk(tp, torch.from_numpy(win),
                                tm.init_cache(2, 8, torch.float32), 0)
    ran = {k: tssm.PREFILL_BRANCHES[k] - before[k] for k in before}
    n = tm.cfg.n_layers
    assert ran == ({"fused": 0, "unfused": n} if mode == "pallas" else
                   {"fused": n, "unfused": 0})
    assert _rel(tl, jl) <= RTOL


# ---------------------------------------------------------------------------
# the reference burst: speculative_step == sequential greedy decode
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _spec_vs_sequential(family):
    """(speculative tokens, sequential greedy tokens, rollbacks): bursts of
    ``speculative_step`` (W8 draft, k = 3) after a prefill, and plain
    greedy decode from the same prefill, 12 tokens a row."""
    _, _, tm, tp = _pair(family)
    params = tm.decode_view(tp)
    draft = tm.decode_view(tquant.quantize_params_for_mode(tp, "w8"))
    rng = np.random.default_rng(101)
    b, plen, n_new, k = 2, 8, 12, 3
    toks = torch.from_numpy(rng.integers(1, V, (b, plen)))
    max_seq = plen + n_new + k + 1
    with torch.inference_mode():
        cache = tm.init_cache(b, max_seq, torch.float32)
        logits, cache = tm.prefill(params, {"tokens": toks}, cache)
        ref = [_greedy(logits)]
        for i in range(n_new - 1):
            logits, cache = tm.decode_step(
                params, torch.from_numpy(ref[-1][:, None]), cache, plen + i)
            ref.append(_greedy(logits))
        ref = np.stack(ref, axis=1)

        cache = tm.init_cache(b, max_seq, torch.float32)
        logits, cache = tm.prefill(params, {"tokens": toks}, cache)
        t0 = _greedy(logits)
        out = [[int(t0[i])] for i in range(b)]
        pend, idx, rollbacks = t0, np.full(b, plen), 0
        while min(len(o) for o in out) < n_new:
            emitted, n_emit, cache, idx = tm.speculative_step(
                draft, params, pend[:, None], cache, idx, k)
            # n_emit < k iff m < k - 1: the row rolled back.
            rollbacks += int((n_emit < k).sum())
            for i in range(b):
                out[i].extend(int(t) for t in emitted[i, :int(n_emit[i])])
            pend = np.array([o[-1] for o in out], np.int64)
    return [o[:n_new] for o in out], ref.tolist(), rollbacks


@pytest.mark.parametrize("family", FAMILIES)
def test_speculative_step_matches_sequential_greedy(family):
    out, ref, _ = _spec_vs_sequential(family)
    assert out == ref


def test_speculative_step_rolled_back_over_the_families():
    """The W8 draft disagreed somewhere over the four families' cases, so
    the rollback path of ``speculative_step`` ran (at this size only
    RecurrentGemma's draft disagrees)."""
    assert sum(_spec_vs_sequential(f)[2] for f in FAMILIES) > 0


def test_speculative_step_k1_is_plain_decode():
    """k = 1 emits the verify token alone and leaves the state exactly
    where a plain decode step does."""
    _, _, tm, tp = _pair("mamba2")
    params = tm.decode_view(tp)
    draft = tm.decode_view(tquant.quantize_params_for_mode(tp, "w8"))
    toks = torch.from_numpy(np.random.default_rng(7).integers(1, V, (1, 8)))
    with torch.inference_mode():
        logits, cache = tm.prefill(params, {"tokens": toks},
                                   tm.init_cache(1, 16, torch.float32))
        t0 = _greedy(logits)
        ref_logits, ref_cache = tm.decode_step(
            params, torch.from_numpy(t0[:, None]), cache, 8)
        emitted, n_emit, new_cache, new_idx = tm.speculative_step(
            draft, params, t0[:, None], cache, 8, 1)
    assert int(n_emit[0]) == 1
    assert int(emitted[0, 0]) == int(_greedy(ref_logits)[0])
    np.testing.assert_array_equal(new_idx, [9])
    assert all(torch.equal(a, c) for a, c in zip(new_cache, ref_cache))


# ---------------------------------------------------------------------------
# the engine: speculation on == off, and == the JAX engine
# ---------------------------------------------------------------------------
def _serve(engine, prompts, budgets):
    for p, m in zip(prompts, budgets):
        engine.submit(p, m)
    done = engine.run()
    if hasattr(engine, "close"):
        engine.close()
    return {r.uid: r.out_tokens for r in done}


def _port(family, prompts, budgets, draft_params=None, **kw):
    _, _, tm, tp = _pair(family)
    eng = ContinuousEngine(tm, tp, ServeConfig(
        max_batch=2, prefill_buckets=(16,), max_new_tokens=8, **kw),
        draft_params=draft_params)
    return _serve(eng, prompts, budgets), eng


def _jax(family, prompts, budgets, **kw):
    jm, jp, _, _ = _pair(family)
    eng = JContinuous(jm, jp, JServeConfig(
        max_batch=2, prefill_buckets=(16,), max_new_tokens=8, **kw))
    return _serve(eng, prompts, budgets)


@pytest.mark.parametrize("family", FAMILIES)
def test_engine_spec_matches_nonspec_greedy(family):
    rng = np.random.default_rng(11)
    prompts = _prompts(rng, 6, 12)
    budgets = [8, 3, 6, 8, 2, 7]          # staggered refills mid-burst
    base, _ = _port(family, prompts, budgets)
    spec, eng = _port(family, prompts, budgets, speculate_k=3)
    assert base == spec
    m = eng.metrics.summary()
    assert m["spec_bursts"] > 0 and m["spec_drafted_tokens"] > 0
    assert 0.0 < m["spec_accept_rate"] <= 1.0
    assert m["spec_tokens_per_verify"] >= 1.0


@pytest.mark.parametrize("family", ["mamba2", "rgemma"])
def test_engine_spec_matches_nonspec_temperature(family):
    """Keyed sampling keeps sampled streams invariant to speculation: the
    verify stream draws position p with the noise a plain step would."""
    rng = np.random.default_rng(13)
    prompts = _prompts(rng, 5, 12)
    budgets = [6, 4, 8, 3, 7]
    kw = dict(temperature=0.9, seed=42)
    base, _ = _port(family, prompts, budgets, **kw)
    spec, eng = _port(family, prompts, budgets, speculate_k=4, **kw)
    assert base == spec
    assert eng.metrics.summary()["spec_bursts"] > 0


@pytest.mark.parametrize("family,kw", [
    pytest.param("mamba2", {}, id="mamba2"),
    pytest.param("mamba2", dict(temperature=0.9, seed=42),
                 id="mamba2-temperature"),
    pytest.param("mamba2", dict(prefill_chunk=8), id="mamba2-chunk8"),
    pytest.param("mamba1", {}, id="mamba1"),
    pytest.param("mamba1", dict(prefill_chunk=8), id="mamba1-chunk8")])
def test_engine_spec_matches_jax_engine(family, kw):
    """The port's engine with speculation against the JAX engine with the
    same options: the same tokens, and both against plain decode."""
    rng = np.random.default_rng(17)
    prompts = _prompts(rng, 5, 14)
    budgets = [8, 5, 8, 4, 6]
    jout = _jax(family, prompts, budgets, speculate_k=3, **kw)
    tout, eng = _port(family, prompts, budgets, speculate_k=3, **kw)
    assert tout == jout
    assert eng.metrics.summary()["spec_bursts"] > 0
    base, _ = _port(family, prompts, budgets, **kw)
    assert base == tout


def test_engine_spec_eos_mid_prefix():
    """EOS produced inside an accepted prefix finishes the request there:
    no token past EOS leaks out, and the freed slot is refilled."""
    rng = np.random.default_rng(23)
    prompts = _prompts(rng, 4, 10)
    base, _ = _port("mamba2", prompts, [8] * 4)
    eos = next(t[1] for t in base.values() if len(t) > 2)
    ref, _ = _port("mamba2", prompts, [8] * 4, eos_id=eos)
    spec, eng = _port("mamba2", prompts, [8] * 4, eos_id=eos, speculate_k=3)
    assert ref == spec
    assert any(t and t[-1] == eos and len(t) < 8 for t in spec.values())
    assert eng.metrics.summary()["completed"] == 4


def test_engine_spec_k1_no_rollbacks():
    rng = np.random.default_rng(19)
    prompts = _prompts(rng, 4, 10)
    base, _ = _port("mamba2", prompts, [6] * 4)
    spec, eng = _port("mamba2", prompts, [6] * 4, speculate_k=1)
    assert base == spec
    m = eng.metrics.summary()
    assert m["spec_bursts"] > 0 and m["spec_rollbacks"] == 0


def test_engine_spec_rolls_back_and_counts_verify_as_steps():
    """The W8 draft disagrees on this model, so rows roll back and drain;
    each verify call counts as one decode step, and every burst's rows
    bank at least one token."""
    rng = np.random.default_rng(11)
    prompts = _prompts(rng, 6, 12)
    budgets = [8] * 6
    base, beng = _port("rgemma", prompts, budgets)
    spec, eng = _port("rgemma", prompts, budgets, speculate_k=4)
    assert base == spec
    m = eng.metrics.summary()
    assert m["spec_rollbacks"] > 0
    assert m["decode_steps"] < beng.metrics.summary()["decode_steps"]
    assert eng.metrics.spec_rows >= m["spec_bursts"]
    assert m["generated_tokens"] == sum(len(t) for t in spec.values())


def test_engine_explicit_draft_params():
    """A caller's own draft params (here the full-precision ones) replace
    the derived W8 draft; outputs are unchanged."""
    rng = np.random.default_rng(29)
    prompts = _prompts(rng, 4, 10)
    _, _, _, tp = _pair("mamba1")
    base, _ = _port("mamba1", prompts, [6] * 4)
    spec, eng = _port("mamba1", prompts, [6] * 4, draft_params=tp,
                      speculate_k=3)
    assert base == spec
    assert not tquant.is_quantized(
        eng._draft_params["layers"][0]["mixer"]["in_proj"]["w"])


def test_speculate_k_validation():
    with pytest.raises(ValueError, match="speculate_k"):
        _port("mamba2", [], [], speculate_k=-1)
