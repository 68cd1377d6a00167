"""The port's Mamba-2 model and wave engine against the JAX package.

Both packages compute with the same weights: the JAX package's params go
through ``repro_torch.nn.params.from_jax_params``.  The port runs on the
CPU here (its kernels' plain versions); the JAX model runs its Pallas
kernels in interpret mode.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core.xamba import XambaConfig as JXamba
from repro.models import ModelConfig as JModelConfig, build_model as jbuild
from repro.nn.params import init_params as jinit
from repro.serve import Engine as JEngine, ServeConfig as JServeConfig
from repro_torch.models import ModelConfig, build_model
from repro_torch.nn import ssm as tssm
from repro_torch.nn.params import from_jax_params
from repro_torch.serve import Engine, ServeConfig

V = 64
DIMS = dict(name="mamba2", family="mamba2", vocab_size=V, d_model=32,
            n_layers=2, d_state=8, ssm_head_dim=8, chunk_size=64,
            param_dtype="float32")


def _pair(xamba=None, seed=0):
    """(jax model, jax params, port model, port params) on one weight set."""
    jcfg = JModelConfig(**DIMS, xamba=xamba or JXamba())
    jm = jbuild(jcfg)
    jp = jinit(jm.param_specs(), jax.random.PRNGKey(seed), jnp.float32)
    tm = build_model(ModelConfig(**DIMS), device="cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tm.cfg, device="cpu")
    return jm, jp, tm, tp


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float64) -
                        np.asarray(b, np.float64)).max())


def _rel(a, b):
    """Max error over the reference's largest magnitude (at least 1): the
    carried states of the second layer reach ~10 at these widths, and
    fp32 sums taken in another order agree to ~1e-5 of that."""
    return _err(a, b) / max(1.0, float(np.abs(np.asarray(b)).max()))


def test_prefill_and_decode_logits_match_jax_pallas(caplog):
    """l = 128 at chunk 64 (two chunks): the JAX gate admits its fused
    Pallas prefill (interpret mode), which is the branch compared; then
    three decode steps through its fused decode-step kernel."""
    jm, jp, tm, tp = _pair(JXamba(decode="pallas_interpret",
                                  prefill="pallas_interpret"))
    rng = np.random.default_rng(1)
    b, l = 2, 128
    toks = rng.integers(1, V, size=(b, l)).astype(np.int32)
    with caplog.at_level(logging.INFO, logger="repro.ssm"):
        jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                            jm.init_cache(b, dtype=jnp.float32))
    assert "skipped" not in caplog.text, caplog.text
    with torch.inference_mode():
        tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()},
                            tm.init_cache(b, dtype=torch.float32))
    assert _err(tl, jl) <= 1e-4
    assert _rel(tc.conv, jc.conv) <= 1e-4
    assert _rel(tc.ssm, jc.ssm) <= 1e-4

    jdp = jm.decode_view(jp)
    for t in range(3):
        tok = rng.integers(1, V, size=(b, 1)).astype(np.int32)
        jl, jc = jm.decode_step(jdp, jnp.asarray(tok), jc, jnp.int32(l + t))
        with torch.inference_mode():
            tl, tc = tm.decode_step(tp, torch.from_numpy(tok).long(), tc,
                                    l + t)
        assert _err(tl, jl) <= 1e-4, f"decode step {t}"
        assert _rel(tc.ssm, jc.ssm) <= 1e-4, f"decode step {t}"


def test_wave_engine_greedy_matches_jax_engine():
    """Same weights, same requests (prompts in both prefill buckets, more
    requests than slots): token-identical greedy outputs."""
    jm, jp, tm, tp = _pair()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, V, size=int(n)).tolist()
               for n in (5, 40, 17, 90, 3)]
    kw = dict(max_batch=2, prefill_buckets=(32, 128), max_new_tokens=6)
    jeng = JEngine(jm, jp, JServeConfig(**kw))
    teng = Engine(tm, tp, ServeConfig(**kw))
    for p in prompts:
        jeng.submit(p)
        teng.submit(p)
    jout = {r.uid: r.out_tokens for r in jeng.run()}
    tout = {r.uid: r.out_tokens for r in teng.run()}
    assert tout == jout
    assert all(len(v) == 6 for v in tout.values())
    m = teng.metrics.summary()
    assert m["completed"] == len(prompts)
    assert m["wall_source"] == "measured"
    assert m["decode_steps"] == 3 * 5      # three waves of max_new - 1


def test_prefill_gate_falls_back_to_unfused_chain_like_jax(caplog,
                                                         monkeypatch):
    """A seqlen that is not a chunk multiple (96 at chunk 64): the gate
    logs its reason and the port falls back to the unfused chain, as the
    JAX package does, with the same logits and state.  The port logs each
    reason once per shape and process, so the test starts from none
    logged."""
    monkeypatch.setattr(tssm, "_LOGGED", set())
    jm, jp, tm, tp = _pair()
    toks = np.random.default_rng(5).integers(1, V, size=(2, 96))
    with caplog.at_level(logging.INFO):
        jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                            jm.init_cache(2, dtype=jnp.float32))
        with torch.inference_mode():
            tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                                tm.init_cache(2, dtype=torch.float32))
    assert caplog.text.count("seqlen 96 not a multiple of chunk 64") >= 2
    assert _err(tl, jl) <= 1e-4
    assert _rel(tc.conv, jc.conv) <= 1e-4
    assert _rel(tc.ssm, jc.ssm) <= 1e-4


def test_decode_view_serves_the_same_logits_into_a_fresh_cache():
    """The view's fp32 kernel operands give the raw params' logits and
    states, and every step writes a new cache instead of the one it was
    given."""
    _, _, tm, tp = _pair()
    view = tm.decode_view(tp)
    k = view["layers"][1]["mixer"]["kernel"]
    assert all(t.dtype == torch.float32 for t in k.values())
    assert torch.equal(k["A"], -torch.exp(tp["layers"][1]["mixer"]["A_log"]))
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(1, V, size=(2, 64))).long()
    tok = torch.from_numpy(rng.integers(1, V, size=(2, 1))).long()
    with torch.inference_mode():
        c0 = tm.init_cache(2, dtype=torch.float32)
        outs = []
        for p in (tp, view):
            lp, cp = tm.prefill(p, {"tokens": toks}, c0)
            ld, cd = tm.decode_step(p, tok, cp, 64)
            assert cp.ssm.data_ptr() != c0.ssm.data_ptr()
            assert cd.conv.data_ptr() != cp.conv.data_ptr()
            outs.append((lp, cp.conv, cp.ssm, ld, cd.conv, cd.ssm))
    assert float(c0.ssm.abs().max()) == 0.0
    for a, b in zip(*outs):
        assert torch.equal(a, b)
