"""The port's MoE layer and MoE transformers (qwen3-moe-30b-a3b, grok-1-314b)
against the JAX package, on the CPU.

``nn/moe.py`` against ``repro.nn.moe.apply`` and against
``tests/test_moe.py``'s dense reference (every expert on every token), in
fp32 and bf16, SwiGLU and GeGLU, ActiBA off and on, and at a tight
``capacity_factor`` that forces drops: each case first asserts that the
expert ids, the keep mask and the auxiliary loss equal JAX's (computed
here by the JAX package's own routing lines), so that a value mismatch
says where it came from.  The reduced MoE models' ``prefill``,
``prefill_chunk``, ``verify_chunk``, ``decode_step`` and ``loss`` (with
``moe_aux``) and their W8 logits against the JAX model on the same calls
(the engines: ``tests/test_torch_moe_serve.py``).  An MoE row's output depends on every
token of the call (capacity and drops), so nothing here holds a chunked
prefill to one whole prefill or a verify window to its steps: every
comparison is against the JAX function or engine on the same calls.

Inputs come from numpy seeds; weights are drawn by the JAX package and
carried across with ``from_jax_params``.  Tolerances: fp32 layer outputs
and logits within 1e-5 of the reference's largest magnitude (at least 1;
``RTOL``), decode-step logits within ``MODEL_TOL`` = 4e-5 (the dense
transformer's decode limit, for the same reason: ``test_torch_
transformer.py``'s docstring; W8 decode reads 1.1e-5), the aux loss within 1e-6 (a mean of fp32 probabilities summed
in other orders); against the dense reference 1e-4, as
``tests/test_moe.py``.  bf16 layer outputs within one bf16 step of each
element's magnitude (the two packages round the products' fp32 sums to
bf16 at the same points and sum them in other orders), model logits
within 4 bf16 steps of the largest magnitude (``_bf16_close``, as the
dense transformer's tests).  W8 logits as fp32 (both sides dequantize
exactly).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_variants
from repro.core.xamba import XambaConfig as JXamba
from repro.models import ModelConfig as JModelConfig
from repro.nn import moe as jmoe, quant as jquant
from repro.nn.params import init_params as jinit
from repro_torch.configs import get_config
from repro_torch.core.xamba import XambaConfig
from repro_torch.models import ModelConfig, build_model
from repro_torch.nn import moe as tmoe, quant as tquant
from repro_torch.nn.params import _tensor_from_numpy, init_params
from test_moe import _reference
from test_torch_rgemma import BF16_STEP, RTOL, _rel
from test_torch_transformer import MODEL_TOL, _bf16_close
from test_torch_variants import _close

ARCHS = ("qwen3-moe-30b-a3b", "grok-1-314b")
AUX_TOL = 1e-6
DENSE_TOL = 1e-4


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------
def _layer_cfgs(mlp_type="swiglu", capacity_factor=8.0, dtype="float32",
                actiba=False):
    kw = dict(name="moe", family="transformer", vocab_size=64, d_model=16,
              n_layers=1, moe=True, n_experts=4, n_experts_per_token=2,
              moe_d_ff=24, mlp_type=mlp_type,
              capacity_factor=capacity_factor, param_dtype=dtype)
    return (JModelConfig(**kw, xamba=JXamba(actiba=actiba)),
            ModelConfig(**kw, xamba=XambaConfig(actiba=actiba)))


def _layer_params(jcfg, seed=0):
    jp = jinit(jmoe.moe_specs(jcfg), jax.random.PRNGKey(seed), jcfg.dtype)
    tp = jax.tree.map(lambda a: _tensor_from_numpy(np.asarray(a)), jp)
    return jp, tp


def _x(shape, dtype, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, jnp.dtype(dtype)), \
        torch.from_numpy(x).to(getattr(torch, dtype))


def _jax_routing(jp, cfg, x):
    """The JAX package's routing lines (``repro/nn/moe.py: apply``) on
    ``x`` (b, s, d): (expert ids, keep, aux)."""
    e, k = cfg.n_experts, cfg.n_experts_per_token
    xf = x.reshape(-1, x.shape[-1])
    n = xf.shape[0]
    logits = jnp.dot(xf.astype(jnp.float32),
                     jp["router"]["w"].astype(jnp.float32))
    probs = jax.nn.softmax(logits, axis=-1)
    _, expert_ids = jax.lax.top_k(probs, k)
    me = jnp.mean(probs, axis=0)
    ce = jnp.mean(jnp.sum(jax.nn.one_hot(expert_ids, e, dtype=jnp.float32),
                          axis=1), axis=0)
    aux = jnp.sum(me * ce) * e
    flat = jax.nn.one_hot(expert_ids, e, dtype=jnp.float32).reshape(n * k, e)
    pos = (jax.lax.associative_scan(jnp.add, flat, axis=0) - 1.0) * flat
    pos_id = jnp.sum(pos.reshape(n, k, e), axis=-1)
    return (np.asarray(expert_ids), np.asarray(pos_id < jmoe.capacity(n, cfg)),
            float(aux))


def _assert_same_routing(jp, tp, jcfg, tcfg, jx, tx):
    ids, keep, aux = _jax_routing(jp, jcfg, jx)
    r = tmoe.route(tp["router"]["w"], tcfg, tx.reshape(-1, tx.shape[-1]))
    np.testing.assert_array_equal(r.expert_ids.numpy(), ids)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    assert r.cap == jmoe.capacity(ids.shape[0], jcfg)
    assert abs(float(r.aux) - aux) <= AUX_TOL
    return r


def _bf16_steps_ok(got, want, steps=1.0):
    """Every element within ``steps`` bf16 steps of its own magnitude."""
    g = got.float().numpy().astype(np.float64)
    w = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    lim = steps * BF16_STEP * np.maximum(np.abs(w), 2.0 ** -20)
    return bool(np.all(np.abs(g - w) <= lim))


@pytest.mark.parametrize("actiba", [False, True], ids=["exact", "actiba"])
@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_matches_jax(dtype, mlp_type, actiba):
    """No drops (capacity factor 8): routing first, then y and aux."""
    jcfg, tcfg = _layer_cfgs(mlp_type, 8.0, dtype, actiba)
    jp, tp = _layer_params(jcfg)
    jx, tx = _x((2, 8, 16), dtype, seed=1)
    r = _assert_same_routing(jp, tp, jcfg, tcfg, jx, tx)
    assert bool(r.keep.all())
    jy, jaux = jmoe.apply(jp, jcfg, jx)
    ty, taux = tmoe.apply(tp, tcfg, tx)
    assert ty.dtype == tx.dtype and taux.dtype == torch.float32
    assert abs(float(taux) - float(jaux)) <= AUX_TOL
    if dtype == "float32":
        assert _rel(ty, jy) <= RTOL
    else:
        assert _bf16_steps_ok(ty, jy)


def test_apply_matches_dense_reference():
    """``tests/test_moe.py``'s dense reference (every expert on every
    token, SwiGLU, renormalized gates), nothing dropped."""
    jcfg, tcfg = _layer_cfgs()
    jp, tp = _layer_params(jcfg)
    jx, tx = _x((2, 8, 16), "float32", seed=2)
    ty, _ = tmoe.apply(tp, tcfg, tx)
    want = np.asarray(_reference(jp, jcfg, jx))
    np.testing.assert_allclose(ty.numpy(), want, rtol=DENSE_TOL,
                               atol=DENSE_TOL)


@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forced_drops_match_jax(dtype, mlp_type):
    """Capacity factor 0.5 over 64 tokens: cap 16 of the 32 pairs an
    expert gets on average, so pairs drop; the same pairs drop in both
    packages and the dropped rows add nothing."""
    jcfg, tcfg = _layer_cfgs(mlp_type, 0.5, dtype)
    jp, tp = _layer_params(jcfg, seed=3)
    jx, tx = _x((4, 16, 16), dtype, seed=3)
    r = _assert_same_routing(jp, tp, jcfg, tcfg, jx, tx)
    assert 0 < int((~r.keep).sum()) < r.keep.numel()
    assert float(r.gates[~r.keep].abs().max()) == 0.0
    jy, jaux = jmoe.apply(jp, jcfg, jx)
    ty, taux = tmoe.apply(tp, tcfg, tx)
    assert abs(float(taux) - float(jaux)) <= AUX_TOL
    if dtype == "float32":
        assert _rel(ty, jy) <= RTOL
    else:
        assert _bf16_steps_ok(ty, jy)
    # A token whose every pair dropped gets exact zeros.
    gone = (~r.keep).all(dim=1)
    if bool(gone.any()):
        assert float(ty.reshape(-1, 16)[gone].abs().max()) == 0.0


def test_capacity_matches_jax():
    jcfg, tcfg = _layer_cfgs(capacity_factor=1.25)
    for n in (1, 4, 7, 31, 64, 100, 1000):
        assert tmoe.capacity(n, tcfg) == jmoe.capacity(n, jcfg)
    q = get_config("qwen3-moe-30b-a3b")
    assert tmoe.capacity(8, q) == 8 and tmoe.capacity(512, q) == 40


def test_bf16_sum_over_k_is_one_fp32_sum_rounded_once():
    """``jnp.sum`` of the gathered bf16 rows (n, k, d) over k accumulates
    in fp32 and rounds once on the CPU: bit-equal to the fp32 sum rounded,
    and not to a sum rounded to bf16 after every add (which this input
    tells apart), so the port's ``.float().sum(1)`` is JAX's reduction."""
    rng = np.random.default_rng(5)
    g = rng.standard_normal((256, 8, 64)).astype(np.float32)
    jg = jnp.asarray(g, jnp.bfloat16)
    want = np.asarray(jnp.sum(jg, axis=1)).view(np.int16)
    tg = torch.from_numpy(g).to(torch.bfloat16)
    once = tg.float().sum(dim=1).to(torch.bfloat16)
    steps = tg[:, 0]
    for j in range(1, 8):
        steps = steps + tg[:, j]
    np.testing.assert_array_equal(once.view(torch.int16).numpy(), want)
    assert not np.array_equal(steps.view(torch.int16).numpy(), want)


def test_dropped_rows_scatter_repeats_bit_for_bit():
    """Forced drops in bf16: two calls give the same bits (the dropped
    rows add exact zeros into slot cap-1)."""
    jcfg, tcfg = _layer_cfgs("swiglu", 0.5, "bfloat16")
    _, tp = _layer_params(jcfg, seed=4)
    _, tx = _x((4, 16, 16), "bfloat16", seed=4)
    a, _ = tmoe.apply(tp, tcfg, tx)
    b, _ = tmoe.apply(tp, tcfg, tx)
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------
# (JAX model, JAX params, port model, port params) of a reduced config,
# one weight set per (arch, dtype, seed), built once: no test writes to it.
_pair = functools.lru_cache(maxsize=None)(test_torch_variants._pair)


def test_from_jax_params_carries_the_experts_bit_for_bit():
    """router.w, wi, wg and wo (stacked (L, e, ...) in JAX) arrive per
    layer with their bits; the MoE block has no dense ``mlp``."""
    jm, jp, tm, tp = _pair("qwen3-moe-30b-a3b", "bfloat16")
    for i, lay in enumerate(tp["layers"]):
        assert "mlp" not in lay and set(lay["moe"]) == {"router", "wi", "wg",
                                                        "wo"}
        for key in ("wi", "wg", "wo"):
            np.testing.assert_array_equal(
                lay["moe"][key].view(torch.int16).numpy(),
                np.asarray(jp["layers"]["moe"][key][i]).view(np.int16))
        np.testing.assert_array_equal(
            lay["moe"]["router"]["w"].view(torch.int16).numpy(),
            np.asarray(jp["layers"]["moe"]["router"]["w"][i]).view(np.int16))
    assert tp["layers"][0]["moe"]["wi"].shape == (8, 128, 64)


def test_init_params_draws_the_experts_with_the_jax_fan_in_rule():
    """The stacked (L, e, d, f) experts take their fan-in from the leading
    layer axis (std 1/sqrt(n_layers)), the router its declared 0.02, as
    ``repro.nn.params._init_one``; split per layer."""
    cfg = get_config("qwen3-moe-30b-a3b", reduced=True)
    model = build_model(cfg, device="cpu")
    p = init_params(model.param_specs(), 0, torch.float32, "cpu")
    moe = [lay["moe"] for lay in p["layers"]]
    assert len(moe) == cfg.n_layers and moe[0]["wi"].shape == (8, 128, 64)
    for key in ("wi", "wg", "wo"):
        w = torch.stack([m[key] for m in moe])
        assert abs(float(w.std()) * cfg.n_layers ** 0.5 - 1) < 0.02, key
    r = torch.stack([m["router"]["w"] for m in moe])
    assert abs(float(r.std()) - 0.02) < 0.001


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_calls_match_jax(arch, dtype):
    """``prefill`` (24 tokens, two rows), three chunks of 8 at per-row
    offsets (``prefill_chunk``), a 4-token ``verify_chunk``, three decode
    steps and ``loss`` (with ``moe_aux``) against the JAX model on the
    same calls and caches."""
    jm, jp, tm, tp = _pair(arch, dtype)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    rng = np.random.default_rng(1)
    toks = rng.integers(1, 512, (2, 24))
    with torch.inference_mode():
        jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)},
                                     jm.init_cache(2, 40, jdt))
        tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                            tm.init_cache(2, 40, tdt))
        assert _close(tl, jl, dtype)
        jchunk = jax.jit(jm.prefill_chunk)
        jcc, tcc = jm.init_cache(2, 40, jdt), tm.init_cache(2, 40, tdt)
        for i in range(0, 24, 8):
            idx = np.array([i, i])
            jl2, jcc = jchunk(jp, jnp.asarray(toks[:, i:i + 8]), jcc,
                              jnp.asarray(idx, jnp.int32))
            tl2, tcc = tm.prefill_chunk(
                tp, torch.from_numpy(toks[:, i:i + 8]), tcc, idx)
            assert _close(tl2, jl2, dtype)
        vt = rng.integers(1, 512, (2, 4))
        idx = np.array([24, 24])
        jv, _ = jax.jit(jm.verify_chunk)(jp, jnp.asarray(vt), jcc,
                                         jnp.asarray(idx, jnp.int32))
        tv, _ = tm.verify_chunk(tp, torch.from_numpy(vt), tcc, idx)
        assert tv.shape == (2, 4, 512) and _close(tv, jv, dtype)
        jdecode = jax.jit(jm.decode_step)
        for t in range(3):
            tok = np.asarray(jl).argmax(-1)[:, None]
            idx = np.array([24 + t, 24 + t])
            jl, jc = jdecode(jp, jnp.asarray(tok), jc, jnp.asarray(idx))
            tl, tc = tm.decode_step(tp, torch.from_numpy(tok), tc, idx)
            assert _rel(tl, jl) <= MODEL_TOL if dtype == "float32" else \
                _bf16_close(tl, jl)
        labels = toks.copy()
        labels[0, :5] = -1
        batch = {"tokens": toks, "labels": labels}
        jloss, jmet = jax.jit(jm.loss)(jp, jax.tree.map(jnp.asarray, batch))
        tloss, tmet = tm.loss(tp, {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
    tol = RTOL if dtype == "float32" else 4 * BF16_STEP
    assert abs(float(tloss) - float(jloss)) <= tol * max(1.0, float(jloss))
    assert abs(float(tmet["moe_aux"]) - float(jmet["moe_aux"])) <= \
        (AUX_TOL if dtype == "float32" else 4 * BF16_STEP)
    assert float(tmet["moe_aux"]) > 0


def test_w8_quantizes_attention_and_lm_head_not_experts_or_router():
    """W8 as JAX's ``quantize_params``: the attention projections and the
    ``lm_head`` are int8, the bare expert tensors and the router stay;
    the same q and scale bits as JAX's for every quantized weight."""
    jm, jp, tm, tp = _pair("qwen3-moe-30b-a3b")
    tq = tquant.quantize_params_for_mode(tp, "w8")
    jq = jquant.quantize_params_for_mode(jax.tree.map(np.asarray, jp), "w8")
    assert tquant.is_quantized(tq["lm_head"]["w"])
    np.testing.assert_array_equal(tq["lm_head"]["w"].q.numpy(),
                                  np.asarray(jq["lm_head"]["w"].q))
    for i, lay in enumerate(tq["layers"]):
        for proj in ("wq", "wk", "wv", "wo"):
            w = lay["attn"][proj]["w"]
            assert tquant.is_quantized(w)
            np.testing.assert_array_equal(
                w.q.numpy(), np.asarray(jq["layers"]["attn"][proj]["w"].q[i]))
        for key in ("wi", "wg", "wo"):
            assert lay["moe"][key] is tp["layers"][i]["moe"][key]
        assert lay["moe"]["router"]["w"] is tp["layers"][i]["moe"]["router"][
            "w"]
    assert not jquant.is_quantized(jq["layers"]["moe"]["wi"])


@pytest.mark.parametrize("arch", ARCHS)
def test_w8_logits_match_jax(arch):
    """W8 weights on both sides (JAX's XLA backend): prefill, a chunk and
    two decode steps."""
    jm, jp, tm, tp = _pair(arch)
    jq = jquant.quantize_params_for_mode(jp, "w8")
    tq = tquant.quantize_params_for_mode(tp, "w8")
    toks = np.random.default_rng(2).integers(1, 512, (2, 16))
    with torch.inference_mode():
        jl, jc = jax.jit(jm.prefill)(jq, {"tokens": jnp.asarray(toks)},
                                     jm.init_cache(2, 32, jnp.float32))
        tl, tc = tm.prefill(tq, {"tokens": torch.from_numpy(toks)},
                            tm.init_cache(2, 32, torch.float32))
        assert _rel(tl, jl) <= RTOL
        more = np.random.default_rng(3).integers(1, 512, (2, 8))
        idx = np.array([16, 16])
        jl, jc = jax.jit(jm.prefill_chunk)(jq, jnp.asarray(more), jc,
                                           jnp.asarray(idx, jnp.int32))
        tl, tc = tm.prefill_chunk(tq, torch.from_numpy(more), tc, idx)
        assert _rel(tl, jl) <= RTOL
        for t in range(2):
            tok = np.asarray(jl).argmax(-1)[:, None]
            idx = np.array([24 + t, 24 + t])
            jl, jc = jax.jit(jm.decode_step)(jq, jnp.asarray(tok), jc,
                                             jnp.asarray(idx))
            tl, tc = tm.decode_step(tq, torch.from_numpy(tok), tc, idx)
            assert _rel(tl, jl) <= MODEL_TOL
