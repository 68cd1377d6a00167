"""The port's configs of deepseek-7b, internlm2-20b, qwen3-moe-30b-a3b,
grok-1-314b, llava-next-mistral-7b, mamba2-2.7b and whisper-tiny against
the JAX package's, field for field; llava's vision stub (``image_embeds`` ahead
of the tokens) through ``prefill``, decode and ``loss``; the dense
deepseek-7b and internlm2-20b through prefill and decode; untied
``MambaLM`` (mamba2 and mamba1) in fp32, bf16 and W8; and RecurrentGemma
with ``tie_embeddings=False``, which ties anyway, as the JAX model does.
On the CPU, with the JAX params carried across by ``from_jax_params``
and inputs from numpy seeds.

Tolerances: fp32 logits within 1e-5 of the reference's largest magnitude
(at least 1; ``RTOL``), transformer decode steps within ``MODEL_TOL`` =
4e-5 (``tests/test_torch_transformer.py``'s docstring says why), the
loss within 1e-5; bf16 logits within 4 bf16 steps of the largest
magnitude (``_bf16_close``: the packages round the bf16 stream at the
same points and sum in fp32 in other orders) and the bf16 loss within 4
steps; W8 logits as fp32 (both sides dequantize exactly).  Untied
``MambaLM``: fp32 and W8 logits within ``MODEL_TOL`` (their logits are
~4x the tied ones', and the hidden state's fp32 difference passes
through the ``lm_head``: 1.4e-5 read), bf16 within 4 bf16 steps for
mamba2 (1.9 read) and 8 for mamba1 (5.7 read): the random Mamba-1
amplifies rounding (``ROADMAP.md`` §3: a one-ulp move of its embeddings
moves its fp32 logits by 6.7e-3), and the tied model's bf16 streams
already part by 2.1 steps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild
from repro.nn import quant as jquant
from repro.nn.params import init_params as jinit
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.nn import quant as tquant
from repro_torch.nn.params import from_jax_params, init_params
from test_torch_rgemma import BF16_STEP, RTOL, _rel
from test_torch_transformer import MODEL_TOL, _bf16_close

NEW_ARCHS = ("deepseek-7b", "internlm2-20b", "qwen3-moe-30b-a3b",
             "grok-1-314b", "llava-next-mistral-7b", "mamba2-2.7b",
             "whisper-tiny")


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_config_equals_jax_field_for_field(arch, reduced):
    """Every field the two ``ModelConfig``s share is equal, the XAMBA
    flags too; the port lacks only the sharding rules."""
    t = get_config(arch, reduced=reduced)
    j = jget_config(arch, reduced=reduced)
    tf = {f.name for f in dataclasses.fields(t)}
    jf = {f.name for f in dataclasses.fields(j)}
    assert jf - tf == {"logical_rules"}
    for f in sorted(tf & jf - {"xamba"}):
        assert getattr(t, f) == getattr(j, f), (arch, f)
    assert dataclasses.asdict(t.xamba) == dataclasses.asdict(j.xamba)


def test_registry_resolves_every_arch_but_whisper():
    """Every arch of the JAX registry resolves, whisper-tiny too since it
    was ported (the name is the test's from before)."""
    from repro.configs.registry import list_archs
    for arch in list_archs():
        assert get_config(arch).name == arch
    m = get_config("mamba2-2.7b")
    assert (m.n_layers, m.d_model, m.d_state, m.vocab_size,
            m.expand * m.d_model // m.ssm_head_dim) == (64, 2560, 128, 50280,
                                                        80)


def _pair(arch, dtype="float32", seed=0, **over):
    """(JAX model, JAX params, port model, port params) of ``arch``'s
    reduced config with ``over``, one weight set drawn by JAX."""
    jcfg = jget_config(arch, reduced=True, param_dtype=dtype, **over)
    jm = jbuild(jcfg)
    jp = jinit(jm.param_specs(), jax.random.PRNGKey(seed), jnp.dtype(dtype))
    tcfg = get_config(arch, reduced=True, param_dtype=dtype, **over)
    tm = build_model(tcfg, device="cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jm, jp, tm, tp


def _close(got, want, dtype, tol=RTOL):
    return _rel(got, want) <= tol if dtype == "float32" else \
        _bf16_close(got, want)


# ---------------------------------------------------------------------------
# llava: the vision stub
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("flash", [False, True], ids=["tensor", "flash"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_llava_image_embeds_prefill_decode_and_loss_match_jax(dtype, flash):
    """16 seeded patch embeddings (fp32, cast to the stream dtype) ahead of
    24 tokens: the prefill over 40 positions (kernel 9's plain version
    under ``use_flash``, JAX's kernel in interpret mode), three decode
    steps from index 40 and the loss over the token positions."""
    jm, jp, tm, tp = _pair("llava-next-mistral-7b", dtype, seed=1,
                           use_flash=flash, flash_interpret=flash)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    rng = np.random.default_rng(1)
    p = tm.cfg.num_patches
    img = rng.standard_normal((2, p, tm.cfg.d_model)).astype(np.float32)
    toks = rng.integers(1, 512, (2, 24))
    jb = {"tokens": jnp.asarray(toks), "image_embeds": jnp.asarray(img)}
    tb = {"tokens": torch.from_numpy(toks),
          "image_embeds": torch.from_numpy(img)}
    with torch.inference_mode():
        jl, jc = jax.jit(jm.prefill)(jp, jb, jm.init_cache(2, 48, jdt))
        tl, tc = tm.prefill(tp, tb, tm.init_cache(2, 48, tdt))
        assert _close(tl, jl, dtype)
        # The image took positions 0..P-1 of the cache.
        assert bool(tc.k[:, :, p + 23].abs().sum(-1).sum(-1).gt(0).all())
        assert not bool(tc.k[:, :, p + 24:].any())
        text, _ = tm.prefill(tp, {"tokens": tb["tokens"]},
                             tm.init_cache(2, 48, tdt))
        assert _rel(text, tl) > 1e-3
        for t in range(3):
            tok = np.asarray(jl).argmax(-1)[:, None]
            idx = np.array([p + 24 + t] * 2)
            jl, jc = jax.jit(jm.decode_step)(jp, jnp.asarray(tok), jc,
                                             jnp.asarray(idx))
            tl, tc = tm.decode_step(tp, torch.from_numpy(tok), tc, idx)
            assert _close(tl, jl, dtype, MODEL_TOL)
        labels = toks.copy()
        labels[1, :3] = -1
        jloss, jmet = jax.jit(jm.loss)(jp, dict(jb, labels=jnp.asarray(
            labels)))
        tloss, tmet = tm.loss(tp, dict(tb, labels=torch.from_numpy(labels)))
    tol = RTOL if dtype == "float32" else 4 * BF16_STEP
    assert abs(float(tloss) - float(jloss)) <= tol * max(1.0, float(jloss))
    assert int(tmet["tokens"]) == int(jmet["tokens"]) == 2 * 23 - 2


@pytest.mark.parametrize("arch", ["deepseek-7b", "internlm2-20b"])
def test_dense_configs_prefill_and_decode_match_jax(arch):
    """The dense configs need no model code of their own: prefill (kernel
    9's plain version under ``use_flash``) and three decode steps."""
    jm, jp, tm, tp = _pair(arch, seed=2, use_flash=True,
                           flash_interpret=True)
    toks = np.random.default_rng(2).integers(1, 512, (2, 20))
    assert "lm_head" in tp
    with torch.inference_mode():
        jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)},
                                     jm.init_cache(2, 32, jnp.float32))
        tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                            tm.init_cache(2, 32, torch.float32))
        assert _rel(tl, jl) <= RTOL
        for t in range(3):
            tok = np.asarray(jl).argmax(-1)[:, None]
            idx = np.array([20 + t, 20 + t])
            jl, jc = jax.jit(jm.decode_step)(jp, jnp.asarray(tok), jc,
                                             jnp.asarray(idx))
            tl, tc = tm.decode_step(tp, torch.from_numpy(tok), tc, idx)
            assert _rel(tl, jl) <= MODEL_TOL


# ---------------------------------------------------------------------------
# untied MambaLM; RecurrentGemma's flag
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["float32", "bfloat16", "w8"])
@pytest.mark.parametrize("arch", ["mamba2-130m", "mamba-130m"])
def test_untied_mamba_matches_jax(arch, mode):
    """``tie_embeddings=False``: the ``lm_head`` leaf, the logits ``x @
    lm_head`` rounded to the stream dtype (a 32-token prefill and three
    decode steps); under W8 (fp32 params) the ``lm_head`` is int8 on both
    sides with the same bits."""
    dtype = "bfloat16" if mode == "bfloat16" else "float32"
    steps = 8 if arch == "mamba-130m" else 4

    def close(got, want):
        return _rel(got, want) <= MODEL_TOL if dtype == "float32" else \
            _bf16_close(got, want, steps)

    jm, jp, tm, tp = _pair(arch, dtype, seed=3, tie_embeddings=False)
    assert tp["lm_head"]["w"].shape == (128, 512)
    if mode == "w8":
        jp = jquant.quantize_params_for_mode(jp, "w8")
        tp = tquant.quantize_params_for_mode(tp, "w8")
        assert tquant.is_quantized(tp["lm_head"]["w"])
        np.testing.assert_array_equal(tp["lm_head"]["w"].q.numpy(),
                                      np.asarray(jp["lm_head"]["w"].q))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    toks = np.random.default_rng(3).integers(1, 512, (2, 32))
    with torch.inference_mode():
        jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)},
                                     jm.init_cache(2, 64, jdt))
        view = tm.decode_view(tp)
        tl, tc = tm.prefill(view, {"tokens": torch.from_numpy(toks)},
                            tm.init_cache(2, 64, tdt))
        assert tl.dtype == torch.float32 and close(tl, jl)
        for t in range(3):
            tok = np.asarray(jl).argmax(-1)[:, None]
            jl, jc = jax.jit(jm.decode_step)(jp, jnp.asarray(tok), jc,
                                             jnp.asarray(32 + t))
            tl, tc = tm.decode_step(view, torch.from_numpy(tok), tc, 32 + t)
            assert close(tl, jl)


def test_untied_lm_head_rounds_to_the_stream_dtype():
    """bf16 untied logits are bf16 values widened (``layers.linear``), not
    an fp32 product; tied ones are fp32 sums."""
    for tie in (False, True):
        cfg = get_config("mamba2-130m", reduced=True, tie_embeddings=tie)
        tm = build_model(cfg, device="cpu")
        p = init_params(tm.param_specs(), 0, torch.bfloat16, "cpu")
        with torch.inference_mode():
            logits, _ = tm.prefill(p, {"tokens": torch.ones(
                (1, 8), dtype=torch.long)}, tm.init_cache(1))
        assert logits.dtype == torch.float32
        rounded = torch.equal(logits, logits.to(torch.bfloat16).float())
        assert rounded == (not tie)


def test_recurrentgemma_untied_flag_ties_like_jax():
    """The JAX RecurrentGemma has no ``lm_head`` and always ties: with the
    flag off the port builds the same tree and the same logits."""
    jm, jp, tm, tp = _pair("recurrentgemma-2b", seed=4,
                           tie_embeddings=False)
    assert "lm_head" not in tp and "lm_head" not in tm.param_specs()
    toks = np.random.default_rng(4).integers(1, 512, (2, 12))
    with torch.inference_mode():
        jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)},
                                     jm.init_cache(2, 16, jnp.float32))
        tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                            tm.init_cache(2, 16, torch.float32))
    assert _rel(tl, jl) <= RTOL
