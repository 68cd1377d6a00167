"""W8 weights in the port's transformer (gemma-2b, qwen1.5-4b) and
RecurrentGemma against the JAX package's W8 paths, on the CPU.

The JAX params are quantized by the JAX package (``quantize_params_for_
mode``) and carried across with ``from_jax_params``, so both packages
hold the same int8 payloads and scales.  Under the default modes the
JAX side runs ``qdot``'s XLA path (``(x @ q) * scale`` in fp32), under
``XambaConfig.pallas()`` its Pallas kernels in interpret mode (tag
``w8_pallas_interpret``): ``qmatmul`` in every projection, its gated
PWL form in the ActiBA MLP (``nn/mlp.py``), and for RecurrentGemma's
decode step ``rglru_step`` with the gate weights dequantized in the
step.  The port runs the plain versions: ``qdot``'s fp32 arithmetic,
``qmatmul_plain``'s gated form, and kernel 6's plain version with the
gate weights dequantized once in ``decode_view``.

Tolerances (relative to the reference's largest magnitude, at least 1):
the transformer's logits within ``MODEL_TOL`` (4e-5, its fp32 rule in
``tests/test_torch_transformer.py``).  RecurrentGemma's within
``RG_TOL`` (2^-12, ``tests/test_torch_rgemma.py``'s rule downstream of
the RG-LRU's input gate).  That rule also covers the one place where the
two packages round differently by design: JAX's ``cumba`` decode step
runs the unfused chain, where ``qdot`` scales the fp32 gate sums
(``(u @ q) * scale``), while the port's kernel 6 multiplies ``u`` by
the dequantized weight (``u @ (q * scale)``).  That moves the gate
pre-activations by a few fp32 ulps, far inside the gate's own 2^-12
rule: the logits read 1.1e-5 under ``cumba`` and 1.2e-6 under
``pallas()`` (printed with ``-s``), the transformer's 3.3e-6.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma_2b as jgemma, qwen15_4b as jqwen
from repro.core.xamba import XambaConfig as JXamba
from repro.models import ModelConfig as JModelConfig, build_model as jbuild
from repro.nn import quant as jquant
from repro.nn.params import init_params as jinit
from repro_torch.configs import get_config
from repro_torch.core.xamba import XambaConfig
from repro_torch.launch import serve as tserve
from repro_torch.models import ModelConfig, build_model
from repro_torch.nn import quant as tquant
from repro_torch.nn.params import from_jax_params
from test_torch_rgemma import DIMS as RG_DIMS, RG_TOL, _rel
from test_torch_transformer import MODEL_TOL

FAMILIES = ("gemma-2b", "qwen1.5-4b", "rgemma")
TOL = {"gemma-2b": MODEL_TOL, "qwen1.5-4b": MODEL_TOL, "rgemma": RG_TOL}
JCFGS = {"gemma-2b": jgemma.REDUCED, "qwen1.5-4b": jqwen.REDUCED}


@functools.lru_cache(maxsize=None)
def _pair(family, mode, seed=0):
    """(JAX model, JAX W8 params, port model, port W8 params): one weight
    set, quantized by the JAX package (built once a case; no test writes
    to it)."""
    pallas = mode == "pallas"
    jx = JXamba.pallas(interpret=True) if pallas else JXamba()
    tx = XambaConfig.pallas() if pallas else XambaConfig()
    qmode = "w8_pallas_interpret" if pallas else "w8"
    if family == "rgemma":
        jcfg = JModelConfig(**RG_DIMS, xamba=jx).with_quant(qmode)
        tcfg = ModelConfig(**RG_DIMS, xamba=tx).with_quant(qmode)
    else:
        jcfg = JCFGS[family].replace(param_dtype="float32",
                                     xamba=jx).with_quant(qmode)
        tcfg = get_config(family, reduced=True, param_dtype="float32",
                          xamba=tx).with_quant(qmode)
    jm = jbuild(jcfg)
    jp = jquant.quantize_params_for_mode(
        jinit(jm.param_specs(), jax.random.PRNGKey(seed), jnp.float32),
        qmode)
    tm = build_model(tcfg, device="cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jm, jp, tm, tp


def _tokens(vocab, shape, seed=5):
    return np.random.default_rng(seed).integers(1, vocab, shape)


@pytest.mark.parametrize("mode", ["cumba", "pallas"])
@pytest.mark.parametrize("family", FAMILIES)
def test_w8_params_are_quantized(family, mode):
    """Every big linear weight of the trunk arrives as a ``QuantTensor``
    (the attention projections, the MLP and, for RecurrentGemma, the
    RG-LRU's projections and gates); ``decode_view`` dequantizes the
    RG-LRU gates once to fp32 for kernel 6."""
    _, _, tm, tp = _pair(family, mode)
    lay = tp["layers"][0]
    blocks = [lay["mlp"]] + ([lay["rglru"]] if "rglru" in lay else
                             [lay["attn"]])
    for blk in blocks:
        for name, p in blk.items():
            if isinstance(p, dict) and "w" in p and name != "conv":
                assert tquant.is_quantized(p["w"]), name
    if family == "rgemma":
        ops = tm.decode_view(tp)["layers"][0]["rglru"]["kernel"]
        for g in ("rg", "ig"):
            w = ops[f"{g}_w"]
            assert w.dtype == torch.float32 and w.is_contiguous()
            assert torch.equal(w, tquant.dequantize(lay["rglru"][g]["w"]))


@pytest.mark.parametrize("entry", ["prefill", "chunks", "decode"])
@pytest.mark.parametrize("mode", ["cumba", "pallas"])
@pytest.mark.parametrize("family", FAMILIES)
def test_w8_logits_match_jax(family, mode, entry):
    """Logits of the whole-prompt prefill, of a prompt fed as two chunks
    (carried state and KV), and of three decode steps after the prefill
    (the port from its ``decode_view``, as the engines serve)."""
    jm, jp, tm, tp = _pair(family, mode)
    V = tm.cfg.vocab_size
    b, L = 2, 16
    toks = _tokens(V, (b, L))
    jcache = jm.init_cache(b, 32, jnp.float32)
    tcache = tm.init_cache(b, 32, torch.float32)
    view = tm.decode_view(tp)
    with torch.inference_mode():
        if entry == "chunks":
            for c in range(2):
                sl = slice(8 * c, 8 * c + 8)
                jl, jcache = jm.prefill_chunk(
                    jp, jnp.asarray(toks[:, sl], jnp.int32), jcache,
                    jnp.int32(8 * c))
                tl, tcache = tm.prefill_chunk(
                    view, torch.from_numpy(toks[:, sl]), tcache, 8 * c)
            pairs = [(tl, jl)]
        else:
            jl, jcache = jm.prefill(
                jp, {"tokens": jnp.asarray(toks, jnp.int32)}, jcache)
            tl, tcache = tm.prefill(view, {"tokens": torch.from_numpy(toks)},
                                    tcache)
            pairs = [(tl, jl)]
        if entry == "decode":
            nxt = _tokens(V, (3, b), seed=7)
            for t in range(3):
                jl, jcache = jm.decode_step(
                    jp, jnp.asarray(nxt[t][:, None], jnp.int32), jcache,
                    jnp.int32(L + t))
                tl, tcache = tm.decode_step(
                    view, torch.from_numpy(nxt[t][:, None]), tcache, L + t)
                pairs.append((tl, jl))
    errs = [_rel(t, j) for t, j in pairs]
    print(f"{family} {mode} {entry}: rel errors {errs}")
    assert max(errs) <= TOL[family]


@pytest.mark.parametrize("arch", ["gemma-2b", "recurrentgemma-2b"])
def test_cli_quant_w8_serves(arch):
    """``--quant w8`` serves the reduced transformer and RecurrentGemma
    through the continuous engine with chunked prefill."""
    engine, done = tserve.main(["--arch", arch, "--reduced", "--device",
                                "cpu", "--engine", "continuous",
                                "--prefill-chunk", "16", "--quant", "w8",
                                "--requests", "3", "--batch", "2",
                                "--max-new", "3"])
    lay = engine.params["layers"][0]
    blk = lay["rglru"] if "rglru" in lay else lay["attn"]
    w = blk[next(k for k in blk if k != "conv" and isinstance(blk[k], dict)
                 and "w" in blk[k])]["w"]
    assert tquant.is_quantized(w) and w.backend == "xla"
    assert tquant.is_quantized(lay["mlp"]["wi"]["w"])
    assert len(done) == 3 and all(len(r.out_tokens) == 3 for r in done)
    assert all(0 <= t < engine.model.cfg.vocab_size
               for r in done for t in r.out_tokens)
    assert engine.metrics.summary()["nonfinite_logit_rows"] == 0
