"""The port's W8 path against the JAX package, on the CPU.

``nn/quant.py`` (quantize bit for bit, the param-tree walk, the byte
summary, ``qdot``), kernel 10's plain version (``kernels/qmatmul.py:
qmatmul_plain``) against the JAX Pallas kernel in interpret mode and its
``kernels/ref.py`` oracle, and the W8 model against the JAX W8 model on
the same weights (the JAX package's params carried across with
``from_jax_params``, quantized on both sides or quantized in JAX and
carried across).  Inputs are seeded numpy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pwl as jpwl
from repro.kernels import ops as jops, ref as jref
from repro.models import ModelConfig as JModelConfig, build_model as jbuild
from repro.nn import quant as jquant
from repro.nn.params import init_params as jinit
from repro_torch.core import pwl as tpwl
from repro_torch.kernels import ops as tops, qmatmul as tqm
from repro_torch.models import ModelConfig, build_model
from repro_torch.nn import quant as tquant, ssm as tssm
from repro_torch.nn.params import from_jax_params

V = 64
DIMS = dict(name="mamba2", family="mamba2", vocab_size=V, d_model=32,
            n_layers=2, d_state=8, ssm_head_dim=8, chunk_size=16,
            param_dtype="float32")
# bf16 outputs, as chip_smoke.py holds the kernels: element by element
# |got - want| <= 2^-7 (|want| + 4 rms(want)) (one bf16 step), and at most
# max(2, 0.5%) of the elements not bit-equal (the fp32 sums differ only in
# order, so few land on the other side of a bf16 rounding boundary).
BF16_RTOL, BF16_ATOL_RMS, BF16_OFF_SHARE = 2.0 ** -7, 4.0, 0.005


def _t(a):
    return torch.from_numpy(np.array(np.asarray(a), copy=True))


def _rel(got, want):
    """Max error over the reference's largest magnitude (at least 1)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(1.0,
                                                 float(np.abs(want).max()))


def _bf16_close(got: torch.Tensor, want: np.ndarray) -> None:
    assert got.dtype == torch.bfloat16
    a = got.float().numpy().astype(np.float64)
    r = np.asarray(want, np.float32).astype(np.float64)
    diff = np.abs(a - r)
    tol = BF16_RTOL * (np.abs(r) + BF16_ATOL_RMS * np.sqrt((r * r).mean()))
    assert bool((diff <= tol).all()), float((diff / tol).max())
    assert int((diff > 0).sum()) <= max(2, BF16_OFF_SHARE * diff.size)


def _jax_pair(seed=1):
    """(JAX model, JAX fp32 params as numpy, port model)."""
    jm = jbuild(JModelConfig(**DIMS))
    jp = jax.tree.map(np.asarray, jinit(jm.param_specs(),
                                        jax.random.PRNGKey(seed),
                                        jnp.float32))
    return jm, jp, build_model(ModelConfig(**DIMS), device="cpu")


# ---------------------------------------------------------------------------
# quantize / summary
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(96, 130), (3, 40, 72), (200, 3352)])
def test_quantize_tensor_bit_identical_to_jax(shape):
    """The same fp32 weight gives the same int8 ``q`` and fp32 ``scale``
    bits in both packages (an outlier channel and a zero channel
    included; a stacked weight scales per layer and channel)."""
    rng = np.random.default_rng(sum(shape))
    w = rng.normal(size=shape).astype(np.float32)
    w[..., 7] *= 100.0
    w[..., 11] = 0.0
    jq = jquant.quantize_tensor(jnp.asarray(w))
    tq = tquant.quantize_tensor(torch.from_numpy(w))
    assert tq.q.dtype == torch.int8 and tq.scale.dtype == torch.float32
    assert tq.scale.shape == shape[:-2] + (1, shape[-1])
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    np.testing.assert_array_equal(tq.scale.numpy().view(np.uint32),
                                  np.asarray(jq.scale).view(np.uint32))
    err = (tquant.dequantize(tq) - torch.from_numpy(w)).abs()
    assert bool((err <= tquant.roundtrip_error_bound(tq)).all())


def test_quantize_params_matches_jax_leaves_and_summary():
    """``quantize_params`` quantizes exactly the leaves JAX does, to the
    same bits per layer; a JAX-quantized tree carried across with
    ``from_jax_params`` is the same tree.  ``quant_summary`` agrees on
    bytes and compression; the port counts per-layer tensors where JAX
    counts stacked ones."""
    jm, jp, tm = _jax_pair()
    jq = jax.tree.map(np.asarray, jquant.quantize_params(jp),
                      is_leaf=lambda x: False)
    tq = tquant.quantize_params(from_jax_params(jp, tm.cfg, device="cpu"))
    carried = from_jax_params(jq, tm.cfg, device="cpu")
    L = DIMS["n_layers"]
    jmix = jq["layers"]["mixer"]
    for i in range(L):
        for mix in (tq["layers"][i]["mixer"], carried["layers"][i]["mixer"]):
            for name in ("in_proj", "out_proj"):
                w = mix[name]["w"]
                assert tquant.is_quantized(w) and w.backend == "xla"
                np.testing.assert_array_equal(w.q.numpy(),
                                              jmix[name]["w"].q[i])
                np.testing.assert_array_equal(w.scale.numpy(),
                                              jmix[name]["w"].scale[i])
            assert not tquant.is_quantized(mix["conv"]["w"])
            assert isinstance(mix["A_log"], torch.Tensor)
    assert not tquant.is_quantized(tq["embed"]["table"])
    js, ts = jquant.quant_summary(jq), tquant.quant_summary(tq)
    for key in ("bytes", "bytes_fp32_equiv", "compression"):
        assert ts[key] == js[key], key
    n_stacked = len(jax.tree.leaves(jp["layers"]))
    assert ts["quantized_tensors"] == L * js["quantized_tensors"] == 2 * L
    assert ts["fp_tensors"] == js["fp_tensors"] + \
        (L - 1) * (n_stacked - js["quantized_tensors"])


def test_quantize_params_for_mode_tags():
    _, jp, tm = _jax_pair()
    params = from_jax_params(jp, tm.cfg, device="cpu")
    assert tquant.quantize_params_for_mode(params, "none") is params
    for mode, backend in tquant.MODE_BACKENDS.items():
        assert jquant.MODE_BACKENDS[mode] == backend
        qp = tquant.quantize_params_for_mode(params, mode)
        assert qp["layers"][1]["mixer"]["out_proj"]["w"].backend == backend
    with pytest.raises(ValueError):
        tquant.quantize_params_for_mode(params, "w9")
    assert tquant.DEFAULT_SKIP == jquant.DEFAULT_SKIP
    assert tquant.DEFAULT_MIN_DIM == jquant.DEFAULT_MIN_DIM


# ---------------------------------------------------------------------------
# kernel 10's plain version
# ---------------------------------------------------------------------------
def _qmm_inputs(m, k, n, variant, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    qt = jquant.quantize_tensor(jnp.asarray(rng.normal(size=(k, n)),
                                            jnp.float32))
    kw = {}
    if variant == "gated":
        qv = jquant.quantize_tensor(jnp.asarray(rng.normal(size=(k, n)),
                                                jnp.float32))
        kw = dict(qv=np.asarray(qv.q), vscale=np.asarray(qv.scale))
    return x, np.asarray(qt.q), np.asarray(qt.scale), kw


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["plain", "pwl", "gated"])
@pytest.mark.parametrize("m,k,n", [(3, 200, 200), (5, 96, 333)])
def test_qmatmul_plain_matches_jax_kernel_and_oracle(m, k, n, variant,
                                                     dtype):
    """Ragged shapes (n no multiple of 128): the plain version against the
    JAX Pallas kernel (interpret mode) and ``qmatmul_ref``, in the plain,
    PWL-table (SiLU, 16 segments) and gated forms; fp32 within 1e-5
    relative, bf16 within one bf16 step."""
    x, q, scale, kw = _qmm_inputs(m, k, n, variant, seed=m * k + n)
    jtab = jpwl.get_table("silu", segments=16) \
        if variant != "plain" else None
    ttab = tpwl.get_table("silu", segments=16) \
        if variant != "plain" else None
    jx = jnp.asarray(x, dtype)
    jkw = {k_: jnp.asarray(v) for k_, v in kw.items()}
    want_k = np.asarray(jops.qmatmul(jx, jnp.asarray(q), jnp.asarray(scale),
                                     table=jtab, interpret=True, **jkw),
                        np.float32)
    want_r = np.asarray(jref.qmatmul_ref(jx, jnp.asarray(q),
                                         jnp.asarray(scale), jtab, **jkw),
                        np.float32)
    tx = _t(x).to(getattr(torch, dtype))
    got = tqm.qmatmul_plain(tx, _t(q), _t(scale).reshape(-1), table=ttab,
                            **{k_: _t(v) for k_, v in kw.items()})
    assert got.dtype == tx.dtype and got.shape == (m, n)
    # CPU dispatch: ops.qmatmul is the plain version.
    assert torch.equal(tops.qmatmul(tx, _t(q), _t(scale).reshape(-1),
                                    table=ttab,
                                    **{k_: _t(v) for k_, v in kw.items()}),
                       got)
    for want in (want_k, want_r):
        if dtype == "float32":
            assert _rel(got.numpy(), want) <= 1e-5
        else:
            _bf16_close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qdot_matches_jax_xla_backend(dtype):
    """``qdot`` on the CPU is the JAX XLA backend's arithmetic: fp32 out,
    the scale on the fp32 sums (bf16 x: exact products, so only the order
    of the sums differs)."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 3, 56)).astype(np.float32)
    w = rng.normal(size=(56, 88)).astype(np.float32)
    jq = jquant.quantize_tensor(jnp.asarray(w))
    want = np.asarray(jquant.qdot(jnp.asarray(x, dtype), jq))
    got = tquant.qdot(_t(x).to(getattr(torch, dtype)),
                      tquant.quantize_tensor(_t(w)))
    assert got.dtype == torch.float32 and got.shape == (2, 3, 88)
    assert _rel(got.numpy(), want) <= 1e-5
    with pytest.raises(ValueError, match="2-D"):
        tquant.qdot(_t(x), tquant.quantize_tensor(_t(w)[None]))


# ---------------------------------------------------------------------------
# the W8 model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["xla", "pallas_interpret"])
def test_w8_model_matches_jax_w8_model(backend):
    """Prefill (l = 32 at chunk 16: the fused prefill, its in-projection
    through ``qdot``) and three decode steps of the JAX-quantized model
    carried across, against the JAX W8 model; under ``pallas_interpret``
    the JAX side runs its qmatmul kernel in interpret mode, the port the
    same arithmetic whatever the tag (fp32, 1e-4)."""
    jm, jp, tm = _jax_pair(seed=3)
    jq = jquant.quantize_params(jax.tree.map(jnp.asarray, jp),
                                backend=backend)
    tp = from_jax_params(jax.tree.map(np.asarray, jq), tm.cfg, device="cpu")
    assert tp["layers"][0]["mixer"]["in_proj"]["w"].backend == backend
    rng = np.random.default_rng(4)
    toks = rng.integers(1, V, size=(2, 32))
    jl, jc = jm.prefill(jq, {"tokens": jnp.asarray(toks, jnp.int32)},
                        jm.init_cache(2, dtype=jnp.float32))
    view = tm.decode_view(tp)
    with torch.inference_mode():
        tl, tc = tm.prefill(view, {"tokens": torch.from_numpy(toks)},
                            tm.init_cache(2, dtype=torch.float32))
    assert float(np.abs(tl.numpy() - np.asarray(jl)).max()) <= 1e-4
    jdv = jm.decode_view(jq)
    for t in range(3):
        tok = rng.integers(1, V, size=(2, 1))
        jl, jc = jm.decode_step(jdv, jnp.asarray(tok, jnp.int32), jc,
                                jnp.int32(32 + t))
        with torch.inference_mode():
            tl, tc = tm.decode_step(view, torch.from_numpy(tok), tc, 32 + t)
        assert float(np.abs(tl.numpy() - np.asarray(jl)).max()) <= 1e-4


def test_w8_chunked_prefill_matches_whole_sequence():
    """Quantized chunked prefill (three chunks of 8, state carried) equals
    the quantized whole-sequence prefill, in the port and against the
    JAX package's chunked prefill (the invariant of the JAX test
    ``test_w8_chunked_prefill_matches_whole_sequence``)."""
    jm, jp, tm = _jax_pair(seed=5)
    jq = jquant.quantize_params(jax.tree.map(jnp.asarray, jp))
    tp = tquant.quantize_params(from_jax_params(jp, tm.cfg, device="cpu"))
    toks = np.random.default_rng(6).integers(1, V, size=(2, 24))
    with torch.inference_mode():
        whole, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                              tm.init_cache(2, dtype=torch.float32))
        cache = tm.init_cache(2, dtype=torch.float32)
        for off in range(0, 24, 8):
            logits, cache = tm.prefill_chunk(
                tp, torch.from_numpy(toks[:, off:off + 8]), cache, off)
    np.testing.assert_allclose(logits.numpy(), whole.numpy(), rtol=1e-5,
                               atol=1e-4)
    jc = jm.init_cache(2, dtype=jnp.float32)
    for off in range(0, 24, 8):
        jl, jc = jm.prefill_chunk(jq, jnp.asarray(toks[:, off:off + 8],
                                                  jnp.int32), jc,
                                  jnp.int32(off))
    assert float(np.abs(logits.numpy() - np.asarray(jl)).max()) <= 1e-4


def test_decode_view_passes_quantized_weights_through(monkeypatch):
    """``decode_view`` keeps each layer's ``QuantTensor`` objects as they
    are, and building the kernel operands never reads a projection."""
    _, jp, tm = _jax_pair()
    tp = tquant.quantize_params(from_jax_params(jp, tm.cfg, device="cpu"))
    seen = []
    real = tssm.mamba2_kernel_operands

    def spy(params):
        seen.append(params)
        return real({k: v for k, v in params.items()
                     if k not in ("in_proj", "out_proj")})
    monkeypatch.setattr(tssm, "mamba2_kernel_operands", spy)
    view = tm.decode_view(tp)
    assert len(seen) == DIMS["n_layers"]
    for raw, lay in zip(tp["layers"], view["layers"]):
        for name in ("in_proj", "out_proj"):
            assert lay["mixer"][name]["w"] is raw["mixer"][name]["w"]
