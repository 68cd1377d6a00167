"""The port's RecurrentGemma path against the JAX package, on the CPU.

The config and registry, the params bridge and the init rule,
``nn/layers.py`` (biased ``linear``, the Gemma norm, RoPE),
``nn/attention.py`` (whole-prompt prefill into linear and ring caches,
``chunk_attention`` in both layouts, decode across a ring wrap), the
plain versions of TPU kernels 6, 8 and 11 against the JAX Pallas kernels
in interpret mode and their ``kernels/ref.py`` oracles,
``nn/ssm.py: rglru_apply`` in every mode and the kernel dispatch (the
model, the engines and the CLI: ``tests/test_torch_rgemma_serve.py``).
Inputs are seeded numpy; the JAX params are carried across with
``from_jax_params``.

The model is the JAX test suites' small rgemma (d_model 32, lru_width
32, 4 heads of 8, 1 KV head, d_ff 96, window 8) with recurrentgemma-2b's
Gemma norm, embedding scale and logit soft-cap, at depths 3, 5 and 7
(one group; a group and a two-layer tail; two groups and a one-layer
tail).  Tolerances: modules, states and plain kernels within 1e-5 of the
reference's largest magnitude (at least 1) in fp32; bf16 outputs within
one bf16 step of the reference's largest magnitude; engines
greedy-identical.  Downstream of the RG-LRU's input gate, 2^-12 instead
(``RG_TOL``): where a gate saturates (a = exp(log_a) within an ulp of 1,
as at this random init, whose single-group weights draw with std 1),
``sqrt(max(1 - exp(2 log_a), 1e-12))`` keeps only the few bits of
``1 - exp(...)`` that survive the cancellation, and PyTorch's ``exp`` and
XLA's may round one ulp (2^-24) apart there: sqrt(2^-24) = 2^-12 of the
gate's input.  The readings sit near 5e-5 (block outputs) and 1.5e-5
(logits, which stay below 1 here).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import recurrentgemma_2b as jcfgs
from repro.core import pwl as jpwl
from repro.core.xamba import XambaConfig as JXamba
from repro.kernels import ops as jops, ref as jref
from repro.models import ModelConfig as JModelConfig, build_model as jbuild
from repro.nn import attention as jattn, layers as jlayers, ssm as jssm
from repro.nn.params import init_params as jinit
from repro_torch.configs import get_config
from repro_torch.core import pwl as tpwl
from repro_torch.core.xamba import XambaConfig
from repro_torch.kernels import decode_step as tds, matmul_pwl as tmpwl, \
    ops as tops, rg_lru as trg
from repro_torch.models import ModelConfig, build_model
from repro_torch.nn import attention as tattn, layers as tlayers, \
    ssm as tssm
from repro_torch.nn.params import from_jax_params, init_params

RTOL = 1e-5          # modules, states, plain kernels (fp32)
RG_TOL = 2.0 ** -12  # downstream of the RG-LRU's input gate (docstring)
BF16_STEP = 2.0 ** -7
V = 64
DIMS = dict(name="rgemma", family="recurrentgemma", vocab_size=V,
            d_model=32, n_layers=5, n_heads=4, n_kv_heads=1, head_dim=8,
            d_ff=96, mlp_type="geglu", lru_width=32, sliding_window=8,
            norm_type="gemma_rmsnorm", embed_scale=True,
            attn_logit_softcap=30.0, param_dtype="float32")
MODES = ("naive", "cumba", "pallas", "pallas_interpret")


def _t(a):
    return torch.from_numpy(np.array(np.asarray(a, np.float32), copy=True))


def _rel(got, want):
    """Max error over the reference's largest magnitude (at least 1)."""
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    return float(np.abs(got - want).max()) / max(1.0,
                                                 float(np.abs(want).max()))


def _pair(seed=0, jxamba=None, txamba=None, dtype="float32", **kw):
    """(JAX model, JAX params, port model, port params): one weight set of
    the small rgemma."""
    dims = dict(DIMS, param_dtype=dtype, **kw)
    jm = jbuild(JModelConfig(**dims, **({"xamba": jxamba} if jxamba else {})))
    jp = jinit(jm.param_specs(), jax.random.PRNGKey(seed), jnp.dtype(dtype))
    tm = build_model(ModelConfig(**{k: v for k, v in dims.items()},
                                 **({"xamba": txamba} if txamba else {})),
                     device="cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tm.cfg, device="cpu")
    return jm, jp, tm, tp


# ---------------------------------------------------------------------------
# config, registry, params
# ---------------------------------------------------------------------------
def test_config_matches_jax_and_registry():
    fields = ("name", "family", "vocab_size", "d_model", "n_layers",
              "n_heads", "n_kv_heads", "head_dim", "qkv_bias", "rope_theta",
              "sliding_window", "attn_logit_softcap", "attn_probs_bf16",
              "d_ff", "mlp_type", "norm_type", "embed_scale",
              "tie_embeddings", "lru_width", "block_pattern", "d_conv",
              "remat", "scan_layers", "use_flash", "param_dtype")
    for reduced in (False, True):
        t = get_config("recurrentgemma-2b", reduced=reduced)
        j = jcfgs.REDUCED if reduced else jcfgs.CONFIG
        for f in fields:
            assert getattr(t, f) == getattr(j, f), f
        assert t.xamba == XambaConfig.optimized()
    cfg = get_config("recurrentgemma-2b")
    assert (cfg.n_layers, cfg.d_model, cfg.lru_width, cfg.n_heads,
            cfg.n_kv_heads, cfg.head_dim, cfg.d_ff, cfg.vocab_size,
            cfg.sliding_window, cfg.attn_logit_softcap) == \
        (26, 2560, 2560, 10, 1, 256, 7680, 256000, 2048, 30.0)
    model = build_model(cfg, device="cpu")
    assert (model.n_groups, model.n_tail, model.n_rec, model.n_attn) == \
        (8, 2, 18, 8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_layers", [5, 7])
def test_from_jax_params_carries_grouped_tree_bit_for_bit(dtype, n_layers):
    """Layer ``g * 3 + j`` is group ``g`` of pattern position ``j``, then
    the tail; every leaf arrives with its dtype and bits."""
    jm, jp, tm, tp = _pair(seed=3, dtype=dtype, n_layers=n_layers)
    jp = jax.tree.map(np.asarray, jp)
    assert len(tp["layers"]) == n_layers and "groups" not in tp
    for i, lay in enumerate(tp["layers"]):
        g, j = divmod(i, 3)
        want = jax.tree.map(lambda a: a[g], jp["groups"][str(j)]) \
            if g < jm.n_groups else jp["tail"][str(i - 3 * jm.n_groups)]
        assert ("rglru" in lay) == (jm.layer_kinds[i] == "recurrent")
        flat_w = jax.tree_util.tree_leaves_with_path(want)
        for path, a in flat_w:
            t = lay
            for k in path:
                t = t[k.key]
            assert str(t.dtype).split(".")[-1] == a.dtype.name
            bits = t.view(torch.int16).numpy() if dtype == "bfloat16" \
                else t.numpy()
            np.testing.assert_array_equal(
                bits, a.view(np.int16) if dtype == "bfloat16" else a)
    np.testing.assert_array_equal(
        tp["embed"]["table"].float().numpy(),
        np.asarray(jp["embed"]["table"], np.float32))


def test_init_params_follows_the_jax_rule_per_leaf():
    """Group-stacked weights draw with std 1/sqrt(n_groups) (their
    stacked fan-in), tail weights with their real fan-in; ``lam`` is ones,
    the Gemma norms and the biases zeros."""
    model = build_model(ModelConfig(**dict(DIMS, n_layers=7)), device="cpu")
    p = init_params(model.param_specs(), 0, torch.float32, "cpu")
    spec = model.param_specs()
    assert spec["groups"]["0"]["rglru"]["rg"]["w"].shape == (2, 32, 32)
    grp, tail = p["layers"][0], p["layers"][6]
    for lay, std in ((grp, 2 ** -0.5), (tail, 32 ** -0.5)):
        for w in (lay["rglru"]["rg"]["w"], lay["rglru"]["in_x"]["w"],
                  lay["mlp"]["wg"]["w"]):
            assert abs(float(w.std()) / std - 1) < 0.1
        assert torch.all(lay["rglru"]["lam"] == 1)
        assert torch.all(lay["rglru"]["rg"]["b"] == 0)
        assert torch.all(lay["ln_mix"]["scale"] == 0)
    assert abs(float(p["layers"][2]["attn"]["wq"]["w"].std()) /
               2 ** -0.5 - 1) < 0.1
    assert torch.all(p["final_norm"]["scale"] == 0)
    assert abs(float(p["embed"]["table"].std()) - 0.02) < 0.004
    again = init_params(model.param_specs(), 0, torch.float32, "cpu")
    assert torch.equal(again["layers"][4]["mlp"]["wi"]["w"],
                       p["layers"][4]["mlp"]["wi"]["w"])


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_with_bias_norm_and_rope_match_jax(dtype):
    """The bias is added in fp32 before the one cast; the Gemma norm
    scales by ``scale + 1``; RoPE rotates half-split pairs at fp32
    angles (per-row positions)."""
    rng = np.random.default_rng(0)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    x = rng.normal(size=(3, 5, 16)).astype(np.float32)
    w = (rng.normal(size=(16, 24)) * 0.3).astype(np.float32)
    bias = rng.normal(size=(24,)).astype(np.float32)
    scale = (rng.normal(size=(16,)) * 0.2).astype(np.float32)
    tol = 1e-6 if dtype == "float32" else BF16_STEP

    def pair(a):
        return jnp.asarray(a).astype(jdt), _t(a).to(tdt)
    (jx, tx), (jw, tw), (jb, tb), (js, ts) = map(pair, (x, w, bias, scale))
    got = tlayers.linear({"w": tw, "b": tb}, tx)
    assert got.dtype == tdt
    assert _rel(got, jlayers.linear({"w": jw, "b": jb}, jx)) <= tol
    for nt in ("rmsnorm", "gemma_rmsnorm"):
        got = tlayers.norm({"scale": ts}, tx, norm_type=nt)
        assert _rel(got, jlayers.norm({"scale": js}, jx, norm_type=nt)) <= tol
    q = rng.normal(size=(3, 5, 4, 8)).astype(np.float32)
    pos = rng.integers(0, 3000, size=(3, 5))
    jq, tq = pair(q)
    got = tlayers.rope(tq, torch.from_numpy(pos), theta=1e4)
    assert _rel(got, jlayers.rope(jq, jnp.asarray(pos), theta=1e4)) <= tol
    with pytest.raises(NotImplementedError):
        tlayers.norm({"scale": ts}, tx, norm_type="layernorm")


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def _attn_pair(window=8):
    cfg = dict(DIMS, sliding_window=window)
    jcfg, tcfg = JModelConfig(**cfg), ModelConfig(**cfg)
    jp = jinit(jattn.attention_specs(jcfg), jax.random.PRNGKey(1),
               jnp.float32)
    tp = jax.tree.map(lambda a: _t(a), jp)
    return jcfg, jp, tcfg, tp


def _cache(T, b=2, seed=0):
    rng = np.random.default_rng(seed)
    k, v = (rng.normal(size=(b, T, 1, 8)).astype(np.float32)
            for _ in range(2))
    return (jattn.KVCache(jnp.asarray(k), jnp.asarray(v)),
            tattn.KVCache(_t(k), _t(v)))


@pytest.mark.parametrize("s,T", [(5, 16), (12, 8), (8, 8)],
                         ids=["linear", "ring-wraps", "ring-exact"])
def test_attention_prefill_matches_jax(s, T):
    """Whole-prompt prefill: a linear cache (s < T) and a ring (s >= T:
    the prompt's last T positions rolled to their slots)."""
    jcfg, jp, tcfg, tp = _attn_pair()
    x = np.random.default_rng(2).normal(size=(2, s, 32)).astype(np.float32)
    jc, tc = _cache(T)
    pos = np.arange(s)[None]
    jy, jnew = jax.jit(lambda p, x_, c: jattn.apply(
        p, jcfg, x_, positions=jnp.asarray(pos), cache=c, window=8))(
            jp, jnp.asarray(x), jc)
    ty, tnew = tattn.apply(tp, tcfg, _t(x), positions=torch.from_numpy(pos),
                           cache=tc, window=8)
    assert _rel(ty, jy) <= RTOL
    assert _rel(tnew.k, jnew.k) <= RTOL and _rel(tnew.v, jnew.v) <= RTOL
    assert torch.equal(tc.k, _t(np.asarray(jc.k)))      # input untouched


@pytest.mark.parametrize("T,s,offset,probs_bf16", [
    (24, 5, [0, 7], False), (24, 5, [0, 7], True), (24, 6, [19, 3], False),
    (8, 5, [0, 6], False), (8, 11, [3, 9], False)],
    ids=["linear", "linear-probs-bf16", "linear-drops-past-T", "ring",
         "ring-longer-chunk"])
def test_chunk_attention_matches_jax(T, s, offset, probs_bf16):
    """``chunk_attention`` with per-row offsets in both layouts (a write
    past a linear cache is dropped, as JAX's scatter drops it), and with
    the probabilities and values rounded to bf16 before their product
    (``attn_probs_bf16``)."""
    rng = np.random.default_rng(T + s)
    q = rng.normal(size=(2, s, 4, 8)).astype(np.float32)
    k, v = (rng.normal(size=(2, s, 1, 8)).astype(np.float32)
            for _ in range(2))
    jc, tc = _cache(T, seed=1)
    off = np.asarray(offset)
    jo, jnew = jax.jit(lambda *a: jattn.chunk_attention(
        *a, window=8, logit_softcap=30.0, probs_bf16=probs_bf16))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jc,
            jnp.asarray(off, jnp.int32))
    to, tnew = tattn.chunk_attention(_t(q), _t(k), _t(v), tc, off,
                                     window=8, logit_softcap=30.0,
                                     probs_bf16=probs_bf16)
    assert _rel(to, jo) <= RTOL
    assert _rel(tnew.k, jnew.k) == 0 and _rel(tnew.v, jnew.v) == 0


@pytest.mark.parametrize("index", [5, [6, 13]], ids=["scalar", "per-row"])
@pytest.mark.parametrize("T", [8, 24], ids=["ring", "linear"])
def test_attention_decode_across_a_ring_wrap_matches_jax(index, T):
    """Decode steps from ``index`` on: the ring's slot ``index % T`` wraps
    past the window; per-row positions; out buffers receive the cache."""
    jcfg, jp, tcfg, tp = _attn_pair()
    jc, tc = _cache(T, seed=4)
    idx = np.asarray(index)
    rng = np.random.default_rng(5)
    japply = jax.jit(lambda p, x_, pos_, c, i: jattn.apply(
        p, jcfg, x_, positions=pos_, cache=c, cache_index=i, window=8))
    for step in range(5):
        x = rng.normal(size=(2, 1, 32)).astype(np.float32)
        pos = np.broadcast_to((idx + step).reshape(-1, 1), (2, 1)).copy()
        jy, jc = japply(jp, jnp.asarray(x), jnp.asarray(pos), jc,
                        jnp.asarray(idx + step, jnp.int32))
        out = tattn.KVCache(torch.empty_like(tc.k), torch.empty_like(tc.v))
        ty, tc = tattn.apply(tp, tcfg, _t(x), positions=torch.from_numpy(pos),
                             cache=tc, cache_index=idx + step, window=8,
                             out=out)
        assert tc.k is out.k
        assert _rel(ty, jy) <= RTOL
        assert _rel(tc.k, jc.k) <= RTOL and _rel(tc.v, jc.v) <= RTOL


def test_blocked_attention_and_flash_refusal():
    """Past 2048 kv positions the whole-sequence path is the blocked
    online softmax, as JAX's; ``use_flash`` does not change that with a
    soft-cap (recurrentgemma's: the flash kernel has none), and without
    one takes kernel 9 (its plain version here) ahead of the blocked
    form, as JAX orders them."""
    rng = np.random.default_rng(6)
    q = rng.normal(size=(1, 40, 2, 8)).astype(np.float32)
    k, v = (rng.normal(size=(1, 2100, 1, 8)).astype(np.float32)
            for _ in range(2))
    want = jattn.blocked_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=True, window=300,
                                   logit_softcap=30.0)
    for use_flash in (False, True):
        got = tattn.full_attention(_t(q), _t(k), _t(v), causal=True,
                                   window=300, logit_softcap=30.0,
                                   use_flash=use_flash)
        assert _rel(got, want) <= RTOL
    got = tattn.full_attention(_t(q), _t(k), _t(v), causal=True, window=None,
                               use_flash=True)
    want = jref.attention_ref(*(jnp.moveaxis(jnp.asarray(a), 2, 1)
                                for a in (q, k, v)), causal=True)
    assert _rel(got, jnp.moveaxis(want, 1, 2)) <= RTOL


# ---------------------------------------------------------------------------
# plain kernels 6, 8, 11
# ---------------------------------------------------------------------------
def _rg_args(rng, b=3, w=24):
    f = np.float32
    return [rng.normal(size=(b, w)).astype(f),
            rng.normal(size=(b, w)).astype(f),
            rng.normal(size=(b, 3, w)).astype(f),
            rng.normal(size=(b, w)).astype(f),
            (rng.normal(size=(4, w)) * 0.5).astype(f),
            (rng.normal(size=(w,)) * 0.1).astype(f),
            (rng.normal(size=(w, w)) * w ** -0.5).astype(f),
            (rng.normal(size=(w,)) * 0.1).astype(f),
            (rng.normal(size=(w, w)) * w ** -0.5).astype(f),
            (rng.normal(size=(w,)) * 0.1).astype(f),
            (rng.normal(size=(w,)) * 0.5).astype(f)]


def _bf16_err(got, want):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    return float(np.abs(got.float().numpy() - want).max()) / \
        max(float(np.abs(want).max()), 1e-30)


@pytest.mark.parametrize("actiba", [False, True], ids=["exact", "actiba"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_step_plain_matches_pallas_and_ref(dtype, actiba):
    """Kernel 6's plain version against ``kops.rglru_decode_step
    (interpret=True)`` and ``rglru_step_ref``: fp32 within 1e-5, bf16
    streams (u, gate, conv tail, y; weights bf16) within one bf16 step,
    h fp32 within 1e-5."""
    args = _rg_args(np.random.default_rng(7))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    stream = (0, 1, 2, 6, 8)
    jargs = [jnp.asarray(a).astype(jdt) if i in stream else jnp.asarray(a)
             for i, a in enumerate(args)]
    targs = [_t(a).to(tdt) if i in stream else _t(a)
             for i, a in enumerate(args)]
    jx = JXamba.pallas(interpret=True) if actiba else \
        JXamba(decode="pallas_interpret")
    tx = XambaConfig.pallas() if actiba else None
    got = tops.rglru_decode_step(*targs, xamba=tx)
    acts = {k: jpwl.activation(k, jx if actiba else None)
            for k in ("sigmoid", "softplus")}
    acts["gelu"] = jpwl.activation("gelu", jx) if actiba else None
    wants = (jops.rglru_decode_step(*jargs, xamba=jx, interpret=True),
             jref.rglru_step_ref(*jargs, **acts))
    for want in wants:
        for name, a, r in zip(("y", "conv", "h"), got, want):
            assert a.dtype == (torch.float32 if name == "h" else tdt)
            if dtype == "float32" or name == "h":
                assert _rel(a, r) <= RTOL, name
            else:
                assert _bf16_err(a, r) <= BF16_STEP, name
    if actiba:
        assert not torch.equal(tds.rglru_step_plain(*targs)[0], got[0])


def test_rglru_dispatch_writes_out_and_refuses_cpu_kernel():
    args = [_t(a) for a in _rg_args(np.random.default_rng(8))]
    want = tds.rglru_step_plain(*args)
    out = (torch.empty_like(args[2]), torch.empty_like(args[3]))
    got = tops.rglru_decode_step(*args, out=out)
    assert got[1] is out[0] and got[2] is out[1]
    assert all(torch.equal(a, r) for a, r in zip(got, want))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tds.rglru_step(*args)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 37, 20), (1, 300, 130)])
def test_rg_lru_scan_plain_matches_pallas_and_ref(dtype, shape):
    """Kernel 8's plain version: bit for bit the sequential oracle's
    rounding order in fp32; within 1e-5 (fp32) or one bf16 step of the
    TPU kernel's in-block associative scan, at lengths and widths that are
    no block multiple."""
    rng = np.random.default_rng(sum(shape))
    a = rng.uniform(0.0, 1.0, size=shape).astype(np.float32)
    b = rng.normal(size=shape).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ja, jb = jnp.asarray(a).astype(jdt), jnp.asarray(b).astype(jdt)
    got = tops.rg_lru_scan(_t(a).to(tdt), _t(b).to(tdt))
    assert got.dtype == tdt
    for want in (jops.rg_lru_scan(ja, jb, interpret=True),
                 jref.rg_lru_scan_ref(ja, jb)):
        assert (_rel(got, want) if dtype == "float32"
                else _bf16_err(got, want)) <= \
            (RTOL if dtype == "float32" else BF16_STEP)
    with pytest.raises(ValueError, match="CUDA tensors"):
        trg.rg_lru_scan(_t(a), _t(b))


@pytest.mark.parametrize("gated", [False, True], ids=["pwl", "gated"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_pwl_plain_matches_pallas_and_ref(dtype, gated):
    """Kernel 11's plain version against ``kops.matmul_pwl(interpret=
    True)`` and ``matmul_pwl_ref`` with the gelu table, at shapes that are
    no block multiple."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(13, 40)).astype(np.float32)
    w, v = ((rng.normal(size=(40, 70)) * 0.2).astype(np.float32)
            for _ in range(2))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jt = jpwl.get_table("gelu", segments=32)
    tt = tpwl.get_table("gelu", segments=32)
    jv = jnp.asarray(v).astype(jdt) if gated else None
    got = tops.matmul_pwl(_t(x).to(tdt), _t(w).to(tdt), tt,
                          _t(v).to(tdt) if gated else None)
    assert got.dtype == tdt
    jargs = (jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt), jt, jv)
    for want in (jops.matmul_pwl(*jargs, interpret=True),
                 jref.matmul_pwl_ref(*jargs)):
        assert (_rel(got, want) if dtype == "float32"
                else _bf16_err(got, want)) <= \
            (RTOL if dtype == "float32" else BF16_STEP)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tmpwl.matmul_pwl(_t(x), _t(w), tt)


# ---------------------------------------------------------------------------
# the RG-LRU block
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["prefill", "prefill_state", "prefill_pallas",
                                  "force_prefill"] + [f"step_{m}"
                                                      for m in MODES])
def test_rglru_apply_matches_jax(case):
    """``rglru_apply`` on one layer's weights: prefill (l = 20) without a
    state (the associative scan; kernel 8's plain version under
    ``pallas``), with a carried state, the one-token prefill path, and
    the decode step in every mode (``naive`` the unfused chain, the
    others the fused step)."""
    mode = case.split("_", 1)[1] if case.startswith("step_") else "cumba"
    if case == "prefill_pallas":
        jx, tx = JXamba.pallas(interpret=True), XambaConfig.pallas()
    else:
        # The JAX package runs Pallas on the CPU in interpret mode only.
        jx = JXamba(decode="pallas_interpret" if mode == "pallas" else mode)
        tx = XambaConfig(decode=mode)
    fp = case == "force_prefill"
    jm, jp, tm, tp = _pair(seed=2, jxamba=jx, txamba=tx,
                           force_prefill_path=fp)
    jl = jp["groups"]["0"]["rglru"]
    jl = jax.tree.map(lambda a: a[0], jl)
    tl = tp["layers"][0]["rglru"]
    rng = np.random.default_rng(9)
    l = 20 if case.startswith("prefill") else 1
    x = rng.normal(size=(2, l, 32)).astype(np.float32)
    state = None
    if case not in ("prefill", "prefill_pallas"):
        conv = rng.normal(size=(2, 3, 32)).astype(np.float32)
        h = (rng.normal(size=(2, 32)) * 3).astype(np.float32)
        jstate = jssm.RGLRUState(jnp.asarray(conv), jnp.asarray(h))
        state = tssm.RGLRUState(_t(conv), _t(h))
    jh, jnew = jax.jit(lambda p, x_, st: jssm.rglru_apply(p, jm.cfg, x_, st))(
        jl, jnp.asarray(x), None if state is None else jstate)
    with torch.inference_mode():
        th, tnew = tssm.rglru_apply(tl, tm.cfg, _t(x), state)
    assert _rel(th, jh) <= RG_TOL
    if state is None:
        assert tnew is None
    else:
        assert _rel(tnew.conv, jnew.conv) <= RTOL
        assert _rel(tnew.h, jnew.h) <= RG_TOL


@pytest.mark.parametrize("mode", MODES)
def test_decode_and_mlp_dispatch_by_mode(mode, monkeypatch):
    """``cumba`` and ``pallas*`` decode through the fused step (once a
    recurrent layer), ``naive`` through the unfused chain; the MLP runs
    ``matmul_pwl`` on every call only under ActiBA with a ``pallas`` CumBA
    mode; the cache-less loss runs ``rg_lru_scan`` once a recurrent layer
    under a ``pallas`` CumBA mode only."""
    calls = {"step": 0, "mlp": 0, "scan": 0}

    def spy(key, fn):
        def f(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return f
    monkeypatch.setattr(tops, "rglru_decode_step",
                        spy("step", tops.rglru_decode_step))
    monkeypatch.setattr(tops, "matmul_pwl", spy("mlp", tops.matmul_pwl))
    monkeypatch.setattr(tops, "rg_lru_scan", spy("scan", tops.rg_lru_scan))
    pallas = mode.startswith("pallas")
    xamba = XambaConfig.pallas(interpret=mode == "pallas_interpret") \
        if pallas else XambaConfig(decode=mode)
    tm = build_model(ModelConfig(**DIMS, xamba=xamba), device="cpu")
    params = init_params(tm.param_specs(), 0, torch.float32, "cpu")
    toks = torch.ones((1, 6), dtype=torch.long)
    with torch.inference_mode():
        _, cache = tm.prefill(params, {"tokens": toks},
                              tm.init_cache(1, 12, torch.float32))
        assert calls == {"step": 0, "mlp": 5 if pallas else 0, "scan": 0}
        tm.decode_step(params, toks[:, :1], cache, 6)
        tm.loss(params, {"tokens": toks, "labels": toks})
    assert calls == {"step": 0 if mode == "naive" else 4,
                     "mlp": 15 if pallas else 0, "scan": 4 if pallas else 0}
