"""The port's dense transformer (gemma-2b, qwen1.5-4b) and its kernels
against the JAX package, on the CPU.

The configs and registry, the params bridge (untied ``lm_head``, QKV
biases, the stacked trunk) and the init rule; the plain versions of TPU
kernels 9 (flash attention) and 14 (``reduce_rows``) against the JAX
Pallas kernels in interpret mode and their ``kernels/ref.py`` oracles,
and the reference's own pad-key fault; ``core/reduce.py`` in the
``pallas`` modes; ``TransformerLM`` (prefill, chunked prefill, decode,
loss, snapshots) with ``use_flash`` on and off; which calls reach kernel
9.  The engines and the CLI: ``tests/test_torch_transformer_serve.py``.
Inputs are seeded numpy; JAX params are carried across with
``from_jax_params``; the JAX side runs its Pallas kernels in interpret
mode (``flash_interpret=True``), as its own tests do.

Tolerances: kernels' plain versions, prefill and chunk logits and the
loss in fp32 within 1e-5 of the reference's largest magnitude (at least
1).  Decode-step logits and the KV caches within ``MODEL_TOL`` = 4e-5:
the reduced models' stacked init (std 1/sqrt(n_layers) per weight, the
JAX rule) gives every projection a gain of ~8 and sharp attention, and
the JAX model itself moves its decode logits by up to 1.3e-5 (gemma) and
2.6e-5 (qwen, logits up to 3) and its second layer's k and v by up to
1.6e-5 of their largest magnitude when every embedding element moves by
one ulp; the two packages' other fp32 summation orders show at that
size (1.45e-5 and 1.2e-5 read).  bf16: logits within 4 bf16 steps of the
largest magnitude (the packages round the bf16 stream at the same
points and sum in fp32 in other orders: one step read), reductions
within one bf16 step of each element.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma_2b as jgemma, qwen15_4b as jqwen
from repro.core import reduce as jreduce
from repro.kernels import ops as jops, ref as jref, reduba as jreduba
from repro.models import build_model as jbuild
from repro.nn.params import init_params as jinit
from repro_torch.configs import get_config
from repro_torch.core import reduce as treduce
from repro_torch.kernels import flash_attention as tfa, ops as tops, \
    reduba as tred
from repro_torch.models import build_model
from repro_torch.models.transformer import TransformerLM
from repro_torch.nn import attention as tattn
from repro_torch.nn.params import from_jax_params, init_params
from test_torch_rgemma import BF16_STEP, RTOL, _rel, _t

MODEL_TOL = 4e-5
JCFGS = {"gemma-2b": jgemma, "qwen1.5-4b": jqwen}
ARCHS = tuple(JCFGS)


def _pair(arch, dtype="float32", flash=False, seed=0, **kw):
    """(JAX model, JAX params, port model, port params) of the reduced
    config, one weight set; ``flash`` is ``use_flash`` (interpret mode on
    the JAX side)."""
    over = dict(param_dtype=dtype, use_flash=flash, flash_interpret=flash,
                **kw)
    jm = jbuild(JCFGS[arch].REDUCED.replace(**over))
    jp = jinit(jm.param_specs(), jax.random.PRNGKey(seed), jnp.dtype(dtype))
    tcfg = get_config(arch, reduced=True, **over)
    tm = build_model(tcfg, device="cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jm, jp, tm, tp


def _bf16_close(got, want, steps=4):
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    err = float(np.abs(got.float().numpy() - want).max())
    return err <= steps * BF16_STEP * max(1.0, float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# configs, params
# ---------------------------------------------------------------------------
def test_configs_match_jax_and_registry():
    fields = ("name", "family", "vocab_size", "d_model", "n_layers",
              "n_heads", "n_kv_heads", "head_dim", "qkv_bias", "rope_theta",
              "sliding_window", "attn_logit_softcap", "attn_probs_bf16",
              "d_ff", "mlp_type", "norm_type", "embed_scale",
              "tie_embeddings", "remat", "scan_layers", "use_flash",
              "flash_interpret", "moe", "frontend", "param_dtype")
    for arch, jmod in JCFGS.items():
        for reduced in (False, True):
            t = get_config(arch, reduced=reduced)
            j = jmod.REDUCED if reduced else jmod.CONFIG
            for f in fields:
                assert getattr(t, f) == getattr(j, f), (arch, f)
            assert t.xamba == type(t.xamba)()
    g = get_config("gemma-2b")
    assert (g.n_layers, g.d_model, g.n_heads, g.n_kv_heads, g.head_dim,
            g.d_ff, g.vocab_size, g.tie_embeddings) == \
        (18, 2048, 8, 1, 256, 16384, 256000, True)
    q = get_config("qwen1.5-4b")
    assert (q.n_layers, q.d_model, q.n_heads, q.head_dim, q.qkv_bias,
            q.tie_embeddings, q.mlp_type) == (40, 2560, 20, 128, True, False,
                                              "swiglu")
    assert isinstance(build_model(g, device="cpu"), TransformerLM)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_from_jax_params_carries_the_tree_bit_for_bit(arch, dtype):
    """The stacked trunk splits into per-layer dicts; ``lm_head`` and the
    QKV biases (qwen) arrive with their dtype and bits."""
    jm, jp, tm, tp = _pair(arch, dtype)
    jp = jax.tree.map(np.asarray, jp)
    untied = arch == "qwen1.5-4b"
    assert ("lm_head" in tp) == untied and len(tp["layers"]) == 2
    pairs = [(tp["embed"]["table"], jp["embed"]["table"])]
    if untied:
        pairs.append((tp["lm_head"]["w"], jp["lm_head"]["w"]))
    for i, lay in enumerate(tp["layers"]):
        assert ("b" in lay["attn"]["wq"]) == untied
        for path, a in jax.tree_util.tree_leaves_with_path(jp["layers"]):
            t = lay
            for k in path:
                t = t[k.key]
            pairs.append((t, a[i]))
    for t, a in pairs:
        assert str(t.dtype).split(".")[-1] == a.dtype.name
        if dtype == "bfloat16":
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          a.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), a)


def test_init_params_draws_lm_head_after_the_trunk():
    """Leaves draw in sorted-key order, as JAX's: ``lm_head`` comes after
    ``layers``, so an untied model shares every other leaf with the tied
    one of the same seed; it draws with std 1/sqrt(d_model) and the
    biases start at zero."""
    cfg = get_config("qwen1.5-4b", reduced=True)
    untied = init_params(build_model(cfg, device="cpu").param_specs(), 0,
                         torch.float32, "cpu")
    tied = init_params(build_model(cfg.replace(tie_embeddings=True),
                                   device="cpu").param_specs(), 0,
                       torch.float32, "cpu")
    assert "lm_head" not in tied
    assert torch.equal(untied["embed"]["table"], tied["embed"]["table"])
    for a, b in zip(untied["layers"], tied["layers"]):
        assert torch.equal(a["mlp"]["wo"]["w"], b["mlp"]["wo"]["w"])
        assert torch.equal(a["attn"]["wk"]["b"], torch.zeros(128))
    w = untied["lm_head"]["w"]
    assert w.shape == (128, 512)
    assert abs(float(w.std()) * 128 ** 0.5 - 1) < 0.05


def test_unported_transformer_modes_raise():
    cfg = get_config("gemma-2b", reduced=True)
    for bad, match in ((dict(moe=True), "MoE"),
                       (dict(frontend="vision_stub"), "frontend")):
        with pytest.raises(NotImplementedError, match=match):
            build_model(cfg.replace(**bad), device="cpu")
    with pytest.raises(NotImplementedError, match="W8"):
        build_model(cfg.with_quant("w8"), device="cpu")


# ---------------------------------------------------------------------------
# kernel 9: flash attention
# ---------------------------------------------------------------------------
FLASH_CASES = [
    dict(hq=4, hkv=2, lq=256, lk=256, causal=True, win=None, hd=64),
    dict(hq=2, hkv=2, lq=128, lk=384, causal=True, win=None, hd=64),
    dict(hq=4, hkv=1, lq=200, lk=200, causal=True, win=64, hd=64),
    dict(hq=2, hkv=2, lq=128, lk=128, causal=False, win=None, hd=64),
    dict(hq=8, hkv=1, lq=128, lk=128, causal=True, win=None, hd=256),
    dict(hq=2, hkv=1, lq=200, lk=200, causal=True, win=None, hd=32),
]


def _qkv(seed, b, hq, hkv, lq, lk, hd):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in
            ((b, hq, lq, hd), (b, hkv, lk, hd), (b, hkv, lk, hd))]


@pytest.mark.parametrize("cfg", FLASH_CASES, ids=[
    "gqa", "lq<lk", "window", "noncausal-128", "mqa-d256", "ragged-200"])
def test_flash_plain_matches_pallas_and_ref(cfg):
    """Kernel 9's plain version against ``kops.flash_attention(interpret=
    True)`` and ``attention_ref`` (the JAX kernel tests' four cases, MQA
    at head_dim 256, a ragged causal L = 200), fp32 within 1e-5."""
    q, k, v = _qkv(sum(cfg[x] for x in ("hq", "lq", "lk", "hd")), 2,
                   cfg["hq"], cfg["hkv"], cfg["lq"], cfg["lk"], cfg["hd"])
    kw = dict(causal=cfg["causal"], window=cfg["win"])
    got = tops.flash_attention(_t(q), _t(k), _t(v), **kw)
    assert got.shape == q.shape and got.dtype == torch.float32
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    for want in (jops.flash_attention(jq, jk, jv, interpret=True, **kw),
                 jref.attention_ref(jq, jk, jv, **kw)):
        assert _rel(got, want) <= RTOL
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfa.flash_attention(_t(q), _t(k), _t(v), **kw)


def test_reference_flash_attends_to_pad_keys_when_not_causal():
    """The JAX kernel pads the keys with zeros to a multiple of 128 and
    masks them only through the causal mask: non-causal at L = 100 it
    attends to 28 zero keys and leaves ``attention_ref`` by more than
    1e-2, causal it does not.  The port's plain version masks them: it
    equals ``attention_ref`` in both."""
    q, k, v = _qkv(100, 1, 2, 2, 100, 100, 64)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    for causal, jax_off in ((False, True), (True, False)):
        want = jref.attention_ref(jq, jk, jv, causal=causal)
        jflash = jops.flash_attention(jq, jk, jv, causal=causal,
                                      interpret=True)
        assert (_rel(jflash, want) > 1e-2) == jax_off
        assert _rel(tops.flash_attention(_t(q), _t(k), _t(v),
                                         causal=causal), want) <= RTOL


def test_full_attention_under_use_flash_takes_kernel_9_first(monkeypatch):
    """``use_flash`` without a soft-cap goes to kernel 9 before the
    blocked switch (2100 keys), with the (b, s, h, d) projections moved as
    JAX moves them; with a soft-cap it stays on the tensor path."""
    calls = []
    monkeypatch.setattr(tops, "flash_attention",
                        lambda *a, **k: calls.append(1) or
                        tfa.flash_attention_plain(*a, **k))
    rng = np.random.default_rng(6)
    q = rng.normal(size=(1, 2100, 2, 8)).astype(np.float32)
    k, v = (rng.normal(size=(1, 2100, 1, 8)).astype(np.float32)
            for _ in range(2))
    got = tattn.full_attention(_t(q), _t(k), _t(v), causal=True, window=300,
                               use_flash=True)
    want = jref.attention_ref(*(jnp.moveaxis(jnp.asarray(a), 2, 1)
                                for a in (q, k, v)), causal=True, window=300)
    assert calls == [1]
    assert _rel(got, jnp.moveaxis(want, 1, 2)) <= RTOL
    tattn.full_attention(_t(q), _t(k), _t(v), causal=True, window=300,
                         use_flash=True, logit_softcap=30.0)
    assert calls == [1]


# ---------------------------------------------------------------------------
# kernel 14: reduce_rows, core/reduce.py
# ---------------------------------------------------------------------------
def _sums_close(got, want, dtype):
    """fp32 within 1e-5 of the largest magnitude; bf16 each element within
    one bf16 step of its own."""
    want = np.asarray(jnp.asarray(want, jnp.float32))
    err = np.abs(got.float().numpy() - want)
    if dtype == "float32":
        assert err.max() <= RTOL * max(1.0, np.abs(want).max())
    else:
        assert (err <= BF16_STEP * np.maximum(np.abs(want), 2 ** -20)).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1000, 300), (100, 37), (1, 8),
                                   (64, 640)])
def test_reduce_rows_plain_matches_pallas_and_ref(shape, dtype):
    """Kernel 14's plain version against ``reduce_rows(interpret=True)``
    and ``reduce_rows_ref`` at ragged shapes: fp32 within 1e-5, bf16
    within one bf16 step of each element."""
    x = np.random.default_rng(sum(shape)).normal(size=shape).astype(
        np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx = jnp.asarray(x).astype(jdt)
    got = tops.reduba_sum(_t(x).to(tdt).t())
    assert got.dtype == tdt and got.shape == (shape[1],)
    assert torch.equal(got, tred.reduce_rows_plain(_t(x).to(tdt)))
    for want in (jreduba.reduce_rows(jx, interpret=True),
                 jref.reduce_rows_ref(jx)):
        _sums_close(got, want, dtype)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tred.reduce_rows(_t(x))


@pytest.mark.parametrize("mode", ["pallas", "pallas_interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,axis", [((100, 37), -1), ((7, 3, 513), 0),
                                        ((7, 3, 513), 1), ((64, 640), 0)])
def test_reduce_sum_and_mean_pallas_match_jax(shape, axis, dtype, mode):
    """``reduce_sum`` and ``mean`` in the ``pallas`` modes (kernel 14's
    plain version on the CPU) against the JAX package's in
    ``pallas_interpret``: the same dtypes (``mean`` of bf16 is fp32, as
    JAX's ``np.float32`` divisor promotes it), fp32 within 1e-5, bf16
    within one bf16 step of each element."""
    x = np.random.default_rng(len(shape) + axis).normal(size=shape).astype(
        np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx, tx = jnp.asarray(x).astype(jdt), _t(x).to(tdt)
    for fn, jfn in ((treduce.reduce_sum, jreduce.reduce_sum),
                    (treduce.mean, jreduce.mean)):
        got = fn(tx, axis=axis, mode=mode)
        want = jfn(jx, axis=axis, mode="pallas_interpret")
        assert str(got.dtype).split(".")[-1] == jnp.dtype(want.dtype).name
        _sums_close(got, want, dtype)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def _close(got, want, dtype, tol=RTOL):
    return _rel(got, want) <= tol if dtype == "float32" else \
        _bf16_close(got, want)


@pytest.mark.parametrize("flash", [False, True], ids=["tensor", "flash"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_prefill_decode_and_loss_match_jax(arch, dtype, flash):
    """Prefill of 24 tokens (kernel 9's plain version under ``use_flash``,
    JAX's kernel in interpret mode), four greedy decode steps at per-row
    positions, and ``loss`` with masked labels against the JAX model."""
    jm, jp, tm, tp = _pair(arch, dtype, flash, seed=1)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    toks = np.random.default_rng(1).integers(1, 512, (2, 24))
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)},
                                 jm.init_cache(2, 32, jdt))
    with torch.inference_mode():
        tl, tc = tm.prefill(tm.decode_view(tp),
                            {"tokens": torch.from_numpy(toks)},
                            tm.init_cache(2, 32, tdt))
        assert tc.k.shape == (2, 2, 32, tm.cfg.n_kv_heads, 32)
        assert tl.dtype == torch.float32 and _close(tl, jl, dtype)
        if dtype == "float32":
            for a, r in zip(tc, jc):
                assert _rel(a, r) <= MODEL_TOL
        jdecode = jax.jit(jm.decode_step)
        for t in range(4):
            tok = np.asarray(jl).argmax(-1)[:, None]
            idx = np.array([24 + t, 24 + t])
            jl, jc = jdecode(jp, jnp.asarray(tok), jc, jnp.asarray(idx))
            tl, tc = tm.decode_step(tp, torch.from_numpy(tok), tc, idx)
            assert _close(tl, jl, dtype, MODEL_TOL)
        labels = toks.copy()
        labels[0, :5] = -1
        batch = {"tokens": toks, "labels": labels}
        jloss, jmet = jax.jit(jm.loss)(jp, jax.tree.map(jnp.asarray, batch))
        tloss, tmet = tm.loss(tp, {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
    tol = 1e-5 if dtype == "float32" else 4 * BF16_STEP
    assert abs(float(tloss) - float(jloss)) <= tol * max(1.0, float(jloss))
    assert int(tmet["tokens"]) == int(jmet["tokens"])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_chunk_matches_jax_and_one_prefill(arch):
    """A 24-token prompt in chunks of 8 (per-row offsets) against the JAX
    model chunk by chunk and against one whole prefill (kernel 9's plain
    version under ``use_flash``): logits and caches."""
    jm, jp, tm, tp = _pair(arch, flash=True, seed=2)
    jchunk = jax.jit(jm.prefill_chunk)
    toks = np.random.default_rng(2).integers(1, 512, (2, 24))
    jc = jm.init_cache(2, 40, jnp.float32)
    with torch.inference_mode():
        whole, wc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                               tm.init_cache(2, 40, torch.float32))
        c = tm.init_cache(2, 40, torch.float32)
        for i in range(0, 24, 8):
            idx = np.array([i, i])
            tl, c = tm.prefill_chunk(tp, torch.from_numpy(toks[:, i:i + 8]),
                                     c, idx)
            jl, jc = jchunk(jp, jnp.asarray(toks[:, i:i + 8]), jc,
                            jnp.asarray(idx, jnp.int32))
            assert _rel(tl, jl) <= RTOL
    assert _rel(tl, whole) <= RTOL
    for a, r, j in zip(c, wc, jc):
        assert _rel(a, r.numpy()) <= MODEL_TOL and _rel(a, j) <= MODEL_TOL


def test_kernel_9_runs_once_a_layer_on_whole_sequence_calls(monkeypatch):
    """Under ``use_flash``: ``prefill`` and ``loss`` reach kernel 9 once a
    layer, ``prefill_chunk`` and ``decode_step`` never; without
    ``use_flash`` nothing does."""
    calls = []
    monkeypatch.setattr(tops, "flash_attention",
                        lambda *a, **k: calls.append(1) or
                        tfa.flash_attention_plain(*a, **k))
    toks = torch.ones((1, 6), dtype=torch.long)
    for flash, want in ((True, 4), (False, 0)):
        cfg = get_config("gemma-2b", reduced=True, use_flash=flash)
        tm = build_model(cfg, device="cpu")
        p = init_params(tm.param_specs(), 0, torch.float32, "cpu")
        calls.clear()
        with torch.inference_mode():
            _, c = tm.prefill(p, {"tokens": toks},
                              tm.init_cache(1, 16, torch.float32))
            assert len(calls) == want // 2
            _, c = tm.prefill_chunk(p, toks, c, 6)
            tm.decode_step(p, toks[:, :1], c, 12)
            assert len(calls) == want // 2
            tm.loss(p, {"tokens": toks, "labels": toks})
        assert len(calls) == want


@pytest.mark.parametrize("index", [None, 9, 40], ids=["all", "9", "past-T"])
def test_export_state_clips_like_jax_and_round_trips(index):
    """``export_state`` keeps a linear cache's first ``index`` positions
    (all when ``None``; at most T), as JAX's clipped host snapshot; the
    values are the rows' own, and ``import_state`` zero-pads them back."""
    jm, jp, tm, _ = _pair("gemma-2b", seed=3)
    toks = np.random.default_rng(3).integers(1, 512, (3, 9))
    _, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)},
                                jm.init_cache(3, 24, jnp.float32))
    jsnap = jm.export_state(jc, index, [2, 0])
    cache = tattn.KVCache(*(_t(a) for a in jc))
    snap = tm.export_state(cache, index, [2, 0])
    for a, j in zip(snap, jsnap):
        assert tuple(a.shape) == np.asarray(j).shape
        np.testing.assert_array_equal(a.numpy(), np.asarray(j))
        assert a.data_ptr() not in (cache.k.data_ptr(), cache.v.data_ptr())
    fresh = tm.import_state(tm.init_cache(3, 24, torch.float32), index,
                            [0, 1], snap)
    for got, full in zip(fresh, cache):
        assert torch.equal(got[:, 0], full[:, 2])
        assert torch.equal(got[:, 1], full[:, 0])
        assert not got[:, 2].any()
    assert tattn.snapshot_keep_len(24, 9, None) == 9
    assert tattn.snapshot_keep_len(8, 3, 8) == 8
