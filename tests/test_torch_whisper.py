"""The port's whisper-tiny against the JAX package, on the CPU.

``Whisper`` (``encode``, ``prefill``, ``prefill_chunk``, ``decode_step``,
``loss`` and its gradients, the train step, W8, ActiBA, snapshots), its
pieces (``layernorm``, the three sinusoid functions, the plain GeLU MLP,
cross-attention), the params bridge and checkpoints for its two trunks,
the calls that reach kernels 9, 10 and 12, and the engines' refusal.
The JAX model runs with ``use_flash=False`` (``attention_ref``'s
function), the weights carried across with ``from_jax_params``, inputs
from numpy seeds, on ``REDUCED`` (d_model 64, 2 + 2 layers, 4 heads of
16, 32 frames) in fp32.

Tolerances, each against the JAX side's largest magnitude (at least 1;
``_rel``): logits, encodings, caches and the loss within ``RTOL`` =
1e-5, as ``tests/test_torch_port.py`` holds logits (read: 4.7e-7 at the
worst, the prefill's caches); gradients within ``GRAD_TOL`` = 1e-5 of
each leaf's largest value (read: 1.5e-6).  The two packages sum in other
orders in fp32; nothing else differs.

The flash padding point: JAX's flash kernel pads the keys with zeros to
a multiple of 128 and masks them only through the causal mask, so its
whisper with ``use_flash=True`` attends to 96 zero keys in every
encoder and cross-attention call at 32 frames and leaves the function
(``test_jax_flash_attends_to_its_padding``: its logits move by 0.24);
the port masks keys past Lk, and its ``use_flash=True`` is JAX's
``use_flash=False`` (``test_port_flash_is_the_jax_reference``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import get_config as jget_config
from repro.core.xamba import XambaConfig as JXamba
from repro.models import build_model as jbuild
from repro.nn import attention as jattn, layers as jlayers, mlp as jmlp, \
    quant as jquant
from repro.nn.params import init_params as jinit
from repro.optim import AdamWConfig as JAdamW, ScheduleConfig as JSched, \
    adamw as jadamw
from repro.train import TrainConfig as JTrainConfig, \
    make_train_step as jmake_train_step
from repro_torch.checkpoint import restore, save
from repro_torch.configs import get_config
from repro_torch.core.xamba import XambaConfig
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve, train as ttrain
from repro_torch.models import build_model
from repro_torch.models.whisper import Whisper
from repro_torch.nn import attention as tattn, layers as tlayers, \
    mlp as tmlp, quant as tquant
from repro_torch.nn.params import from_jax_params, init_params, \
    to_jax_params, tree_leaves, tree_map
from repro_torch.optim import AdamWConfig, ScheduleConfig, adamw
from repro_torch.serve import ContinuousEngine, Engine, ServeConfig
from repro_torch.train import TrainConfig, make_train_step
from test_torch_checkpoint import _as_jax_layout, _assert_same, \
    _jax_state, _port_target
from test_torch_rgemma import BF16_STEP, RTOL, _rel
from test_torch_train import _port_grads, _worst_leaf

GRAD_TOL = 1e-5
ARCH = "whisper-tiny"
B, L_PROMPT = 2, 9


def _cfgs(**over):
    over = dict(dict(param_dtype="float32"), **over)
    return (jget_config(ARCH, reduced=True, **over),
            get_config(ARCH, reduced=True, **over))


@functools.lru_cache(maxsize=None)
def _pair(flash=False, quant="none", pallas=False):
    """(JAX model, JAX params, port model, port params) of REDUCED in
    fp32, one weight set drawn by JAX (quantized by JAX under W8), built
    once a case; ``flash`` is ``use_flash`` on both sides (interpret mode
    on the JAX side)."""
    over = dict(use_flash=flash, flash_interpret=flash)
    jcfg, tcfg = _cfgs(**over)
    if pallas:
        jcfg = jcfg.replace(xamba=JXamba.pallas())
        tcfg = tcfg.replace(xamba=XambaConfig.pallas())
    jm = jbuild(jcfg)
    jp = jinit(jm.param_specs(), jax.random.PRNGKey(0), jnp.float32)
    if quant != "none":
        jp = jquant.quantize_params_for_mode(jp, quant)
    tm = build_model(tcfg, "cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jm, jp, tm, tp


def _inputs(cfg, b=B, l=L_PROMPT, seed=1):
    """(frames, tokens) as numpy: seeded normal frames (b, encoder_seq,
    d_model) and token ids (b, l)."""
    rng = np.random.default_rng(seed)
    frames = rng.normal(size=(b, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)
    return frames, rng.integers(1, cfg.vocab_size, (b, l)).astype(np.int32)


def _batches(frames, tokens, labels=False):
    jb = {"frames": jnp.asarray(frames), "tokens": jnp.asarray(tokens)}
    tb = {"frames": torch.from_numpy(frames),
          "tokens": torch.from_numpy(tokens).long()}
    if labels:
        jb["labels"], tb["labels"] = jb["tokens"], tb["tokens"]
    return jb, tb


def _caches_rel(tcache, jcache):
    """The worst ``_rel`` over every layer's self and cross k and v."""
    return max(_rel(getattr(t[kind], f), getattr(j[kind], f))
               for t, j in zip(tcache, jcache)
               for kind in ("self", "cross") for f in ("k", "v"))


def _prefill(jm, jp, tm, tp, frames, tokens, max_seq=16):
    jb, tb = _batches(frames, tokens)
    jl, jc = jax.jit(jm.prefill)(jp, jb, jm.init_cache(
        tokens.shape[0], max_seq, jnp.float32))
    with torch.inference_mode():
        tl, tc = tm.prefill(tp, tb, tm.init_cache(tokens.shape[0], max_seq,
                                                  torch.float32))
    return (jl, jc), (tl, tc)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_jax(dtype):
    """fp32 within RTOL; bf16 within one bf16 step (both round the fp32
    result once)."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(3, 7, 48)) * 4 + 2).astype(np.float32)
    scale = rng.normal(size=48).astype(np.float32)
    bias = rng.normal(size=48).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    specs = tlayers.norm_specs(48, norm_type="layernorm")
    assert set(specs) == {"scale", "bias"} and specs["bias"].init == "zeros"
    want = jlayers.norm({"scale": jnp.asarray(scale, jdt),
                         "bias": jnp.asarray(bias, jdt)},
                        jnp.asarray(x, jdt), norm_type="layernorm")
    got = tlayers.norm({"scale": torch.from_numpy(scale).to(tdt),
                        "bias": torch.from_numpy(bias).to(tdt)},
                       torch.from_numpy(x).to(tdt), norm_type="layernorm")
    assert got.dtype == tdt
    assert _rel(got, want) <= (RTOL if dtype == "float32" else BF16_STEP)


@pytest.mark.parametrize("d", [64, 384])
def test_sinusoids_match_jax(d):
    """The table, one position and a tensor of positions, against JAX's:
    ``[sin, cos]`` interleaved per pair, the fp32 angles p * inv (within
    RTOL: the sines of the two libraries part by an ulp at most)."""
    seq = 1500
    table = tlayers.sinusoidal_positions(seq, d)
    assert table.shape == (seq, d) and table.dtype == torch.float32
    assert _rel(table, jlayers.sinusoidal_positions(seq, d)) <= RTOL
    # The layout: column 2i is sin(p inv_i), column 2i + 1 is cos.
    inv = 1.0 / (1e4 ** (np.arange(0, d, 2, dtype=np.float32) / d))
    ang = np.float32(7.0) * inv
    np.testing.assert_allclose(table[7, 0::2].numpy(), np.sin(ang),
                               atol=1e-6)
    np.testing.assert_allclose(table[7, 1::2].numpy(), np.cos(ang),
                               atol=1e-6)
    for idx in (0, 5, 1499, 2999):
        got = tlayers.sinusoidal_position_at(idx, d)
        assert _rel(got, jlayers.sinusoidal_position_at(jnp.int32(idx),
                                                        d)) <= RTOL
        assert torch.equal(got, tlayers.sinusoidal_position_at(
            torch.tensor(idx), d))
    pos = np.random.default_rng(4).integers(0, 3000, (3, 5))
    got = tlayers.sinusoidal_positions_at(torch.from_numpy(pos), d)
    assert got.shape == (3, 5, d)
    assert _rel(got, jlayers.sinusoidal_positions_at(jnp.asarray(pos),
                                                     d)) <= RTOL


@pytest.mark.parametrize("actiba", [False, True], ids=["exact", "actiba"])
def test_plain_mlp_matches_jax(actiba):
    """``mlp_type="mlp"``: wi and wo only, ``wo(gelu(wi(x)))`` with the
    tanh GeLU, or its PWL table under ActiBA (``pallas()``: the JAX plain
    MLP never takes ``matmul_pwl``, and neither does the port's)."""
    jcfg, tcfg = _cfgs()
    if actiba:
        jcfg = jcfg.replace(xamba=JXamba.pallas())
        tcfg = tcfg.replace(xamba=XambaConfig.pallas())
    assert set(tmlp.mlp_specs(tcfg)) == {"wi", "wo"}
    jp = jinit(jmlp.mlp_specs(jcfg), jax.random.PRNGKey(5), jnp.float32)
    tp = tree_map(lambda a: torch.from_numpy(np.array(a)),
                  jax.tree.map(np.asarray, jp))
    x = np.random.default_rng(5).normal(size=(2, 6, 64)).astype(np.float32)

    def refuse(*a, **k):
        raise AssertionError("the plain MLP reached matmul_pwl")
    real = tops.matmul_pwl
    tops.matmul_pwl = refuse
    try:
        got = tmlp.apply(tp, tcfg, torch.from_numpy(x))
    finally:
        tops.matmul_pwl = real
    assert _rel(got, jmlp.apply(jp, jcfg, jnp.asarray(x))) <= RTOL


def test_cross_attention_modes_match_jax():
    """``attention.apply`` with ``kv_source`` against JAX's: the cache-less
    call, the prefill (cross cache rewritten from position 0, no RoPE,
    not causal) and the decode (``wq`` and ``wo`` against the whole
    cache)."""
    jcfg, tcfg = _cfgs()
    jp = jinit(jattn.attention_specs(jcfg), jax.random.PRNGKey(6),
               jnp.float32)
    tp = tree_map(lambda a: torch.from_numpy(np.array(a)),
                  jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    src = rng.normal(size=(2, 32, 64)).astype(np.float32)
    pos = np.arange(5)[None, :]
    jpos, tpos = jnp.asarray(pos, jnp.int32), torch.from_numpy(pos)
    jy, _ = jattn.apply(jp, jcfg, jnp.asarray(x), positions=jpos,
                        kv_source=jnp.asarray(src))
    ty, _ = tattn.apply(tp, tcfg, torch.from_numpy(x), positions=tpos,
                        kv_source=torch.from_numpy(src))
    assert _rel(ty, jy) <= RTOL
    jc = jattn.init_cache(jcfg, 2, 32, jnp.float32)
    tc = tattn.init_cache(tcfg, 2, 32, torch.float32, "cpu")
    jy, jc = jattn.apply(jp, jcfg, jnp.asarray(x), positions=jpos, cache=jc,
                         kv_source=jnp.asarray(src), is_cross=True)
    ty, tc2 = tattn.apply(tp, tcfg, torch.from_numpy(x), positions=tpos,
                          cache=tc, kv_source=torch.from_numpy(src),
                          is_cross=True)
    assert _rel(ty, jy) <= RTOL and torch.equal(tc.k, torch.zeros_like(tc.k))
    assert _rel(tc2.k, jc.k) <= RTOL and _rel(tc2.v, jc.v) <= RTOL
    x1 = x[:, :1]
    jy, _ = jattn.apply(jp, jcfg, jnp.asarray(x1), positions=jpos[:, :1],
                        cache=jc, cache_index=jnp.int32(5), is_cross=True)
    ty, tc3 = tattn.apply(tp, tcfg, torch.from_numpy(x1),
                          positions=tpos[:, :1], cache=tc2, cache_index=5,
                          is_cross=True)
    assert _rel(ty, jy) <= RTOL and tc3 is tc2
    with pytest.raises(ValueError, match="cache"):
        tattn.apply(tp, tcfg, torch.from_numpy(x1), positions=tpos[:, :1],
                    is_cross=True)


# ---------------------------------------------------------------------------
# params, checkpoints
# ---------------------------------------------------------------------------
def test_bridge_carries_every_leaf_both_ways():
    """Both trunks and every other leaf cross ``from_jax_params`` (the
    same leaf count and values) and ``to_jax_params`` gives back the JAX
    tree leaf for leaf (fp32 bit for bit, bf16 as its fp32 widening); a
    trunk of the wrong depth is refused, each against its own count."""
    jcfg, tcfg = _cfgs()
    jm = jbuild(jcfg)
    for dt in (jnp.float32, jnp.bfloat16):
        jp = jax.tree.map(np.asarray, jinit(jm.param_specs(),
                                            jax.random.PRNGKey(0), dt))
        tp = from_jax_params(jp, tcfg, "cpu")
        assert len(tp["encoder"]) == 2 and len(tp["decoder"]) == 2
        assert set(tp) == set(jp)
        assert len(tree_leaves(tp)) == len(jax.tree.leaves(jp))
        _assert_same(jp, to_jax_params(tp, tcfg))
    with pytest.raises(ValueError, match="encoder"):
        from_jax_params(jp, tcfg.replace(encoder_layers=3), "cpu")
    with pytest.raises(ValueError, match="decoder"):
        to_jax_params(tp, tcfg.replace(n_layers=3))


def test_init_params_builds_both_trunks():
    """``init_params``: the JAX tree's names and shapes, the trunks as
    per-layer lists, LayerNorm scales ones and biases zeros; the encoder
    depth falls back to ``n_layers`` when ``encoder_layers`` is 0."""
    jcfg, tcfg = _cfgs()
    tm = build_model(tcfg, "cpu")
    assert isinstance(tm, Whisper)
    tp = init_params(tm.param_specs(), 0, torch.float32, "cpu")
    want = jinit(jbuild(jcfg).param_specs(), jax.random.PRNGKey(0),
                 jnp.float32)
    got = to_jax_params(tp, tcfg)
    for path, ref in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = got
        for k in path:
            node = node[k.key]
        assert node.shape == ref.shape, jax.tree_util.keystr(path)
    assert len(tree_leaves(got)) == len(jax.tree.leaves(want))
    for p in tp["encoder"] + tp["decoder"]:
        for name in [k for k in p if k.startswith("ln_")]:
            assert torch.equal(p[name]["scale"], torch.ones(64))
            assert torch.equal(p[name]["bias"], torch.zeros(64))
    assert Whisper(tcfg.replace(encoder_layers=0), "cpu").n_enc == 2


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    jstate, _, cfg = _jax_state(ARCH, {})
    jckpt.save(tmp_path, 5, jstate, extra={"data_step": 5})
    got, step, extra = restore(tmp_path, _port_target(cfg), cfg=cfg)
    assert step == 5 and extra == {"data_step": 5}
    assert len(got["params"]["encoder"]) == 2
    _assert_same(jstate, _as_jax_layout(got, cfg))


def test_port_checkpoint_restores_in_jax(tmp_path):
    jstate, _, cfg = _jax_state(ARCH, {}, seed=1)
    port = {"params": from_jax_params(jax.tree.map(np.asarray,
                                                   jstate["params"]), cfg,
                                      "cpu"),
            "opt": {"step": torch.tensor(5, dtype=torch.int32),
                    **{k: from_jax_params(jax.tree.map(
                        np.asarray, jstate["opt"][k]), cfg, "cpu")
                       for k in ("m", "v")}}}
    save(tmp_path, 5, port, extra={"data_step": 7}, cfg=cfg)
    target = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                          jstate)
    got, step, extra = jckpt.restore(tmp_path, target)
    assert step == 5 and extra == {"data_step": 7}
    for a, b in zip(jax.tree.leaves(jstate), jax.tree.leaves(got)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def test_encode_matches_jax():
    jm, jp, tm, tp = _pair()
    frames, _ = _inputs(tm.cfg)
    want = jax.jit(jm.encode)(jp, jnp.asarray(frames))
    with torch.inference_mode():
        got = tm.encode(tp, torch.from_numpy(frames))
    assert got.shape == (B, 32, 64) and _rel(got, want) <= RTOL


def test_prefill_logits_and_caches_match_jax():
    jm, jp, tm, tp = _pair()
    frames, tokens = _inputs(tm.cfg)
    (jl, jc), (tl, tc) = _prefill(jm, jp, tm, tp, frames, tokens)
    assert tl.shape == (B, 512) and tl.dtype == torch.float32
    assert _rel(tl, jl) <= RTOL
    assert [c["cross"].k.shape[1] for c in tc] == [32, 32]
    assert _caches_rel(tc, jc) <= RTOL


@pytest.mark.parametrize("chunk", [1, 3, 4])
def test_prefill_chunk_matches_whole_prefill(chunk):
    """Chunks of 1 (the decode branch for self-attention, the cross cache
    rewritten each call), 3 and 4 over a 9-token prompt: the last logits
    and the caches within RTOL of one whole ``prefill`` and of JAX's
    chunks; one call with per-row offsets as well."""
    jm, jp, tm, tp = _pair()
    frames, tokens = _inputs(tm.cfg)
    (_, _), (whole, wcache) = _prefill(jm, jp, tm, tp, frames, tokens)
    jc = jm.init_cache(B, 16, jnp.float32)
    tc = tm.init_cache(B, 16, torch.float32)
    off = 0
    with torch.inference_mode():
        while off < L_PROMPT:
            s = min(chunk, L_PROMPT - off)
            jb, tb = _batches(frames, tokens[:, off:off + s])
            jl, jc = jm.prefill_chunk(jp, jb, jc, jnp.int32(off))
            index = off if chunk != 3 else np.full(B, off)
            tl, tc = tm.prefill_chunk(tp, tb, tc, index)
            off += s
    assert _rel(tl, whole) <= RTOL and _rel(tl, jl) <= RTOL
    assert _caches_rel(tc, jc) <= RTOL
    assert max(float((a[k].k - b[k].k).abs().max())
               for a, b in zip(tc, wcache) for k in ("self", "cross")) <= 1e-5


def test_decode_steps_and_greedy_tokens_match_jax():
    """Eight greedy decode steps after the prefill, each side on its own
    tokens: the same tokens, logits within RTOL at every step."""
    jm, jp, tm, tp = _pair()
    frames, tokens = _inputs(tm.cfg)
    (jl, jc), (tl, tc) = _prefill(jm, jp, tm, tp, frames, tokens, 24)
    jstep = jax.jit(jm.decode_step)
    jtoks, ttoks = [], []
    with torch.inference_mode():
        for i in range(8):
            jt = np.asarray(jl).argmax(-1)
            tt = tl.argmax(-1).numpy()
            jtoks.append(jt), ttoks.append(tt)
            jl, jc = jstep(jp, jnp.asarray(jt[:, None], jnp.int32), jc,
                           jnp.int32(L_PROMPT + i))
            tl, tc = tm.decode_step(tp, torch.from_numpy(tt[:, None]), tc,
                                    L_PROMPT + i)
            assert _rel(tl, jl) <= RTOL, i
    assert np.array_equal(np.stack(jtoks), np.stack(ttoks))
    assert _caches_rel(tc, jc) <= RTOL


def test_loss_and_grads_match_jax():
    jm, jp, tm, tp = _pair()
    frames, tokens = _inputs(tm.cfg, l=12)
    jb, tb = _batches(frames, tokens, labels=True)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, jb)
    tl, tmet, tg = _port_grads(tm, tp, tb)
    assert abs(float(tl.detach()) - float(jl)) <= RTOL * abs(float(jl))
    assert set(tmet) == set(jmet)
    worst, key = _worst_leaf(to_jax_params(tg, tm.cfg),
                             jax.tree.map(np.asarray, jg))
    assert worst <= GRAD_TOL, (key, worst)


def test_train_step_takes_the_frames_batch():
    """Two ``make_train_step`` steps on ``{"frames", "tokens", "labels"}``
    against JAX's from the same state: losses, grad norms and the params
    (the AdamW rule of ``tests/test_torch_train.py``)."""
    jm, jp, tm, tp = _pair()
    jtc = JTrainConfig(optimizer=JAdamW(), schedule=JSched(
        base_lr=1e-3, warmup_steps=2, total_steps=50))
    tc = TrainConfig(optimizer=AdamWConfig(), schedule=ScheduleConfig(
        base_lr=1e-3, warmup_steps=2, total_steps=50))
    jstate = {"params": jp, "opt": jadamw.init(jp, jtc.optimizer)}
    tstate = {"params": tp, "opt": adamw.init(tp, tc.optimizer)}
    jstep = jax.jit(jmake_train_step(jm, jtc))
    tstep = make_train_step(tm, tc)
    for s in range(2):
        frames, tokens = _inputs(tm.cfg, l=12, seed=10 + s)
        jb, tb = _batches(frames, tokens, labels=True)
        jstate, jmet = jstep(jstate, jb)
        tstate, tmet = tstep(tstate, tb)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       rtol=1e-4, err_msg=(s, k))
        got = to_jax_params(tstate["params"], tm.cfg)
        for path, ref in jax.tree_util.tree_flatten_with_path(
                jax.tree.map(np.asarray, jstate["params"]))[0]:
            node = got
            for k in path:
                node = node[k.key]
            assert np.abs(node - ref).max() <= \
                1e-5 * np.abs(ref).max() + 0.05 * 1e-3, path


def test_w8_prefill_and_decode_match_jax():
    """W8 weights quantized by JAX (the table stays fp32): prefill logits,
    caches and four decode steps against JAX's ``qdot`` path."""
    jm, jp, tm, tp = _pair(quant="w8")
    assert tquant.is_quantized(tp["decoder"][0]["cross_attn"]["wq"]["w"])
    assert not tquant.is_quantized(tp["embed"]["table"])
    frames, tokens = _inputs(tm.cfg)
    (jl, jc), (tl, tc) = _prefill(jm, jp, tm, tp, frames, tokens)
    assert _rel(tl, jl) <= RTOL and _caches_rel(tc, jc) <= RTOL
    with torch.inference_mode():
        for i in range(4):
            tok = np.asarray(jl).argmax(-1)[:, None]
            jl, jc = jm.decode_step(jp, jnp.asarray(tok, jnp.int32), jc,
                                    jnp.int32(L_PROMPT + i))
            tl, tc = tm.decode_step(tp, torch.from_numpy(tok).long(), tc,
                                    L_PROMPT + i)
            assert _rel(tl, jl) <= RTOL, i


def test_actiba_prefill_and_decode_match_jax():
    """Under ``pallas()`` (ActiBA's GeLU table in every MLP): prefill and
    a decode step against the JAX model under its ``pallas()``."""
    jm, jp, tm, tp = _pair(pallas=True)
    frames, tokens = _inputs(tm.cfg)
    (jl, jc), (tl, tc) = _prefill(jm, jp, tm, tp, frames, tokens)
    assert _rel(tl, jl) <= RTOL
    tok = np.asarray(jl).argmax(-1)[:, None]
    jl, _ = jm.decode_step(jp, jnp.asarray(tok, jnp.int32), jc,
                           jnp.int32(L_PROMPT))
    with torch.inference_mode():
        tl, _ = tm.decode_step(tp, torch.from_numpy(tok).long(), tc,
                               L_PROMPT)
    assert _rel(tl, jl) <= RTOL


def test_kernel_calls_a_prefill_chunk_and_step(monkeypatch):
    """The calls that reach kernels 9, 10 and 12 (counted at their
    dispatch on the CPU), per layer: under ``use_flash`` each whole
    prefill runs flash attention once an encoder layer and twice a
    decoder layer (self and cross), a chunk call once an encoder layer
    and once a decoder layer (cross; self takes ``chunk_attention``), a
    decode step never; under W8 ``qdot`` 6 times an encoder layer and 10
    a decoder layer a prefill, 8 a decoder layer a step; under
    ``pallas()`` the GeLU table once a layer, ``matmul_pwl`` never."""
    calls = {"flash": 0, "qdot": 0, "pwl": 0}

    def counting(name, fn):
        def run(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return run
    monkeypatch.setattr(tops, "flash_attention",
                        counting("flash", tops.flash_attention))
    monkeypatch.setattr(tquant, "qdot", counting("qdot", tquant.qdot))
    monkeypatch.setattr(tops, "actiba_activate",
                        counting("pwl", tops.actiba_activate))
    monkeypatch.setattr(tops, "matmul_pwl", None)
    frames, tokens = _inputs(get_config(ARCH, reduced=True), l=4)
    _, tb = _batches(frames, tokens)
    base = get_config(ARCH, reduced=True, param_dtype="float32")
    want = {"flash": (6, 4, 0), "qdot": (32, 32, 16), "pwl": (4, 4, 2)}
    for name, cfg in (("flash", base.replace(use_flash=True)),
                      ("qdot", base.with_quant("w8")),
                      ("pwl", base.replace(xamba=XambaConfig.pallas()))):
        m = build_model(cfg, "cpu")
        p = init_params(m.param_specs(), 0, torch.float32, "cpu")
        if name == "qdot":
            p = tquant.quantize_params_for_mode(p, "w8")
        got = []
        with torch.inference_mode():
            calls[name] = 0
            _, c = m.prefill(p, tb, m.init_cache(B, 8, torch.float32))
            got.append(calls[name])
            calls[name] = 0
            _, c2 = m.prefill_chunk(p, {"frames": tb["frames"],
                                        "tokens": tb["tokens"][:, :2]},
                                    m.init_cache(B, 8, torch.float32), 0)
            got.append(calls[name])
            calls[name] = 0
            m.decode_step(p, tb["tokens"][:, :1], c, 4)
            got.append(calls[name])
        assert tuple(got) == want[name], (name, got)


def test_w8_bodies_by_call(monkeypatch):
    """Kernel 10's shape rule (``qmatmul.path``) on every W8 projection
    of a bf16 whisper: the ``wgmma`` body for each prefill call (m = b x
    prompt > 8, the encoder's and the cross k / v's m = b x frames) and
    the GEMV for each decode-step call (m = b)."""
    from repro_torch.kernels import qmatmul as tqm
    cfg = get_config(ARCH, reduced=True).with_quant("w8")
    m = build_model(cfg, "cpu")
    p = tquant.quantize_params_for_mode(
        init_params(m.param_specs(), 0, torch.bfloat16, "cpu"), "w8")
    bodies = []
    real = tquant.qdot

    def qdot(x, qt):
        bodies.append(tqm.path(x.reshape(-1, x.shape[-1]), qt.q))
        return real(x, qt)
    monkeypatch.setattr(tquant, "qdot", qdot)
    frames, tokens = _inputs(cfg)
    tb = {"frames": torch.from_numpy(frames).bfloat16(),
          "tokens": torch.from_numpy(tokens).long()}
    with torch.inference_mode():
        _, cache = m.prefill(p, tb, m.init_cache(B, 12, torch.bfloat16))
        assert bodies == ["wgmma"] * 32
        bodies.clear()
        m.decode_step(p, tb["tokens"][:, :1], cache, L_PROMPT)
    assert bodies == ["gemv"] * 16


def test_export_import_state_restores_rows_bit_for_bit():
    """Whole rows, whatever ``index``: fresh tensors; imported into a
    zeroed cache at other rows, the same bits, and the rows the import
    did not name untouched."""
    _, _, tm, tp = _pair()
    frames, tokens = _inputs(tm.cfg, b=3)
    with torch.inference_mode():
        _, cache = tm.prefill(tp, _batches(frames, tokens)[1],
                              tm.init_cache(3, 16, torch.float32))
        snap = tm.export_state(cache, 4, [2, 0])
        assert snap[0]["self"].k.shape == (2, 16, 4, 16)
        assert snap[0]["self"].k.data_ptr() != cache[0]["self"].k.data_ptr()
        assert tm.cache_batch_axes(cache) == [
            {"self": tattn.KVCache(0, 0), "cross": tattn.KVCache(0, 0)}] * 2
        dst = tm.init_cache(3, 16, torch.float32)
        out = tm.import_state(dst, 4, [0, 1], snap)
    assert out is dst
    for c, d in zip(cache, dst):
        for kind in ("self", "cross"):
            for f in ("k", "v"):
                a, b = getattr(c[kind], f), getattr(d[kind], f)
                assert torch.equal(b[0], a[2]) and torch.equal(b[1], a[0])
                assert not b[2].any()


def test_engines_and_the_clis_refuse_whisper():
    """The token-only engines and ``launch/serve`` raise naming whisper
    before any work; ``launch/train`` exits (its data has no frames)."""
    cfg = get_config(ARCH, reduced=True, param_dtype="float32")
    m = build_model(cfg, "cpu")
    p = init_params(m.param_specs(), 0, torch.float32, "cpu")
    for engine in (Engine, ContinuousEngine):
        with pytest.raises(NotImplementedError, match="whisper"):
            engine(m, p, ServeConfig(max_batch=2))
    with pytest.raises(NotImplementedError, match="whisper"):
        tserve.main(["--arch", ARCH, "--reduced", "--device", "cpu"])
    with pytest.raises(SystemExit):
        ttrain.main(["--arch", ARCH, "--reduced", "--device", "cpu"])


# ---------------------------------------------------------------------------
# the flash padding point
# ---------------------------------------------------------------------------
def test_jax_flash_attends_to_its_padding():
    """JAX's whisper with ``use_flash=True`` (its kernel in interpret
    mode) departs from its ``use_flash=False`` logits by more than 1e-3:
    at 32 frames its kernel attends to 96 zero-padded keys in the encoder
    and the cross-attention (neither causal)."""
    jm, jp, _, _ = _pair()
    jmf, _, _, _ = _pair(flash=True)
    frames, tokens = _inputs(jm.cfg)
    jb, _ = _batches(frames, tokens)
    ref, _ = jm.prefill(jp, jb, jm.init_cache(B, 16, jnp.float32))
    got, _ = jmf.prefill(jp, jb, jmf.init_cache(B, 16, jnp.float32))
    assert float(jnp.abs(got - ref).max()) > 1e-3


def test_port_flash_is_the_jax_reference():
    """The port's ``use_flash=True`` (the kernel's plain version on the
    CPU) masks keys past Lk: its logits equal JAX's ``use_flash=False``
    within RTOL (prefill and the loss)."""
    jm, jp, _, _ = _pair()
    _, _, tm, tp = _pair(flash=True)
    frames, tokens = _inputs(tm.cfg)
    (jl, _), (tl, _) = _prefill(jm, jp, tm, tp, frames, tokens)
    assert _rel(tl, jl) <= RTOL
    jb, tb = _batches(frames, tokens, labels=True)
    jloss, _ = jm.loss(jp, jb)
    with torch.inference_mode():
        tloss, _ = tm.loss(tp, tb)
    assert abs(float(tloss) - float(jloss)) <= RTOL * abs(float(jloss))
