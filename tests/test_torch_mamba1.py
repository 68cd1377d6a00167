"""The port's Mamba-1 path against the JAX package, on the CPU.

``core/selective_scan.py`` (every scan mode and the one-token update), the
plain versions of TPU kernels 3, 4 and 5 (``kernels/decode_step.py``)
against the JAX Pallas kernels in interpret mode and their
``kernels/ref.py`` oracles, ``nn/ssm.py: mamba1_apply``, ``MambaLM`` of
family ``mamba`` on the reduced mamba-130m (the JAX params carried across
with ``from_jax_params``), W8, the wave engine and the CLI.  Inputs are
seeded numpy.

Tolerances: module outputs and SSM states within 1e-5 of the reference's
largest magnitude (states reach ~1e3 here, where two fp32 orders of the
same recurrence differ by more than 1e-5 elementwise); logits within
5e-4 (``tests/test_decode_step.py``'s mamba1 tolerance); engines
greedy-identical.  The model's states after decode steps (up to ~1.5e5 in
the second layer of this random model) are held to an fp64 witness
(``_witness``: token by token, numpy, written apart from the port): the
port within 1e-5 of its largest magnitude, and no farther from the JAX
package than that plus the JAX package's own distance from the witness.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import mamba_130m as jcfgs
from repro.core import pwl as jpwl, selective_scan as jsscan
from repro.core.xamba import XambaConfig as JXamba
from repro.kernels import ops as jops, ref as jref
from repro.models import build_model as jbuild
from repro.nn import quant as jquant, ssm as jssm
from repro.nn.params import init_params as jinit
from repro.serve import Engine as JEngine, ServeConfig as JServeConfig
from repro_torch.configs import get_config
from repro_torch.core import selective_scan as tsscan
from repro_torch.core.xamba import XambaConfig
from repro_torch.kernels import decode_step as tds, ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model
from repro_torch.nn import quant as tquant, ssm as tssm
from repro_torch.nn.params import ParamSpec, from_jax_params, init_params
from repro_torch.serve import ContinuousEngine, Engine, ServeConfig

RTOL = 1e-5          # modules and states, relative to the largest magnitude
LOGIT_TOL = 5e-4     # logits


def _t(a):
    return torch.from_numpy(np.array(np.asarray(a), copy=True))


def _rel(got, want):
    """Max error over the reference's largest magnitude (at least 1)."""
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(1.0,
                                                 float(np.abs(want).max()))


def _err(got, want):
    return float(np.abs(np.asarray(got, np.float64)
                        - np.asarray(want, np.float64)).max())


def _jcfg(**kw):
    return jcfgs.REDUCED.replace(param_dtype="float32", **kw)


def _tcfg(**kw):
    return get_config("mamba-130m", reduced=True, param_dtype="float32", **kw)


def _pair(seed=0, jxamba=None, txamba=None, **kw):
    """(JAX model, JAX params, port model, port params): the reduced
    mamba-130m in fp32, one weight set."""
    jm = jbuild(_jcfg(**kw, **({"xamba": jxamba} if jxamba else {})))
    jp = jinit(jm.param_specs(), jax.random.PRNGKey(seed), jnp.float32)
    tm = build_model(_tcfg(**kw, **({"xamba": txamba} if txamba else {})),
                     device="cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tm.cfg, device="cpu")
    return jm, jp, tm, tp


# ---------------------------------------------------------------------------
# config, params
# ---------------------------------------------------------------------------
def test_config_matches_jax_and_registry():
    for reduced in (False, True):
        t = get_config("mamba-130m", reduced=reduced)
        j = jcfgs.REDUCED if reduced else jcfgs.CONFIG
        for f in ("name", "family", "vocab_size", "d_model", "n_layers",
                  "d_state", "d_conv", "expand", "dt_rank", "scan_mode",
                  "tie_embeddings", "param_dtype"):
            assert getattr(t, f) == getattr(j, f), f
    cfg = get_config("mamba-130m")
    assert (cfg.d_model * cfg.expand, cfg.dt_rank) == (1536, 48)
    assert cfg.dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_from_jax_params_carries_mamba1_tree_bit_for_bit(dtype):
    """Every leaf of the JAX mamba1 tree (``dt_proj`` a dict, ``A_log``
    2-D) arrives with its dtype and bits, split per layer."""
    jdt = getattr(jnp, dtype)
    jm = jbuild(jcfgs.REDUCED.replace(param_dtype=dtype))
    jp = jinit(jm.param_specs(), jax.random.PRNGKey(3), jdt)
    tm = build_model(get_config("mamba-130m", reduced=True,
                                param_dtype=dtype), device="cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tm.cfg, device="cpu")
    tdt = getattr(torch, dtype)
    spec = tm.param_specs()["layers"]["mixer"]
    assert spec["A_log"].shape == (2, 256, 16)
    assert spec["dt_proj"]["b"].init == "small_normal"
    for i, lay in enumerate(tp["layers"]):
        for path in (("mixer", "A_log"), ("mixer", "dt_proj", "w"),
                     ("mixer", "dt_proj", "b"), ("mixer", "x_proj", "w"),
                     ("mixer", "in_proj", "w"), ("ln", "scale")):
            j, t = jp["layers"], lay
            for k in path:
                j, t = j[k], t[k]
            assert t.dtype == tdt
            want = np.asarray(j[i]).astype(np.float32)
            assert np.array_equal(t.float().numpy(), want), path
    assert np.array_equal(tp["embed"]["table"].float().numpy(),
                          np.asarray(jp["embed"]["table"]).astype(np.float32))


def test_init_params_small_normal_and_specs():
    tm = build_model(_tcfg(), device="cpu")
    p = init_params(tm.param_specs(), 0, torch.float32, "cpu")
    mix = p["layers"][0]["mixer"]
    assert abs(float(mix["dt_proj"]["b"].std()) - 0.02) < 0.004
    assert abs(float(mix["dt_proj"]["w"].std()) - 0.1) < 0.01
    assert torch.equal(mix["A_log"], torch.ones(256, 16))
    assert ParamSpec((3,), init="small_normal").init == "small_normal"
    assert set(mix) == {"in_proj", "conv", "x_proj", "dt_proj", "A_log",
                        "D", "out_proj"}


# ---------------------------------------------------------------------------
# selective scan
# ---------------------------------------------------------------------------
def _scan_inputs(rng, b=2, l=45, d=12, n=8):
    f = np.float32
    return (rng.normal(size=(b, l, d)).astype(f),
            rng.uniform(0.01, 0.5, size=(b, l, d)).astype(f),
            -rng.uniform(0.1, 2.0, size=(d, n)).astype(f),
            rng.normal(size=(b, l, n)).astype(f),
            rng.normal(size=(b, l, n)).astype(f),
            rng.normal(size=(d,)).astype(f),
            rng.normal(size=(b, d, n)).astype(f))


SCAN_MODES = [("sequential", "cumba"), ("associative", "cumba"),
              ("chunked", "naive"), ("chunked", "cumba")]


@pytest.mark.parametrize("init", [False, True], ids=["zero", "init_state"])
@pytest.mark.parametrize("mode,cumba", SCAN_MODES,
                         ids=["sequential", "associative", "chunked_naive",
                              "chunked_cumba"])
def test_selective_scan_matches_jax(mode, cumba, init):
    """Each mode against the JAX package's same mode, l = 45 (not a
    multiple of the chunk of 16), with D."""
    u, dt, A, B, C, D, h0 = _scan_inputs(np.random.default_rng(1))
    kw = dict(mode=mode, chunk_size=16, return_final_state=True)
    jy, jh = jsscan.selective_scan(
        *map(jnp.asarray, (u, dt, A, B, C, D)), **kw,
        initial_state=jnp.asarray(h0) if init else None,
        xamba=JXamba(cumba=cumba))
    ty, th = tsscan.selective_scan(
        *map(_t, (u, dt, A, B, C, D)), **kw,
        initial_state=_t(h0) if init else None,
        xamba=XambaConfig(cumba=cumba))
    assert ty.dtype == torch.float32 and th.shape == (2, 12, 8)
    assert _rel(ty, jy) <= RTOL and _rel(th, jh) <= RTOL


@pytest.mark.parametrize("mode,cumba", [("sequential", "cumba"),
                                        ("associative", "cumba"),
                                        ("chunked", "cumba")],
                         ids=["sequential", "associative", "chunked"])
def test_selective_scan_resumes_across_slices(mode, cumba):
    """Two slices (20 + 25 tokens) with the state threaded through equal
    one call, and the sequential oracle."""
    u, dt, A, B, C, D, h0 = map(_t, _scan_inputs(np.random.default_rng(2)))
    kw = dict(mode=mode, chunk_size=16, return_final_state=True,
              xamba=XambaConfig(cumba=cumba))
    y, h = tsscan.selective_scan(u, dt, A, B, C, D, initial_state=h0, **kw)
    y1, h1 = tsscan.selective_scan(u[:, :20], dt[:, :20], A, B[:, :20],
                                   C[:, :20], D, initial_state=h0, **kw)
    y2, h2 = tsscan.selective_scan(u[:, 20:], dt[:, 20:], A, B[:, 20:],
                                   C[:, 20:], D, initial_state=h1, **kw)
    assert _rel(torch.cat([y1, y2], 1), y.numpy()) <= RTOL
    assert _rel(h2, h.numpy()) <= RTOL
    ys, hs = tsscan.selective_scan(u, dt, A, B, C, D, initial_state=h0,
                                   **dict(kw, mode="sequential"))
    assert _rel(y, ys.numpy()) <= RTOL and _rel(h, hs.numpy()) <= RTOL


def _step_inputs(rng, b=3, d=20, n=16):
    f = np.float32
    return (rng.normal(size=(b, d, n)).astype(f),
            rng.normal(size=(b, d)).astype(f),
            rng.uniform(0.01, 0.5, size=(b, d)).astype(f),
            -rng.uniform(0.1, 2.0, size=(d, n)).astype(f),
            rng.normal(size=(b, n)).astype(f),
            rng.normal(size=(b, n)).astype(f),
            rng.normal(size=(d,)).astype(f))


@pytest.mark.parametrize("mode", ["naive", "cumba"])
def test_selective_scan_decode_step_matches_jax(mode):
    args = _step_inputs(np.random.default_rng(3))
    js, jy = jsscan.selective_scan_decode_step(*map(jnp.asarray, args),
                                               mode=mode)
    ts, ty = tsscan.selective_scan_decode_step(*map(_t, args), mode=mode)
    assert _rel(ts, js) <= RTOL and _rel(ty, jy) <= RTOL


@pytest.mark.parametrize("with_d", [True, False], ids=["D", "noD"])
def test_sscan_step_plain_matches_pallas_and_ref(with_d):
    """``selective_scan_decode_step(mode="pallas")`` on the CPU is kernel
    4's plain version: against the JAX kernel in interpret mode and its
    oracle, with and without D."""
    args = list(_step_inputs(np.random.default_rng(4)))
    if not with_d:
        args[-1] = None
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    targs = [None if a is None else _t(a) for a in args]
    for want in (jops.sscan_step(*jargs, interpret=True),
                 jref.sscan_step_ref(*jargs)):
        got = tsscan.selective_scan_decode_step(*targs, mode="pallas")
        for a, r in zip(got, want):
            assert _err(a, r) <= 1e-5
    assert torch.equal(
        tops.sscan_step(*targs)[1],
        tsscan.selective_scan_decode_step(*targs, mode="pallas_interpret")[1])


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_step_plain_matches_pallas_and_ref(g):
    """Kernel 3's plain version against the JAX kernel in interpret mode
    and ``ssd_step_ref``."""
    rng = np.random.default_rng(5 + g)
    b, h, p, n = 3, 4, 8, 16
    f = np.float32
    args = (rng.normal(size=(b, h, p, n)).astype(f),
            rng.normal(size=(b, h, p)).astype(f),
            rng.uniform(0.01, 1.0, size=(b, h)).astype(f),
            -rng.uniform(0.1, 2.0, size=(h,)).astype(f),
            rng.normal(size=(b, g, n)).astype(f),
            rng.normal(size=(b, g, n)).astype(f))
    got = tds.ssd_step_plain(*map(_t, args))
    for want in (jops.ssd_step(*map(jnp.asarray, args), interpret=True),
                 jref.ssd_step_ref(*map(jnp.asarray, args))):
        for a, r in zip(got, want):
            assert _err(a, r) <= 1e-5


# ---------------------------------------------------------------------------
# kernel 5's plain version
# ---------------------------------------------------------------------------
def _m1_args(rng, b=2, d=24, n=8, r=6, w=4, dtype=np.float32):
    f = np.float32
    return (rng.normal(size=(b, d)).astype(dtype),
            rng.normal(size=(b, d)).astype(dtype),
            rng.normal(size=(b, w - 1, d)).astype(dtype),
            rng.normal(size=(b, d, n)).astype(f),
            (rng.normal(size=(w, d)) * 0.3).astype(f),
            (rng.normal(size=(d,)) * 0.1).astype(f),
            (rng.normal(size=(d, r + 2 * n)) * 0.2).astype(f),
            (rng.normal(size=(r, d)) * 0.2).astype(f),
            (rng.normal(size=(d,)) * 0.1).astype(f),
            -rng.uniform(0.1, 2.0, size=(d, n)).astype(f),
            rng.normal(size=(d,)).astype(f))


@pytest.mark.parametrize("actiba", [False, True], ids=["exact", "actiba"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba1_step_plain_matches_pallas_and_ref(dtype, actiba):
    """Against ``kops.mamba1_decode_step(interpret=True)`` and
    ``mamba1_step_ref``: fp32 within 1e-5; bf16 streams within one bf16
    step of the reference's y and conv tail (the state fp32, 1e-5)."""
    rng = np.random.default_rng(7)
    args = _m1_args(rng)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = [jnp.asarray(a).astype(jdt) if i < 3 else jnp.asarray(a)
             for i, a in enumerate(args)]
    targs = [_t(a).to(tdt) if i < 3 else _t(a) for i, a in enumerate(args)]
    jx = JXamba.full() if actiba else None
    tx = XambaConfig.full() if actiba else None
    got = tops.mamba1_decode_step(*targs, dt_rank=6, xamba=tx)
    acts = dict(silu=jpwl.activation("silu", jx),
                softplus=jpwl.activation("softplus", jx))
    wants = (jops.mamba1_decode_step(*jargs, dt_rank=6, xamba=jx,
                                     interpret=True),
             jref.mamba1_step_ref(*jargs, dt_rank=6, **acts))
    for want in wants:
        for name, a, r in zip(("y", "conv", "ssm"), got, want):
            assert a.dtype == (torch.float32 if name == "ssm" else tdt)
            r32 = np.asarray(jnp.asarray(r, jnp.float32))
            tol = 1e-5 if dtype == "float32" or name == "ssm" else \
                2.0 ** -7 * float(np.abs(r32).max())
            assert _err(a.float(), r32) <= tol, name
    if actiba:
        exact = tds.mamba1_step_plain(*targs, dt_rank=6)
        assert not torch.equal(exact[0], got[0])


def test_mamba1_dispatch_takes_plain_on_cpu_and_writes_out():
    args = [_t(a) for a in _m1_args(np.random.default_rng(8))]
    want = tds.mamba1_step_plain(*args, dt_rank=6)
    out = (torch.empty_like(args[2]), torch.empty_like(args[3]))
    got = tops.mamba1_decode_step(*args, dt_rank=6, out=out)
    assert got[1] is out[0] and got[2] is out[1]
    for a, r in zip(got, want):
        assert torch.equal(a, r)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tds.mamba1_step(*args, dt_rank=6)


# ---------------------------------------------------------------------------
# the mixer
# ---------------------------------------------------------------------------
MIXER_CASES = ["prefill", "prefill_state", "step_naive", "step_cumba",
               "force_prefill"]


@pytest.mark.parametrize("case", MIXER_CASES)
def test_mamba1_apply_matches_jax(case):
    """``mamba1_apply`` against ``repro.nn.ssm.mamba1_apply`` on one
    layer's weights: prefill (l = 20) without and with a carried state,
    the one-token step in ``naive`` and ``cumba`` mode, and a one-token
    call down the prefill path."""
    decode = {"step_naive": "naive"}.get(case, "cumba")
    fp = case == "force_prefill"
    jm, jp, tm, tp = _pair(seed=2, jxamba=JXamba(decode=decode),
                           txamba=XambaConfig(decode=decode),
                           force_prefill_path=fp)
    jl = jax.tree.map(lambda a: a[0], jp["layers"]["mixer"])
    tl = tp["layers"][0]["mixer"]
    rng = np.random.default_rng(9)
    l = 20 if case.startswith("prefill") else 1
    x = rng.normal(size=(2, l, 128)).astype(np.float32)
    state = None
    if case != "prefill":
        conv = rng.normal(size=(2, 3, 256)).astype(np.float32)
        ssm = (rng.normal(size=(2, 256, 16)) * 3).astype(np.float32)
        jstate = jssm.Mamba1State(jnp.asarray(conv), jnp.asarray(ssm))
        state = tssm.Mamba1State(_t(conv), _t(ssm))
    jh, jnew = jssm.mamba1_apply(jl, jm.cfg, jnp.asarray(x),
                                 None if state is None else jstate)
    with torch.inference_mode():
        th, tnew = tssm.mamba1_apply(tl, tm.cfg, _t(x), state)
    assert _rel(th, jh) <= RTOL
    if state is None:
        assert tnew is None
    else:
        assert tnew.conv.dtype == torch.float32
        assert _rel(tnew.conv, jnew.conv) <= RTOL
        assert _rel(tnew.ssm, jnew.ssm) <= RTOL


@pytest.mark.parametrize("mode", ["naive", "cumba", "pallas",
                                  "pallas_interpret"])
def test_decode_modes_take_their_paths(mode, monkeypatch):
    """``cumba`` and ``pallas*`` decode through the fused step (once a
    layer), ``naive`` through the unfused chain; the prefill never calls
    the step."""
    calls = []
    real = tops.mamba1_decode_step
    monkeypatch.setattr(tops, "mamba1_decode_step",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    tm = build_model(_tcfg().with_decode_mode(mode), device="cpu")
    params = init_params(tm.param_specs(), 0, torch.float32, "cpu")
    with torch.inference_mode():
        _, cache = tm.prefill(params, {"tokens": torch.ones(
            (1, 8), dtype=torch.long)}, tm.init_cache(1))
        assert calls == []
        tm.decode_step(params, torch.ones((1, 1), dtype=torch.long), cache, 8)
    assert len(calls) == (0 if mode == "naive" else tm.cfg.n_layers)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def _witness(tp, cfg, tokens):
    """fp64 numpy Mamba-1 LM fed token by token (the plain recurrence, no
    scan modes, no kernels): yields (logits (b, V), ssm (L, b, di, n))
    after each token of ``tokens`` (b, T)."""
    def P(t):
        return t.double().numpy()

    def rms(x, s):
        return x / np.sqrt((x * x).mean(-1, keepdims=True) + 1e-6) * s

    def silu(v):
        return v / (1.0 + np.exp(-v))

    di, n, r = tssm.mamba1_dims(cfg)
    emb = P(tp["embed"]["table"])
    b = tokens.shape[0]
    conv = [np.zeros((b, cfg.d_conv - 1, di)) for _ in tp["layers"]]
    ssm = [np.zeros((b, di, n)) for _ in tp["layers"]]
    for t in range(tokens.shape[1]):
        x = emb[tokens[:, t]]
        for i, lay in enumerate(tp["layers"]):
            m = lay["mixer"]
            xz = rms(x, P(lay["ln"]["scale"])) @ P(m["in_proj"]["w"])
            win = np.concatenate([conv[i], xz[:, None, :di]], 1)
            conv[i] = win[:, 1:]
            u = silu((win * P(m["conv"]["w"])[None]).sum(1)
                     + P(m["conv"]["b"]))
            dbc = u @ P(m["x_proj"]["w"])
            dt = np.logaddexp(0.0, dbc[:, :r] @ P(m["dt_proj"]["w"])
                              + P(m["dt_proj"]["b"]))
            ssm[i] = ssm[i] * np.exp(dt[..., None] * -np.exp(P(m["A_log"]))) \
                + (dt * u)[..., None] * dbc[:, None, r:r + n]
            y = (ssm[i] * dbc[:, None, r + n:]).sum(-1) + P(m["D"]) * u
            x = x + (y * silu(xz[:, di:])) @ P(m["out_proj"]["w"])
        yield rms(x, P(tp["final_norm"]["scale"])) @ emb.T, np.stack(ssm)


def _state_ok(port, jax_state, exact):
    """The port within 1e-5 of the witness (relative to its largest
    magnitude), and no farther from the JAX package than that bound plus
    the JAX package's own distance from the witness."""
    scale = float(np.abs(exact).max())
    jerr = _err(np.asarray(jax_state), exact)
    return _err(port, exact) <= RTOL * scale and \
        _err(port, np.asarray(jax_state)) <= RTOL * scale + jerr


@pytest.mark.parametrize("scan_mode", ["associative", "sequential"])
def test_model_matches_jax(scan_mode):
    """Prefill (l = 24), 8 decode steps, ``prefill_chunk`` in two slices
    and ``forward`` of the reduced mamba-130m against the JAX model: logits
    within 5e-4, states within 1e-5 of their largest magnitude (after the
    decode steps: ``_state_ok``)."""
    jm, jp, tm, tp = _pair(seed=4, scan_mode=scan_mode)
    rng = np.random.default_rng(10)
    toks = rng.integers(1, 512, size=(2, 24))
    steps = rng.integers(1, 512, size=(2, 8))
    witness = list(_witness(tp, tm.cfg, np.concatenate([toks, steps], 1)))
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                        jm.init_cache(2, dtype=jnp.float32))
    view = tm.decode_view(tp)
    with torch.inference_mode():
        tl, tc = tm.prefill(view, {"tokens": torch.from_numpy(toks)},
                            tm.init_cache(2, dtype=torch.float32))
    assert isinstance(tc, tssm.Mamba1State)
    assert tc.ssm.shape == (2, 2, 256, 16) and tc.conv.shape == (2, 2, 3, 256)
    assert _err(tl, jl) <= LOGIT_TOL and _rel(tc.ssm, jc.ssm) <= RTOL
    jdv = jm.decode_view(jp)
    assert _err(tl, witness[23][0]) <= LOGIT_TOL
    for t in range(8):
        tok = steps[:, t:t + 1]
        jl, jc = jm.decode_step(jdv, jnp.asarray(tok, jnp.int32), jc,
                                jnp.int32(24 + t))
        with torch.inference_mode():
            tl, tc = tm.decode_step(view, torch.from_numpy(tok), tc, 24 + t)
        assert _err(tl, jl) <= LOGIT_TOL
        assert _err(tl, witness[24 + t][0]) <= LOGIT_TOL
        assert _state_ok(tc.ssm, jc.ssm, witness[24 + t][1])
        assert _rel(tc.conv, jc.conv) <= RTOL
    jc = jm.init_cache(2, dtype=jnp.float32)
    tc = tm.init_cache(2, dtype=torch.float32)
    for off in (0, 10):
        sl = toks[:, off:off + (10 if off == 0 else 14)]
        jl, jc = jm.prefill_chunk(jp, jnp.asarray(sl, jnp.int32), jc,
                                  jnp.int32(off))
        with torch.inference_mode():
            tl, tc = tm.prefill_chunk(tp, torch.from_numpy(sl), tc, off)
    assert _err(tl, jl) <= LOGIT_TOL and _rel(tc.ssm, jc.ssm) <= RTOL
    with torch.inference_mode():
        tf = tm.forward(tp, torch.from_numpy(toks))
    assert _err(tf, jm.forward(jp, jnp.asarray(toks, jnp.int32))) <= LOGIT_TOL


def test_w8_model_matches_jax_w8_model():
    """``quantize_params_for_mode`` on both sides quantizes in_proj and
    out_proj only (x_proj and dt_proj stay fp: kernel 5 takes them raw);
    prefill and three decode steps against the JAX W8 XLA path."""
    jm, jp, tm, tp = _pair(seed=5)
    jq = jquant.quantize_params_for_mode(jp, "w8")
    tq = tquant.quantize_params_for_mode(tp, "w8")
    mix = tq["layers"][0]["mixer"]
    assert [k for k in sorted(mix) if isinstance(mix[k], dict)
            and tquant.is_quantized(mix[k].get("w"))] == ["in_proj",
                                                          "out_proj"]
    assert tquant.quant_summary(tq)["quantized_tensors"] == 4
    for i, lay in enumerate(tq["layers"]):
        for k in ("in_proj", "out_proj"):
            jw = jq["layers"]["mixer"][k]["w"]
            assert np.array_equal(lay["mixer"][k]["w"].q.numpy(),
                                  np.asarray(jw.q[i]))
    rng = np.random.default_rng(11)
    toks = rng.integers(1, 512, size=(2, 16))
    jl, jc = jm.prefill(jq, {"tokens": jnp.asarray(toks, jnp.int32)},
                        jm.init_cache(2, dtype=jnp.float32))
    view = tm.decode_view(tq)
    with torch.inference_mode():
        tl, tc = tm.prefill(view, {"tokens": torch.from_numpy(toks)},
                            tm.init_cache(2, dtype=torch.float32))
    assert _err(tl, jl) <= LOGIT_TOL
    jdv = jm.decode_view(jq)
    for t in range(3):
        tok = rng.integers(1, 512, size=(2, 1))
        jl, jc = jm.decode_step(jdv, jnp.asarray(tok, jnp.int32), jc,
                                jnp.int32(16 + t))
        with torch.inference_mode():
            tl, tc = tm.decode_step(view, torch.from_numpy(tok), tc, 16 + t)
        assert _err(tl, jl) <= LOGIT_TOL


# ---------------------------------------------------------------------------
# engines, CLI
# ---------------------------------------------------------------------------
def test_wave_engine_greedy_matches_jax_engine():
    """Same weights, same requests (both prefill buckets, more requests
    than slots): token-identical greedy outputs."""
    jm, jp, tm, tp = _pair(seed=6)
    rng = np.random.default_rng(12)
    prompts = [rng.integers(1, 512, size=int(n)).tolist()
               for n in (5, 40, 17, 90, 3)]
    kw = dict(max_batch=2, prefill_buckets=(32, 128), max_new_tokens=6)
    jeng, teng = JEngine(jm, jp, JServeConfig(**kw)), \
        Engine(tm, tp, ServeConfig(**kw))
    for p in prompts:
        jeng.submit(p)
        teng.submit(p)
    tout = {r.uid: r.out_tokens for r in teng.run()}
    assert tout == {r.uid: r.out_tokens for r in jeng.run()}
    assert all(len(v) == 6 for v in tout.values())


def test_cli_mamba1_continuous_chunked_w8_serves_on_cpu():
    engine, done = tserve.main(["--arch", "mamba-130m", "--reduced",
                                "--device", "cpu", "--engine", "continuous",
                                "--prefill-chunk", "16", "--quant", "w8",
                                "--requests", "3", "--batch", "2",
                                "--max-new", "3"])
    assert isinstance(engine, ContinuousEngine) and engine.chunk == 16
    assert engine.model.cfg.family == "mamba"
    mix = engine.params["layers"][0]["mixer"]
    assert tquant.is_quantized(mix["in_proj"]["w"])
    assert not tquant.is_quantized(mix["x_proj"]["w"])
    assert set(mix["kernel"]) == {"conv_w", "conv_b", "xproj_w", "dtproj_w",
                                  "dtproj_b", "A", "D"}
    assert len(done) == 3 and all(len(r.out_tokens) == 3 for r in done)
    assert all(0 <= t < 512 for r in done for t in r.out_tokens)
    assert engine.metrics.summary()["prefill_tokens"] % 16 == 0


def test_cli_mamba1_naive_decode_and_default_device():
    """``--decode-mode naive`` serves; without ``--device cpu`` and with
    no GPU the CLI raises instead of running on the CPU."""
    _, done = tserve.main(["--arch", "mamba-130m", "--reduced", "--device",
                           "cpu", "--decode-mode", "naive", "--requests",
                           "2", "--batch", "2", "--max-new", "2"])
    assert len(done) == 2 and all(len(r.out_tokens) == 2 for r in done)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tserve.main(["--arch", "mamba-130m", "--reduced", "--requests",
                         "1"])
