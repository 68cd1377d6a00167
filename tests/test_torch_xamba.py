"""The port's XAMBA technique path against the JAX package, on the CPU.

ActiBA tables and kernel 12, CumBA (``core/segsum.py``, kernel 13),
ReduBA (``core/reduce.py``), the chunked SSD with kernel 7, the fused
kernels' PWL epilogue, the unfused prefill chain and the naive decode,
the model under every preset, and the wave engine.  The same seeded
numpy inputs (and the JAX package's params, carried across with
``from_jax_params``) go through both packages; the JAX package's Pallas
kernels run in interpret mode and beside their ``kernels/ref.py``
oracles.  The port runs its kernels' plain versions here.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pwl as jpwl, reduce as jreduce, segsum as jsegsum, \
    ssd as jssd
from repro.core.xamba import XambaConfig as JXamba
from repro.kernels import ops as jops, prefill_chunk as jpc, ref as jref
from repro.models import ModelConfig as JModelConfig, build_model as jbuild
from repro.nn.params import init_params as jinit
from repro.serve import Engine as JEngine, ServeConfig as JServeConfig
from repro_torch.core import pwl as tpwl, reduce as treduce, \
    segsum as tsegsum, ssd as tssd
from repro_torch.core.xamba import XambaConfig as TXamba
from repro_torch.kernels import actiba as tact, cumba as tcumba, \
    decode_step as tds, ops as tops, prefill_chunk as tpc, \
    ssd_chunk as tssdk
from repro_torch.models import ModelConfig, build_model
from repro_torch.nn import ssm as tssm
from repro_torch.nn.params import from_jax_params
from repro_torch.serve import Engine, ServeConfig

V = 64
DIMS = dict(name="mamba2", family="mamba2", vocab_size=V, d_model=32,
            n_layers=2, d_state=8, ssm_head_dim=8, chunk_size=64,
            param_dtype="float32")
NAMES = ("silu", "softplus", "gelu", "sigmoid")


def _t(a):
    return torch.from_numpy(np.array(np.asarray(a), copy=True))


def _err(got, want):
    return float(np.abs(np.asarray(got, np.float64) -
                        np.asarray(want, np.float64)).max())


def _rel(got, want):
    """Max error over the reference's largest magnitude (at least 1)."""
    return _err(got, want) / max(1.0, float(np.abs(np.asarray(want)).max()))


# ---------------------------------------------------------------------------
# ActiBA: tables and kernel 12
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("adaptive", [True, False],
                         ids=["adaptive", "uniform"])
@pytest.mark.parametrize("segments", [8, 16, 32])
@pytest.mark.parametrize("name", NAMES)
def test_pwl_tables_bit_identical(name, segments, adaptive):
    """The same float64 fit in both packages: every breakpoint, slope and
    intercept equal, and so the fp32 coefficients the kernels read."""
    jt = jpwl.get_table(name, segments=segments, adaptive=adaptive)
    tt = tpwl.get_table(name, segments=segments, adaptive=adaptive)
    assert (tt.name, tt.breakpoints, tt.slopes, tt.intercepts) == \
        (jt.name, jt.breakpoints, jt.slopes, jt.intercepts)
    dm, m0, c0 = jt.basis()
    want = np.concatenate([np.asarray(jt.breakpoints, np.float32),
                           dm.astype(np.float32),
                           np.float32([m0, c0])])
    np.testing.assert_array_equal(tt.packed_f32(), want)
    assert tpwl.pwl_error(tpwl.numpy_fn(name), tt) == \
        jpwl.pwl_error(jpwl.numpy_fn(name), jt)


@pytest.mark.parametrize("name", NAMES)
def test_actiba_plain_matches_pallas_and_ref(name):
    """Kernel 12's plain version against the Pallas kernel (interpret) and
    its oracle, over an uneven shape that spans both linear extensions."""
    x = (np.random.default_rng(3).normal(size=(3, 37, 50)) * 6).astype(
        np.float32)
    jt = jpwl.get_table(name, segments=16)
    tt = tpwl.get_table(name, segments=16)
    pallas = jops.actiba_activate(jnp.asarray(x), jt, interpret=True)
    oracle = jref.pwl_activate_ref(jnp.asarray(x), jt)
    got = tact.pwl_activate_plain(_t(x), tt)
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert _err(got, pallas) <= 1e-5
    assert _err(got, oracle) <= 1e-5
    before = tact.pwl_activate.launches
    assert torch.equal(tops.actiba_activate(_t(x), tt), got)
    assert tact.pwl_activate.launches == before


def test_actiba_bf16_stream_keeps_dtype():
    """A bf16 stream: fp32 inside, the output rounded once to bf16, as the
    JAX package's ``eval_pwl``."""
    x = np.random.default_rng(4).normal(size=(4, 64)).astype(np.float32) * 4
    tt = tpwl.get_table("silu", segments=32)
    jt = jpwl.get_table("silu", segments=32)
    xb = _t(x).bfloat16()
    got = tpwl.eval_pwl(tt, xb)
    assert got.dtype == torch.bfloat16
    want = jpwl.eval_pwl(jt, jnp.asarray(xb.float().numpy()).astype(
        jnp.bfloat16))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_activation_exact_and_actiba():
    x = _t(np.linspace(-12, 12, 101, dtype=np.float32))
    for name in NAMES:
        assert _err(tpwl.activation(name)(x),
                    jpwl.activation(name)(jnp.asarray(x.numpy()))) <= 1e-5
        xa = TXamba(actiba=True, actiba_segments=16)
        ja = JXamba(actiba=True, actiba_segments=16)
        assert _err(tpwl.activation(name, xa)(x),
                    jpwl.activation(name, ja)(jnp.asarray(x.numpy()))) <= 1e-5


# ---------------------------------------------------------------------------
# CumBA: cumsum / segsum, kernel 13
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(3, 5, 256), (2, 300), (7,)],
                         ids=["tile", "ragged", "1d"])
def test_cumsum_plain_matches_pallas_and_ref(shape):
    x = -np.random.default_rng(5).uniform(0.0, 0.1, size=shape).astype(
        np.float32)
    pallas = jops.cumba_cumsum(jnp.asarray(x), interpret=True)
    oracle = jref.cumsum_last_ref(jnp.asarray(x))
    got = tcumba.cumsum_last_plain(_t(x))
    assert _err(got, pallas) <= 1e-5
    assert _err(got, oracle) <= 1e-5
    before = tcumba.cumsum_last.launches
    assert torch.equal(tops.cumba_cumsum(_t(x)), got)
    assert tcumba.cumsum_last.launches == before


@pytest.mark.parametrize("mode", ["naive", "cumba", "pallas_interpret"])
def test_cumsum_and_segsum_modes_match_jax(mode):
    a = -np.random.default_rng(6).uniform(0.0, 0.5, size=(2, 3, 4, 16)) \
        .astype(np.float32)
    for axis in (-1, 2):
        assert _err(tsegsum.cumsum(_t(a), axis=axis, mode=mode),
                    jsegsum.cumsum(jnp.asarray(a), axis=axis,
                                   mode=mode)) <= 1e-5
    got = tsegsum.segsum(_t(a), mode=mode)
    want = np.asarray(jsegsum.segsum(jnp.asarray(a), mode=mode))
    lower = np.tril(np.ones((16, 16), bool))
    assert _err(got.numpy()[..., lower], want[..., lower]) <= 1e-5
    assert np.all(got.numpy()[..., ~lower] == want[..., ~lower])
    assert _err(tsegsum.decay_matrix(_t(a), mode=mode),
                jsegsum.decay_matrix(jnp.asarray(a), mode=mode)) <= 1e-5


# ---------------------------------------------------------------------------
# ReduBA: contract / reduce_sum / mean
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["naive", "reduba", "pallas_interpret"])
@pytest.mark.parametrize("spec,shapes", [
    ("blgn,bsgn->bgls", ((2, 5, 2, 4), (2, 6, 2, 4))),
    ("bgqls,bsgqp->blgqp", ((2, 2, 3, 5, 5), (2, 5, 2, 3, 4))),
    ("bgqpn,bgn->bgqp", ((2, 2, 3, 4, 5), (2, 2, 5)))],
    ids=["scores", "y", "decode"])
def test_contract_matches_jax(mode, spec, shapes):
    rng = np.random.default_rng(7)
    lhs, rhs = (rng.normal(size=s).astype(np.float32) for s in shapes)
    got = treduce.contract(spec, _t(lhs), _t(rhs), mode=mode)
    want = jreduce.contract(spec, jnp.asarray(lhs), jnp.asarray(rhs),
                            mode=mode)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _err(got, want) <= 1e-5


@pytest.mark.parametrize("mode", ["naive", "reduba"])
def test_reduce_sum_and_mean_match_jax(mode):
    x = np.random.default_rng(8).normal(size=(4, 6, 5)).astype(np.float32)
    for axis in (0, 1, -1):
        assert _err(treduce.reduce_sum(_t(x), axis=axis, mode=mode),
                    jreduce.reduce_sum(jnp.asarray(x), axis=axis,
                                       mode=mode)) <= 1e-5
        assert _err(treduce.mean(_t(x), axis=axis, mode=mode),
                    jreduce.mean(jnp.asarray(x), axis=axis,
                                 mode=mode)) <= 1e-5


def test_unported_kernel_modes_raise():
    """Kernels 14 and 3, ported since, run in these modes: on the CPU
    their plain versions, against the JAX package's ``reduce_sum`` and
    ``ssd_decode_step`` in the same mode (interpret)."""
    x = np.random.default_rng(11).normal(size=(3, 4)).astype(np.float32)
    rng = np.random.default_rng(12)
    args = (rng.normal(size=(2, 4, 8, 16)), rng.normal(size=(2, 4, 8)),
            rng.uniform(0.01, 1.0, size=(2, 4)), -rng.uniform(0.1, 2, 4),
            rng.normal(size=(2, 2, 16)), rng.normal(size=(2, 2, 16)))
    args = [a.astype(np.float32) for a in args]
    want = jssd.ssd_decode_step(*map(jnp.asarray, args),
                                mode="pallas_interpret")
    for mode in ("pallas", "pallas_interpret"):
        assert _err(treduce.reduce_sum(_t(x), mode=mode),
                    jreduce.reduce_sum(jnp.asarray(x),
                                       mode="pallas_interpret")) <= 1e-5
        got = tssd.ssd_decode_step(*map(_t, args), mode=mode)
        for a, r in zip(got, want):
            assert _err(a, r) <= 1e-5


# ---------------------------------------------------------------------------
# SSD: kernel 7, ssd(), ssd_decode_step
# ---------------------------------------------------------------------------
def _ssd_inputs(rng, b, l, h, p, g, n):
    f = np.float32
    return (rng.normal(size=(b, l, h, p)).astype(f),
            rng.uniform(0.01, 0.5, size=(b, l, h)).astype(f),
            -rng.uniform(0.1, 2.0, size=(h,)).astype(f),
            rng.normal(size=(b, l, g, n)).astype(f),
            rng.normal(size=(b, l, g, n)).astype(f),
            (rng.normal(size=(b, h, p, n)) * 0.1).astype(f))


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_chunk_plain_matches_pallas_and_ref(g):
    b, c, L, h, p, n = 2, 2, 64, 4, 8, 16
    rng = np.random.default_rng(9 + g)
    x_c = (rng.normal(size=(b, c, L, h, p)) * 0.3).astype(np.float32)
    a_c = -rng.uniform(0.0, 0.2, size=(b, h, c, L)).astype(np.float32)
    A_cum = np.cumsum(a_c, axis=-1).astype(np.float32)
    B_c = (rng.normal(size=(b, c, L, g, n)) * 0.5).astype(np.float32)
    C_c = (rng.normal(size=(b, c, L, g, n)) * 0.5).astype(np.float32)
    jargs = [jnp.asarray(a) for a in (x_c, a_c, A_cum, B_c, C_c)]
    pallas = jops.ssd_chunk(*jargs, interpret=True)
    oracle = jref.ssd_chunk_ref(*jargs)
    got = tssdk.ssd_chunk_plain(_t(x_c), _t(A_cum), _t(B_c), _t(C_c))
    for want in (pallas, oracle):
        for a, r in zip(got, want):
            assert a.shape == r.shape and a.dtype == torch.float32
            assert _rel(a, r) <= 1e-5
    before = tssdk.ssd_chunk.launches
    via = tops.ssd_chunk(*map(_t, (x_c, A_cum, B_c, C_c)))
    assert tssdk.ssd_chunk.launches == before
    for a, r in zip(via, got):
        assert torch.equal(a, r)


@pytest.mark.parametrize("init", [False, True], ids=["zero", "init_state"])
@pytest.mark.parametrize("reduba", ["naive", "reduba", "pallas_interpret"])
@pytest.mark.parametrize("cumba", ["naive", "cumba", "pallas_interpret"])
def test_ssd_matches_jax(cumba, reduba, init):
    """l = 100 at chunk 64: padded to two chunks (with ``pallas*`` the
    chunk passes kernel 7's gate), with and without a carried state."""
    b, l, h, p, g, n = 2, 100, 4, 8, 2, 8
    x, dt, A, B, C, s0 = _ssd_inputs(np.random.default_rng(12), b, l, h, p,
                                     g, n)
    kw = dict(chunk_size=64, return_final_state=True)
    jy, js = jssd.ssd(*map(jnp.asarray, (x, dt, A, B, C)),
                      initial_state=jnp.asarray(s0) if init else None,
                      xamba=JXamba(cumba=cumba, reduba=reduba), **kw)
    ty, ts = tssd.ssd(*map(_t, (x, dt, A, B, C)),
                      initial_state=_t(s0) if init else None,
                      xamba=TXamba(cumba=cumba, reduba=reduba), **kw)
    assert ty.shape == (b, l, h, p) and ts.shape == (b, h, p, n)
    assert _rel(ty, jy) <= 1e-5
    assert _rel(ts, js) <= 1e-5


def test_ssd_loops_over_many_chunks_and_matches_reference():
    """Ten chunks take the looped intra-chunk pass (the JAX package's
    scan); both it and the JAX ssd agree with the sequential oracle."""
    b, l, h, p, g, n = 1, 160, 2, 4, 1, 4
    x, dt, A, B, C, s0 = _ssd_inputs(np.random.default_rng(13), b, l, h, p,
                                     g, n)
    ty, ts = tssd.ssd(*map(_t, (x, dt, A, B, C)), chunk_size=16,
                      initial_state=_t(s0), return_final_state=True)
    jy, js = jssd.ssd(*map(jnp.asarray, (x, dt, A, B, C)), chunk_size=16,
                      initial_state=jnp.asarray(s0), return_final_state=True)
    ry, rs = tssd.ssd_reference(*map(_t, (x, dt, A, B, C)),
                                initial_state=_t(s0))
    for want_y, want_s in ((jy, js), (ry, rs)):
        assert _rel(ty, want_y) <= 1e-5
        assert _rel(ts, want_s) <= 1e-5


def test_ssd_bf16_matmul_dtype_matches_jax():
    b, l, h, p, g, n = 1, 64, 2, 8, 1, 8
    x, dt, A, B, C, _ = _ssd_inputs(np.random.default_rng(14), b, l, h, p,
                                    g, n)
    ty = tssd.ssd(*map(_t, (x, dt, A, B, C)), chunk_size=32,
                  matmul_dtype=torch.bfloat16)
    jy = jssd.ssd(*map(jnp.asarray, (x, dt, A, B, C)), chunk_size=32,
                  matmul_dtype=jnp.bfloat16)
    assert _rel(ty, jy) <= 1e-2


def _ssd_fp64(x, dt, A, B, C):
    """The SSD recurrence step by step in float64 numpy (one group)."""
    b, l, h, p = x.shape
    s = np.zeros((b, h, p, B.shape[-1]))
    ys = []
    for t in range(l):
        s = s * np.exp(dt[:, t] * A)[..., None, None] + \
            (dt[:, t, :, None] * x[:, t])[..., None] * B[:, t, 0, None, None]
        ys.append(np.einsum("bhpn,bn->bhp", s, C[:, t, 0]))
    return np.stack(ys, axis=1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefix_sum_decays_lose_digits_in_both_packages(seed):
    """At prefix sums |cs| of ~1.3e3-1.5e3 (dt = softplus of a wide normal,
    A = -e, one chunk of 256) the CumBA form's decays exp(cs_i - cs_j) lose
    the digits of |cs| in fp32: in the JAX package as in the port, its
    error against the float64 recurrence is 100-300x the segment-sum
    form's (cumba mode ``naive``), and the two packages lose the same
    order of digits."""
    rng = np.random.default_rng(seed)
    b, l, h, p, n = 2, 256, 4, 8, 16
    f = np.float32
    x = rng.normal(size=(b, l, h, p)).astype(f)
    dt = np.log1p(np.exp(rng.normal(0.0, 4.0, size=(b, l, h)))).astype(f)
    A = np.full((h,), -np.e, f)
    B = rng.normal(size=(b, l, 1, n)).astype(f)
    C = rng.normal(size=(b, l, 1, n)).astype(f)
    want = _ssd_fp64(*(a.astype(np.float64) for a in (x, dt, A, B, C)))
    assert np.abs(np.cumsum(dt * A, axis=1)).max() > 1e3
    err = {}
    for mode in ("naive", "cumba"):
        ty = tssd.ssd(*map(_t, (x, dt, A, B, C)), chunk_size=l,
                      xamba=TXamba(cumba=mode))
        jy = jssd.ssd(*map(jnp.asarray, (x, dt, A, B, C)), chunk_size=l,
                      xamba=JXamba(cumba=mode))
        err[mode] = (_err(ty, want), _err(jy, want))
    assert err["naive"][0] == err["naive"][1] <= 1e-4
    port, jax_ = err["cumba"]
    assert min(port, jax_) > 30 * err["naive"][0]
    assert max(port, jax_) <= 4 * min(port, jax_)


@pytest.mark.parametrize("mode", ["naive", "cumba"])
def test_ssd_decode_step_matches_jax(mode):
    rng = np.random.default_rng(15)
    b, h, p, g, n = 2, 4, 8, 2, 8
    f = np.float32
    args = (rng.normal(size=(b, h, p, n)).astype(f),
            rng.normal(size=(b, h, p)).astype(f),
            rng.uniform(0.01, 1.0, size=(b, h)).astype(f),
            -rng.uniform(0.1, 2.0, size=(h,)).astype(f),
            rng.normal(size=(b, g, n)).astype(f),
            rng.normal(size=(b, g, n)).astype(f))
    js, jy = jssd.ssd_decode_step(*map(jnp.asarray, args), mode=mode)
    ts, ty = tssd.ssd_decode_step(*map(_t, args), mode=mode)
    assert _err(ts, js) <= 1e-5 and _err(ty, jy) <= 1e-5


# ---------------------------------------------------------------------------
# The fused kernels' PWL epilogue
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("g", [1, 2])
def test_decode_step_plain_actiba_matches_pallas(g):
    """Mirrors the JAX package's ``test_mamba2_fused_kernel_ties_reference
    [actiba]``: the same step with SiLU and softplus as PWL tables."""
    rng = np.random.default_rng(16 + g)
    b, h, p, n, w = 2, 4, 8, 16, 4
    di, dxbc = h * p, h * p + 2 * g * n
    f = np.float32
    args = (rng.normal(size=(b, di)).astype(f),
            rng.normal(size=(b, dxbc)).astype(f),
            rng.normal(size=(b, h)).astype(f),
            rng.normal(size=(b, w - 1, dxbc)).astype(f),
            rng.normal(size=(b, h, p, n)).astype(f),
            (rng.normal(size=(w, dxbc)) * 0.3).astype(f),
            (rng.normal(size=(dxbc,)) * 0.1).astype(f),
            (rng.normal(size=(h,)) * 0.1).astype(f),
            -rng.uniform(0.1, 2.0, size=(h,)).astype(f),
            rng.normal(size=(h,)).astype(f),
            rng.normal(size=(di,)).astype(f))
    jx = JXamba(decode="pallas_interpret", actiba=True)
    jargs = [jnp.asarray(a) for a in args]
    pallas = jops.mamba2_decode_step(*jargs, ngroups=g, head_dim=p,
                                     xamba=jx, interpret=True)
    oracle = jref.mamba2_step_ref(*jargs, ngroups=g, head_dim=p,
                                  silu=jpwl.activation("silu", jx),
                                  softplus=jpwl.activation("softplus", jx))
    tx = TXamba.pallas(interpret=True)
    got = tops.mamba2_decode_step(*map(_t, args), ngroups=g, head_dim=p,
                                  xamba=tx)
    exact = tds.mamba2_step_plain(*map(_t, args), ngroups=g, head_dim=p)
    for name, a, r1, r2, e in zip(("y", "conv", "ssm"), got, pallas, oracle,
                                  exact):
        assert _err(a, r1) <= 1e-5, name
        assert _err(a, r2) <= 1e-5, name
    assert _err(got[0], exact[0]) > 1e-4     # the tables did change y


@pytest.mark.parametrize("g", [1, 2])
def test_prefill_plain_actiba_matches_pallas(g):
    """Two chunks of 64 with a carried state, SiLU and softplus as PWL
    tables in the Pallas pipeline (interpret) and in the port."""
    rng = np.random.default_rng(18 + g)
    b, l, h, p, n, w, chunk = 2, 128, 4, 8, 8, 4, 64
    di, dxbc = h * p, h * p + 2 * g * n
    r = lambda *s: rng.normal(size=s).astype(np.float32)
    ins = dict(z=r(b, l, di), xbc=r(b, l, dxbc), dt=r(b, l, h),
               conv_state=r(b, w - 1, dxbc), ssm_state=r(b, h, p, n) * 0.1,
               conv_w=r(w, dxbc) * 0.3, conv_b=r(dxbc) * 0.1,
               dt_bias=r(h) * 0.1, A=-np.exp(r(h) * 0.3), D=r(h) * 0.2,
               norm_scale=np.abs(r(di)) + 0.5)
    jx = JXamba(actiba=True)
    pallas = jpc.mamba2_prefill_pallas(
        **{k: jnp.asarray(v) for k, v in ins.items()}, ngroups=g, head_dim=p,
        chunk=chunk, silu=jpwl.activation("silu", jx),
        softplus=jpwl.activation("softplus", jx), interpret=True)
    tx = TXamba.full()
    got = tpc.mamba2_prefill_plain(
        **{k: _t(v) for k, v in ins.items()}, ngroups=g, head_dim=p,
        chunk=chunk, silu=tpwl.activation("silu", tx),
        softplus=tpwl.activation("softplus", tx))
    assert _err(got[0], pallas[0]) <= 2e-4, "y"
    assert _err(got[1], pallas[1]) <= 1e-5, "conv tail"
    assert _err(got[2], pallas[2]) <= 2e-4, "ssm state"


# ---------------------------------------------------------------------------
# The model under every preset, and the wave engine
# ---------------------------------------------------------------------------
PRESETS = {
    "baseline": (JXamba.baseline(), TXamba.baseline()),
    "optimized": (JXamba.optimized(), TXamba.optimized()),
    "full": (JXamba.full(), TXamba.full()),
    "pallas": (JXamba.pallas(interpret=True), TXamba.pallas(interpret=True)),
}


def _pair(jx, tx, seed=0, **over):
    dims = dict(DIMS, **over)
    jm = jbuild(JModelConfig(**dims, xamba=jx))
    jp = jinit(jm.param_specs(), jax.random.PRNGKey(seed), jnp.float32)
    tm = build_model(ModelConfig(**dims, xamba=tx), device="cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tm.cfg, device="cpu")
    return jm, jp, tm, tp


@pytest.mark.parametrize("preset", list(PRESETS))
def test_model_logits_match_jax_under_preset(preset, caplog):
    """l = 96 at chunk 64 (not a chunk multiple): ``forward`` and
    ``prefill`` run the unfused chain in both packages; then two decode
    steps from the prefill's cache."""
    jx, tx = PRESETS[preset]
    jm, jp, tm, tp = _pair(jx, tx)
    rng = np.random.default_rng(20)
    b, l = 2, 96
    toks = rng.integers(1, V, size=(b, l)).astype(np.int32)
    tt = torch.from_numpy(toks).long()
    with caplog.at_level(logging.INFO):
        jf = jm.forward(jp, jnp.asarray(toks))
        jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                            jm.init_cache(b, dtype=jnp.float32))
        with torch.inference_mode():
            tf = tm.forward(tp, tt)
            tl, tc = tm.prefill(tp, {"tokens": tt},
                                tm.init_cache(b, dtype=torch.float32))
    if preset != "baseline":
        assert "seqlen 96 not a multiple of chunk 64" in caplog.text
    assert tf.shape == (b, l, V) and tf.dtype == torch.float32
    assert _err(tf, jf) <= 1e-4
    assert _err(tl, jl) <= 1e-4
    assert _rel(tc.ssm, jc.ssm) <= 1e-4
    jdp = jm.decode_view(jp)
    for t in range(2):
        tok = rng.integers(1, V, size=(b, 1)).astype(np.int32)
        jl, jc = jm.decode_step(jdp, jnp.asarray(tok), jc, jnp.int32(l + t))
        with torch.inference_mode():
            tl, tc = tm.decode_step(tp, torch.from_numpy(tok).long(), tc,
                                    l + t)
        assert _err(tl, jl) <= 1e-4, f"decode step {t}"
        assert _rel(tc.ssm, jc.ssm) <= 1e-4, f"decode step {t}"


def test_bf16_ssd_dtype_prefill_matches_jax(caplog, monkeypatch):
    """``ssd_dtype="bfloat16"``: both packages' gate sends a chunk-multiple
    prefill (l = 128 at chunk 64) to the unfused chain, whose SSD keeps its
    wide streams and contraction results in bf16.  Both round the same
    values at the same points, so they agree to a bf16 step of a few
    elements (2e-4 here), far inside the 2.4e-2 the bf16 SSD moves the
    logits from fp32."""
    monkeypatch.setattr(tssm, "_LOGGED", set())     # logged once per shape
    rng = np.random.default_rng(22)
    b, l = 2, 128
    toks = rng.integers(1, V, size=(b, l)).astype(np.int32)
    tt = torch.from_numpy(toks).long()
    jm, jp, tm, tp = _pair(JXamba(), TXamba(), ssd_dtype="bfloat16")
    with caplog.at_level(logging.INFO):
        jf = jm.forward(jp, jnp.asarray(toks))
        jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                            jm.init_cache(b, dtype=jnp.float32))
        with torch.inference_mode():
            tf = tm.forward(tp, tt)
            tl, tc = tm.prefill(tp, {"tokens": tt},
                                tm.init_cache(b, dtype=torch.float32))
    assert caplog.text.count("ssd_dtype=bfloat16 (fused prefill is "
                             "fp32-only)") >= 2
    assert _err(tf, jf) <= 1e-3
    assert _err(tl, jl) <= 1e-3
    assert _rel(tc.ssm, jc.ssm) <= 1e-2
    _, _, t32, tp32 = _pair(JXamba(), TXamba())
    with torch.inference_mode():
        assert float((tf - t32.forward(tp32, tt)).abs().max()) > 1e-2


@pytest.mark.parametrize("prefill", ["cumba", "naive"])
def test_force_prefill_path_decode_matches_jax(prefill, monkeypatch):
    """``force_prefill_path``: a one-token call with a state runs the
    prefill path (the fused prefill, or under ``prefill="naive"`` the
    unfused chain), never the step, in both packages; its logits and
    states match the JAX package's and the port's own step (the JAX
    package's ``test_decode_matches_force_prefill_path_slice``)."""
    steps = []
    step = tops.mamba2_decode_step
    monkeypatch.setattr(tops, "mamba2_decode_step",
                        lambda *a, **k: steps.append(1) or step(*a, **k))
    jx, tx = JXamba(prefill=prefill), TXamba(prefill=prefill)
    jm, jp, tm, tp = _pair(jx, tx, force_prefill_path=True)
    sm = build_model(ModelConfig(**DIMS, xamba=tx), device="cpu")
    rng = np.random.default_rng(23)
    S, P = 14, 10
    toks = rng.integers(1, V, size=(2, S)).astype(np.int32)
    tt = torch.from_numpy(toks).long()
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :P])},
                        jm.init_cache(2, dtype=jnp.float32))
    with torch.inference_mode():
        _, tc = tm.prefill(tp, {"tokens": tt[:, :P]},
                           tm.init_cache(2, dtype=torch.float32))
    sc = tc
    for t in range(P, S):
        jl, jc = jm.decode_step(jp, jnp.asarray(toks[:, t:t + 1]), jc,
                                jnp.int32(t))
        with torch.inference_mode():
            tl, tc = tm.decode_step(tp, tt[:, t:t + 1], tc, t)
            assert not steps, "force_prefill_path ran the decode step"
            sl, sc = sm.decode_step(tp, tt[:, t:t + 1], sc, t)
            assert steps, "the step model did not run the decode step"
            steps.clear()
        assert _err(tl, jl) <= 1e-5, f"t={t}"
        assert _rel(tc.ssm, jc.ssm) <= 1e-5, f"t={t}"
        assert _err(tl, sl) <= 1e-5, f"t={t}"


def test_pallas_forward_reaches_kernels_7_12_13(monkeypatch):
    """Under ``pallas()`` the unfused chain calls the kernel dispatch of
    kernels 13 (A_cum), 7 (intra-chunk) and 12 (three activations) once
    per layer each; under ``full()`` only kernel 12."""
    calls = {}
    for name in ("cumba_cumsum", "ssd_chunk", "actiba_activate"):
        fn = getattr(tops, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(tops, name, counted)
    toks = torch.ones((1, 96), dtype=torch.long)
    for preset, want in (("pallas", {"cumba_cumsum": 2, "ssd_chunk": 2,
                                     "actiba_activate": 6}),
                         ("full", {"actiba_activate": 6})):
        calls.clear()
        _, _, tm, tp = _pair(*PRESETS[preset])
        with torch.inference_mode():
            tm.forward(tp, toks)
        assert calls == want, preset


@pytest.mark.parametrize("variant", ["pallas_actiba", "naive_modes"])
def test_wave_engine_greedy_matches_jax_engine_under_modes(variant):
    """Token-identical greedy outputs under ``pallas()`` (ActiBA in the
    fused kernels; the short bucket's chunk 32 is not a multiple of 64, so
    that prefill takes the unfused chain) and under the CLI's
    ``--prefill-mode naive --decode-mode naive``."""
    if variant == "pallas_actiba":
        jx, tx = JXamba.pallas(interpret=True), TXamba.pallas(interpret=True)
    else:
        jx = JXamba(prefill="naive", decode="naive")
        tx = TXamba(prefill="naive", decode="naive")
    jm, jp, tm, tp = _pair(jx, tx, chunk_size=128)
    rng = np.random.default_rng(21)
    prompts = [rng.integers(1, V, size=int(n)).tolist() for n in (5, 40, 17)]
    kw = dict(max_batch=2, prefill_buckets=(32, 128), max_new_tokens=4)
    jeng = JEngine(jm, jp, JServeConfig(**kw))
    teng = Engine(tm, tp, ServeConfig(**kw))
    for p in prompts:
        jeng.submit(p)
        teng.submit(p)
    jout = {r.uid: r.out_tokens for r in jeng.run()}
    tout = {r.uid: r.out_tokens for r in teng.run()}
    assert tout == jout
    assert all(len(v) == 4 for v in tout.values())


def test_ablation_cli_runs_on_cpu():
    """``repro_torch.launch.ablation --device cpu --reduced``: every
    variant's logits are finite; the exact remaps agree with the baseline
    and ``pallas()`` with ``full()``."""
    from repro_torch.launch import ablation
    res = ablation.main(["--device", "cpu", "--reduced", "--seqlen", "40",
                         "--batch", "2", "--iters", "1"])
    assert [n for n, _ in ablation.VARIANTS] == list(res)
    base = res["baseline"]["logits"]
    for name, r in res.items():
        assert torch.isfinite(r["logits"]).all() and r["ms"] > 0
        assert r["logits"].shape == base.shape == (2, 40, 512)
    for a, b in (("baseline", "+CumBA+ReduBA"), ("baseline", "+CumBA"),
                 ("baseline", "+ReduBA"), ("+ActiBA (k=32)", "pallas")):
        assert _err(res[a]["logits"], res[b]["logits"]) <= 1e-4, (a, b)
