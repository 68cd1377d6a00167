"""The port's kernel modules against the JAX package, on the CPU.

Each plain PyTorch version (what a CPU tensor runs, and what the CUDA
kernel is held to on the card) is fed the same numpy inputs as the JAX
function it replaces: the Pallas kernel in interpret mode and its
``kernels/ref.py`` oracle, at the tolerances of the JAX package's own
tests (``test_decode_step.py``, ``test_prefill_fused.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ssd as jssd
from repro.core.xamba import XambaConfig as JXamba
from repro.kernels import ops as jops, prefill_chunk as jpc, ref as jref
from repro_torch.core import ssd as tssd
from repro_torch.kernels import decode_step as tds, ops as tops, \
    prefill_chunk as tpc


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _err(got, want):
    return float(np.abs(np.asarray(got, np.float64) -
                        np.asarray(want, np.float64)).max())


def _decode_inputs(rng, b, h, p, n, g, w):
    di = h * p
    dxbc = di + 2 * g * n
    f = np.float32
    return (rng.normal(size=(b, di)).astype(f),
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


@pytest.mark.parametrize("g", [1, 2])
def test_decode_step_plain_matches_pallas_and_ref(g):
    b, h, p, n, w = 2, 4, 8, 16, 4
    args = _decode_inputs(np.random.default_rng(2 + g), b, h, p, n, g, w)
    jargs = [jnp.asarray(a) for a in args]
    pallas = jops.mamba2_decode_step(
        *jargs, ngroups=g, head_dim=p,
        xamba=JXamba(decode="pallas_interpret"), interpret=True)
    oracle = jref.mamba2_step_ref(*jargs, ngroups=g, head_dim=p)
    got = tds.mamba2_step_plain(*map(_t, args), ngroups=g, head_dim=p)
    for name, a, r1, r2 in zip(("y", "conv", "ssm"), got, pallas, oracle):
        assert a.dtype == torch.float32
        assert _err(a, r1) <= 1e-5, name
        assert _err(a, r2) <= 1e-5, name


def test_decode_dispatch_takes_plain_on_cpu():
    """A CPU tensor reaches the plain version and never the kernel."""
    b, h, p, n, g, w = 2, 4, 8, 16, 1, 4
    args = [_t(a) for a in _decode_inputs(np.random.default_rng(7), b, h, p,
                                          n, g, w)]
    before = tds.mamba2_step.launches
    got = tops.mamba2_decode_step(*args, ngroups=g, head_dim=p)
    want = tds.mamba2_step_plain(*args, ngroups=g, head_dim=p)
    assert tds.mamba2_step.launches == before
    for a, r in zip(got, want):
        assert torch.equal(a, r)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tds.mamba2_step(*args, ngroups=g, head_dim=p)


def _prefill_inputs(rng, b, l, h, p, g, n, w):
    di = h * p
    dxbc = di + 2 * g * n
    r = lambda *s: rng.normal(size=s).astype(np.float32)
    return dict(
        z=r(b, l, di), xbc=r(b, l, dxbc), dt=r(b, l, h),
        conv_state=r(b, w - 1, dxbc), ssm_state=r(b, h, p, n) * 0.1,
        conv_w=r(w, dxbc) * 0.3, conv_b=r(dxbc) * 0.1, dt_bias=r(h) * 0.1,
        A=-np.exp(r(h) * 0.3), D=r(h) * 0.2,
        norm_scale=np.abs(r(di)) + 0.5)


@pytest.mark.parametrize("l", [64, 128], ids=["one_chunk", "two_chunks"])
@pytest.mark.parametrize("g", [1, 2])
def test_prefill_plain_matches_pallas_and_ref(l, g):
    """Chunk 64, one and two chunks with a carried state in and out."""
    b, h, p, n, w, chunk = 2, 4, 8, 8, 4, 64
    ins = _prefill_inputs(np.random.default_rng(l + g), b, l, h, p, g, n, w)
    jins = {k: jnp.asarray(v) for k, v in ins.items()}
    kw = dict(ngroups=g, head_dim=p)
    pallas = jpc.mamba2_prefill_pallas(
        **jins, chunk=chunk, silu=jax.nn.silu, softplus=jax.nn.softplus,
        interpret=True, **kw)
    oracle = jref.mamba2_prefill_ref(**jins, **kw)
    got = tpc.mamba2_prefill_plain(**{k: _t(v) for k, v in ins.items()},
                                   chunk=chunk, **kw)
    for want in (pallas, oracle):
        assert _err(got[0], want[0]) <= 2e-4, "y"
        assert _err(got[1], want[1]) <= 1e-5, "conv tail"
        assert _err(got[2], want[2]) <= 2e-4, "ssm state"


def test_prefill_dispatch_projects_and_takes_plain_on_cpu():
    """``ops.mamba2_prefill`` = in-projection + split + plain prefill on a
    CPU tensor, against the JAX package's ``cumba`` dispatch."""
    b, l, dm, h, p, g, n, w = 2, 32, 24, 2, 8, 1, 4, 4
    di = h * p
    rng = np.random.default_rng(9)
    ins = _prefill_inputs(rng, b, l, h, p, g, n, w)
    x = rng.normal(size=(b, l, dm)).astype(np.float32)
    in_w = (rng.normal(size=(dm, 2 * di + 2 * g * n + h)) * 0.2).astype(
        np.float32)
    common = {k: v for k, v in ins.items() if k not in ("z", "xbc", "dt")}
    want = jops.mamba2_prefill(
        jnp.asarray(x), jnp.asarray(in_w),
        **{k: jnp.asarray(v) for k, v in common.items()}, ngroups=g,
        head_dim=p, chunk=16, xamba=JXamba(), mode="cumba")
    before = tpc.mamba2_prefill.launches
    got = tops.mamba2_prefill(_t(x), _t(in_w),
                              **{k: _t(v) for k, v in common.items()},
                              ngroups=g, head_dim=p, chunk=16)
    assert tpc.mamba2_prefill.launches == before
    for a, r in zip(got, want):
        assert _err(a, r) <= 1e-4


def test_ssd_reference_matches_jax():
    rng = np.random.default_rng(5)
    b, l, h, p, g, n = 2, 12, 4, 8, 2, 8
    x = rng.normal(size=(b, l, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 1.0, size=(b, l, h)).astype(np.float32)
    A = -rng.uniform(0.1, 2.0, size=(h,)).astype(np.float32)
    B = rng.normal(size=(b, l, g, n)).astype(np.float32)
    C = rng.normal(size=(b, l, g, n)).astype(np.float32)
    s0 = (rng.normal(size=(b, h, p, n)) * 0.1).astype(np.float32)
    jy, js = jssd.ssd_reference(*map(jnp.asarray, (x, dt, A, B, C)),
                                initial_state=jnp.asarray(s0))
    ty, ts = tssd.ssd_reference(*map(_t, (x, dt, A, B, C)),
                                initial_state=_t(s0))
    assert _err(ty, jy) <= 1e-5
    assert _err(ts, js) <= 1e-5


def test_prefill_plain_matches_ssd_reference_composition():
    """The plain prefill against an oracle built from the port's own
    sequential ``ssd_reference`` (conv + SiLU + recurrence + gated norm,
    fp32 end to end)."""
    import torch.nn.functional as F
    b, l, h, p, g, n, w = 1, 64, 4, 8, 2, 8, 4
    ins = {k: _t(v) for k, v in _prefill_inputs(
        np.random.default_rng(11), b, l, h, p, g, n, w).items()}
    di = h * p
    win = torch.cat([ins["conv_state"], ins["xbc"]], dim=1)
    conv = sum(win[:, i:i + l] * ins["conv_w"][i] for i in range(w)) + \
        ins["conv_b"]
    act = F.silu(conv)
    xs = act[..., :di].reshape(b, l, h, p)
    B = act[..., di:di + g * n].reshape(b, l, g, n)
    C = act[..., di + g * n:].reshape(b, l, g, n)
    dt_f = F.softplus(ins["dt"] + ins["dt_bias"])
    y, st = tssd.ssd_reference(xs, dt_f, ins["A"], B, C,
                               initial_state=ins["ssm_state"])
    y = (y + xs * ins["D"][None, None, :, None]).reshape(b, l, di)
    yn = y * torch.rsqrt((y * y).mean(-1, keepdim=True) + 1e-6) * \
        ins["norm_scale"]
    want = yn * F.silu(ins["z"])
    got = tpc.mamba2_prefill_plain(**ins, ngroups=g, head_dim=p, chunk=16)
    assert _err(got[0], want) <= 2e-4
    assert _err(got[2], st) <= 2e-4
