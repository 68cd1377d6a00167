"""Kernels 5 and 6's one-launch designs, on the CPU.

The two CUDA kernels run only on the card (``tests/test_torch_cuda.py``);
here their summation orders are emulated in plain PyTorch fp32 and held
to the JAX package's ``mamba1_step`` / ``rglru_step`` (the Pallas kernels
in interpret mode and their ``kernels/ref.py`` oracles) on the same
numpy inputs and weights, and their plans are pinned at every shipped
width.

* Kernel 5 (``csrc/mamba1_step.cu``): each batch row is a cluster of
  ``M1_CLUSTER`` = 16 blocks of ceil(d_inner / 16) channels; a block's x_proj partial is its row groups' sums in order, the ranks'
  partials are added in rank order; dt_proj is four interleaved partial
  sums met by a butterfly of shuffles, and so is y over the state.
* Kernel 6 (``csrc/rglru_step.cu`` on ``gemm.cuh``'s cluster GEMV): at
  plan (lanes, splits) a split takes ceil(w / splits) rows of k, a k lane
  every klanes-th row of its split (klanes = 256 / lanes), the k lanes of
  a warp meet by a butterfly, the warps in order, the splits in rank
  order.

Tolerances are those the existing port tests state for these kernels'
plain versions (``tests/test_torch_mamba1.py:
test_mamba1_step_plain_matches_pallas_and_ref``, ``tests/
test_torch_rgemma.py: test_rglru_step_plain_matches_pallas_and_ref``):
fp32 within 1e-5 of the reference's largest magnitude, bf16 streams
within one bf16 step, the fp32 states within 1e-5.
"""
import math
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core import pwl as jpwl
from repro.core.xamba import XambaConfig as JXamba
from repro.kernels import ops as jops, ref as jref
from repro_torch.configs import get_config
from repro_torch.kernels import decode_step as ds, qmatmul as qm
from repro_torch.nn import layers

RTOL = 1e-5
BF16_STEP = 2.0 ** -7
CSRC = pathlib.Path(ds.__file__).resolve().parents[1] / "csrc"


def _constant(source: str, name: str) -> int:
    """A ``constexpr int`` of a kernel source."""
    text = (CSRC / source).read_text()
    return int(re.search(rf"\b{name} = (\d+)", text).group(1))


GW_THREADS = _constant("gemm.cuh", "GW_THREADS")       # a GEMV block
M1_MAX_THREADS = _constant("mamba1_step.cu", "M1_MAX_THREADS")
M1_CLUSTER = _constant("mamba1_step.cu", "M1_CLUSTER")  # blocks a row


def _t(a):
    return torch.from_numpy(np.array(np.asarray(a), copy=True))


def _err(got, want):
    """Max error over the reference's largest magnitude (at least 1)."""
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    return float(np.abs(got - want).max()) / max(1.0,
                                                 float(np.abs(want).max()))


def _butterfly(parts):
    """Lanes that meet by xor shuffles at offsets 1, 2, 4, ...: every lane
    ends with the same tree sum."""
    parts = list(parts)
    off = 1
    while off < len(parts):
        parts = [parts[i] + parts[i ^ off] for i in range(len(parts))]
        off *= 2
    return parts[0]


def _check(got, wants, dtype, names, state):
    for want in wants:
        for name, a, r in zip(names, got, want):
            if dtype == "float32" or name == state:
                assert _err(a, r) <= RTOL, name
            else:
                assert _err(a, r) <= BF16_STEP, name


# ---------------------------------------------------------------------------
# kernel 5
# ---------------------------------------------------------------------------
def m1_threads(di: int, rn: int) -> int:
    """Threads of a kernel-5 block (csrc/mamba1_step.cu:
    mamba1_step_launch): four a channel, at least r + 2n, a warp
    multiple, at most 768."""
    chb = -(-di // M1_CLUSTER)
    nt = max(4 * min(chb, M1_MAX_THREADS // 4), rn)
    return min(-(-nt // 32) * 32, M1_MAX_THREADS)


def mamba1_emulated(xs_raw, z, conv_state, ssm_state, conv_w, conv_b,
                    xproj_w, dtproj_w, dtproj_b, A, D, *, dt_rank,
                    silu=F.silu, softplus=F.softplus):
    """``mamba1_step_plain`` with kernel 5's summation orders."""
    b, di = z.shape
    n, r = ssm_state.shape[-1], dt_rank
    rn = r + 2 * n
    conv_out, new_conv = layers.causal_conv1d_step(
        {"w": conv_w, "b": conv_b}, xs_raw.float(), conv_state.float())
    xs = silu(conv_out)
    xp = xproj_w.float()
    chb = -(-di // M1_CLUSTER)
    groups = m1_threads(di, rn) // rn
    dbc = torch.zeros(b, rn)
    for rank in range(M1_CLUSTER):                    # rank order
        c0 = rank * chb
        psum = torch.zeros(b, rn)
        hi = max(c0, min(c0 + chb, di))               # none past di
        for g in range(groups):                       # row groups in order
            rows = torch.arange(c0 + g, max(hi, c0 + g), groups)
            psum = psum + (xs[:, rows] @ xp[rows] if len(rows) else 0.0)
        dbc = dbc + psum
    dt_low, B, C = torch.split(dbc, [r, n, n], dim=-1)
    dtw = dtproj_w.float()
    dt_acc = _butterfly(dt_low[:, q::4] @ dtw[q::4] for q in range(4))
    dt = softplus(dt_acc + dtproj_b.float()[None])
    new = ssm_state.float() * torch.exp(dt[..., None] * A.float()[None]) + \
        (dt * xs)[..., None] * B[:, None, :]
    lane = (torch.arange(n) % 16) // 4                # the four lanes
    y = _butterfly((new * C[:, None, :] * (lane == q)).sum(-1)
                   for q in range(4))
    out = (y + D.float()[None] * xs) * silu(z.float())
    return out.to(z.dtype), new_conv.to(conv_state.dtype), new


def _m1_args(rng, b, d, n, r, w=4):
    f = np.float32
    return (rng.normal(size=(b, d)).astype(f),
            rng.normal(size=(b, d)).astype(f),
            rng.normal(size=(b, w - 1, d)).astype(f),
            rng.normal(size=(b, d, n)).astype(f),
            (rng.normal(size=(w, d)) * 0.3).astype(f),
            (rng.normal(size=(d,)) * 0.1).astype(f),
            (rng.normal(size=(d, r + 2 * n)) * d ** -0.5).astype(f),
            (rng.normal(size=(r, d)) * 0.2).astype(f),
            (rng.normal(size=(d,)) * 0.1).astype(f),
            -rng.uniform(0.1, 2.0, size=(d, n)).astype(f),
            rng.normal(size=(d,)).astype(f))


def _streams(args, dtype, stream):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = [jnp.asarray(a).astype(jdt) if i in stream else jnp.asarray(a)
             for i, a in enumerate(args)]
    targs = [_t(a).to(tdt) if i in stream else _t(a)
             for i, a in enumerate(args)]
    return jargs, targs


@pytest.mark.parametrize("actiba", [False, True], ids=["exact", "actiba"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("di,n,r", [(96, 8, 6), (200, 16, 13), (7, 4, 3)])
def test_mamba1_rank_order_matches_jax(di, n, r, dtype, actiba):
    """Kernel 5's orders, ragged d_inner (96 and 200 channels: 6 and 13 a
    block, the last one short; 7 channels, so nine blocks hold none),
    against the JAX kernel in interpret mode and its oracle."""
    args = _m1_args(np.random.default_rng(di + 16), 3, di, n, r)
    jargs, targs = _streams(args, dtype, (0, 1, 2))
    jx = JXamba.full() if actiba else None
    acts = dict(silu=jpwl.activation("silu", jx),
                softplus=jpwl.activation("softplus", jx))
    tacts = {}
    if actiba:
        from repro_torch.core import pwl as tpwl
        from repro_torch.core.xamba import XambaConfig
        tx = XambaConfig.full()
        tacts = {k: (lambda v, t=tpwl.table_for(k, tx): tpwl.eval_pwl(t, v))
                 for k in ("silu", "softplus")}
    got = mamba1_emulated(*targs, dt_rank=r, **tacts)
    wants = (jops.mamba1_decode_step(*jargs, dt_rank=r, xamba=jx,
                                     interpret=True),
             jref.mamba1_step_ref(*jargs, dt_rank=r, **acts))
    _check(got, wants, dtype, ("y", "conv", "ssm"), "ssm")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba1_rank_order_at_full_width(dtype):
    """mamba-130m's widths (d_inner 1536, d_state 16, dt_rank 48),
    against the JAX oracle."""
    di, n, r = 1536, 16, 48
    args = _m1_args(np.random.default_rng(3), 2, di, n, r)
    jargs, targs = _streams(args, dtype, (0, 1, 2))
    got = mamba1_emulated(*targs, dt_rank=r)
    want = jref.mamba1_step_ref(*jargs, dt_rank=r)
    _check(got, (want,), dtype, ("y", "conv", "ssm"), "ssm")


def test_mamba1_emulation_is_the_plain_function():
    """The emulated orders change only rounding: at fp64 they give the
    plain version's values."""
    args = [_t(a).double() for a in _m1_args(np.random.default_rng(5), 2,
                                             200, 16, 13)]
    got = mamba1_emulated(*args, dt_rank=13)
    want = ds.mamba1_step_plain(*args, dt_rank=13)
    for a, r in zip(got, want):
        assert torch.allclose(a.double(), r.double(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_mamba1_cluster_at_every_shipped_width(reduced):
    """mamba-130m's d_inner (1536 full, 256 reduced) over a cluster of 16
    blocks: every block holds channels, one pass of four threads a channel
    (at most 192 channels a block), and the threads (a warp multiple)
    cover both the channels and the r + 2n x_proj columns."""
    cfg = get_config("mamba-130m", reduced=reduced)
    di = cfg.expand * cfg.d_model
    rn = cfg.dt_rank + 2 * cfg.d_state
    cl = M1_CLUSTER
    chb = -(-di // cl)
    assert cl == 16 and (cl - 1) * chb < di and chb <= M1_MAX_THREADS // 4
    nt = m1_threads(di, rn)
    assert nt % 32 == 0 and rn <= nt <= M1_MAX_THREADS and nt >= 4 * chb
    assert (di, chb, nt) == ((1536, 96, 384) if not reduced else
                             (256, 16, 64))


# ---------------------------------------------------------------------------
# kernel 6
# ---------------------------------------------------------------------------
def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def gate_sums(u_c, wt, plan):
    """u_c @ wt in kernel 6's order at plan (lanes, splits)."""
    lanes, splits = plan
    k = wt.shape[0]
    ks = math.ceil(k / splits)
    klanes = GW_THREADS // lanes
    per_warp = 32 // lanes
    total = 0.0
    for s in range(splits):                           # rank order
        lo, hi = s * ks, min(k, (s + 1) * ks)
        lane_sums = [u_c[:, lo + kl:hi:klanes] @ wt[lo + kl:hi:klanes]
                     for kl in range(klanes)]
        warps = [_butterfly(lane_sums[w * per_warp:(w + 1) * per_warp])
                 for w in range(GW_THREADS // 32)]
        split = warps[0]
        for v in warps[1:]:                           # warp order
            split = split + v
        total = total + split
    return total


def rglru_emulated(u, gate, conv_state, h_state, conv_w, conv_b, rg_w, rg_b,
                   ig_w, ig_b, lam, *, plan, sigmoid=torch.sigmoid,
                   softplus=F.softplus, gelu=_gelu_tanh):
    """``rglru_step_plain`` with kernel 6's gate sums."""
    u_c, new_conv = layers.causal_conv1d_step(
        {"w": conv_w, "b": conv_b}, u.float(), conv_state.float())
    r = sigmoid(gate_sums(u_c, rg_w.float(), plan) + rg_b.float()[None])
    i = sigmoid(gate_sums(u_c, ig_w.float(), plan) + ig_b.float()[None])
    log_a = -ds.RG_LRU_C * softplus(lam.float())[None] * r
    gated_in = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a),
                                          1e-12)) * (i * u_c)
    h_new = torch.exp(log_a) * h_state.float() + gated_in
    out = h_new * gelu(gate.float())
    return out.to(u.dtype), new_conv.to(conv_state.dtype), h_new


def _rg_args(rng, b, w):
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


RG_STREAM = (0, 1, 2, 6, 8)     # u, gate, conv tail, rg_w, ig_w


@pytest.mark.parametrize("actiba", [False, True], ids=["exact", "actiba"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("w", [24, 200])
def test_rglru_split_order_matches_jax(w, dtype, actiba):
    """Kernel 6's gate sums at its plan for the width (weights in the
    stream dtype, as the model stores them), against the JAX kernel in
    interpret mode and its oracle."""
    args = _rg_args(np.random.default_rng(w), 3, w)
    jargs, targs = _streams(args, dtype, RG_STREAM)
    plan = ds.rglru_plan(w, targs[6].element_size())
    jx = JXamba.pallas(interpret=True) if actiba else \
        JXamba(decode="pallas_interpret")
    acts = {k: jpwl.activation(k, jx if actiba else None)
            for k in ("sigmoid", "softplus")}
    acts["gelu"] = jpwl.activation("gelu", jx) if actiba else None
    tacts = {}
    if actiba:
        from repro_torch.core import pwl as tpwl
        from repro_torch.core.xamba import XambaConfig
        tx = XambaConfig.pallas()
        tacts = {k: (lambda v, t=tpwl.table_for(k, tx): tpwl.eval_pwl(t, v))
                 for k in ("sigmoid", "softplus", "gelu")}
    got = rglru_emulated(*targs, plan=plan, **tacts)
    wants = (jops.rglru_decode_step(*jargs, xamba=jx, interpret=True),
             jref.rglru_step_ref(*jargs, **acts))
    _check(got, wants, dtype, ("y", "conv", "h"), "h")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_split_order_at_full_width(dtype):
    """recurrentgemma-2b's width 2560 at its shipped plan, against the JAX
    oracle."""
    args = _rg_args(np.random.default_rng(11), 2, 2560)
    jargs, targs = _streams(args, dtype, RG_STREAM)
    plan = ds.rglru_plan(2560, targs[6].element_size())
    got = rglru_emulated(*targs, plan=plan)
    want = jref.rglru_step_ref(*jargs)
    _check(got, (want,), dtype, ("y", "conv", "h"), "h")


def test_rglru_emulation_is_the_plain_function():
    args = [_t(a).double() for a in _rg_args(np.random.default_rng(6), 2,
                                             200)]
    got = rglru_emulated(*args, plan=(16, 4))
    want = ds.rglru_step_plain(*args)
    for a, r in zip(got, want):
        assert torch.allclose(a.double(), r.double(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("esize", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_rglru_plan_at_every_shipped_width(reduced, esize):
    """recurrentgemma-2b's lru_width (2560 full, 128 reduced) with bf16
    and fp32 gate weights: a GEMV plan within one wave of the 132 SMs,
    every split holding rows, a pure function of the shape."""
    w = get_config("recurrentgemma-2b", reduced=reduced).lru_width
    plan = ds.rglru_plan(w, esize)
    ds.rglru_plan.cache_clear()
    assert ds.rglru_plan(w, esize) == plan
    lanes, splits = plan
    assert lanes in qm.GEMV_LANES and 1 <= splits <= qm.MAX_SPLITS
    blocks = math.ceil(w / (lanes * 16 // esize)) * splits
    assert blocks <= qm.SMS
    assert (splits - 1) * math.ceil(w / splits) < w
    assert lanes * 16 // esize == ds.RG_COLS
    if not reduced:
        assert splits == 5 and blocks == 100
