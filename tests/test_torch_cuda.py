"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a GPU every test here skips with a reason.  On a
machine with one: ``PYTHONPATH=src python -m pytest tests/test_torch_cuda.py
-q``.  This file imports no JAX (the GPU machine has none).  Shapes are
small and uneven (groups 2, head_dim 8 and 32, chunks that do not fill a
64-row tile); ``chip_smoke.py`` covers the full width.
"""
import pytest
import torch

from repro_torch.kernels import decode_step as ds, ops, prefill_chunk as pc

pytestmark = pytest.mark.cuda

# As chip_smoke.py: element by element, |kernel - plain| <= rtol *
# (|plain| + ATOL_RMS * rms(plain)), rtol by the case's stream dtype and
# the output (the fp32 SSM state is "state"); in bf16 at most
# MAX_OFF_SHARE of a stream output's elements (and at least 2) may differ.
TOL = {(torch.float32, "stream"): 1e-4, (torch.float32, "state"): 1e-4,
       (torch.bfloat16, "stream"): 2.0 ** -7, (torch.bfloat16, "state"): 1e-4}
ATOL_RMS = 4.0
MAX_OFF_SHARE = 0.005

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(dev, dtype, b, l, h, p, g, n, w, seed):
    gen = torch.Generator().manual_seed(seed)
    di = h * p
    dxbc = di + 2 * g * n
    lead = (b,) if l is None else (b, l)
    f32 = torch.float32
    r = lambda *s, scale=1.0, dtype=dtype: (
        torch.randn(s, generator=gen) * scale).to(dev).to(dtype)
    return dict(
        z=r(*lead, di), xbc=r(*lead, dxbc), dt=r(*lead, h),
        conv_state=r(b, w - 1, dxbc),
        ssm_state=(torch.randn(b, h, p, n, generator=gen) * 0.1).to(dev),
        conv_w=r(w, dxbc, scale=0.3, dtype=f32),
        conv_b=r(dxbc, scale=0.1, dtype=f32),
        dt_bias=r(h, scale=0.1, dtype=f32),
        A=-torch.exp(torch.randn(h, generator=gen) * 0.3).to(dev),
        D=r(h, scale=0.2, dtype=f32), norm_scale=r(di, dtype=f32).abs() + 0.5)


def _check(got, want, dtype):
    for name, a, r in zip(("y", "conv", "ssm"), got, want):
        assert a.dtype == r.dtype and a.shape == r.shape
        rtol = TOL[dtype, "state" if name == "ssm" else "stream"]
        diff = (a.float() - r.float()).abs()
        r32 = r.float()
        tol = rtol * (r32.abs() + ATOL_RMS * r32.square().mean().sqrt())
        assert bool((diff <= tol).all()), name
        if a.dtype == torch.bfloat16:
            n_off = int((diff > 0).sum())
            assert n_off <= max(2, MAX_OFF_SHARE * diff.numel()), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,p,g,n", [(4, 8, 2, 16), (8, 32, 1, 64)])
def test_decode_kernel_matches_plain(dev, dtype, h, p, g, n):
    ins = _inputs(dev, dtype, 3, None, h, p, g, n, 4, seed=h + n)
    before = ds.mamba2_step.launches
    got = ds.mamba2_step(**ins, ngroups=g, head_dim=p)
    assert ds.mamba2_step.launches == before + 1
    _check(got, ds.mamba2_step_plain(**ins, ngroups=g, head_dim=p), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l,chunk", [(96, 32), (128, 128), (160, 80)])
def test_prefill_kernel_matches_plain(dev, dtype, l, chunk):
    h, p, g, n = 4, 16, 2, 32
    ins = _inputs(dev, dtype, 2, l, h, p, g, n, 4, seed=l + chunk)
    kw = dict(ngroups=g, head_dim=p, chunk=chunk)
    before = pc.mamba2_prefill.launches
    got = pc.mamba2_prefill(**ins, **kw)
    assert pc.mamba2_prefill.launches == before + 1
    _check(got, pc.mamba2_prefill_plain(**ins, **kw), dtype)


def test_prefill_takes_projection_views(dev):
    """The in-projection's z/xbc/dt splits reach the kernel as strided
    views (no copies) and match the plain version on the same views."""
    h, p, g, n, w, dm, b, l = 4, 16, 1, 32, 4, 48, 2, 64
    ins = _inputs(dev, torch.float32, b, l, h, p, g, n, w, seed=5)
    gen = torch.Generator().manual_seed(6)
    x = torch.randn(b, l, dm, generator=gen).to(dev)
    in_w = (torch.randn(dm, 2 * h * p + 2 * g * n + h, generator=gen)
            * 0.2).to(dev)
    common = {k: v for k, v in ins.items() if k not in ("z", "xbc", "dt")}
    got = ops.mamba2_prefill(x, in_w, **common, ngroups=g, head_dim=p,
                             chunk=32)
    want = ops.mamba2_prefill(x.cpu(), in_w.cpu(),
                              **{k: v.cpu() for k, v in common.items()},
                              ngroups=g, head_dim=p, chunk=32)
    _check([t.cpu() for t in got], want, torch.float32)


def test_wrappers_refuse_bad_inputs(dev):
    ins = _inputs(dev, torch.float32, 2, None, 4, 8, 1, 16, 4, seed=1)
    with pytest.raises(ValueError, match="xbc is"):
        ds.mamba2_step(**dict(ins, xbc=ins["xbc"].bfloat16()), ngroups=1,
                       head_dim=8)
    with pytest.raises(ValueError, match="ssm_state"):
        ds.mamba2_step(**dict(ins, ssm_state=ins["ssm_state"].bfloat16()),
                       ngroups=1, head_dim=8)
    with pytest.raises(ValueError, match="conv_w must be contiguous fp32"):
        ds.mamba2_step(**dict(ins, conv_w=ins["conv_w"].bfloat16()),
                       ngroups=1, head_dim=8)
    with pytest.raises(ValueError, match="out ssm"):
        ds.mamba2_step(**ins, ngroups=1, head_dim=8,
                       out=(torch.empty_like(ins["conv_state"]),
                            ins["ssm_state"]))
    pins = _inputs(dev, torch.float32, 1, 48, 4, 8, 1, 16, 4, seed=2)
    with pytest.raises(ValueError, match="multiple"):
        pc.mamba2_prefill(**pins, ngroups=1, head_dim=8, chunk=32)


def test_kernels_write_into_out_buffers(dev):
    """Given ``out``, each kernel writes the new state into those buffers
    (the model's per-layer slices of the next cache) and returns them."""
    h, p, g, n = 4, 8, 1, 16
    ins = _inputs(dev, torch.bfloat16, 2, None, h, p, g, n, 4, seed=3)
    kw = dict(ngroups=g, head_dim=p)
    fresh = ds.mamba2_step(**ins, **kw)
    out = (torch.empty_like(ins["conv_state"]),
           torch.empty_like(ins["ssm_state"]))
    got = ds.mamba2_step(**ins, **kw, out=out)
    assert got[1] is out[0] and got[2] is out[1]
    for a, r in zip(got, fresh):
        assert torch.equal(a, r)
    pins = _inputs(dev, torch.bfloat16, 2, 64, h, p, g, n, 4, seed=4)
    fresh = pc.mamba2_prefill(**pins, **kw, chunk=32)
    out = (torch.empty_like(pins["conv_state"]),
           torch.empty_like(pins["ssm_state"]))
    got = pc.mamba2_prefill(**pins, **kw, chunk=32, out=out)
    assert got[1] is out[0] and got[2] is out[1]
    for a, r in zip(got, fresh):
        assert torch.equal(a, r)
