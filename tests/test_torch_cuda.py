"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a GPU every test here skips with a reason.  On a
machine with one: ``PYTHONPATH=src python -m pytest tests/test_torch_cuda.py
-q``.  This file imports no JAX (the GPU machine has none).  Shapes are
small and uneven (groups 2, head_dim 8 and 32, chunks that do not fill a
64-row tile); ``chip_smoke.py`` covers the full width.
"""
import pytest
import torch

from repro_torch.core import pwl
from repro_torch.core.xamba import XambaConfig
from repro_torch.kernels import actiba, cumba, decode_step as ds, ops, \
    prefill_chunk as pc, qmatmul as qm, ssd_chunk as sc
from repro_torch.nn import quant

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


def _close(a, r, rtol, name):
    assert a.dtype == r.dtype and a.shape == r.shape, name
    diff = (a.float() - r.float()).abs()
    r32 = r.float()
    tol = rtol * (r32.abs() + ATOL_RMS * r32.square().mean().sqrt())
    assert bool((diff <= tol).all()), name
    if a.dtype == torch.bfloat16:
        n_off = int((diff > 0).sum())
        assert n_off <= max(2, MAX_OFF_SHARE * diff.numel()), name


def _check(got, want, dtype):
    for name, a, r in zip(("y", "conv", "ssm"), got, want):
        _close(a, r, TOL[dtype, "state" if name == "ssm" else "stream"],
               name)


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


# Kernel 1's one launch (the gated norm fused through the row counters):
# mamba2-130m's widths at b = 4 and 1, odd widths (6 rows a block), d_state
# not a multiple of 4 (scalar loads) and past 256 (the loop past the
# prefetch).
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,p,g,n", [(4, 24, 64, 1, 128), (1, 24, 64, 1, 128),
                                       (3, 6, 36, 2, 96), (2, 4, 8, 2, 18),
                                       (1, 2, 8, 1, 320)])
def test_step_with_fused_norm_matches_plain_and_repeats(dev, dtype, b, h, p,
                                                        g, n):
    ins = _inputs(dev, dtype, b, None, h, p, g, n, 4, seed=b + h + n)
    kw = dict(ngroups=g, head_dim=p)
    before = ds.mamba2_step.launches
    got = ds.mamba2_step(**ins, **kw)
    again = ds.mamba2_step(**ins, **kw)
    torch.cuda.synchronize(dev)
    assert ds.mamba2_step.launches == before + 2
    assert all(torch.equal(a, r) for a, r in zip(got, again))
    _check(got, ds.mamba2_step_plain(**ins, **kw), dtype)


def _wgmma_prefill(dev, ins, body, **kw):
    """Kernel 2 twice on ``body`` (counted in ``path_launches``), the same
    bits both times, held to the plain version."""
    assert pc.path(ins["xbc"], ins["ssm_state"], chunk=kw["chunk"],
                   head_dim=kw["head_dim"]) == body
    before = pc.mamba2_prefill.path_launches[body]
    got = pc.mamba2_prefill(**ins, **kw)
    again = pc.mamba2_prefill(**ins, **kw)
    torch.cuda.synchronize(dev)
    assert pc.mamba2_prefill.path_launches[body] == before + 2
    assert all(torch.equal(a, r) for a, r in zip(got, again))
    return got


# Kernel 2's tensor-core body: the wave serve's call (b 4, one chunk of
# 128, mamba2-130m's widths), the continuous engine's chunks of 64, two to
# four chunks with a carried state, two and four groups, d_state 64.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,l,chunk,h,g,n", [
    (4, 128, 128, 24, 1, 128), (4, 64, 64, 24, 1, 128),
    (2, 256, 64, 8, 2, 64), (1, 512, 256, 4, 1, 128),
    (2, 192, 64, 6, 2, 128), (3, 128, 128, 4, 4, 64)])
def test_prefill_wgmma_body_matches_plain(dev, dtype, b, l, chunk, h, g, n):
    ins = _inputs(dev, dtype, b, l, h, 64, g, n, 4, seed=l + h + n)
    kw = dict(ngroups=g, head_dim=64, chunk=chunk)
    got = _wgmma_prefill(dev, ins, "wgmma", **kw)
    _check(got, pc.mamba2_prefill_plain(**ins, **kw), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_wgmma_body_with_actiba_tables(dev, dtype):
    xamba = XambaConfig.pallas()
    ins = _inputs(dev, dtype, 2, 128, 8, 64, 1, 128, 4, seed=43)
    kw = dict(ngroups=1, head_dim=64, chunk=64)
    tables = {f"{k}_table": pwl.table_for(k, xamba)
              for k in ("silu", "softplus")}
    got = _wgmma_prefill(dev, ins, "wgmma", **kw, **tables)
    plain = {k: (lambda v, t=pwl.table_for(k, xamba): pwl.eval_pwl(t, v))
             for k in ("silu", "softplus")}
    _check(got, pc.mamba2_prefill_plain(**ins, **kw, **plain), dtype)


def test_prefill_refused_shapes_take_the_simt_body(dev):
    """Shapes the tensor-core body refuses run the SIMT body, held to the
    plain version: a chunk of 32, head_dim 32 and an incoming state one
    element past a 16-byte boundary."""
    dtype = torch.bfloat16
    kw = dict(ngroups=1, head_dim=64)
    ins = _inputs(dev, dtype, 2, 128, 4, 64, 1, 128, 4, seed=50)
    got = _wgmma_prefill(dev, ins, "simt", **kw, chunk=32)
    _check(got, pc.mamba2_prefill_plain(**ins, **kw, chunk=32), dtype)
    buf = torch.empty(ins["ssm_state"].numel() + 1, device=dev)
    off = buf[1:].view_as(ins["ssm_state"])
    off.copy_(ins["ssm_state"])
    mis = dict(ins, ssm_state=off)
    got = _wgmma_prefill(dev, mis, "simt", **kw, chunk=64)
    _check(got, pc.mamba2_prefill_plain(**ins, **kw, chunk=64), dtype)
    ins = _inputs(dev, dtype, 2, 128, 4, 32, 1, 128, 4, seed=51)
    kw = dict(ngroups=1, head_dim=32, chunk=64)
    got = _wgmma_prefill(dev, ins, "simt", **kw)
    _check(got, pc.mamba2_prefill_plain(**ins, **kw), dtype)


def test_mixed_launches_repeat_bit_for_bit(dev):
    """A few hundred launches of both new bodies and the SIMT body, mixed
    (one and several chunks, bf16 and fp32, b 1 to 4: the step's row
    counters and the prefill's two block kinds), each giving the bits of
    its first call."""
    calls = []
    for dtype, b in ((torch.bfloat16, 4), (torch.float32, 1),
                     (torch.bfloat16, 3)):
        ins = _inputs(dev, dtype, b, None, 24, 64, 1, 128, 4, seed=60 + b)
        calls.append(lambda ins=ins: ds.mamba2_step(**ins, ngroups=1,
                                                    head_dim=64))
    for dtype, b, l, chunk in ((torch.bfloat16, 4, 128, 128),
                               (torch.bfloat16, 4, 64, 64),
                               (torch.float32, 2, 256, 64),
                               (torch.bfloat16, 2, 128, 32)):
        ins = _inputs(dev, dtype, b, l, 24, 64, 1, 128, 4, seed=l + chunk)
        calls.append(lambda ins=ins, chunk=chunk: pc.mamba2_prefill(
            **ins, ngroups=1, head_dim=64, chunk=chunk))
    first = [call() for call in calls]
    order = torch.randint(len(calls), (300,),
                          generator=torch.Generator().manual_seed(0))
    for i in order.tolist():
        got = calls[i]()
        assert all(torch.equal(a, r) for a, r in zip(got, first[i])), i


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,segments", [("silu", 32), ("softplus", 32),
                                           ("gelu", 8), ("sigmoid", 16),
                                           ("silu", 12), ("softplus", 100)])
def test_pwl_activate_kernel_matches_plain(dev, dtype, name, segments):
    """Same sum in the same order: fp32 bit for bit, bf16 within the
    stream tolerance (12 and 100 segments: padded to 15 and 127 terms)."""
    table = pwl.get_table(name, segments=segments)
    gen = torch.Generator().manual_seed(segments)
    x = (torch.randn(3, 37, 41, generator=gen) * 8).to(dev).to(dtype)
    before = actiba.pwl_activate.launches
    got = actiba.pwl_activate(x, table)
    assert actiba.pwl_activate.launches == before + 1
    want = actiba.pwl_activate_plain(x, table)
    if dtype == torch.float32:
        assert torch.equal(got, want)
    _close(got, want, TOL[dtype, "stream"], "pwl")


def _pwl_on(dev, x, table, body):
    """Kernel 12 on ``x``, asserting the one launch took ``body``."""
    counts = actiba.pwl_activate.path_launches
    before = dict(counts)
    assert actiba.path(x) == body
    got = actiba.pwl_activate(x, table)
    torch.cuda.synchronize(dev)
    took = {k: v - before[k] for k, v in counts.items() if v != before[k]}
    assert took == {body: 1}, took
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("numel", [1, 3, 7, 9, 4101, 8 * 1000 + 5])
def test_pwl_activate_ragged_numel_and_offset_view(dev, dtype, numel):
    """A numel that is no multiple of the vector (its tail by scalars),
    and the same values in a view offset by one element, which is not
    16-byte aligned and takes the scalar body: both give the plain
    version's output (fp32 bit for bit)."""
    table = pwl.get_table("silu", segments=32)
    gen = torch.Generator().manual_seed(numel)
    base = (torch.randn(numel + 1, generator=gen) * 8).to(dev).to(dtype)
    want = actiba.pwl_activate_plain(base[1:], table)
    for x, body in ((base[1:].clone(), "vector"), (base[1:], "scalar")):
        got = _pwl_on(dev, x, table, body)
        if dtype == torch.float32:
            assert torch.equal(got, want), body
        _close(got, want, TOL[dtype, "stream"], body)


@pytest.mark.parametrize("segments", [12, 32, 100])
def test_pwl_activate_edge_values_keep_the_plain_bits(dev, segments):
    """Zeros, infinities, NaN, +-1e30 and every breakpoint with its fp32
    neighbours, fp32, through both bodies: the plain version's bits (NaN
    where it is NaN; a zero may differ in sign only where the padding
    terms add +0)."""
    table = pwl.get_table("softplus", segments=segments)
    bps = torch.tensor(table.breakpoints, dtype=torch.float32)
    inf = torch.tensor(float("inf"))
    x = torch.cat([torch.tensor([0.0, -0.0, float("inf"), float("-inf"),
                                 float("nan"), 1e30, -1e30]),
                   torch.nextafter(bps, -inf), bps,
                   torch.nextafter(bps, inf)]).to(dev)
    want = actiba.pwl_activate_plain(x, table)
    base = torch.empty(x.numel() + 1, device=dev)
    base[1:] = x
    for xx, body in ((x, "vector"), (base[1:], "scalar")):
        got = _pwl_on(dev, xx, table, body)
        same = (got.view(torch.int32) == want.view(torch.int32)) | \
            (got.isnan() & want.isnan()) | ((got == 0) & (want == 0))
        assert bool(same.all()), body


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(5, 256), (3, 4, 300), (70,)])
def test_cumsum_kernel_matches_plain(dev, dtype, shape):
    gen = torch.Generator().manual_seed(len(shape))
    x = (-torch.rand(shape, generator=gen) * 0.2).to(dev).to(dtype)
    before = cumba.cumsum_last.launches
    got = cumba.cumsum_last(x)
    assert cumba.cumsum_last.launches == before + 1
    _close(got, cumba.cumsum_last_plain(x), TOL[dtype, "stream"], "cumsum")


# Kernel 13's strips: one element a lane (t <= 32), strips that run past
# the row (31, 33, 255, 300), whole 16-byte strips (256, 1024) and rows
# longer than one pass (4097: nine passes of 512, the last ragged).
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [1, 31, 33, 255, 256, 300, 1024, 4097])
@pytest.mark.parametrize("rows", [1, 7, 10000])
def test_cumsum_strips_match_plain(dev, dtype, t, rows):
    gen = torch.Generator().manual_seed(t + rows)
    x = (torch.randn(rows, t, generator=gen) * 0.2).to(dev).to(dtype)
    before = cumba.cumsum_last.launches
    got = cumba.cumsum_last(x)
    assert cumba.cumsum_last.launches == before + 1
    assert torch.equal(cumba.cumsum_last(x), got)
    _close(got, cumba.cumsum_last_plain(x), TOL[dtype, "stream"],
           f"cumsum t={t}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [256, 1024, 300])
def test_cumsum_unaligned_row_starts(dev, dtype, t):
    """A contiguous x whose base is one element past a 16-byte boundary:
    the strips go element by element."""
    gen = torch.Generator().manual_seed(t)
    buf = (torch.randn(33 * t + 1, generator=gen) * 0.2).to(dev).to(dtype)
    x = buf[1:].view(33, t)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    _close(cumba.cumsum_last(x), cumba.cumsum_last_plain(x),
           TOL[dtype, "stream"], f"cumsum unaligned t={t}")


def _ssd_inputs(dev, b, c, L, h, g, p, n, seed):
    gen = torch.Generator().manual_seed(seed)
    x_c = (torch.randn(b, c, L, h, p, generator=gen) * 0.3).to(dev)
    a_c = (-torch.rand(b, h, c, L, generator=gen) * 0.2).to(dev)
    B_c = (torch.randn(b, c, L, g, n, generator=gen) * 0.5).to(dev)
    C_c = (torch.randn(b, c, L, g, n, generator=gen) * 0.5).to(dev)
    return x_c, torch.cumsum(a_c, dim=-1), B_c, C_c


def _ssd_on(dev, args, body):
    """Kernel 7 twice on ``body`` (counted in ``path_launches``), the same
    bits both times, held to the plain version."""
    assert sc.path(*args) == body
    before = sc.ssd_chunk.path_launches[body]
    got = ops.ssd_chunk(*args)
    again = ops.ssd_chunk(*args)
    torch.cuda.synchronize(dev)
    assert sc.ssd_chunk.path_launches[body] == before + 2
    assert all(torch.equal(a, r) for a, r in zip(got, again))
    want = sc.ssd_chunk_plain(*args)
    for name, a, r in zip(("y", "states"), got, want):
        _close(a, r, TOL[torch.float32, "state"], name)


@pytest.mark.parametrize("g,L", [(1, 64), (2, 96), (1, 256)])
def test_ssd_chunk_kernel_matches_plain(dev, g, L):
    """Chunks of one, one and a half and four 64-row tiles (head_dim 32:
    the SIMT body)."""
    args = _ssd_inputs(dev, 2, 3, L, 4, g, 32, 64, seed=L + g)
    before = sc.ssd_chunk.launches
    _ssd_on(dev, args, "simt")
    assert sc.ssd_chunk.launches == before + 2


# Kernel 7's tensor-core body: the ablation's shape (b 4, two chunks of
# 256, 24 heads of 64, one group of d_state 128), two groups of 1, 4 and
# 24 heads at chunks of one to eight 64-row tiles (four-tile score groups
# twice at 512), and d_state 64.
@pytest.mark.parametrize("b,c,L,h,g,n", [(4, 2, 256, 24, 1, 128)] + [
    (1, 2, L, 2 * hpg, 2, 128) for hpg in (1, 4, 24)
    for L in (64, 128, 256, 512)] + [(2, 1, 128, 8, 2, 64),
                                      (1, 2, 512, 4, 1, 64)])
def test_ssd_chunk_wgmma_body_matches_plain(dev, b, c, L, h, g, n):
    args = _ssd_inputs(dev, b, c, L, h, g, 64, n, seed=L + h + n)
    _ssd_on(dev, args, "wgmma")


def test_ssd_chunk_misaligned_or_narrow_takes_the_simt_body(dev):
    """A B view one element past a 16-byte boundary, and head_dim 32,
    take the SIMT body, each held to the plain version."""
    x_c, A_cum, B_c, C_c = _ssd_inputs(dev, 1, 2, 128, 4, 1, 64, 128, 7)
    buf = torch.empty(B_c.numel() + 1, device=dev)
    B_off = buf[1:].view_as(B_c)
    B_off.copy_(B_c)
    _ssd_on(dev, (x_c, A_cum, B_off, C_c), "simt")
    _ssd_on(dev, _ssd_inputs(dev, 1, 2, 128, 4, 1, 32, 128, 8), "simt")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_kernels_with_actiba_tables_match_plain(dev, dtype):
    """The PWL epilogue of the decode-step and prefill kernels (the
    tables through ``ops`` with ``xamba``) against the plain versions
    with the PWL activations."""
    xamba = XambaConfig.full()
    h, p, g, n = 4, 16, 2, 32
    kw = dict(ngroups=g, head_dim=p)
    plain_acts = dict(silu=lambda v: pwl.eval_pwl(pwl.table_for("silu", xamba),
                                                  v),
                      softplus=lambda v: pwl.eval_pwl(
                          pwl.table_for("softplus", xamba), v))
    ins = _inputs(dev, dtype, 3, None, h, p, g, n, 4, seed=40)
    got = ops.mamba2_decode_step(*ins.values(), **kw, xamba=xamba)
    _check(got, ds.mamba2_step_plain(**ins, **kw, **plain_acts), dtype)
    exact = ds.mamba2_step(**ins, **kw)
    assert not torch.equal(got[0], exact[0])
    pins = _inputs(dev, dtype, 2, 128, h, p, g, n, 4, seed=41)
    got = pc.mamba2_prefill(**pins, **kw, chunk=64,
                            silu_table=pwl.table_for("silu", xamba),
                            softplus_table=pwl.table_for("softplus", xamba))
    _check(got, pc.mamba2_prefill_plain(**pins, **kw, chunk=64, **plain_acts),
           dtype)


def test_pallas_forward_launches_kernels_7_12_13(dev):
    """A 2-layer model's ``forward`` under ``pallas()`` at l = 96, chunk
    64: per layer one cumsum_last, one ssd_chunk and three pwl_activate
    launches, and logits near the CPU plain path's."""
    from repro_torch.models import ModelConfig, build_model
    from repro_torch.nn.params import init_params
    cfg = ModelConfig(name="m", vocab_size=64, d_model=64, n_layers=2,
                      d_state=16, ssm_head_dim=16, chunk_size=64,
                      param_dtype="float32", xamba=XambaConfig.pallas())
    gpu, cpu = build_model(cfg, dev), build_model(cfg, "cpu")
    params = init_params(gpu.param_specs(), 0, torch.float32, "cpu")
    toks = torch.randint(1, 64, (2, 96), generator=torch.Generator()
                         .manual_seed(0))
    counters = (cumba.cumsum_last, sc.ssd_chunk, actiba.pwl_activate)
    before = [f.launches for f in counters]
    with torch.inference_mode():
        lg = gpu.forward(_to(params, dev), toks.to(dev))
        lc = cpu.forward(params, toks)
    assert [f.launches - b0 for f, b0 in zip(counters, before)] == [2, 2, 6]
    assert float((lg.cpu() - lc).abs().max()) <= 1e-3


def _qmm_inputs(dev, dtype, m, k, n, variant, seed):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(m, k, generator=gen).to(dev).to(dtype)
    qt = quant.quantize_tensor(torch.randn(k, n, generator=gen).to(dev))
    kw = dict(table=pwl.get_table("silu", segments=16)
              if variant != "plain" else None)
    if variant == "gated":
        qv = quant.quantize_tensor(torch.randn(k, n, generator=gen).to(dev))
        kw.update(qv=qv.q, vscale=qv.scale.reshape(-1))
    return x, qt.q, qt.scale.reshape(-1), kw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ["plain", "pwl", "gated"])
@pytest.mark.parametrize("m,k,n", [(3, 200, 333), (8, 1536, 768),
                                   (1, 768, 3352), (70, 200, 130)])
def test_qmatmul_kernel_matches_plain(dev, dtype, variant, m, k, n):
    """The GEMV path (m <= 8: n not a multiple of 4, split k, one row)
    and the tiled path (ragged m and n), in every form, against the plain
    version; a second call gives the same bits."""
    x, q, scale, kw = _qmm_inputs(dev, dtype, m, k, n, variant, m + k + n)
    body = qm.path(x, q, kw.get("qv"))
    assert body == ("gemv" if m <= 8 else "tiled")
    before = qm.qmatmul.launches
    paths = dict(qm.qmatmul.path_launches)
    gated = dict(qm.qmatmul.gated_launches)
    got = qm.qmatmul(x, q, scale, **kw)
    assert qm.qmatmul.launches == before + 1
    assert torch.equal(qm.qmatmul(x, q, scale, **kw), got)
    assert qm.qmatmul.path_launches[body] == paths[body] + 2
    assert qm.qmatmul.gated_launches[body] == \
        gated[body] + (2 if variant == "gated" else 0)
    _close(got, qm.qmatmul_plain(x, q, scale, **kw), TOL[dtype, "stream"],
           f"qmatmul {variant}")


def _twice_on(dev, fn, counts, body, args, kw):
    """``fn(*args, **kw)`` twice on ``body`` (by the wrapper's
    ``path_launches``); both calls give the same bits."""
    before = counts[body]
    got = fn(*args, **kw)
    again = fn(*args, **kw)
    torch.cuda.synchronize(dev)
    assert counts[body] == before + 2
    assert torch.equal(got, again)
    return got


# Kernel 10's bf16 tensor-core body at mamba2-130m's projections (k split
# over a cluster at out_proj), in every form.
@pytest.mark.parametrize("variant", ["plain", "pwl", "gated"])
@pytest.mark.parametrize("k,n", [(768, 3352), (1536, 768)],
                         ids=["in_proj", "out_proj"])
@pytest.mark.parametrize("m", [9, 256, 512])
def test_qmatmul_wgmma_body_matches_plain(dev, variant, k, n, m):
    x, q, scale, kw = _qmm_inputs(dev, torch.bfloat16, m, k, n, variant,
                                  m * 7 + k + n)
    assert qm.path(x, q, kw.get("qv")) == "wgmma"
    got = _twice_on(dev, qm.qmatmul, qm.qmatmul.path_launches, "wgmma",
                    (x, q, scale), kw)
    _close(got, qm.qmatmul_plain(x, q, scale, **kw),
           TOL[torch.bfloat16, "stream"], f"qmatmul {variant}")


# The cluster GEMV of kernels 10 and 11 at m = 1, 4, 8: 8-byte int8 rows
# (n = 3352), unaligned rows (n = 333), 16-byte rows split over a cluster
# (n = 768) and kernel 11's recurrentgemma-2b GeGLU weights.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ["plain", "gated"])
@pytest.mark.parametrize("k,n", [(768, 3352), (200, 333), (1536, 768)])
@pytest.mark.parametrize("m", [1, 4, 8])
def test_qmatmul_gemv_matches_plain(dev, dtype, variant, k, n, m):
    x, q, scale, kw = _qmm_inputs(dev, dtype, m, k, n, variant, m + k + n)
    assert qm.path(x, q, kw.get("qv")) == "gemv"
    got = _twice_on(dev, qm.qmatmul, qm.qmatmul.path_launches, "gemv",
                    (x, q, scale), kw)
    _close(got, qm.qmatmul_plain(x, q, scale, **kw), TOL[dtype, "stream"],
           f"qmatmul {variant}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gated", [False, True], ids=["pwl", "gated"])
@pytest.mark.parametrize("k,n", [(768, 3352), (200, 333), (2560, 7680)])
@pytest.mark.parametrize("m", [1, 4, 8])
def test_matmul_pwl_gemv_matches_plain(dev, dtype, gated, k, n, m):
    from repro_torch.kernels import matmul_pwl as mp
    gen = torch.Generator().manual_seed(m + k + n)
    x = torch.randn(m, k, generator=gen).to(dev).to(dtype)
    w, v = ((torch.randn(k, n, generator=gen) * k ** -0.5).to(dev).to(dtype)
            for _ in range(2))
    args = (x, w, pwl.get_table("gelu", segments=32), v if gated else None)
    assert mp.path(x, w, args[3]) == "gemv"
    got = _twice_on(dev, mp.matmul_pwl, mp.matmul_pwl.path_launches, "gemv",
                    args, {})
    _close(got, mp.matmul_pwl_plain(*args), TOL[dtype, "stream"],
           "matmul_pwl")


def test_qmatmul_refuses_bad_inputs(dev):
    x, q, scale, _ = _qmm_inputs(dev, torch.float32, 4, 64, 96, "plain", 0)
    with pytest.raises(ValueError, match="int8"):
        qm.qmatmul(x, q.float(), scale)
    with pytest.raises(ValueError, match="contiguous fp32"):
        qm.qmatmul(x, q, scale.bfloat16())
    with pytest.raises(ValueError, match="CUDA tensors"):
        qm.qmatmul(x.cpu(), q.cpu(), scale.cpu())
    with pytest.raises(ValueError, match="come together"):
        qm.qmatmul(x, q, scale, qv=q)


@pytest.mark.parametrize("mode", ["w8", "w8_pallas", "w8_pallas_interpret"])
def test_every_w8_mode_runs_the_kernel(dev, mode):
    """Whatever the backend tag, a quantized model on the card runs every
    projection through the kernel (two per layer per prefill and per
    decode step), near the CPU's plain path."""
    from repro_torch.models import ModelConfig, build_model
    from repro_torch.nn.params import init_params
    cfg = ModelConfig(name="m", vocab_size=64, d_model=64, n_layers=2,
                      d_state=16, ssm_head_dim=16, chunk_size=64,
                      param_dtype="float32").with_quant(mode)
    gpu, cpu = build_model(cfg, dev), build_model(cfg, "cpu")
    params = quant.quantize_params_for_mode(
        init_params(gpu.param_specs(), 0, torch.float32, "cpu"), mode)
    toks = torch.randint(1, 64, (2, 64), generator=torch.Generator()
                         .manual_seed(0))
    before = qm.qmatmul.launches
    with torch.inference_mode():
        gp = _to(params, dev)
        lg, cg = gpu.prefill(gp, {"tokens": toks.to(dev)},
                             gpu.init_cache(2, dtype=torch.float32))
        lg2, _ = gpu.decode_step(gp, toks[:, :1].to(dev), cg, 64)
        lc, cc = cpu.prefill(params, {"tokens": toks},
                             cpu.init_cache(2, dtype=torch.float32))
        lc2, _ = cpu.decode_step(params, toks[:, :1], cc, 64)
    assert qm.qmatmul.launches - before == 2 * 2 * cfg.n_layers
    assert float((lg.cpu() - lc).abs().max()) <= 1e-3
    assert float((lg2.cpu() - lc2).abs().max()) <= 1e-3


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    if isinstance(tree, quant.QuantTensor):
        return tree.apply(lambda a: a.to(dev))
    return tree.to(dev)


# ---------------------------------------------------------------------------
# Mamba-1: the fused step (kernel 5) and the bare updates (kernels 3, 4)
# ---------------------------------------------------------------------------
def _m1_inputs(dev, dtype, b, di, n, r, w, seed):
    """Kernel 5's operands: xs_raw and z as the two halves of one
    in_proj output (strided views), the parameters contiguous fp32."""
    gen = torch.Generator().manual_seed(seed)
    f32 = torch.float32
    rnd = lambda *s, scale=1.0, dtype=f32: (
        torch.randn(s, generator=gen) * scale).to(dev).to(dtype)
    xz = rnd(b, 2 * di, dtype=dtype)
    return dict(
        xs_raw=xz[:, :di], z=xz[:, di:], conv_state=rnd(b, w - 1, di,
                                                        dtype=dtype),
        ssm_state=rnd(b, di, n), conv_w=rnd(w, di, scale=0.3),
        conv_b=rnd(di, scale=0.1), xproj_w=rnd(di, r + 2 * n, scale=0.05),
        dtproj_w=rnd(r, di, scale=0.1), dtproj_b=rnd(di, scale=0.1),
        A=-torch.exp(torch.randn(di, n, generator=gen) * 0.5).to(dev),
        D=rnd(di))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,di,n,r", [(1, 96, 8, 6), (3, 200, 16, 13),
                                      (4, 1536, 16, 48), (2, 7, 4, 3)])
def test_mamba1_kernel_matches_plain(dev, dtype, b, di, n, r):
    """One launch a call: ragged blocks (96 and 200 channels over the
    cluster's 16 blocks, the last one short; 7 channels, so some blocks
    hold none), n not a multiple of 4 (no 16-byte loads), one row and
    several; a second call gives the same bits."""
    ins = _m1_inputs(dev, dtype, b, di, n, r, 4, seed=di + n)
    before = ds.mamba1_step.launches
    got = ds.mamba1_step(**ins, dt_rank=r)
    assert ds.mamba1_step.launches == before + 1
    again = ds.mamba1_step(**ins, dt_rank=r)
    assert all(torch.equal(a, g) for a, g in zip(again, got))
    _check(got, ds.mamba1_step_plain(**ins, dt_rank=r), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba1_kernel_with_actiba_tables_matches_plain(dev, dtype):
    xamba = XambaConfig.full()
    ins = _m1_inputs(dev, dtype, 2, 256, 16, 8, 4, seed=7)
    got = ops.mamba1_decode_step(*ins.values(), dt_rank=8, xamba=xamba)
    plain = dict(silu=lambda v: pwl.eval_pwl(pwl.table_for("silu", xamba), v),
                 softplus=lambda v: pwl.eval_pwl(
                     pwl.table_for("softplus", xamba), v))
    _check(got, ds.mamba1_step_plain(**ins, dt_rank=8, **plain), dtype)
    exact = ds.mamba1_step(**ins, dt_rank=8)
    assert not torch.equal(got[0], exact[0])


def _allocated_by(dev, call):
    """Bytes a call leaves allocated on the card (its results held)."""
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    got = call()
    torch.cuda.synchronize(dev)
    return got, torch.cuda.memory_allocated(dev) - before


def _blocks(t):
    """A tensor's bytes in the caching allocator's 512-byte blocks."""
    return -(-t.numel() * t.element_size() // 512) * 512


def test_mamba1_kernel_writes_into_out_and_refuses_bad_inputs(dev):
    """``out`` buffers take the new state, and the call allocates nothing
    but y (no scratch); bad inputs raise with their reason."""
    ins = _m1_inputs(dev, torch.bfloat16, 2, 128, 16, 8, 4, seed=8)
    fresh = ds.mamba1_step(**ins, dt_rank=8)
    out = (torch.empty_like(ins["conv_state"]),
           torch.empty_like(ins["ssm_state"]))
    got, grew = _allocated_by(dev, lambda: ds.mamba1_step(**ins, dt_rank=8,
                                                          out=out))
    assert got[1] is out[0] and got[2] is out[1]
    assert grew == _blocks(got[0])
    assert all(torch.equal(a, r) for a, r in zip(got, fresh))
    with pytest.raises(ValueError, match="xproj_w must be contiguous fp32"):
        ds.mamba1_step(**dict(ins, xproj_w=ins["xproj_w"].bfloat16()),
                       dt_rank=8)
    with pytest.raises(ValueError, match="parameter shapes"):
        ds.mamba1_step(**ins, dt_rank=7)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ds.mamba1_step(**{k: v.cpu() for k, v in ins.items()}, dt_rank=8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_d", [True, False], ids=["D", "noD"])
def test_sscan_kernel_matches_plain(dev, dtype, with_d):
    gen = torch.Generator().manual_seed(9)
    b, d, n = 3, 200, 16
    rnd = lambda *s: torch.randn(s, generator=gen).to(dev)
    args = (rnd(b, d, n), rnd(b, d).to(dtype), rnd(b, d).abs() * 0.5,
            -rnd(d, n).abs() - 0.1, rnd(b, n), rnd(b, n),
            rnd(d) if with_d else None)
    before = ds.sscan_step.launches
    got = ops.sscan_step(*args)
    assert ds.sscan_step.launches == before + 1
    assert all(torch.equal(a, g) for a, g in zip(ops.sscan_step(*args), got))
    for name, a, r in zip(("ssm", "y"), got, ds.sscan_step_plain(*args)):
        _close(a, r, TOL[dtype, "state" if name == "ssm" else "stream"], name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,p,g,n", [(4, 8, 2, 16), (6, 40, 1, 96),
                                     (24, 64, 1, 128), (4, 7, 1, 18),
                                     (6, 64, 2, 128), (2, 16, 1, 300),
                                     (2, 9, 1, 258)])
def test_ssd_step_kernel_matches_plain(dev, dtype, h, p, g, n):
    gen = torch.Generator().manual_seed(h + n)
    b = 3
    rnd = lambda *s: torch.randn(s, generator=gen).to(dev)
    args = (rnd(b, h, p, n), rnd(b, h, p).to(dtype), rnd(b, h).abs() * 0.5,
            -rnd(h).abs() - 0.1, rnd(b, g, n), rnd(b, g, n))
    before = ds.ssd_step.launches
    got = ops.ssd_step(*args)
    assert ds.ssd_step.launches == before + 1
    assert all(torch.equal(a, g) for a, g in zip(ops.ssd_step(*args), got))
    for name, a, r in zip(("ssm", "y"), got, ds.ssd_step_plain(*args)):
        _close(a, r, TOL[dtype, "state" if name == "ssm" else "stream"], name)


def test_ssd_step_unaligned_state_matches_plain(dev):
    """A state 4 bytes off 16-byte alignment (a view offset by one
    element) takes the scalar loads and stores of the same body."""
    gen = torch.Generator().manual_seed(7)
    b, h, p, n = 2, 6, 64, 128
    rnd = lambda *s: torch.randn(s, generator=gen).to(dev)
    base = rnd(b * h * p * n + 1)
    state = base[1:].view(b, h, p, n)
    assert state.data_ptr() % 16
    args = (state, rnd(b, h, p), rnd(b, h).abs() * 0.5, -rnd(h).abs() - 0.1,
            rnd(b, 1, n), rnd(b, 1, n))
    got = ops.ssd_step(*args)
    assert all(torch.equal(a, g) for a, g in zip(ops.ssd_step(*args), got))
    for name, a, r in zip(("ssm", "y"), got, ds.ssd_step_plain(*args)):
        _close(a, r, TOL[torch.float32, "state" if name == "ssm"
                         else "stream"], name)


def test_mamba1_model_on_the_card_launches_kernel_5(dev):
    """A 2-layer mamba1 model: each decode step launches kernel 5 once a
    layer, and prefill and steps sit near the CPU plain path's logits;
    ``selective_scan_decode_step`` and ``ssd_decode_step`` in ``pallas``
    mode launch kernels 4 and 3 once each."""
    from repro_torch.core import selective_scan as tsscan, ssd as tssd
    from repro_torch.models import ModelConfig, build_model
    from repro_torch.nn.params import init_params
    cfg = ModelConfig(name="m", family="mamba", vocab_size=64, d_model=64,
                      n_layers=2, d_state=16, param_dtype="float32")
    gpu, cpu = build_model(cfg, dev), build_model(cfg, "cpu")
    params = init_params(gpu.param_specs(), 0, torch.float32, "cpu")
    toks = torch.randint(1, 64, (2, 24), generator=torch.Generator()
                         .manual_seed(0))
    before = ds.mamba1_step.launches
    with torch.inference_mode():
        gp = gpu.decode_view(_to(params, dev))
        lg, cg = gpu.prefill(gp, {"tokens": toks.to(dev)},
                             gpu.init_cache(2, dtype=torch.float32))
        lc, cc = cpu.prefill(params, {"tokens": toks},
                             cpu.init_cache(2, dtype=torch.float32))
        for t in range(3):
            lg, cg = gpu.decode_step(gp, toks[:, t:t + 1].to(dev), cg, t)
            lc, cc = cpu.decode_step(params, toks[:, t:t + 1], cc, t)
            assert float((lg.cpu() - lc).abs().max()) <= 1e-3
    assert ds.mamba1_step.launches - before == 3 * cfg.n_layers
    gen = torch.Generator().manual_seed(1)
    st = torch.randn(2, 64, 16, generator=gen).to(dev)
    u, dt = torch.randn(2, 64).to(dev), torch.rand(2, 64).to(dev)
    A, B, C = -torch.rand(64, 16).to(dev), torch.randn(2, 16).to(dev), \
        torch.randn(2, 16).to(dev)
    b4 = ds.sscan_step.launches
    got = tsscan.selective_scan_decode_step(st, u, dt, A, B, C,
                                            mode="pallas")
    assert ds.sscan_step.launches == b4 + 1
    want = tsscan.selective_scan_decode_step(st, u, dt, A, B, C,
                                             mode="naive")
    assert all(float((a - r).abs().max()) <= 1e-4 for a, r in zip(got, want))
    st = torch.randn(2, 4, 8, 16).to(dev)
    b3 = ds.ssd_step.launches
    args = (st, torch.randn(2, 4, 8).to(dev), torch.rand(2, 4).to(dev),
            -torch.rand(4).to(dev), torch.randn(2, 1, 16).to(dev),
            torch.randn(2, 1, 16).to(dev))
    got = tssd.ssd_decode_step(*args, mode="pallas")
    assert ds.ssd_step.launches == b3 + 1
    want = tssd.ssd_decode_step(*args, mode="naive")
    assert all(float((a - r).abs().max()) <= 1e-4 for a, r in zip(got, want))


# ---------------------------------------------------------------------------
# recurrentgemma: kernels 6 (rglru_step), 8 (rg_lru_scan), 11 (matmul_pwl)
# ---------------------------------------------------------------------------
def _rg_inputs(dev, dtype, wdtype, b, w, seed):
    gen = torch.Generator().manual_seed(seed)
    f32 = torch.float32
    r = lambda *s, scale=1.0, dtype=dtype: (
        torch.randn(s, generator=gen) * scale).to(dev).to(dtype)
    return dict(u=r(b, w), gate=r(b, w), conv_state=r(b, 3, w),
                h_state=r(b, w, dtype=f32), conv_w=r(4, w, scale=0.5, dtype=f32),
                conv_b=r(w, scale=0.1, dtype=f32),
                rg_w=r(w, w, scale=w ** -0.5, dtype=wdtype),
                rg_b=r(w, scale=0.1, dtype=f32),
                ig_w=r(w, w, scale=w ** -0.5, dtype=wdtype),
                ig_b=r(w, scale=0.1, dtype=f32),
                lam=r(w, scale=0.5, dtype=f32))


def _rg_check(got, want, dtype):
    for name, a, r in zip(("y", "conv", "h"), got, want):
        _close(a, r, TOL[dtype, "state" if name == "h" else "stream"], name)


@pytest.mark.parametrize("weights", ["stream", "fp32"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,w", [(1, 96), (3, 200), (4, 136), (8, 256),
                                 (11, 256), (4, 2560), (11, 200)])
def test_rglru_kernel_matches_plain(dev, dtype, weights, b, w):
    """Kernel 6 at uneven widths (w not a multiple of the column group:
    8-byte and element-wise weight loads), b = 1 to 8 (one row group, one
    launch) and 11 (two), weights in the stream dtype or fp32; counted
    once a call; a second call gives the same bits."""
    wdtype = dtype if weights == "stream" else torch.float32
    ins = _rg_inputs(dev, dtype, wdtype, b, w, seed=b + w)
    before = ds.rglru_step.launches
    got = ds.rglru_step(**ins)
    assert ds.rglru_step.launches == before + 1
    assert all(torch.equal(a, g) for a, g in zip(ds.rglru_step(**ins), got))
    _rg_check(got, ds.rglru_step_plain(**ins), dtype)


@pytest.mark.parametrize("weights", ["bf16", "fp32"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_kernel_with_actiba_tables_matches_plain(dev, dtype, weights):
    """Kernel 6 under ``XambaConfig.pallas()`` through ``ops``: the
    sigmoid, softplus and gelu tables, bf16 or fp32 weights under either
    stream; ``out`` buffers receive the new state and the call allocates
    nothing but y."""
    xamba = XambaConfig.pallas()
    wdtype = torch.bfloat16 if weights == "bf16" else torch.float32
    ins = _rg_inputs(dev, dtype, wdtype, 4, 160, seed=7)
    out = (torch.empty_like(ins["conv_state"]),
           torch.empty_like(ins["h_state"]))
    fresh = ops.rglru_decode_step(*ins.values(), xamba=xamba)
    got, grew = _allocated_by(dev, lambda: ops.rglru_decode_step(
        *ins.values(), xamba=xamba, out=out))
    assert got[1] is out[0] and got[2] is out[1]
    assert grew == _blocks(got[0])
    assert all(torch.equal(a, r) for a, r in zip(fresh, got))
    want = ds.rglru_step_plain(*ins.values(), **{
        k: (lambda v, t=pwl.table_for(k, xamba): actiba.pwl_activate_plain(
            v, t)) for k in ("sigmoid", "softplus", "gelu")})
    _rg_check(got, want, dtype)
    with pytest.raises(ValueError, match="contiguous fp32"):
        ds.rglru_step(**dict(ins, lam=ins["lam"].bfloat16()))
    with pytest.raises(ValueError, match="conv_state"):
        ds.rglru_step(**dict(ins, conv_state=ins["conv_state"][:, :2]))


def test_step_kernels_5_6_mixed_launches_repeat_bit_for_bit(dev):
    """Several hundred interleaved launches of kernels 5 and 6 (both
    stream dtypes, fp32 and bf16 weights, one and two row groups, ragged
    widths, full width), each giving the bits of its first call: no state
    is carried from one call to the next."""
    calls = []
    for dtype, b, di, n, r in ((torch.bfloat16, 4, 1536, 16, 48),
                               (torch.float32, 1, 200, 16, 13),
                               (torch.bfloat16, 3, 96, 8, 6)):
        ins = _m1_inputs(dev, dtype, b, di, n, r, 4, seed=di + b)
        calls.append(lambda ins=ins, r=r: ds.mamba1_step(**ins, dt_rank=r))
    for dtype, wdtype, b, w in ((torch.bfloat16, torch.bfloat16, 4, 2560),
                                (torch.float32, torch.float32, 11, 256),
                                (torch.bfloat16, torch.float32, 8, 200)):
        ins = _rg_inputs(dev, dtype, wdtype, b, w, seed=w + b)
        calls.append(lambda ins=ins: ds.rglru_step(**ins))
    first = [call() for call in calls]
    order = torch.randint(len(calls), (400,),
                          generator=torch.Generator().manual_seed(1))
    for i in order.tolist():
        got = calls[i]()
        assert all(torch.equal(a, r) for a, r in zip(got, first[i])), i


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 37, 70), (3, 256, 300)])
def test_rg_lru_scan_kernel_matches_plain_bit_for_bit(dev, dtype, shape):
    """Kernel 8 rounds each multiply and add as its plain version does:
    the same bits, at a ragged channel count and length."""
    gen = torch.Generator().manual_seed(sum(shape))
    a = torch.rand(shape, generator=gen).to(dev).to(dtype)
    b = torch.randn(shape, generator=gen).to(dev).to(dtype)
    before = ops._rg.rg_lru_scan.launches
    got = ops.rg_lru_scan(a, b)
    assert ops._rg.rg_lru_scan.launches == before + 1
    assert torch.equal(got, ops._rg.rg_lru_scan_plain(a, b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gated", [False, True], ids=["pwl", "gated"])
@pytest.mark.parametrize("m,k,n", [(3, 200, 333), (8, 1536, 768),
                                   (70, 200, 130)])
def test_matmul_pwl_kernel_matches_plain(dev, dtype, gated, m, k, n):
    """Kernel 11 on its GEMV (m <= 8) and tiled paths, weights in the
    stream dtype; a second call gives the same bits."""
    gen = torch.Generator().manual_seed(m + k + n)
    x = torch.randn(m, k, generator=gen).to(dev).to(dtype)
    w, v = ((torch.randn(k, n, generator=gen) * k ** -0.5).to(dev).to(dtype)
            for _ in range(2))
    table = pwl.get_table("gelu", segments=32)
    args = (x, w, table, v if gated else None)
    mp = ops._mpwl
    before = mp.matmul_pwl.launches
    got = ops.matmul_pwl(*args)
    assert mp.matmul_pwl.launches == before + 1
    assert torch.equal(ops.matmul_pwl(*args), got)
    _close(got, mp.matmul_pwl_plain(*args), TOL[dtype, "stream"],
           "matmul_pwl")
    with pytest.raises(ValueError, match="like w"):
        mp.matmul_pwl(x, w, table, v.float() if dtype != torch.float32
                      else v.bfloat16())


def test_rgemma_model_on_the_card_launches_kernels_6_8_11(dev):
    """A 5-layer recurrentgemma (one group and a two-layer tail, a window
    of 8 that the decode wraps): each decode step launches kernel 6 once
    a recurrent layer; under ``pallas()`` every MLP call is kernel 11 and
    the cache-less loss runs kernel 8 once a recurrent layer; logits near
    the CPU plain path's."""
    from repro_torch.models import ModelConfig, build_model
    from repro_torch.nn.params import init_params
    base = ModelConfig(name="rg", family="recurrentgemma", vocab_size=64,
                       d_model=32, n_layers=5, n_heads=4, n_kv_heads=1,
                       head_dim=8, d_ff=96, mlp_type="geglu", lru_width=32,
                       sliding_window=8, norm_type="gemma_rmsnorm",
                       embed_scale=True, attn_logit_softcap=30.0,
                       param_dtype="float32")
    toks = torch.randint(1, 64, (2, 12), generator=torch.Generator()
                         .manual_seed(0))
    for xamba in (XambaConfig.optimized(), XambaConfig.pallas()):
        cfg = base.replace(xamba=xamba)
        gpu, cpu = build_model(cfg, dev), build_model(cfg, "cpu")
        params = init_params(gpu.param_specs(), 0, torch.float32, "cpu")
        counts = (ds.rglru_step, ops._mpwl.matmul_pwl, ops._rg.rg_lru_scan)
        before = [f.launches for f in counts]
        with torch.inference_mode():
            gp = gpu.decode_view(_to(params, dev))
            lg, cg = gpu.prefill(gp, {"tokens": toks.to(dev)},
                                 gpu.init_cache(2, 24, torch.float32))
            lc, cc = cpu.prefill(params, {"tokens": toks},
                                 cpu.init_cache(2, 24, torch.float32))
            for t in range(6):
                lg, cg = gpu.decode_step(gp, toks[:, t:t + 1].to(dev), cg,
                                         12 + t)
                lc, cc = cpu.decode_step(params, toks[:, t:t + 1], cc, 12 + t)
                assert float((lg.cpu() - lc).abs().max()) <= 1e-3
            batch = {"tokens": toks, "labels": toks}
            loss_g = gpu.loss(gp, {k: v.to(dev) for k, v in batch.items()})[0]
            loss_c = cpu.loss(params, batch)[0]
            assert abs(float(loss_g) - float(loss_c)) <= 1e-4
        got = [f.launches - b for f, b in zip(counts, before)]
        pallas = xamba.actiba
        assert got == [6 * 4, (1 + 6 + 1) * 5 if pallas else 0,
                       4 if pallas else 0], got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,lq,lk,d,causal,window", [
    (2, 4, 2, 256, 256, 64, True, None), (1, 2, 2, 128, 384, 128, True, None),
    (2, 4, 1, 200, 200, 32, True, 64), (1, 2, 2, 100, 100, 64, False, None),
    (2, 8, 1, 130, 130, 256, True, None)],
    ids=["gqa", "lq<lk", "window", "noncausal-ragged", "mqa-d256"])
def test_flash_attention_kernel_matches_plain(dev, dtype, b, hq, hkv, lq, lk,
                                              d, causal, window):
    """Kernel 9 against ``attention_ref``'s plain version (keys past Lk
    masked even when not causal), the same bits on a second call; the
    (b, s, h, d) layout ``nn/attention.py`` passes, without a copy."""
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator().manual_seed(lq + d)
    q, k, v = (torch.randn(s, generator=gen).to(dev).to(dtype) for s in
               ((b, lq, hq, d), (b, lk, hkv, d), (b, lk, hkv, d)))
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    kw = dict(causal=causal, window=window)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, **kw)
    again = fa.flash_attention(q, k, v, **kw)
    assert fa.flash_attention.launches == before + 2
    assert got.stride() == q.stride()
    torch.cuda.synchronize(dev)
    _close(got, fa.flash_attention_plain(q, k, v, **kw),
           TOL[dtype, "stream"], "out")
    assert torch.equal(got, again)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q[..., :d - 8], k[..., :d - 8], v[..., :d - 8])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2048, 2048), (1000, 300), (1, 7),
                                   (5000, 129)])
def test_reduce_rows_kernel_matches_plain(dev, dtype, shape):
    """Kernel 14 against ``torch.sum`` in fp32, at one and at many row
    splits, the same bits on a second call; through ``reduce_sum`` in
    ``pallas`` mode once a call."""
    from repro_torch.core import reduce as red
    from repro_torch.kernels import reduba
    x = torch.randn(shape, generator=torch.Generator().manual_seed(
        shape[0])).to(dev).to(dtype)
    before = reduba.reduce_rows.launches
    got = reduba.reduce_rows(x)
    assert torch.equal(got, reduba.reduce_rows(x))
    torch.cuda.synchronize(dev)
    _close(got, reduba.reduce_rows_plain(x), TOL[dtype, "stream"], "sum")
    assert torch.equal(red.reduce_sum(x, axis=0, mode="pallas"), got)
    assert reduba.reduce_rows.launches == before + 3


# The bf16 tensor-core bodies of kernels 11 (tiled) and 9: ragged and
# TMA-aligned shapes; each case checks the body the shape rule names, the
# path counter, and the same bits on a second call.
@pytest.mark.parametrize("gated", [False, True], ids=["pwl", "gated"])
@pytest.mark.parametrize("k,n", [(256, 384), (200, 136), (2560, 256),
                                 (72, 130)])
@pytest.mark.parametrize("m", [9, 64, 70, 512])
def test_matmul_pwl_wgmma_body_matches_plain(dev, gated, k, n, m):
    """bf16 x (m, k), w / v (k, n): the ``wgmma`` body where k and n are
    multiples of 8 (ragged against its 128 x 128 tiles and 64-deep k
    steps), the SIMT ``tiled`` body at n = 130."""
    from repro_torch.kernels import matmul_pwl as mp
    gen = torch.Generator().manual_seed(m * 7 + k + n)
    x = torch.randn(m, k, generator=gen).to(dev).bfloat16()
    w, v = ((torch.randn(k, n, generator=gen) * k ** -0.5).to(dev).bfloat16()
            for _ in range(2))
    table = pwl.get_table("gelu", segments=32)
    args = (x, w, table, v if gated else None)
    body = mp.path(x, w, args[3])
    assert body == ("wgmma" if n % 8 == 0 else "tiled")
    before = dict(mp.matmul_pwl.path_launches)
    got = mp.matmul_pwl(*args)
    again = mp.matmul_pwl(*args)
    torch.cuda.synchronize(dev)
    assert mp.matmul_pwl.path_launches[body] == before[body] + 2
    assert torch.equal(got, again)
    _close(got, mp.matmul_pwl_plain(*args), TOL[torch.bfloat16, "stream"],
           "matmul_pwl")


def test_matmul_pwl_fp32_and_misaligned_take_the_simt_body(dev):
    """fp32 operands and a base TMA cannot read go to the SIMT body."""
    from repro_torch.kernels import matmul_pwl as mp
    gen = torch.Generator().manual_seed(3)
    table = pwl.get_table("gelu", segments=32)
    x = torch.randn(64, 256, generator=gen).to(dev)
    w = (torch.randn(256, 128, generator=gen) * 0.06).to(dev)
    flat = torch.empty(64 * 256 + 1, device=dev, dtype=torch.bfloat16)
    xb = flat[1:].view(64, 256).copy_(x)
    for xx, ww in ((x, w), (xb, w.bfloat16())):
        assert mp.path(xx, ww) == "tiled"
        before = mp.matmul_pwl.path_launches["tiled"]
        got = mp.matmul_pwl(xx, ww, table)
        torch.cuda.synchronize(dev)
        assert mp.matmul_pwl.path_launches["tiled"] == before + 1
        _close(got, mp.matmul_pwl_plain(xx, ww, table),
               TOL[xx.dtype, "stream"], "matmul_pwl")


def _flash_case(dev, b, hq, hkv, lq, lk, d, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(s, generator=gen).to(dev).to(dtype) for s in
               ((b, lq, hq, d), (b, lk, hkv, d), (b, lk, hkv, d)))
    return tuple(t.transpose(1, 2) for t in (q, k, v))


def _flash_twice(dev, q, k, v, kw, body, dtype):
    from repro_torch.kernels import flash_attention as fa
    assert fa.path(q, k, v) == body
    before = dict(fa.flash_attention.path_launches)
    got = fa.flash_attention(q, k, v, **kw)
    again = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize(dev)
    assert fa.flash_attention.path_launches[body] == before[body] + 2
    assert got.stride() == q.stride()
    assert torch.equal(got, again)
    _close(got, fa.flash_attention_plain(q, k, v, **kw),
           TOL[dtype, "stream"], "out")


@pytest.mark.parametrize("L", [1, 100, 300, 4096])
@pytest.mark.parametrize("qpg", [1, 4, 8])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_flash_attention_wgmma_body_matches_plain(dev, d, qpg, L):
    """Kernel 9's bf16 body, causal, groups of qpg query heads per key /
    value head (b = 2 with 2 key / value heads; b = 1 with one at L =
    4096)."""
    b, hkv = (1, 1) if L == 4096 else (2, 2)
    q, k, v = _flash_case(dev, b, hkv * qpg, hkv, L, L, d, torch.bfloat16,
                          seed=d + qpg + L)
    _flash_twice(dev, q, k, v, dict(causal=True), "wgmma", torch.bfloat16)


@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("mode", ["window", "noncausal", "lq<lk"])
def test_flash_attention_wgmma_body_masks(dev, d, mode):
    """The window (64 keys at L = 300), not causal (L = 100, ragged against
    the 64-key tiles) and Lq < Lk (128 queries, 384 keys) in bf16."""
    lq, lk, kw = {"window": (300, 300, dict(causal=True, window=64)),
                  "noncausal": (100, 100, dict(causal=False)),
                  "lq<lk": (128, 384, dict(causal=True))}[mode]
    q, k, v = _flash_case(dev, 2, 8, 2, lq, lk, d, torch.bfloat16,
                          seed=d + lq)
    _flash_twice(dev, q, k, v, kw, "wgmma", torch.bfloat16)


def test_flash_attention_fp32_and_unaligned_views_take_the_simt_body(dev):
    """fp32 at head_dim 32 goes to the SIMT body, and so do an fp32 and a
    bf16 view whose base TMA cannot read (q starting one element into its
    buffer)."""
    q, k, v = _flash_case(dev, 2, 4, 2, 130, 130, 32, torch.float32, seed=9)
    _flash_twice(dev, q, k, v, dict(causal=True), "simt", torch.float32)
    q, k, v = _flash_case(dev, 2, 4, 2, 130, 130, 64, torch.float32, seed=9)
    for dtype in (torch.float32, torch.bfloat16):
        qb, kb, vb = (t.to(dtype) for t in (q, k, v))
        flat = torch.empty(qb.numel() + 1, device=dev, dtype=dtype)
        qs = flat[1:].view(2, 130, 4, 64).copy_(qb.transpose(1, 2)) \
            .transpose(1, 2)
        _flash_twice(dev, qs, kb, vb, dict(causal=True), "simt", dtype)


# Kernel 9's fp32 tensor-core body: clusters of d / 64 blocks (1, 2, 4).
@pytest.mark.parametrize("L", [1, 64, 100, 300, 1000])
@pytest.mark.parametrize("qpg", [1, 4, 8])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_attention_fp32_wgmma_body_matches_plain(dev, d, qpg, L):
    """fp32, causal, groups of qpg query heads per key / value head (b = 2
    with 2 key / value heads), ragged against the 64-row tiles; the body,
    its path counter and the same bits on a second call."""
    q, k, v = _flash_case(dev, 2, 2 * qpg, 2, L, L, d, torch.float32,
                          seed=d + qpg + L)
    _flash_twice(dev, q, k, v, dict(causal=True), "wgmma_fp32",
                 torch.float32)


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("mode", ["window", "noncausal", "lq<lk", "gemma"])
def test_flash_attention_fp32_wgmma_body_masks(dev, d, mode):
    """The window (64 keys at L = 300), not causal (L = 100), Lq < Lk (128
    queries, 384 keys) and gemma-2b's fp32 parity shape (b = 4, MQA 8 x 1,
    L = 64) in fp32."""
    b, hq, hkv, lq, lk, kw = {
        "window": (2, 8, 2, 300, 300, dict(causal=True, window=64)),
        "noncausal": (2, 8, 2, 100, 100, dict(causal=False)),
        "lq<lk": (2, 8, 2, 128, 384, dict(causal=True)),
        "gemma": (4, 8, 1, 64, 64, dict(causal=True))}[mode]
    q, k, v = _flash_case(dev, b, hq, hkv, lq, lk, d, torch.float32,
                          seed=d + lq + 3)
    _flash_twice(dev, q, k, v, kw, "wgmma_fp32", torch.float32)


@pytest.mark.parametrize("n,offset", [(16, 0), (8, 0), (18, 0), (36, 0),
                                      (16, 1)],
                         ids=["n16", "n8", "n18-scalar", "n36-two-passes",
                              "unaligned-scalar"])
def test_sscan_kernel_four_lanes_match_plain(dev, n, offset):
    """Kernel 4's four lanes a channel at mamba-130m's width (b = 4, 1536
    channels): 16-byte pieces at n = 16, 8 and 36, the element path at n
    = 18 and for a state one element off 16-byte alignment; the same bits
    on a second call."""
    gen = torch.Generator().manual_seed(n + offset)
    b, d = 4, 1536
    rnd = lambda *s: torch.randn(s, generator=gen).to(dev)
    flat = rnd(b * d * n + offset)
    state = flat[offset:].view(b, d, n)
    assert (state.data_ptr() % 16 == 0) == (offset == 0)
    for dtype in (torch.float32, torch.bfloat16):
        args = (state, rnd(b, d).to(dtype), rnd(b, d).abs() * 0.5,
                -rnd(d, n).abs() - 0.1, rnd(b, n), rnd(b, n), rnd(d))
        before = ds.sscan_step.launches
        got = ds.sscan_step(*args)
        again = ds.sscan_step(*args)
        torch.cuda.synchronize(dev)
        assert ds.sscan_step.launches == before + 2
        assert all(torch.equal(a, g) for a, g in zip(again, got))
        for name, a, r in zip(("ssm", "y"), got, ds.sscan_step_plain(*args)):
            _close(a, r, TOL[dtype, "state" if name == "ssm" else "stream"],
                   name)


# Kernel 2 on a speculative verify window (serve/continuous.py): k = 1-8
# tokens after a carried state at mamba2-130m's widths (b = 4, 24 heads of
# 64, d_state 128).  A chunk below 64 takes the SIMT body.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l", range(1, 9))
def test_prefill_verify_window_matches_plain(dev, dtype, l):
    ins = _inputs(dev, dtype, 4, l, 24, 64, 1, 128, 4, seed=300 + l)
    assert float(ins["ssm_state"].abs().max()) > 0
    kw = dict(ngroups=1, head_dim=64, chunk=l)
    got = _wgmma_prefill(dev, ins, "simt", **kw)
    _check(got, pc.mamba2_prefill_plain(**ins, **kw), dtype)


# Kernel 10 at the W8 widths of gemma-2b (d_model 2048) and
# recurrentgemma-2b (d_model 2560): the attention and RG-LRU projections
# plain, the GeGLU MLP's wi / wg in the gated form with the GeLU table
# (ActiBA under pallas()) and wo plain, at m = 4 (the GEMV: decode and
# draft steps) and m = 256 (the wgmma body: chunks), bf16.
W8_SHAPES = [("gemma q/o", 2048, 2048, False), ("gemma k/v", 2048, 256, False),
             ("gemma wi/wg", 2048, 16384, True),
             ("gemma wo", 16384, 2048, False),
             ("rgemma q/o/in", 2560, 2560, False),
             ("rgemma k/v", 2560, 256, False),
             ("rgemma wi/wg", 2560, 7680, True),
             ("rgemma wo", 7680, 2560, False)]


@pytest.mark.parametrize("m", [4, 256])
@pytest.mark.parametrize("name,k,n,gated", W8_SHAPES,
                         ids=[s[0] for s in W8_SHAPES])
def test_qmatmul_at_the_w8_transformer_shapes(dev, name, k, n, gated, m):
    gen = torch.Generator().manual_seed(k + n + m)
    x = torch.randn(m, k, generator=gen).to(dev).to(torch.bfloat16)
    qt = quant.quantize_tensor(torch.randn(k, n, generator=gen).to(dev))
    kw = {}
    if gated:
        qv = quant.quantize_tensor(torch.randn(k, n, generator=gen).to(dev))
        kw = dict(table=pwl.table_for("gelu", XambaConfig.pallas()),
                  qv=qv.q, vscale=qv.scale.reshape(-1))
    args = (x, qt.q, qt.scale.reshape(-1))
    body = "gemv" if m <= qm.GEMV_M else "wgmma"
    assert qm.path(x, qt.q, kw.get("qv")) == body
    got = _twice_on(dev, qm.qmatmul, qm.qmatmul.path_launches, body, args,
                    kw)
    _close(got, qm.qmatmul_plain(*args, **kw), TOL[torch.bfloat16, "stream"],
           f"qmatmul {name}")
