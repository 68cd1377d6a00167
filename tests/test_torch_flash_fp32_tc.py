"""Kernel 9's fp32 tensor-core body and kernel 4's four-lane stream, on
the CPU.

Both CUDA bodies run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).  Here their arithmetic is emulated in plain PyTorch
fp32 and held, on the same seeded numpy inputs, to the port's plain
versions and to the JAX package (the Pallas kernels in interpret mode and
their ``kernels/ref.py`` oracles):

* kernel 9, fp32 (``csrc/flash_attention.cu``: the ``wgmma_fp32`` body):
  per 64-key tile, each warpgroup takes a unit of 64 columns of the head,
  q * scale and k each as three bf16 terms split by truncation (as
  ``csrc/ssd_tc.cuh``: split2), its partial scores the sum of the six term
  products a_i b_j, i + j <= 2, in fp32; a block's partial is its two
  units' (unit 0's plus unit 1's), the blocks' partials added in rank
  order;
  the masks at -1e30 and the online softmax; P and v as three terms each,
  P V the six term products.  Held to ``flash_attention_plain`` under
  ``chip_smoke.py``'s element-wise limit (rtol ``TOL[float32, stream]`` =
  1e-4 times |plain| + ``ATOL_RMS`` rms), and to the JAX kernel and
  ``attention_ref`` by the same rule; one bf16 term misses it, which pins
  the split.  The JAX kernel attends to its zero-padded keys when
  attention is not causal and Lk is no multiple of 128
  (``tests/test_torch_transformer.py``), so such cases hold the emulation
  to ``attention_ref`` and the plain version only;
* kernel 4 (``csrc/mamba1_step.cu``: ``sscan_step_kernel`` on kernel 5's
  state stream): four lanes a channel, lane q summing s' C over its
  elements [4 q + 16 i, 4 q + 16 i + 4) in order, the lanes met by xor
  shuffles at 1 then 2, then the D skip; held to ``sscan_step_plain``,
  the JAX kernel and ``sscan_step_ref`` within the tolerances of
  ``tests/test_torch_mamba1.py`` (fp32 within 1e-5 of the reference's
  largest magnitude, a bf16 y within one bf16 step), and its grid pinned.
"""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import ATOL_RMS, M1_D_INNER, M1_D_STATE, TOL
from repro.kernels import ops as jops, ref as jref
from repro_torch.kernels import decode_step as ds
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.flash_attention import NEG_INF
from test_torch_ssd_tc import _terms

TILE = 64     # csrc/flash_attention.cu: keys a tile, columns a unit
CSRC = pathlib.Path(fa.__file__).resolve().parents[1] / "csrc"


@pytest.fixture(autouse=True, scope="module")
def _warm_exp():
    """One fp32 ``torch.exp`` first (``tests/test_torch_ssd_tc.py``: the
    CPU build's first exp of a process has been seen to read ~1e-4 off)."""
    torch.exp(torch.zeros(64, 64))


def _t(a):
    return torch.from_numpy(np.array(np.asarray(a), copy=True))


def _split_product(eq, a, b, terms):
    """einsum ``eq`` of the term lists ``a`` and ``b``: the term products
    a_i b_j with i + j < terms, summed in fp32 in order of i, then j."""
    acc = None
    for i in range(terms):
        for j in range(terms - i):
            p = torch.einsum(eq, a[i], b[j])
            acc = p if acc is None else acc + p
    return acc


def _mask(lq, lk, causal, window):
    qi = torch.arange(lq)[:, None]
    ki = torch.arange(lk)[None, :]
    ok = torch.ones(lq, lk, dtype=torch.bool)
    if causal:
        ok = ok & (ki <= qi)
    if window is not None:
        ok = ok & (ki > qi - window)
    return ok


def fp32_tensorcore_flash(q, k, v, *, causal, window, terms=3, unit=TILE):
    """Kernel 9's fp32 tensor-core body in plain PyTorch (fp32): ``unit``
    columns of the head a warpgroup, two units a block."""
    b, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    qs = (q.float() * d ** -0.5).reshape(b, hkv, hq // hkv, lq, d)
    qt, kt, vt = (_terms(x, terms) for x in (qs, k.float(), v.float()))
    ok = _mask(lq, lk, causal, window)
    m = torch.full((b, hkv, hq // hkv, lq), NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros(b, hkv, hq // hkv, lq, d)
    for k0 in range(0, lk, TILE):
        ks = slice(k0, k0 + TILE)
        units = [_split_product("bgqld,bgkd->bgqlk",
                                [x[..., c:c + unit] for x in qt],
                                [x[:, :, ks, c:c + unit] for x in kt], terms)
                 for c in range(0, d, unit)]
        blocks = [units[i] + units[i + 1] for i in range(0, len(units), 2)
                  ] if len(units) > 1 else units
        s = blocks[0]
        for part in blocks[1:]:                  # the cluster, rank order
            s = s + part
        s = torch.where(ok[:, ks], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + _split_product(
            "bgqlk,bgkd->bgqld", _terms(p, terms), [x[:, :, ks] for x in vt],
            terms)
        m = m_new
    out = acc / torch.where(l == 0, 1.0, l)[..., None]
    return out.reshape(b, hq, lq, d)


def _qkv(b, hq, hkv, lq, lk, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=s).astype(np.float32) for s in
                 ((b, hq, lq, d), (b, hkv, lk, d), (b, hkv, lk, d)))


def _within(got, want):
    """The largest share of ``chip_smoke.py``'s element-wise fp32 limit
    that an element of ``got`` uses against ``want``."""
    r = torch.from_numpy(np.array(np.asarray(want, np.float32), copy=True))
    tol = TOL["float32", "stream"] * (r.abs() + ATOL_RMS *
                                      r.square().mean().sqrt())
    return float(((got.float() - r).abs() / tol).max())


FLASH_CASES = [  # (label, b, hq, hkv, lq, lk, d, causal, window)
    ("MQA d256 L64", 2, 8, 1, 64, 64, 256, True, None),
    ("MQA d256 L200", 1, 8, 1, 200, 200, 256, True, None),
    ("GQA d128 L100", 2, 4, 2, 100, 100, 128, True, None),
    ("MHA d64 L130", 1, 2, 2, 130, 130, 64, True, None),
    ("window 48 d128", 1, 4, 1, 200, 200, 128, True, 48),
    ("not causal d256 Lk 256", 1, 2, 1, 100, 256, 256, False, None),
    ("not causal d64 Lk 100", 1, 4, 2, 100, 100, 64, False, None),
    ("lq<lk d128", 1, 2, 2, 64, 192, 128, True, None),
]


@pytest.mark.parametrize("label,b,hq,hkv,lq,lk,d,causal,window",
                         FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_fp32_split_attention_within_the_limit(label, b, hq, hkv, lq, lk, d,
                                               causal, window):
    q, k, v = _qkv(b, hq, hkv, lq, lk, d, seed=lq + lk + d + hq)
    kw = dict(causal=causal, window=window)
    got = fp32_tensorcore_flash(*map(_t, (q, k, v)), **kw)
    wants = [fa.flash_attention_plain(*map(_t, (q, k, v)), **kw)]
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    wants.append(jref.attention_ref(jq, jk, jv, **kw))
    if causal or lk % 128 == 0:    # where the JAX kernel masks its padding
        wants.append(jops.flash_attention(jq, jk, jv, interpret=True, **kw))
    for want in wants:
        assert _within(got, want) <= 1.0, label


@pytest.mark.parametrize("label,b,hq,hkv,lq,lk,d,causal,window",
                         FLASH_CASES[:3], ids=[c[0] for c in FLASH_CASES[:3]])
def test_one_bf16_term_misses_the_limit(label, b, hq, hkv, lq, lk, d, causal,
                                        window):
    """Every operand as one truncated bf16 term (the textbook bf16 product)
    leaves the fp32 limit many times over: the three-term split is what
    keeps the fp32 function."""
    q, k, v = map(_t, _qkv(b, hq, hkv, lq, lk, d, seed=lq + lk + d + hq))
    kw = dict(causal=causal, window=window)
    want = fa.flash_attention_plain(q, k, v, **kw)
    assert _within(fp32_tensorcore_flash(q, k, v, **kw, terms=1), want) > 10


def test_rank_order_is_the_only_change_from_one_block():
    """At d = 256 the four units' partials, added as the blocks and the
    cluster add them, read within a tenth of the limit of the same split
    product taken over all 256 columns at once: the split over the head
    dimension changes only the order of fp32 sums."""
    q, k, v = map(_t, _qkv(1, 4, 1, 128, 128, 256, seed=11))
    kw = dict(causal=True, window=None)
    got = fp32_tensorcore_flash(q, k, v, **kw)
    assert _within(got, fp32_tensorcore_flash(q, k, v, **kw, unit=256)) \
        <= 0.1


@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_fp32_body_rule(d):
    """fp32 q, k, v that TMA can read take the fp32 tensor-core body at
    head_dim 64, 128 and 256 (one warpgroup a 64-column unit, clusters of
    d / 128 blocks at d = 256), the SIMT body
    at 32; a base off 16 bytes or a stride that is no multiple of 4
    elements takes the SIMT body at any head_dim."""
    q = torch.empty(2, 100, 4, d).transpose(1, 2)
    k = torch.empty(2, 100, 2, d).transpose(1, 2)
    want = "wgmma_fp32" if d in fa.FP32_HEAD_DIMS else "simt"
    assert fa.path(q, k, k) == want
    flat = torch.empty(q.numel() + 1)
    shifted = flat[1:].view(2, 100, 4, d).transpose(1, 2)
    assert fa.path(shifted, k, k) == "simt"              # base + 4 bytes
    padded = torch.empty(2, 100, 4, d + 2)[..., :d].transpose(1, 2)
    assert fa.path(padded, k, k) == "simt"               # rows 4 d + 8 bytes
    assert fa.path(q, k.bfloat16(), k) == "simt"


def test_fp32_body_cluster_fits_one_block_a_sm():
    """The fp32 body's shared memory at d = 256 (csrc/flash_attention.cu:
    tc32::Carve<2, 2>, a cluster of two blocks of two units): the ring of
    four 16 KB units, q's two units, k's and v's three 8 KB terms for each,
    two inboxes of a 64 x 64 fp32 slot for the other block and seven
    barriers, within one block's 227 KB."""
    text = (CSRC / "flash_attention.cu").read_text()
    stages = int(re.search(r"constexpr int STAGES = (\d+);\s+// ring",
                           text).group(1))
    unit, chunk = 64 * 64 * 4, 64 * 64 * 2
    smem = 1024 + stages * unit + 2 * unit + 2 * 2 * 3 * chunk + \
        2 * 1 * unit + 8 * (1 + stages + 2)
    assert stages == 4 and smem <= 232448


# ---------------------------------------------------------------------------
# kernel 4
# ---------------------------------------------------------------------------
def _constant(source: str, name: str) -> int:
    text = (CSRC / source).read_text()
    return int(re.search(rf"\b{name} = (\d+)", text).group(1))


M1_TPC = _constant("mamba1_step.cu", "M1_TPC")          # lanes a channel
SS_THREADS = _constant("mamba1_step.cu", "SS_THREADS")  # kernel 4's block


def sscan_four_lanes(state, u_t, delta_t, A, B_t, C_t, D=None):
    """``sscan_step_plain`` with kernel 4's order of the sum over n."""
    n = state.shape[-1]
    dtf = delta_t.float()
    new = state.float() * torch.exp(dtf[..., None] * A.float()[None]) + \
        (dtf * u_t.float())[..., None] * B_t.float()[:, None, :]
    prod = new * C_t.float()[:, None, :]
    parts = [torch.zeros(prod.shape[:-1]) for _ in range(M1_TPC)]
    for kk in range(n):                                 # each lane in order
        q = (kk % (4 * M1_TPC)) // 4
        parts[q] = parts[q] + prod[..., kk]
    y = (parts[0] + parts[1]) + (parts[2] + parts[3])   # xor 1, then xor 2
    if D is not None:
        y = y + u_t.float() * D.float()[None]
    return new, y.to(u_t.dtype)


def _sscan_args(rng, b, d, n, with_d):
    f = np.float32
    return [rng.normal(size=(b, d, n)).astype(f),
            rng.normal(size=(b, d)).astype(f),
            rng.uniform(0.05, 1.0, size=(b, d)).astype(f),
            -rng.uniform(0.1, 2.0, size=(d, n)).astype(f),
            rng.normal(size=(b, n)).astype(f),
            rng.normal(size=(b, n)).astype(f),
            rng.normal(size=(d,)).astype(f) if with_d else None]


def _err(got, want):
    """Max error over the reference's largest magnitude (at least 1)."""
    got = np.asarray(got.float(), np.float64)
    want = np.asarray(want.float() if isinstance(want, torch.Tensor) else
                      jnp.asarray(want, jnp.float32), np.float64)
    return float(np.abs(got - want).max()) / max(1.0,
                                                 float(np.abs(want).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_d", [True, False], ids=["D", "noD"])
@pytest.mark.parametrize("b,d,n", [(3, 200, 16), (2, 96, 8), (2, 7, 18),
                                   (1, 40, 36)])
def test_sscan_four_lanes_match_jax(b, d, n, with_d, dtype):
    """mamba-130m's n = 16 (each lane one 16-byte piece), n = 8 (two lanes
    idle), n = 18 (the element path) and n = 36 (two passes), against the
    plain version, the JAX kernel in interpret mode and its oracle."""
    args = _sscan_args(np.random.default_rng(b * d + n), b, d, n, with_d)
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    targs = [None if a is None else _t(a) for a in args]
    jargs[1] = jargs[1].astype(getattr(jnp, dtype))
    targs[1] = targs[1].to(getattr(torch, dtype))
    got = sscan_four_lanes(*targs)
    assert got[1].dtype == targs[1].dtype
    wants = (ds.sscan_step_plain(*targs), jops.sscan_step(*jargs,
                                                          interpret=True),
             jref.sscan_step_ref(*jargs))
    for want in wants:
        assert _err(got[0], want[0]) <= 1e-5
        assert _err(got[1], want[1]) <= (1e-5 if dtype == "float32"
                                         else 2.0 ** -7)


def test_sscan_four_lanes_are_the_plain_function():
    """The four-lane order changes only the order of the fp32 sum over n:
    within 1e-6 of the plain version (as kernel 5's emulation,
    ``tests/test_torch_step_cluster.py``)."""
    args = [None if a is None else _t(a).double() for a in
            _sscan_args(np.random.default_rng(5), 2, 50, 16, True)]
    for a, r in zip(sscan_four_lanes(*args), ds.sscan_step_plain(*args)):
        assert torch.allclose(a.double(), r.double(), rtol=1e-6, atol=1e-6)


def test_sscan_grid_at_mamba_130m():
    """b = 4 rows of mamba-130m's 1536 channels: four threads a channel in
    blocks of 128 (32 channels), 192 blocks, one wave of the 132 SMs."""
    assert (M1_TPC, SS_THREADS) == (4, 128)
    threads = 4 * M1_D_INNER * M1_TPC
    blocks = -(-threads // SS_THREADS)
    assert M1_D_STATE == 4 * M1_TPC and blocks == 192
    assert blocks <= 132 * (2048 // SS_THREADS)
