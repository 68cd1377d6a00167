"""Kernel 7's tensor-core body and kernel 13's strips, on the CPU.

The ``wgmma`` body of ``ssd_chunk`` runs only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).  Here:

* its split arithmetic, emulated in plain PyTorch the way the kernel
  takes it (``csrc/ssd_chunk.cu``, ``csrc/ssd_tc.cuh``): score tiles C_q
  B_k^T of 64 x 64 over n, kept in fp32 in groups of four key tiles; the
  decay exp(cs_i - cs_j), masked for j > i, on those fp32 scores; y += S x
  per key tile, each group's y added to the last; the state as (x
  exp(cs_L - cs))^T B per 64-row tile.  Every product takes each fp32
  operand as bf16 terms split by truncation (a0 = the top 16 bits of a,
  a1 = those of a - a0, ...) and sums the term products a_i b_j with i +
  j < terms in fp32.  With three terms
  (six products) it stays within ``chip_smoke.py``'s ``TOL[fp32,
  "state"]`` of ``ssd_chunk_plain``; with one bf16 term it does not,
  which pins the split;
* the wrapper's body rule (``ssd_chunk.path``) on every shape the port's
  model paths and ``chip_smoke.py`` hand kernel 7, and its head-set rule;
* kernel 13's strip rule (``cumba.strip``).
"""
import pytest
import torch

from chip_smoke import ATOL_RMS, CHAIN_B, CHAIN_C, CHUNK, D_STATE, \
    HEAD_DIM, N_GROUPS, N_HEADS, TOL
from repro_torch.configs import get_config
from repro_torch.kernels import cumba
from repro_torch.kernels import ssd_chunk as sc

TILE = 64   # csrc/ssd_tc.cuh: ROWS, the query and key rows of a tile
KG = 4      # csrc/ssd_chunk.cu: score tiles a y block holds at once


@pytest.fixture(autouse=True, scope="module")
def _warm_exp():
    """One fp32 ``torch.exp`` before the comparisons: PyTorch 2.13's CPU
    build has been seen to return values up to ~1e-4 off on the first exp
    of a process (a race in its first dispatch; the second call and every
    later one are right), which would move the plain version's decays by
    more than the tolerance this file holds the emulation to."""
    torch.exp(torch.zeros(64, 64))


def _trunc(a):
    """The top 16 bits of each fp32 value: an exact bf16, held in fp32."""
    return (a.contiguous().view(torch.int32) & -65536).view(torch.float32)


def _terms(a, terms):
    """``a`` (fp32) as ``terms`` bf16 terms split by truncation, as the
    kernel splits it (csrc/ssd_tc.cuh: split2), each held in fp32."""
    out = []
    for _ in range(terms):
        t = _trunc(a)
        out.append(t)
        a = a - t
    return out


def _product(eq, a, b, terms):
    """einsum ``eq`` of fp32 ``a`` and ``b`` as the kernel takes it: the
    sum of the bf16 term products a_i b_j with i + j < terms, in fp32."""
    ta, tb = _terms(a, terms), _terms(b, terms)
    acc = None
    for i in range(terms):
        for j in range(terms - i):
            p = torch.einsum(eq, ta[i], tb[j])
            acc = p if acc is None else acc + p
    return acc


def tensorcore_ssd(x_c, A_cum, B_c, C_c, terms):
    """Kernel 7's ``wgmma`` body in plain PyTorch (fp32 throughout)."""
    b, c, L, h, p = x_c.shape
    g, n = B_c.shape[3], B_c.shape[4]
    hpg = h // g
    x, cs = x_c.float(), A_cum.float()
    Bf, Cf = B_c.float(), C_c.float()
    y = torch.zeros(b, c, L, h, p)
    states = torch.zeros(b, c, h, p, n)
    rows = torch.arange(TILE)
    for q in range(L // TILE):
        qs = slice(q * TILE, (q + 1) * TILE)
        for k0 in range(0, q + 1, KG):
            keys = range(k0, min(k0 + KG, q + 1))
            # Score tiles of each group: (b, c, g, 64, 64) per key tile.
            S = {k: _product("bclgn,bcsgn->bcgls", Cf[:, :, qs],
                             Bf[:, :, k * TILE:(k + 1) * TILE], terms)
                 for k in keys}
            part = torch.zeros(b, c, TILE, h, p)
            for hh in range(h):
                gi = hh // hpg
                for k in keys:
                    ks = slice(k * TILE, (k + 1) * TILE)
                    seg = cs[:, hh, :, qs, None] - cs[:, hh, :, None, ks]
                    ok = (k * TILE + rows)[None, :] <= (q * TILE + rows)[:, None]
                    decay = torch.where(ok, torch.exp(torch.where(ok, seg, 0.0)),
                                        0.0)
                    sd = S[k][:, :, gi] * decay                  # (b, c, 64, 64)
                    part[:, :, :, hh] += _product(
                        "bcls,bcsp->bclp", sd, x[:, :, ks, hh], terms)
            y[:, :, qs] += part
    w = torch.exp(cs[..., -1:] - cs)                             # (b, h, c, L)
    for hh in range(h):
        gi = hh // hpg
        for lt in range(L // TILE):
            ls = slice(lt * TILE, (lt + 1) * TILE)
            xw = x[:, :, ls, hh] * w[:, hh, :, ls, None]         # (b, c, 64, p)
            states[:, :, hh] += _product("bclp,bcln->bcpn", xw,
                                         Bf[:, :, ls, gi], terms)
    return y, states


def _inputs(b, c, L, h, g, p, n, seed, scale=0.5):
    gen = torch.Generator().manual_seed(seed)
    x_c = torch.randn(b, c, L, h, p, generator=gen) * scale
    a_c = -torch.rand(b, h, c, L, generator=gen) * 0.95 - 0.05
    B_c = torch.randn(b, c, L, g, n, generator=gen) * scale
    C_c = torch.randn(b, c, L, g, n, generator=gen) * scale
    return x_c, torch.cumsum(a_c, dim=-1), B_c, C_c


def _used(got, want):
    """The largest share of its ``TOL[fp32, "state"]`` tolerance any
    element uses (chip_smoke.py's element rule)."""
    r = want.float()
    tol = TOL["float32", "state"] * (r.abs() + ATOL_RMS *
                                     r.square().mean().sqrt())
    return float(((got.float() - r).abs() / tol).max())


ARITH_CASES = [  # (label, b, c, L, h, g, p, n, scale)
    ("one tile", 1, 2, 64, 2, 1, 32, 64, 0.5),
    ("four tiles, two groups", 1, 1, 256, 4, 2, 32, 64, 0.5),
    ("eight tiles: two score groups", 1, 1, 512, 2, 1, 32, 32, 0.5),
    ("the model's p and n", 1, 1, 128, 2, 1, 64, 128, 0.5),
    ("large values", 1, 1, 256, 2, 1, 32, 64, 2.0),
]


@pytest.mark.parametrize("label,b,c,L,h,g,p,n,scale", ARITH_CASES,
                         ids=[a[0] for a in ARITH_CASES])
def test_three_bf16_terms_stay_within_the_state_tolerance(label, b, c, L, h,
                                                          g, p, n, scale):
    args = _inputs(b, c, L, h, g, p, n, seed=L + h + n, scale=scale)
    want = sc.ssd_chunk_plain(*args)
    got = tensorcore_ssd(*args, terms=3)
    for name, a, r in zip(("y", "states"), got, want):
        assert _used(a, r) <= 0.1, (label, name, _used(a, r))


@pytest.mark.parametrize("label,b,c,L,h,g,p,n,scale", ARITH_CASES[:3],
                         ids=[a[0] for a in ARITH_CASES[:3]])
def test_one_bf16_term_breaks_the_state_tolerance(label, b, c, L, h, g, p,
                                                  n, scale):
    """The textbook bf16 product (each operand rounded once) misses the
    limit many times over: the split is what keeps the fp32 function."""
    args = _inputs(b, c, L, h, g, p, n, seed=L + h + n, scale=scale)
    want = sc.ssd_chunk_plain(*args)
    got = tensorcore_ssd(*args, terms=1)
    for name, a, r in zip(("y", "states"), got, want):
        assert _used(a, r) > 10, (label, name, _used(a, r))


def test_enough_terms_give_the_plain_function():
    """With four terms the emulation is the plain version up to the order
    of its fp32 sums."""
    args = _inputs(1, 1, 128, 2, 1, 32, 64, seed=3)
    want = sc.ssd_chunk_plain(*args)
    for a, r in zip(tensorcore_ssd(*args, terms=4), want):
        assert _used(a, r) <= 0.02


# ---- the body rule --------------------------------------------------------

def _operands(b, c, L, h, g, p, n, dtype=torch.float32):
    return (torch.empty(b, c, L, h, p, dtype=dtype),
            torch.empty(b, h, c, L), torch.empty(b, c, L, g, n, dtype=dtype),
            torch.empty(b, c, L, g, n, dtype=dtype))


def _model_shapes():
    """(label, b, c, L, h, g, p, n) of every kernel-7 call on the model
    paths: ``core/ssd.py`` calls it under a ``pallas`` cumsum mode when the
    chunk is a multiple of 64: mamba2-130m's ablation forward (b = 4, l =
    300 padded to two chunks of 256) and the served prefills at 4 x 128
    (one chunk, padded to 256) and 4 x 512."""
    cfg = get_config("mamba2-130m")
    h = cfg.d_model * cfg.expand // cfg.ssm_head_dim
    out = []
    for label, b, l in (("ablation", 4, 300), ("prefill 128", 4, 128),
                        ("prefill 512", 4, 512)):
        c = -(-l // cfg.chunk_size)
        out.append((label, b, c, cfg.chunk_size, h, cfg.ssm_ngroups,
                    cfg.ssm_head_dim, cfg.d_state))
    return out


def test_model_and_chip_smoke_shapes_take_the_wgmma_body():
    shapes = _model_shapes() + [
        ("chip_smoke chain", CHAIN_B, CHAIN_C, CHUNK, N_HEADS, N_GROUPS,
         HEAD_DIM, D_STATE)]
    for label, *shape in shapes:
        assert sc.path(*_operands(*shape)) == "wgmma", label
    # bf16 streams are cast to fresh fp32 copies: the same body.
    assert sc.path(*_operands(*shapes[0][1:], dtype=torch.bfloat16)) \
        == "wgmma"


def test_reduced_and_small_shapes_take_the_simt_body():
    """The reduced configs' widths (head_dim 32, d_state 16), the card
    tests' small model (head_dim 16) and chunks that are no multiple of
    64 go to the SIMT body."""
    red = get_config("mamba2-130m", reduced=True)
    h = red.d_model * red.expand // red.ssm_head_dim
    assert sc.path(*_operands(2, 1, 64, h, red.ssm_ngroups,
                              red.ssm_head_dim, red.d_state)) == "simt"
    assert sc.path(*_operands(2, 2, 64, 8, 1, 16, 16)) == "simt"
    assert sc.path(*_operands(2, 3, 96, 4, 2, 32, 64)) == "simt"
    assert sc.path(*_operands(1, 1, 96, 4, 1, 64, 128)) == "simt"
    assert sc.path(*_operands(1, 1, 64, 4, 1, 64, 256)) == "simt"
    assert sc.path(*_operands(1, 1, 8192, 4, 1, 64, 128)) == "simt"
    assert sc.path(*_operands(1, 1, 4096, 4, 1, 64, 64)) == "wgmma"


def test_misaligned_operands_take_the_simt_body():
    x, a, B, C = _operands(1, 2, 128, 4, 1, 64, 128)
    B_off = torch.empty(B.numel() + 1)[1:].view_as(B)
    assert B_off.data_ptr() % 16 != 0
    assert sc.path(x, a, B_off, C) == "simt"
    assert sc.path(x, a, B, C) == "wgmma"


@pytest.mark.parametrize("b,c,L,h,g,want", [
    (4, 2, 256, 24, 1, 6),      # the ablation: 128 y blocks of 6 heads
    (4, 1, 256, 24, 1, 3),      # one chunk: 128 blocks of 3 heads
    (1, 2, 64, 48, 2, 1),       # few tiles: a block a head
    (1, 2, 512, 48, 2, 6),
    (16, 4, 256, 24, 1, 24),    # no set fits one wave: a group a block
])
def test_heads_per_set(b, c, L, h, g, want):
    hs = sc.heads_per_set(b, c, L, h, g)
    assert hs == want
    assert (h // g) % hs == 0
    blocks = b * c * (L // TILE) * (h // hs)
    assert blocks <= sc.SMS or hs == h // g
    smaller = [d for d in range(1, hs) if (h // g) % d == 0]
    assert all(b * c * (L // TILE) * (h // d) > sc.SMS for d in smaller)


# ---- kernel 13's strips ---------------------------------------------------

@pytest.mark.parametrize("t,want", [(1, 1), (31, 1), (32, 1), (33, 2),
                                    (64, 2), (65, 4), (255, 8), (256, 8),
                                    (300, 16), (512, 16), (1024, 16),
                                    (4097, 16)])
def test_cumsum_strip_rule(t, want):
    s = cumba.strip(t)
    assert s == want
    assert s in (1, 2, 4, 8, cumba.MAX_STRIP)
    # One pass covers the row up to the cap; longer rows take several.
    assert 32 * s >= t or s == cumba.MAX_STRIP
    assert s == 1 or 32 * (s // 2) < t
