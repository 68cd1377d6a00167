"""The bf16 tensor-core bodies of kernels 9 and 11, on the CPU.

The ``wgmma`` bodies run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).  Here:

* kernel 9's P V arithmetic, emulated in plain PyTorch: S = q k^T in fp32
  (the bf16 products are exact), scaled and masked, the online softmax
  over 64-key tiles, and P V with P split into bf16 terms, summed in fp32.
  With two terms (P_hi = bf16(P), P_lo = bf16(P - P_hi)) the bf16 outputs
  that differ from ``flash_attention_plain`` stay under ``chip_smoke.py``'s
  ``MAX_OFF_SHARE``; with one bf16 P they do not, which pins the split;
* the wrappers' shape rules: which body (``gemv`` / ``wgmma`` / ``tiled``
  for kernel 11, ``wgmma`` / ``simt`` for kernel 9) each shape that
  ``chip_smoke.py`` and the model paths give them takes, from dtypes,
  shapes and alignment alone.
"""
import pytest
import torch

from chip_smoke import ATOL_RMS, FLASH_CASES, MAX_OFF_SHARE, RG_D_FF, \
    RG_W, TOL
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import matmul_pwl as mp
from repro_torch.kernels.flash_attention import NEG_INF

BK = 64   # csrc/flash_attention.cu: tc::BK, keys per tile


def _mask(lq, lk, causal, window):
    qi = torch.arange(lq)[:, None]
    ki = torch.arange(lk)[None, :]
    ok = torch.ones(lq, lk, dtype=torch.bool)
    if causal:
        ok = ok & (ki <= qi)
    if window is not None:
        ok = ok & (ki > qi - window)
    return ok


def tensorcore_flash(q, k, v, *, causal, window, terms):
    """Kernel 9's bf16 body in plain PyTorch: per 64-key tile, scores in
    fp32 times ``scale``, masked at -1e30, m_new = max(m, rowmax), p =
    exp(s - m_new), alpha = exp(m - m_new), l = l alpha + rowsum(p), acc =
    acc alpha + sum over ``terms`` bf16 terms t of t v; the drain divides
    by l (1 where l == 0)."""
    b, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, hkv, hq // hkv, lq, d)
    kf, vf = k.float(), v.float()
    ok = _mask(lq, lk, causal, window)
    m = torch.full((b, hkv, hq // hkv, lq), NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros(b, hkv, hq // hkv, lq, d)
    for k0 in range(0, lk, BK):
        s = torch.einsum("bgqld,bgkd->bgqlk", qg, kf[:, :, k0:k0 + BK])
        s = torch.where(ok[:, k0:k0 + BK], s * d ** -0.5, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None]
        for _ in range(terms):
            t = p.bfloat16().float()
            acc = acc + torch.einsum("bgqlk,bgkd->bgqld", t,
                                     vf[:, :, k0:k0 + BK])
            p = p - t
        m = m_new
    out = acc / torch.where(l == 0, 1.0, l)[..., None]
    return out.reshape(b, hq, lq, d).bfloat16()


def _qkv(b, hq, hkv, L, d, seed):
    """bf16 q, k, v as the model hands them over: (b, L, h, d) seen as (b,
    h, L, d)."""
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(b, L, h, d, generator=g).bfloat16()
                 .transpose(1, 2) for h in (hq, hkv, hkv))


def _off_share(got, want):
    assert got.dtype == want.dtype == torch.bfloat16
    return float((got != want).sum()) / got.numel()


ARITH_CASES = [  # (label, b, hq, hkv, L, d, causal, window)
    ("MQA 8x1 d256 L128", 1, 8, 1, 128, 256, True, None),
    ("MQA 8x1 d256 L300", 1, 8, 1, 300, 256, True, None),
    ("MHA 4x4 d128 L256", 1, 4, 4, 256, 128, True, None),
    ("MQA window 64", 1, 8, 1, 300, 256, True, 64),
    ("MHA window 64", 1, 4, 4, 256, 128, True, 64),
    ("MQA not causal", 1, 8, 1, 300, 256, False, None),
    ("MHA not causal", 1, 4, 4, 256, 128, False, None),
]


@pytest.mark.parametrize("label,b,hq,hkv,L,d,causal,window", ARITH_CASES,
                         ids=[c[0] for c in ARITH_CASES])
def test_two_bf16_terms_of_p_stay_under_the_off_share(label, b, hq, hkv, L,
                                                      d, causal, window):
    q, k, v = _qkv(b, hq, hkv, L, d, seed=L + d + hq)
    kw = dict(causal=causal, window=window)
    want = fa.flash_attention_plain(q, k, v, **kw)
    got = tensorcore_flash(q, k, v, **kw, terms=2)
    share = _off_share(got, want)
    assert share <= MAX_OFF_SHARE, (label, share)
    # And every element within chip_smoke.py's bf16 tolerance.
    r = want.float()
    tol = TOL["bfloat16", "stream"] * (r.abs() + ATOL_RMS *
                                       r.square().mean().sqrt())
    assert bool(((got.float() - r).abs() <= tol).all()), label


@pytest.mark.parametrize("label,b,hq,hkv,L,d,causal,window",
                         ARITH_CASES[:3], ids=[c[0] for c in ARITH_CASES[:3]])
def test_one_bf16_p_breaks_the_off_share(label, b, hq, hkv, L, d, causal,
                                         window):
    """The textbook bf16 P V (P rounded once) changes far more outputs
    than ``MAX_OFF_SHARE`` allows: the split is what keeps the function."""
    q, k, v = _qkv(b, hq, hkv, L, d, seed=L + d + hq)
    kw = dict(causal=causal, window=window)
    want = fa.flash_attention_plain(q, k, v, **kw)
    share = _off_share(tensorcore_flash(q, k, v, **kw, terms=1), want)
    assert share > 10 * MAX_OFF_SHARE, (label, share)


def test_enough_bf16_terms_of_p_give_the_plain_function():
    """With P carried in enough bf16 terms to be exact the emulation is
    the plain version up to the order of its fp32 sums."""
    q, k, v = _qkv(1, 4, 2, 200, 64, seed=5)
    kw = dict(causal=True, window=None)
    want = fa.flash_attention_plain(q, k, v, **kw)
    assert _off_share(tensorcore_flash(q, k, v, **kw, terms=4), want) \
        <= MAX_OFF_SHARE / 5


# ---- the shape rules ------------------------------------------------------

def _bf16(*shape):
    return torch.empty(shape, dtype=torch.bfloat16)


def _mlp_shapes():
    """(m, d_model, d_ff) of every kernel-11 call on the model paths:
    recurrentgemma-2b (and its reduced config) under ``pallas()``: decode
    at 4 slots, the wave prefills at 4 x 32 and 4 x 128, the chunk calls
    at 4 x 64, the loss at 2 x 256; chip_smoke.py's cases at m = 4 and
    512."""
    out = []
    for reduced in (False, True):
        cfg = get_config("recurrentgemma-2b", reduced=reduced)
        for m in (4, 128, 256, 512):
            out.append((m, cfg.d_model, cfg.d_ff))
    return out


@pytest.mark.parametrize("m,k,n", _mlp_shapes())
@pytest.mark.parametrize("gated", [False, True], ids=["pwl", "gated"])
def test_matmul_pwl_body_on_the_model_shapes(m, k, n, gated):
    x, w = _bf16(m, k), _bf16(k, n)
    v = _bf16(k, n) if gated else None
    want = "gemv" if m <= 8 else "wgmma"
    assert mp.path(x, w, v) == want
    assert mp.path(x.float(), w.float(), v.float() if gated else None) == \
        ("gemv" if m <= 8 else "tiled")


def test_matmul_pwl_body_on_chip_smokes_cases():
    for m in (4, 512):
        x, w = _bf16(m, RG_W), _bf16(RG_W, RG_D_FF)
        assert mp.path(x, w, _bf16(RG_W, RG_D_FF)) == \
            ("gemv" if m == 4 else "wgmma")


@pytest.mark.parametrize("shape,want", [
    ((9, 256, 384), "wgmma"), ((70, 200, 136), "wgmma"),
    ((70, 200, 130), "tiled"), ((70, 204, 136), "tiled"),
    ((8, 256, 384), "gemv"), ((3, 200, 333), "gemv")])
def test_matmul_pwl_body_on_ragged_shapes(shape, want):
    """k and n must be multiples of 8 (16-byte TMA strides); m <= 8 is
    the GEMV's whatever the dtype."""
    m, k, n = shape
    assert mp.path(_bf16(m, k), _bf16(k, n)) == want


def test_matmul_pwl_body_on_mixed_dtypes_and_misaligned_bases():
    x, w = _bf16(64, 256), _bf16(256, 128)
    assert mp.path(x, w) == "wgmma"
    assert mp.path(x.float(), w) == "tiled"
    assert mp.path(x, w.float()) == "tiled"
    assert mp.path(x, w, w.float()) == "tiled"
    flat = _bf16(64 * 256 + 1)
    assert mp.path(flat[1:].view(64, 256), w) == "tiled"
    flat = _bf16(256 * 128 + 8)
    assert mp.path(x, flat[8:].view(256, 128)) == "wgmma"   # 16 bytes in


def _attn_shapes():
    """(b, hq, hkv, L, d) of kernel 9's calls: chip_smoke.py's cases and
    the prefills of gemma-2b and qwen1.5-4b (and their reduced configs)
    at the wave engine's buckets and the 4096-token prompt."""
    out = [(b, hq, hkv, L, d) for _, b, hq, hkv, L, d, _, _ in FLASH_CASES]
    for arch in ("gemma-2b", "qwen1.5-4b"):
        for reduced in (False, True):
            cfg = get_config(arch, reduced=reduced)
            for b, L in ((4, 32), (4, 128), (1, 4096), (1, 512)):
                out.append((b, cfg.n_heads, cfg.n_kv_heads, L,
                            cfg.head_dim))
    return out


@pytest.mark.parametrize("b,hq,hkv,L,d", _attn_shapes())
def test_flash_attention_body_on_the_model_shapes(b, hq, hkv, L, d):
    """The (b, s, h, d) projections seen as (b, h, s, d) take the
    ``wgmma`` body in bf16; in fp32 the fp32 tensor-core body at head_dim
    64, 128 and 256 (every full-width model's) and the SIMT body at 32 (the
    reduced gemma's)."""
    q = _bf16(b, L, hq, d).transpose(1, 2)
    k, v = (_bf16(b, L, hkv, d).transpose(1, 2) for _ in range(2))
    assert fa.path(q, k, v) == "wgmma"
    assert fa.path(q.float(), k.float(), v.float()) == (
        "wgmma_fp32" if d in (64, 128, 256) else "simt")
    assert fa.path(q.contiguous(), k.contiguous(), v.contiguous()) == "wgmma"


def test_flash_attention_body_on_views_tma_cannot_read():
    q = _bf16(2, 100, 4, 64).transpose(1, 2)
    k = _bf16(2, 100, 2, 64).transpose(1, 2)
    assert fa.path(q, k, k) == "wgmma"
    flat = _bf16(q.numel() + 1)
    shifted = flat[1:].view(2, 100, 4, 64).transpose(1, 2)
    assert fa.path(shifted, k, k) == "simt"                # base + 2 bytes
    padded = _bf16(2, 100, 1, 36)[..., :32].transpose(1, 2)
    kp = _bf16(2, 100, 1, 32).transpose(1, 2)
    assert fa.path(padded, kp, kp) == "simt"               # 72-byte rows
    assert fa.path(q, k.float(), k) == "simt"


def test_flash_attention_strides_of_extent_one_axes():
    """An axis of extent 1 is never stepped: its stride, whatever it is,
    does not keep a view off the ``wgmma`` body, and the tensor maps get
    the span of the axes inside it."""
    base = _bf16(1 * 1 * 7 * 32 + 64)
    q = base.as_strided((1, 1, 7, 32), (3, 5, 32, 1))
    assert fa._tma_strides(q) == (7 * 32, 7 * 32, 32)
    assert fa.path(q, q, q) == "wgmma"
    one = base.as_strided((1, 1, 1, 32), (3, 5, 7, 1))
    assert fa._tma_strides(one) == (32, 32, 32)
    assert fa.path(one, q, q) == "wgmma"


if __name__ == "__main__":
    # The share of bf16 outputs off the plain version per number of bf16
    # terms of P (PERF.md's emulation table): from the repo root,
    # PYTHONPATH=src:. python tests/test_torch_tensorcore.py
    for label, b, hq, hkv, L, d, causal, window in ARITH_CASES:
        q, k, v = _qkv(b, hq, hkv, L, d, seed=L + d + hq)
        kw = dict(causal=causal, window=window)
        want = fa.flash_attention_plain(q, k, v, **kw)
        shares = [_off_share(tensorcore_flash(q, k, v, **kw, terms=n), want)
                  for n in (1, 2, 3)]
        print(f"{label}: " + ", ".join(f"{n} term{'s' * (n > 1)} {s:.4%}"
                                       for n, s in zip((1, 2, 3), shares)))
