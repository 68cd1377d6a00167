"""Kernel 2's tensor-core body and the rules of kernels 1 and 2, on the CPU.

The ``wgmma`` body of ``mamba2_prefill`` and the one-launch ``mamba2_step``
run only on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
Here:

* kernel 2's decomposition and precision, emulated in plain PyTorch the
  way the body takes them (``csrc/prefill_chunk.cu``, ``csrc/ssd_tc.cuh``):
  chunk states (x (.) dt (.) exp(cs_L - cs))^T B per 64-row tile, then the
  pass over the chunks in order, then per 64-row query tile the score
  tiles C_q B_k^T, folded with exp(cs_i - cs_j) (masked for j > i) and
  dt_j, times x_k, plus the carried-state term (C_q . state^T) exp(cs_i),
  the D skip in the stream dtype and the gated norm.  Every product takes
  each operand as bf16 terms split by truncation and sums the term
  products a_i b_j with i + j < 3: one term for the bf16-exact streams (x,
  B, C of a bf16 model), three for the folded fp32 operand and the state,
  three for every operand of an fp32 model.  It is held to the JAX
  package's ``mamba2_prefill_xla`` (the TPU kernel's reference semantics)
  under ``chip_smoke.py``'s limits, with 1-4 chunks, a nonzero incoming
  state, one and two groups, chunks of 64 and 128 and the ActiBA tables;
* the wrappers' rules: kernel 2's body rule (``prefill_chunk.path``) and
  head-set rule, kernel 1's rows-per-block rule (``step_rows``), and the
  packed argument layouts of kernels 1, 2, 3, 4, 5, 6, 9 and 12 against
  the C structs they fill;
* the plain prefill against ``chip_smoke.py``'s fp64 witness of the
  function on the card test's seed-280 inputs.
"""
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chip_smoke import ATOL_RMS, D_STATE, HEAD_DIM, N_GROUPS, N_HEADS, \
    TOL, card_case_inputs, compare, witness_prefill
from repro.core import pwl as jpwl
from repro.core.xamba import XambaConfig as JXamba
from repro.kernels import prefill_chunk as jpc
from repro_torch.configs import get_config
from repro_torch.core import pwl as tpwl
from repro_torch.core.xamba import XambaConfig as TXamba
from repro_torch.kernels import actiba, decode_step as ds
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import prefill_chunk as pc
from repro_torch.kernels.gated_norm import gated_norm_plain
from repro_torch.nn import layers

TILE = 64        # csrc/ssd_tc.cuh: ROWS, the rows of every tile
TERMS = 3        # csrc/ssd_tc.cuh: TERMS, bf16 terms of a split operand
CSRC = pathlib.Path(pc.__file__).resolve().parents[1] / "csrc"


@pytest.fixture(autouse=True, scope="module")
def _warm_exp():
    """One fp32 ``torch.exp`` before the comparisons (the first exp of a
    process has been seen to come out up to ~1e-4 off on this PyTorch CPU
    build; ``tests/test_torch_ssd_tc.py`` has the same fixture)."""
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


def _product(eq, a, ta, b, tb):
    """einsum ``eq`` of fp32 ``a`` (taken as ``ta`` terms) and ``b`` (``tb``
    terms) as the kernel takes it (ssd_tc.cuh: for_terms): the sum of the
    term products a_i b_j with i + j < TERMS, in fp32."""
    pa, pb = _terms(a, ta), _terms(b, tb)
    acc = None
    for i in range(ta):
        for j in range(tb):
            if i + j < TERMS:
                p = torch.einsum(eq, pa[i], pb[j])
                acc = p if acc is None else acc + p
    return acc


def tensorcore_prefill(z, xbc, dt, conv_state, ssm_state, conv_w, conv_b,
                       dt_bias, A, D, norm_scale, *, ngroups, head_dim, chunk,
                       eps=1e-6, silu=F.silu, softplus=F.softplus,
                       folded_terms=TERMS, stream_terms=None):
    """Kernel 2's ``wgmma`` body in plain PyTorch.  ``stream_terms``: the
    terms of x, B and C (default: 1 for bf16 streams, TERMS for fp32);
    ``folded_terms``: those of the fp32 operands (the folded scores, the
    weighted x, the state)."""
    b, l, di = z.shape
    g, p = ngroups, head_dim
    h = dt.shape[-1]
    n = (xbc.shape[-1] - di) // (2 * g)
    sd = z.dtype
    ts = stream_terms or (1 if sd == torch.bfloat16 else TERMS)
    tf = folded_terms
    L, c, hpg = chunk, l // chunk, h // g
    conv, new_tail = layers.causal_conv1d(
        {"w": conv_w, "b": conv_b}, xbc.float(), conv_state.float())
    act = silu(conv.to(sd))
    x = act[..., :di].reshape(b, l, h, p).float()
    B = act[..., di:di + g * n].reshape(b, l, g, n).float()
    C = act[..., di + g * n:].reshape(b, l, g, n).float()
    dtf = softplus(dt.float() + dt_bias.float())              # (b, l, h)
    a = dtf * A.float()
    cs = torch.cat([torch.cumsum(a[:, ci * L:(ci + 1) * L], dim=1)
                    for ci in range(c)], dim=1)               # per chunk

    # State blocks: each chunk's own state, per 64-row tile.
    chunk_states = []
    for ci in range(c):
        sl = slice(ci * L, (ci + 1) * L)
        w = dtf[:, sl] * torch.exp(cs[:, sl][:, -1:] - cs[:, sl])
        st = torch.zeros(b, h, p, n)
        for hh in range(h):
            for lt in range(L // TILE):
                rows = slice(ci * L + lt * TILE, ci * L + (lt + 1) * TILE)
                xw = x[:, rows, hh] * w[:, lt * TILE:(lt + 1) * TILE, hh, None]
                st[:, hh] += _product("blp,bln->bpn", xw, tf,
                                      B[:, rows, hh // hpg], ts)
        chunk_states.append(st)
    # The pass over the chunks in order.
    incoming, run = [], ssm_state.float()
    for ci in range(c):
        incoming.append(run)
        run = run * torch.exp(cs[:, (ci + 1) * L - 1])[..., None, None] + \
            chunk_states[ci]

    # y blocks: per query tile, the group's scores once, then each head.
    y = torch.zeros(b, l, h, p)
    idx = torch.arange(TILE)
    for ci in range(c):
        for q in range(L // TILE):
            q0 = ci * L + q * TILE
            qs = slice(q0, q0 + TILE)
            for gi in range(g):
                S = [_product("bln,bsn->bls", C[:, qs, gi], ts,
                              B[:, ci * L + k * TILE:ci * L + (k + 1) * TILE,
                                gi], ts) for k in range(q + 1)]
                for hh in range(gi * hpg, (gi + 1) * hpg):
                    yo = _product("bln,bpn->blp", C[:, qs, gi], ts,
                                  incoming[ci][:, hh], tf)
                    yo = yo * torch.exp(cs[:, qs, hh])[..., None]
                    for k in range(q + 1):
                        k0 = ci * L + k * TILE
                        ks = slice(k0, k0 + TILE)
                        seg = cs[:, qs, hh, None] - cs[:, None, ks, hh]
                        ok = (k0 + idx)[None, :] <= (q0 + idx)[:, None]
                        decay = torch.where(
                            ok, torch.exp(torch.where(ok, seg, 0.0)), 0.0)
                        folded = S[k] * decay * dtf[:, None, ks, hh]
                        yo = yo + _product("bls,bsp->blp", folded, tf,
                                           x[:, ks, hh], ts)
                    y[:, qs, hh] = yo
    # The D skip in the stream dtype, then the norm (round_stream).
    y = y.to(sd) + x.to(sd) * D.to(sd)[None, None, :, None]
    out = gated_norm_plain(y.reshape(b, l, di), z, norm_scale,
                           round_stream=True, eps=eps, silu=silu)
    return out, new_tail.to(conv_state.dtype), run


def _inputs(rng, b, l, h, p, g, n, w=4):
    di = h * p
    dxbc = di + 2 * g * n
    r = lambda *s: rng.normal(size=s).astype(np.float32)    # noqa: E731
    return dict(
        z=r(b, l, di), xbc=r(b, l, dxbc), dt=r(b, l, h),
        conv_state=r(b, w - 1, dxbc), ssm_state=r(b, h, p, n) * 0.1,
        conv_w=r(w, dxbc) * 0.3, conv_b=r(dxbc) * 0.1, dt_bias=r(h) * 0.1,
        A=-np.exp(r(h) * 0.3), D=r(h) * 0.2,
        norm_scale=np.abs(r(di)) + 0.5)


STREAMS = ("z", "xbc", "dt", "conv_state")


def _fp32_inside(fn):
    """``fn`` computed in fp32 and rounded once to its input's dtype, as
    PyTorch's SiLU and softplus take a bf16 tensor (XLA's CPU rounds each
    step of them to bf16, which moves most of a bf16 output by a step)."""
    return lambda v: fn(v.astype(jnp.float32)).astype(v.dtype)


def _jax(ins, dtype, chunk, g, p, actiba):
    """``mamba2_prefill_xla`` on the CPU, the streams in ``dtype``, with
    the exact activations taken as the port takes them (``_fp32_inside``)
    or the ActiBA tables."""
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jins = {k: jnp.asarray(v, jd if k in STREAMS else jnp.float32)
            for k, v in ins.items()}
    if actiba:
        acts = {k: jpwl.activation(k, JXamba.pallas())
                for k in ("silu", "softplus")}
    else:
        acts = dict(silu=_fp32_inside(jax.nn.silu),
                    softplus=_fp32_inside(jax.nn.softplus))
    out = jpc.mamba2_prefill_xla(**jins, ngroups=g, head_dim=p, chunk=chunk,
                                 **acts)
    return tuple(torch.from_numpy(np.array(o, np.float32)).to(
        torch.float32 if i == 2 else dtype) for i, o in enumerate(out))


def _torch(ins, dtype):
    return {k: torch.from_numpy(v).to(dtype if k in STREAMS else
                                      torch.float32) for k, v in ins.items()}


def _acts(actiba):
    tx = TXamba.pallas() if actiba else None
    return dict(silu=tpwl.activation("silu", tx),
                softplus=tpwl.activation("softplus", tx))


# (label, b, l, chunk, g, actiba); h 4 heads of 64, d_state 64 (shapes the
# wgmma body takes), a nonzero incoming state in every case.
EMU_CASES = [
    ("one chunk of 64", 2, 64, 64, 1, False),
    ("one chunk of 128, two groups", 2, 128, 128, 2, False),
    ("two chunks of 64", 1, 128, 64, 1, False),
    ("three chunks of 64, two groups", 1, 192, 64, 2, False),
    ("four chunks of 64", 1, 256, 64, 1, False),
    ("two chunks of 128", 1, 256, 128, 2, False),
    ("one chunk of 128, ActiBA", 2, 128, 128, 1, True),
    ("two chunks of 64, ActiBA", 1, 128, 64, 2, True),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("label,b,l,chunk,g,actiba", EMU_CASES,
                         ids=[c[0] for c in EMU_CASES])
def test_tensorcore_prefill_matches_jax(label, b, l, chunk, g, actiba,
                                        dtype):
    """The emulated body against the JAX reference under chip_smoke.py's
    limits (rtol 1e-4 fp32, 2^-7 bf16 streams; at most 0.5% of a bf16
    output's elements off)."""
    h, p, n = 4, 64, 64
    ins = _inputs(np.random.default_rng(l + chunk + g), b, l, h, p, g, n)
    want = _jax(ins, dtype, chunk, g, p, actiba)
    got = tensorcore_prefill(**_torch(ins, dtype), ngroups=g, head_dim=p,
                             chunk=chunk, **_acts(actiba))
    dn = str(dtype).split(".")[-1]
    _, fails = compare(label, got, want, dn)
    assert not fails, fails


def test_bf16_exact_values_split_into_one_term():
    """An exact bf16 value (the bf16 model's x, B and C) split as the
    kernel splits it leaves its second and third terms zero: its one bf16
    product is exact.  An fp32 value in general does not."""
    gen = torch.Generator().manual_seed(0)
    v = torch.randn(4096, generator=gen)
    exact = v.to(torch.bfloat16).float()
    t = _terms(exact, TERMS)
    assert torch.equal(t[0], exact)
    assert not t[1].any() and not t[2].any()
    t = _terms(v, TERMS)
    assert t[1].abs().sum() > 0 and torch.equal(t[0] + t[1] + t[2], v)


def test_fp32_streams_need_the_split():
    """With fp32 streams taken as one bf16 term (the rule that serves bf16
    streams) the fp32 function is lost many times over the limit: fp32
    streams take three terms, six products."""
    b, l, h, p, g, n, chunk = 1, 128, 2, 64, 1, 64, 64
    ins = _inputs(np.random.default_rng(3), b, l, h, p, g, n)
    want = _jax(ins, torch.float32, chunk, g, p, False)
    tins = _torch(ins, torch.float32)
    kw = dict(ngroups=g, head_dim=p, chunk=chunk)
    _, fails = compare("one term", tensorcore_prefill(**tins, **kw,
                                                      stream_terms=1),
                       want, "float32")
    assert fails
    _, fails = compare("one folded term", tensorcore_prefill(
        **tins, **kw, folded_terms=1), want, "float32")
    assert fails


# ---- the rules ------------------------------------------------------------

def _prefill_operands(b, l, h, p, g, n, dtype=torch.bfloat16):
    """xbc as the model hands it over (a view of one in_proj output) and
    the incoming state."""
    di = h * p
    zxbcdt = torch.empty(b, l, 2 * di + 2 * g * n + h, dtype=dtype)
    xbc = zxbcdt[..., di:2 * di + 2 * g * n]
    return xbc, torch.empty(b, h, p, n)


def test_serve_shapes_take_the_wgmma_body():
    """mamba2-130m's serve calls: the wave engine's l = 128 bucket (chunk
    128), the continuous engine's chunks of 64, longer prompts at chunk 256
    (l = 512), in bf16 and fp32 (the parity phases)."""
    cfg = get_config("mamba2-130m")
    h = cfg.d_model * cfg.expand // cfg.ssm_head_dim
    assert (h, cfg.ssm_head_dim, cfg.ssm_ngroups, cfg.d_state) == \
        (N_HEADS, HEAD_DIM, N_GROUPS, D_STATE)
    for dtype in (torch.bfloat16, torch.float32):
        for b, l in ((4, 128), (4, 64), (1, 64), (4, 512)):
            chunk = min(cfg.chunk_size, l)
            xbc, st = _prefill_operands(b, l, h, cfg.ssm_head_dim,
                                        cfg.ssm_ngroups, cfg.d_state, dtype)
            assert pc.path(xbc, st, chunk=chunk,
                           head_dim=cfg.ssm_head_dim) == "wgmma", (b, l)


def test_other_shapes_take_the_simt_body():
    """The reduced config's widths, chunks that are no multiple of 64 or
    past 256, d_state 256 and a misaligned incoming state go to the SIMT
    body."""
    red = get_config("mamba2-130m", reduced=True)
    h = red.d_model * red.expand // red.ssm_head_dim
    xbc, st = _prefill_operands(2, 64, h, red.ssm_head_dim, red.ssm_ngroups,
                                red.d_state)
    assert pc.path(xbc, st, chunk=64, head_dim=red.ssm_head_dim) == "simt"
    xbc, st = _prefill_operands(2, 96, 4, 64, 1, 128)
    assert pc.path(xbc, st, chunk=32, head_dim=64) == "simt"
    assert pc.path(xbc, st, chunk=96, head_dim=64) == "simt"
    xbc, st = _prefill_operands(1, 512, 4, 64, 1, 128)
    assert pc.path(xbc, st, chunk=512, head_dim=64) == "simt"
    assert pc.path(xbc, st, chunk=256, head_dim=64) == "wgmma"
    xbc, st = _prefill_operands(1, 64, 4, 64, 1, 256)
    assert pc.path(xbc, st, chunk=64, head_dim=64) == "simt"
    xbc, st = _prefill_operands(1, 64, 4, 32, 1, 128)
    assert pc.path(xbc, st, chunk=64, head_dim=32) == "simt"
    xbc, st = _prefill_operands(1, 64, 4, 64, 1, 128)
    off = torch.empty(st.numel() + 1)[1:].view_as(st)
    assert off.data_ptr() % 16 != 0
    assert pc.path(xbc, off, chunk=64, head_dim=64) == "simt"
    assert pc.path(xbc, st, chunk=64, head_dim=64) == "wgmma"


@pytest.mark.parametrize("b,c,L,h,g,want", [
    (4, 1, 128, 24, 1, 2),     # the wave serve: 96 y blocks of 2 heads + 96
    (4, 1, 64, 24, 1, 1),      # the continuous chunks: 96 + 96
    (1, 1, 128, 24, 1, 1),
    (4, 2, 256, 24, 1, 3),     # two chunks: the y blocks launch alone
    (2, 1, 128, 8, 2, 1),
    (32, 1, 256, 24, 1, 24),   # no set fits one wave: a group a block
])
def test_prefill_heads_per_set(b, c, L, h, g, want):
    hs = pc.heads_per_set(b, c, L, h, g)
    assert hs == want
    assert (h // g) % hs == 0
    beside = b * h if c == 1 else 0

    def blocks(d):
        return b * c * (L // TILE) * (h // d) + beside
    assert blocks(hs) <= pc.WAVE or hs == h // g
    assert all(blocks(d) > pc.WAVE for d in range(1, hs) if (h // g) % d == 0)


@pytest.mark.parametrize("p,want", [(64, 16), (8, 8), (16, 16), (40, 10),
                                    (36, 12), (7, 7), (1, 1), (128, 16)])
def test_step_rows(p, want):
    """Kernel 1's rows a block: the largest divisor of p up to MAX_ROWS
    (8 warps, a warp two rows).  At mamba2-130m's widths, b = 4: 384
    blocks of 256 threads, within one wave."""
    r = ds.step_rows(p)
    assert r == want and p % r == 0 and r <= ds.MAX_ROWS
    assert 4 * N_HEADS * (HEAD_DIM // ds.step_rows(HEAD_DIM)) == 384


def _c_struct(source, name):
    """(field names, their C types) of ``struct name`` in ``source``."""
    text = (CSRC / source).read_text()
    body = re.search(r"struct %s \{(.*?)\};" % name, text, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names, types = [], []
    for decl in body.split(";"):
        parts = [x.strip() for x in decl.split(",") if x.strip()]
        if not parts:
            continue
        first = re.findall(r"[\w*]+", parts[0].replace("*", " * "))
        typ = " ".join(first[:-1])
        for part in [first[-1]] + [re.findall(r"\w+", x)[-1]
                                   for x in parts[1:]]:
            names.append(part)
            types.append(typ)
    return names, types


@pytest.mark.parametrize("source,name,fields,packer", [
    ("decode_step.cu", "StepArgs", ds.STEP_FIELDS, ds._STEP_ARGS),
    ("prefill_chunk.cu", "PrefillArgs", pc.PREFILL_FIELDS,
     pc._PREFILL_ARGS),
    ("mamba1_step.cu", "M1Args", ds.M1_FIELDS, ds._M1_ARGS),
    ("rglru_step.cu", "RgArgs", ds.RG_FIELDS, ds._RG_ARGS),
    ("decode_step.cu", "SsdArgs", ds.SSD_FIELDS, ds._SSD_ARGS),
    ("actiba.cu", "PwlLaunch", actiba.PWL_FIELDS, actiba._PWL_ARGS),
    ("mamba1_step.cu", "SscanArgs", ds.SSCAN_FIELDS, ds._SSCAN_ARGS),
    ("flash_attention.cu", "FlashArgs", fa.FLASH_FIELDS, fa._FLASH_ARGS)],
    ids=["kernel 1", "kernel 2", "kernel 5", "kernel 6", "kernel 3",
         "kernel 12", "kernel 4", "kernel 9"])
def test_packed_arguments_match_the_c_struct(source, name, fields, packer):
    """Each launcher's one packed buffer: the fields in the C struct's
    order, 8 bytes each (int64_t, a pointer or a double: eps, scale)."""
    names, types = _c_struct(source, name)
    assert tuple(names) == tuple(fields)
    assert packer.size == 8 * len(fields)
    fmt = packer.format if isinstance(packer.format, str) else \
        packer.format.decode()
    for f, t, code in zip(names, types, fmt.lstrip("<")):
        assert t in ("int64_t", "double", "void *", "const void *"), (f, t)
        assert code == ("d" if t == "double" else "q"), (f, t, code)


def _triangular_cumsum(a, dim):
    """An inclusive prefix sum over dim 1 as CumBA's triangular product
    (the JAX package's form, summed in the matmul's order)."""
    assert dim == 1
    L = a.shape[1]
    return torch.einsum("ls,bsh->blh", torch.ones(L, L).tril(), a)


@pytest.mark.parametrize("form", ["serial", "triangular"])
def test_plain_prefill_against_the_fp64_witness_on_the_card_case(
        monkeypatch, form):
    """Kernel 2's reference on the card test's seed-280 inputs (bf16; the
    wave serve's call: b 4, one chunk of 128, 24 heads): the plain version
    with either form of its prefix sums, the serial ``torch.cumsum`` (the
    kernels' order) or the triangular product, stays within 1.25 of
    ``chip_smoke.py``'s element-wise limit from an fp64 witness of the
    function (``witness_prefill``), and fewer than 0.1% of its elements
    differ from it at all.  Which side of the limit the worst element
    falls on depends on the order of the prefix sums (PERF.md,
    Findings), so the bound is set with margin over both forms."""
    if form == "triangular":
        monkeypatch.setattr(torch, "cumsum", _triangular_cumsum)
    ins = card_case_inputs("cpu", torch.bfloat16, 4, 128, 24, 64, 1, 128, 4,
                           seed=280)
    want, _ = witness_prefill(ins, ngroups=1, head_dim=64)
    got = pc.mamba2_prefill_plain(**ins, ngroups=1, head_dim=64,
                                  chunk=128)[0]
    r = want.float()
    diff = (got.float() - r).abs()
    used = diff / (TOL["bfloat16", "stream"] * (
        r.abs() + ATOL_RMS * r.square().mean().sqrt()))
    assert float(used.max()) < 1.25
    assert int((diff > 0).sum()) < 0.001 * diff.numel()
