"""Kernel 12's unrolled knot walk and kernel 3's rows, on the CPU.

The two CUDA kernels run only on the card (``tests/test_torch_cuda.py``);
here what their designs rest on is emulated in plain PyTorch fp32, with
the constants read from the sources, and held to the JAX package's
functions on the same numpy inputs.

* Kernel 12 (``csrc/actiba.cu``) takes its table by value with the term
  loop unrolled for the counts of ``PwlNks``; a table of another size is
  padded to the next count with terms b = +inf, dm = 0.  Each term is
  ``y + dm * fmaxf(x - b, 0)``, rounded operation by operation; CUDA's
  ``fmaxf`` returns the other operand when one is NaN, as ``torch.fmax``
  does (``torch.clamp_min``, the plain version's, keeps the NaN).  The
  padded walk gives the unpadded one's bits (y = -0 may become +0, which
  compares equal), held here at every shipped activation on the values
  where that could fail: zeros, infinities, NaN, every breakpoint and its
  fp32 neighbours, +-1e30.
* Kernel 3 (``csrc/decode_step.cu: ssd_step_kernel``) runs on kernel 1's
  row stream: grid (p / ``step_rows(p)``, h, b), a warp on rows w and w +
  ``WARPS``, lanes along n a float4 at a time, the first ``PREFETCH``
  float4 of a lane's row in registers, the rest streamed.  The emulation
  visits every state element through that split and takes y in the
  kernel's order (a lane's running sum, then a butterfly over the warp).

Tolerances: the unrolled walk is held bit for bit (to the padded walk and
to the port's ``eval_pwl``), and within 1e-5 of the largest magnitude to
the JAX kernel in interpret mode, as ``tests/test_torch_xamba.py:
test_actiba_plain_matches_pallas_and_ref`` holds the plain version; kernel
3's order within 1e-5 of the JAX kernel and its oracle, as
``tests/test_torch_mamba1.py: test_ssd_step_plain_matches_pallas_and_ref``
holds the plain version.
"""
import math
import pathlib
import re
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pwl as jpwl
from repro.kernels import ops as jops, ref as jref
from repro_torch.core import pwl as tpwl
from repro_torch.core.xamba import XambaConfig
from repro_torch.kernels import actiba, decode_step as ds

CSRC = pathlib.Path(ds.__file__).resolve().parents[1] / "csrc"
TESTS = pathlib.Path(__file__).resolve().parent
NAMES = ("silu", "softplus", "gelu", "sigmoid")
SEGMENTS = (8, 12, 32, 100)
RTOL = 1e-5


def _constant(source: str, name: str) -> int:
    """A ``constexpr int`` of a kernel source."""
    text = (CSRC / source).read_text()
    return int(re.search(rf"\b{name} = (\d+)", text).group(1))


def _instantiated_nks():
    """The term counts ``csrc/actiba.cu`` instantiates (``PwlNks``)."""
    text = (CSRC / "actiba.cu").read_text()
    got = re.search(r"using PwlNks = NkList<([\d,\s]+)>;", text).group(1)
    return [int(v) for v in got.split(",")]


NKS = _instantiated_nks()
MAX_NK = _constant("actiba.cu", "MAX_NK")
WARPS = _constant("decode_step.cu", "WARPS")
MAX_ROWS = _constant("decode_step.cu", "MAX_ROWS")
PREFETCH = _constant("decode_step.cu", "PREFETCH")


def _t(a):
    return torch.from_numpy(np.array(np.asarray(a), copy=True))


def _err(got, want):
    return float(np.abs(np.asarray(got, np.float64) -
                        np.asarray(want, np.float64)).max())


# ---------------------------------------------------------------------------
# Kernel 12
# ---------------------------------------------------------------------------
def _next_nk(nk: int) -> int:
    """The launcher's choice: the smallest instantiated count >= nk."""
    return min(v for v in NKS if v >= nk)


def _walk(table, x: torch.Tensor, terms: int) -> torch.Tensor:
    """``csrc/actiba.cu: pwl1`` on fp32 ``x``: the table's ``nk`` terms,
    then ``terms - nk`` padding terms (b = +inf, dm = 0), each operation
    rounded to fp32, the max as CUDA's ``fmaxf``."""
    tab = torch.from_numpy(table.packed_f32())
    nk = table.num_segments - 1
    b = torch.cat([tab[:nk], torch.full((terms - nk,), math.inf)])
    dm = torch.cat([tab[nk:2 * nk], torch.zeros(terms - nk)])
    zero = torch.zeros((), dtype=torch.float32)
    y = tab[2 * nk] * x + tab[2 * nk + 1]
    for k in range(terms):
        y = y + dm[k] * torch.fmax(x - b[k], zero)
    return y


def _edge_inputs(table) -> torch.Tensor:
    """Zeros, infinities, NaN, +-1e30, every breakpoint as fp32 and its
    two fp32 neighbours, and a spread of ordinary values."""
    bps = np.asarray(table.breakpoints, np.float32)
    near = np.concatenate([np.nextafter(bps, np.float32(-np.inf)), bps,
                           np.nextafter(bps, np.float32(np.inf))])
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e30, -1e30],
                       np.float32)
    spread = np.random.default_rng(len(bps)).normal(size=257) * 8
    return torch.from_numpy(np.concatenate(
        [special, near, spread.astype(np.float32)]))


def _same_bits_or_signed_zero(padded, exact):
    """Equal bits, or both NaN, or a -0 of ``exact`` that came out +0."""
    pb, eb = padded.view(torch.int32), exact.view(torch.int32)
    zero_sign = (padded == 0) & (exact == 0)
    return (pb == eb) | (padded.isnan() & exact.isnan()) | zero_sign


@pytest.mark.parametrize("segments", SEGMENTS)
@pytest.mark.parametrize("name", NAMES)
def test_padding_terms_add_an_exact_zero(name, segments):
    """A table padded to every instantiated count above its own gives the
    unpadded walk's bits on the edge values, and the unpadded walk gives
    the port's ``eval_pwl`` bits wherever the input is not +-inf or NaN
    (there the two maxima differ on purpose, and y is inf or NaN in
    both)."""
    table = tpwl.get_table(name, segments=segments)
    nk = segments - 1
    x = _edge_inputs(table)
    exact = _walk(table, x, nk)
    for terms in [v for v in NKS if v >= nk]:
        padded = _walk(table, x, terms)
        assert bool(_same_bits_or_signed_zero(padded, exact).all()), terms
    finite = torch.isfinite(x)
    plain = tpwl.eval_pwl(table, x)
    assert torch.equal(exact[finite].view(torch.int32),
                       plain[finite].view(torch.int32))
    assert bool((exact[~finite].isnan() | torch.isinf(exact[~finite]))
                .all())


@pytest.mark.parametrize("name", NAMES)
def test_padded_walk_matches_the_jax_kernel(name):
    """The walk the kernel takes at 12 segments (padded to 15 terms)
    against the JAX Pallas kernel (interpret mode) and its oracle, on an
    uneven shape that spans both linear extensions."""
    x = (np.random.default_rng(9).normal(size=(3, 37, 50)) * 6).astype(
        np.float32)
    jt = jpwl.get_table(name, segments=12)
    tt = tpwl.get_table(name, segments=12)
    got = _walk(tt, _t(x), _next_nk(11))
    for want in (jops.actiba_activate(jnp.asarray(x), jt, interpret=True),
                 jref.pwl_activate_ref(jnp.asarray(x), jt)):
        want = np.asarray(want)
        assert _err(got, want) <= RTOL * float(np.abs(want).max())


def _segments_in_use():
    """Every table size the port's configurations and tests ask for:
    ``XambaConfig``'s defaults and each ``segments=N`` /
    ``actiba_segments=N`` in a test, with this file's own sizes."""
    used = {XambaConfig().actiba_segments, XambaConfig.full().actiba_segments,
            *SEGMENTS}
    for path in TESTS.glob("test_*.py"):
        for m in re.finditer(r"\b(?:actiba_)?segments\s*=\s*(\d+)",
                             path.read_text()):
            used.add(int(m.group(1)))
    text = (TESTS / "test_torch_cuda.py").read_text()
    for m in re.finditer(r'\("(?:%s)", (\d+)\)' % "|".join(NAMES), text):
        used.add(int(m.group(1)))
    return sorted(used)


def test_instantiated_counts_cover_every_table_in_use():
    """``PwlNks`` is ascending, ends at ``MAX_NK`` (the wrapper's
    ``MAX_SEGMENTS`` - 1), and holds every table the port uses; a larger
    table is refused before any launch."""
    assert NKS == sorted(NKS) and NKS[-1] == MAX_NK
    assert actiba.MAX_SEGMENTS == MAX_NK + 1
    used = _segments_in_use()
    assert 32 in used and 12 in used and 100 in used
    for s in used:
        assert 2 <= s <= actiba.MAX_SEGMENTS
        assert _next_nk(s - 1) - (s - 1) >= 0
    assert _next_nk(31) == 31          # the shipped K = 32: no padding
    too_big = tpwl.get_table("silu", segments=actiba.MAX_SEGMENTS + 1)
    with pytest.raises(ValueError, match="segments"):
        actiba.host_table(too_big)


def test_parameter_struct_stays_under_the_launch_limit():
    """``PwlParams<NK>``, the kernel's by-value parameter: 8-byte header
    fields and two fp32 arrays of NK plus m0 and c0; at the largest count
    it stays under the 4 KB a kernel's parameters may take."""
    text = (CSRC / "actiba.cu").read_text()
    body = re.search(r"struct PwlParams \{(.*?)\};", text, re.S).group(1)
    decls = [d.strip() for d in body.split(";") if d.strip()]
    size = 0
    for d in decls:
        m = re.fullmatch(r"float (\w+)\[NK\]", d)
        if m:
            size += 4 * MAX_NK
        elif d.startswith("float "):
            size += 4
        else:
            assert re.match(r"(const )?(void\*|int64_t) \w+", d), d
            size += 8
    assert size == 4 * 8 + 2 * 4 * MAX_NK + 2 * 4
    assert size <= 4096
    assert "__grid_constant__ PwlParams<NK>" in text


def test_host_table_is_the_packed_table_kept_per_table():
    """The launcher's ``tab`` is ``packed_f32()``'s floats at a kept
    address: the same table gives the same address, and the floats there
    are the table's."""
    import ctypes
    table = tpwl.get_table("softplus", segments=12)
    addr, nk = actiba.host_table(table)
    assert actiba.host_table(table) == (addr, nk) and nk == 11
    got = np.ctypeslib.as_array((ctypes.c_float * (2 * nk + 2))
                                .from_address(addr))
    np.testing.assert_array_equal(got, table.packed_f32())


# ---------------------------------------------------------------------------
# Kernel 3
# ---------------------------------------------------------------------------
def _lane_ks(lane: int, n: int):
    """The float4 starts a lane of a row takes: its ``PREFETCH`` in
    registers, then one every 128 elements (``rows_update``)."""
    ks = [4 * (lane + 32 * j) for j in range(PREFETCH)]
    ks += list(range(4 * (lane + 32 * PREFETCH), n, 128))
    return [k for k in ks if k < n]


def _row_split(h: int, p: int):
    """(head, row) of each state row each (block, warp) takes, in the
    kernel's order."""
    R = ds.step_rows(p)
    assert p % R == 0 and R <= MAX_ROWS
    for hi in range(h):
        for rs in range(p // R):
            for warp in range(WARPS):
                for r in range(MAX_ROWS // WARPS):
                    row = warp + WARPS * r
                    if row < R:
                        yield hi, rs * R + row


@pytest.mark.parametrize("h,p,n", [(24, 64, 128), (6, 40, 96), (4, 7, 18),
                                   (3, 17, 300), (2, 1, 16)])
def test_kernel3_rows_cover_every_state_element_once(h, p, n):
    """Every (head, row) once, and every element of a row once through
    the lanes' float4 starts (the last float4 of a ragged n cut at n)."""
    rows = Counter(_row_split(h, p))
    assert rows == Counter({(hi, r): 1 for hi in range(h)
                            for r in range(p)})
    elems = Counter(k + e for lane in range(32) for k in _lane_ks(lane, n)
                    for e in range(4) if k + e < n)
    assert elems == Counter(range(n))


def _kernel3(state, x, dt, A, B, C):
    """Kernel 3's arithmetic in its order, fp32: per element s decay +
    (dt x) B; y a lane's running sum of s' C over its elements in the
    order of its float4 starts, then the butterfly over the 32 lanes
    (``common.cuh: warp_sum``).  Every row takes the same order, so the
    rows go at once."""
    b, h, p, n = state.shape
    hpg = h // B.shape[1]
    Bh = B.repeat_interleave(hpg, dim=1)[:, :, None, :]
    Ch = C.repeat_interleave(hpg, dim=1)[:, :, None, :]
    decay = torch.exp(dt * A[None, :])[..., None, None]
    new = state * decay + (dt[..., None] * x)[..., None] * Bh
    prod = torch.cat([new * Ch, torch.zeros(b, h, p, 1)], dim=-1)
    order = [[k + e for k in _lane_ks(lane, n) for e in range(4)
              if k + e < n] for lane in range(32)]
    width = max(map(len, order))
    idx = torch.tensor([o + [n] * (width - len(o)) for o in order])
    part = torch.zeros(b, h, p, 32)
    for t in range(width):
        part = part + prod[..., idx[:, t]]
    for o in (16, 8, 4, 2, 1):
        part = part + part[..., torch.arange(32) ^ o]
    return new, part[..., 0]


@pytest.mark.parametrize("h,p,g,n", [(4, 8, 2, 16), (4, 7, 1, 18),
                                     (2, 40, 1, 300)])
def test_kernel3_order_matches_jax(h, p, g, n):
    """The kernel's order against the JAX kernel (interpret mode) and
    ``ssd_step_ref``, and against the port's plain version."""
    rng = np.random.default_rng(h * p + n)
    b = 2
    f = np.float32
    args = (rng.normal(size=(b, h, p, n)).astype(f),
            rng.normal(size=(b, h, p)).astype(f),
            rng.uniform(0.01, 1.0, size=(b, h)).astype(f),
            -rng.uniform(0.1, 2.0, size=(h,)).astype(f),
            rng.normal(size=(b, g, n)).astype(f),
            rng.normal(size=(b, g, n)).astype(f))
    got = _kernel3(*map(_t, args))
    plain = ds.ssd_step_plain(*map(_t, args))
    for want in (jops.ssd_step(*map(jnp.asarray, args), interpret=True),
                 jref.ssd_step_ref(*map(jnp.asarray, args)), plain):
        for a, r in zip(got, want):
            r = np.asarray(r)
            assert _err(a, r) <= RTOL * float(np.abs(r).max())
