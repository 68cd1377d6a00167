#!/usr/bin/env python3
"""Kernel 2 (``mamba2_prefill``) at prefill_32k on one GPU: ``python3
scripts/prefill_32k_draws.py`` from the repo root.

b = 32, l = 32768, chunk 256, bf16, mamba2-130m's widths, inputs drawn on
the card from seed 29 two ways: ``chip_smoke.prefill_inputs_card`` (z,
xbc and dt views of one (b, l, 3352) projection of 3.5e9 elements) and
three separate tensors (:func:`three_tensors`, the draw ``chip_smoke.py``
used before).  Prints whether the call on the views gives the bits of
the call on contiguous copies, and, on rows 0-1 and 30-31 of each draw,
the kernel against the plain version run alone on those rows
(``chip_smoke.compare``, phase 3's element-wise rule) and both against
the fp64 witness (``chip_smoke.witness_prefill``): the worst element in
units of that rule's limit and the share of elements off.  Needs a GPU.
"""
from __future__ import annotations

import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build, prefill_chunk as pc  # noqa: E402

KW = dict(ngroups=cs.N_GROUPS, head_dim=cs.HEAD_DIM, chunk=256)
BATCH = ("z", "xbc", "dt", "conv_state", "ssm_state")
ROWS = ((0, 2), (30, 32))


def three_tensors(b, l, dev, seed, heads=cs.N_HEADS):
    """``prefill_inputs_card``'s operands with z, xbc and dt drawn as
    three tensors, in that order."""
    g = torch.Generator(device=dev).manual_seed(seed)
    f32, bf = torch.float32, torch.bfloat16
    di = heads * cs.HEAD_DIM
    dx = di + 2 * cs.N_GROUPS * cs.D_STATE

    def rnd(shape, scale, dt):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dt)
    return dict(
        z=rnd((b, l, di), 1.0, bf), xbc=rnd((b, l, dx), 1.0, bf),
        dt=rnd((b, l, heads), 1.0, bf),
        conv_state=rnd((b, cs.WIDTH - 1, dx), 1.0, bf),
        ssm_state=rnd((b, heads, cs.HEAD_DIM, cs.D_STATE), 0.1, f32),
        conv_w=rnd((cs.WIDTH, dx), 0.3, f32), conv_b=rnd((dx,), 0.1, f32),
        dt_bias=rnd((heads,), 0.1, f32),
        A=-torch.exp(rnd((heads,), 0.3, f32)), D=rnd((heads,), 0.2, f32),
        norm_scale=rnd((di,), 1.0, f32).abs() + 0.5)


def rows_against_witness(label, ins, got, r0, r1):
    head = {k: v[r0:r1] if k in BATCH else v for k, v in ins.items()}
    want = pc.mamba2_prefill_plain(**head, **KW)
    cs.compare(f"{label} rows {r0}-{r1 - 1} kernel vs plain",
               tuple(o[r0:r1] for o in got), want, "bfloat16", cs.FUSED_OUTS)
    t0 = time.time()
    wit = cs.witness_prefill(head, ngroups=cs.N_GROUPS,
                             head_dim=cs.HEAD_DIM)[0].float()
    for name, y in (("kernel", got[0][r0:r1]), ("plain", want[0])):
        used, off = cs.witness_accuracy(y, wit)
        print(f"  {label} rows {r0}-{r1 - 1} {name} vs fp64 witness: worst "
              f"{used:.4f} of the limit, {off:.4%} off", flush=True)
    print(f"  witness {time.time() - t0:.1f} s", flush=True)


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(cs._nvidia_smi(), flush=True)
    build.build_all()
    b, l = cs.PREFILL_32K[:2]
    ins = cs.prefill_inputs_card(b, l, dev, torch.bfloat16, seed=29)
    got = pc.mamba2_prefill(**ins, **KW)
    copies = {k: v.contiguous() for k, v in ins.items()}
    same = [bool(torch.equal(a, c))
            for a, c in zip(got, pc.mamba2_prefill(**copies, **KW))]
    print(f"views vs contiguous copies, bit for bit: {same}", flush=True)
    del copies
    for r0, r1 in ROWS:
        rows_against_witness("views seed 29", ins, got, r0, r1)
    del ins, got
    torch.cuda.empty_cache()
    ins = three_tensors(b, l, dev, seed=29)
    got = pc.mamba2_prefill(**ins, **KW)
    for r0, r1 in ROWS:
        rows_against_witness("three tensors seed 29", ins, got, r0, r1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
