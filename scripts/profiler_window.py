#!/usr/bin/env python3
"""Whether ``torch.profiler`` keeps every device event of a short session
as a process ages: ``python3 scripts/profiler_window.py [--minutes M]
[--every S] [--smoke]``.

Builds the port's kernels and, every ``S`` seconds until ``M`` minutes
have passed (the card kept busy in between with the same call), profiles
TPU kernel 1 (``mamba2_step``, b = 4, at mamba2-2.7b's width, with
``chip_smoke.py``'s inputs), 10 calls a session, in each layout of
``VARIANTS`` in turn: bare, bare again right after, padded with 0.2 and
1.0 s of host sleep at both ends, preceded by ``ABSORB`` one-element
kernels inside the session (with and without a pad), and with CPU
activity recorded too.  Each session brackets its calls with two spin
kernels (``torch.cuda._sleep``): while both brackets are kept, every
event between them is.  The absorbers count how many of a session's
first events the profiler drops.

With ``--smoke`` it instead runs ``chip_smoke.py`` whole and takes the
same sessions before each of its phases and at its end: which phase of a
long run the profiler starts losing events in.

Prints one line per session, ``PROBE`` and a JSON object: ``t_s``
(seconds since the start), ``variant``, ``brackets`` (of 2), ``events``
(the kernel's, of 10), ``absorbed`` (kept of sent), ``device_ms`` a call
and ``offset_ms`` (the first kept bracket's device start, as the
profiler dates it, less the host's clock at the last launch before it,
both from the session's start).  Exits 1 without a GPU.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
SPIN_CYCLES = 100_000
ABSORB = 4000


# Each session's layouts: (label, pad s, absorber kernels, CPU activity too).
VARIANTS = (("bare", 0.0, 0, False), ("bare again", 0.0, 0, False),
            ("pad 0.2", 0.2, 0, False), ("pad 1.0", 1.0, 0, False),
            ("absorb", 0.0, ABSORB, False), ("absorb, pad 0.2", 0.2, ABSORB,
                                              False),
            ("cpu and cuda", 0.0, 0, True))


def profile_session(fn, n, pad_s, absorb=0, cpu=False):
    """One session: ``pad_s`` of host sleep, ``absorb`` one-element
    ``bitwise_not`` kernels, then ``n`` calls of ``fn`` between two spin
    kernels, and ``pad_s`` again.  Returns (events by name as (count,
    device us), brackets kept, absorbers kept, offset ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    z = torch.zeros(1, dtype=torch.int32, device="cuda")
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
        t_in = time.perf_counter_ns()
        time.sleep(pad_s)
        for _ in range(absorb):
            torch.bitwise_not(z, out=z)
        t_launch = time.perf_counter_ns()
        torch.cuda._sleep(SPIN_CYCLES)
        for _ in range(n):
            fn()
        torch.cuda._sleep(SPIN_CYCLES)
        torch.cuda.synchronize()
        time.sleep(pad_s)
    res = prof.profiler.kineto_results
    by, spins, absorbed = {}, [], 0
    for ev in res.events():
        if ev.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        if "spin_kernel" in ev.name():
            spins.append(ev.start_ns())
            continue
        if "bitwise_not" in ev.name():
            absorbed += 1
            continue
        c, us = by.get(ev.name(), (0, 0.0))
        by[ev.name()] = (c + 1, us + ev.duration_ns() / 1e3)
    offset = None
    if spins:
        offset = (min(spins) - res.trace_start_ns()
                  - (t_launch - t_in)) / 1e6
    return by, len(spins), absorbed, offset


def variants_line(cs, fn, t0, **extra):
    """Print one JSON line per variant of a 10-call session of ``fn``."""
    for label, pad, absorb, cpu in VARIANTS:
        by, spins, absorbed, offset = profile_session(fn, 10, pad, absorb,
                                                      cpu)
        ours = {k: v for k, v in by.items()
                if any(s in k for s in cs.OUR_KERNELS)}
        print("PROBE " + json.dumps(dict(
            t_s=round(time.perf_counter() - t0, 1), variant=label,
            brackets=spins, events=sum(c for c, _ in ours.values()),
            absorbed=f"{absorbed}/{absorb}",
            device_ms=sum(us for _, us in ours.values()) / 1e4,
            offset_ms=offset, **extra)), flush=True)


def smoke_probe(cs) -> int:
    """Run ``chip_smoke.main()`` with a probe of kernel 1 (2.7b width)
    before each phase: one line per variant."""
    import torch
    from repro_torch.kernels import decode_step
    t0 = time.perf_counter()
    state = {}

    def probe(title):
        if "fn" not in state:
            ins = cs.decode_inputs(4, torch.device("cuda", 0),
                                   torch.bfloat16, seed=35,
                                   heads=cs.M27_HEADS)
            state["fn"] = lambda: decode_step.mamba2_step(
                **ins, ngroups=cs.N_GROUPS, head_dim=cs.HEAD_DIM)
        with torch.inference_mode():
            state["fn"]()
            torch.cuda.synchronize()
            variants_line(cs, state["fn"], t0, before=title)

    cs.PHASE_HOOK = probe
    return cs.main()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--minutes", type=float, default=6.0)
    ap.add_argument("--every", type=float, default=20.0)
    ap.add_argument("--smoke", action="store_true",
                    help="probe before each phase of chip_smoke.py")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profiler_window: no CUDA device; nothing run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build, decode_step
    smi = cs._nvidia_smi()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    if args.smoke:
        return smoke_probe(cs)
    build.build_all()
    dev = torch.device("cuda", 0)
    kw = dict(ngroups=cs.N_GROUPS, head_dim=cs.HEAD_DIM)
    step_in = cs.decode_inputs(4, dev, torch.bfloat16, seed=35,
                               heads=cs.M27_HEADS)
    step = lambda: decode_step.mamba2_step(**step_in, **kw)  # noqa: E731
    t0 = time.perf_counter()
    with torch.inference_mode():
        while True:
            step()
            torch.cuda.synchronize()
            variants_line(cs, step, t0)
            if time.perf_counter() - t0 > args.minutes * 60:
                break
            deadline = time.perf_counter() + args.every
            while time.perf_counter() < deadline:
                step()
                torch.cuda.synchronize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
