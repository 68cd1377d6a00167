"""Trace-report CLI: fold a serve trace into phase breakdowns, TTFT
decompositions, slot timelines and a recompile audit (the port's own copy
of ``repro.launch.trace_report``).

``python -m repro_torch.launch.serve --trace PATH`` (or any engine with
``ServeConfig.trace``) records the span taxonomy of
``repro_torch/serve/tracing.py``; this tool folds a saved trace (Chrome
JSON or the JSONL event log) into:

* **per-phase wall breakdown**: decode / prefill / admission / snapshot
  moves / other host work / idle gaps, from self-times by interval
  nesting on the engine and host tracks, reconciled with the trace's wall
  extent (``--check`` fails past 5% drift);
* **per-program breakdown**: wall, calls and tokens/s per program id
  (``serve/program_registry.py``), and with ``--cards`` each program's
  share of its roofline (a PyTorch card's ``None`` fields are skipped);
* **TTFT decomposition**: queue wait against staging (the prefill
  calls); the first token comes from the final prefill call's logits, so
  the first decode step's share is 0 by construction;
* **queue-time waterfall** and **slot-timeline utilization**;
* **recompile sentinel audit**: a ``recompile`` instant is a program
  that met a new signature or built a kernel after warmup; ``--check``
  asserts that decode and prefill_chunk never did.

    python -m repro_torch.launch.trace_report serve_trace.json [--json]
        [--check] [--cards CARDS.json]

``--flight PATH`` renders the flight recorder's dumps instead
(``serve/flight_recorder.py``, ``launch/serve --flight-path``); with
``--check`` it fails unless the file holds a dump.  The fault instants
the report tallies are the JAX engine's, but ``backend_fallback``, which
the port never emits: it has no backend fallback, a failed kernel raises.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from typing import Any, Dict, List, Optional

from repro_torch.serve.flight_recorder import load_flight
from repro_torch.serve.metrics import _percentile
from repro_torch.serve.tracing import TID_ENGINE, TID_HOST, TID_SLOT0

# Leaf span name -> report phase.  Container spans ("poll", "serve.run",
# "admit") contribute their *self* time: "admit" self-time is admission
# bookkeeping outside the prefix lookup / snapshot restore nested in it.
PHASE_OF = {
    "decode_step": "decode",
    "prefill_chunk": "prefill",
    "prefill_bucket": "prefill",
    "admit": "admission",
    "prefix_lookup": "admission",
    "snapshot_restore": "snapshot",
    "snapshot_export": "snapshot",
    "pool_insert": "snapshot",
    "pool_reset": "snapshot",
    "poll": "host_other",
    "serve.run": "host_other",
    "host_gap": "idle",
}
CHECK_PROGRAMS = ("decode", "prefill_chunk")   # must compile exactly once

# Engine-track span name -> the compiled program it times, for the
# program-level breakdown.  Engine spans carry the registry's program id
# in ``args.program`` (``serve/program_registry.py``); this map covers
# the pool spans, whose names already identify the compiled row op
# (``snapshot_restore``/``snapshot_export`` run the same compiled
# scatter/gather as slot turnover — model.import_state/export_state).
# These spans never nest in one another, so full durations sum cleanly.
PROGRAM_OF_SPAN = {
    "decode_step": "decode",
    "draft": "draft",
    "verify": "verify",
    "prefill_chunk": "prefill_chunk",
    "prefill_bucket": "prefill",
    "pool_insert": "pool_insert",
    "pool_reset": "pool_reset",
    "snapshot_export": "pool_extract",
    "snapshot_restore": "pool_insert",
}


def load_events(path: str) -> List[dict]:
    """Load a trace: Chrome JSON (``{"traceEvents": [...]}``) or the
    JSONL event log (one event object per line)."""
    with open(path) as f:
        text = f.read()
    try:
        data = json.loads(text)
    except json.JSONDecodeError:   # one object per line
        return [json.loads(line) for line in text.splitlines() if line.strip()]
    return data["traceEvents"] if isinstance(data, dict) else data


def _spans(events: List[dict], tid: Optional[int] = None) -> List[dict]:
    return [e for e in events if e.get("ph") == "X" and
            (tid is None or e.get("tid") == tid)]


def self_times_s(events: List[dict]) -> Dict[str, float]:
    """Per-name self time (seconds) of the engine+host tracks' spans.

    Both tracks come from one Python thread of synchronous context
    managers, so their spans are properly nested (``host_gap`` covers
    exactly the time between two ``poll`` spans, inside any enclosing
    ``serve.run``); a stack walk over the merged tracks subtracts each
    span's duration from its enclosing span's self time."""
    spans = sorted((e for e in events if e.get("ph") == "X" and
                    e.get("tid") in (TID_ENGINE, TID_HOST)),
                   key=lambda e: (e["ts"], -e["dur"]))
    out: Dict[str, float] = defaultdict(float)
    stack: List[dict] = []
    for ev in spans:
        while stack and ev["ts"] >= stack[-1]["ts"] + stack[-1]["dur"] - 1e-9:
            stack.pop()
        out[ev["name"]] += ev["dur"] / 1e6
        if stack:
            out[stack[-1]["name"]] -= ev["dur"] / 1e6
        stack.append(ev)
    return dict(out)


def wall_extent_s(events: List[dict]) -> float:
    """Trace wall: extent of the engine+host tracks' complete events."""
    spans = [e for e in events if e.get("ph") == "X" and
             e.get("tid") in (TID_ENGINE, TID_HOST)]
    if not spans:
        return 0.0
    t0 = min(e["ts"] for e in spans)
    t1 = max(e["ts"] + e["dur"] for e in spans)
    return (t1 - t0) / 1e6


def phase_breakdown(events: List[dict]) -> Dict[str, Any]:
    """Phase -> seconds, plus the reconciliation against wall extent."""
    selfs = self_times_s(events)
    phases: Dict[str, float] = defaultdict(float)
    for name, s in selfs.items():
        phases[PHASE_OF.get(name, "host_other")] += s
    wall = wall_extent_s(events)
    total = sum(phases.values())
    return {
        "wall_s": round(wall, 6),
        "phase_total_s": round(total, 6),
        # total / wall: 1.0 = every microsecond attributed to a phase.
        "coverage": round(total / wall, 4) if wall else 0.0,
        "phases_s": {k: round(v, 6) for k, v in sorted(phases.items())},
        "phases_frac": {k: round(v / wall, 4) if wall else 0.0
                        for k, v in sorted(phases.items())},
    }


def program_breakdown(events: List[dict],
                      cards: Optional[Dict[str, Any]] = None
                      ) -> Dict[str, Any]:
    """Wall attribution per *compiled program*: wall, calls, tokens/s —
    plus achieved-vs-roofline utilization when program cards are given.

    Program spans never nest in each other (verified by the span
    taxonomy: pool spans nest only under host sections like ``admit`` /
    ``spec_copy``), so per-program wall is the plain sum of span
    durations.  ``_host`` (scheduling/self time of non-program spans)
    and ``_idle`` (host gaps) pseudo-rows come from the same interval
    -nesting self-times as ``phase_breakdown``, so the rows reconcile
    with the trace wall — ``coverage`` reports the ratio.

    ``cards`` maps program name -> card dict (or ``ProgramCard``); a
    program's ``utilization`` is its modeled best-case seconds per call
    (the binding roofline term) over the measured mean call — the
    fraction of the roofline the program actually achieves."""
    progs: Dict[str, Dict[str, Any]] = {}
    for ev in _spans(events, TID_ENGINE):
        name = ev["name"]
        if name not in PROGRAM_OF_SPAN:
            continue
        args = ev.get("args") or {}
        pid = args.get("program")
        prog = (pid.split(":", 1)[1] if isinstance(pid, str) and ":" in pid
                else PROGRAM_OF_SPAN[name])
        row = progs.setdefault(prog, {"id": None, "wall_s": 0.0,
                                      "calls": 0, "tokens": 0})
        if pid:
            row["id"] = pid
        row["wall_s"] += ev["dur"] / 1e6
        row["calls"] += 1
        row["tokens"] += int(args.get("tokens") or 0)

    wall = wall_extent_s(events)
    selfs = self_times_s(events)
    host = sum(s for name, s in selfs.items()
               if name not in PROGRAM_OF_SPAN and name != "host_gap")
    idle = selfs.get("host_gap", 0.0)

    def card_get(card, key):
        if card is None:
            return None
        if isinstance(card, dict):
            return card.get(key)
        return getattr(card, key, None)

    out_rows: Dict[str, Dict[str, Any]] = {}
    for prog, row in progs.items():
        r: Dict[str, Any] = {
            "id": row["id"],
            "wall_s": round(row["wall_s"], 6),
            "frac": round(row["wall_s"] / wall, 4) if wall else 0.0,
            "calls": row["calls"],
            "mean_call_ms": round(row["wall_s"] / row["calls"] * 1e3, 4)
            if row["calls"] else 0.0,
        }
        if row["tokens"]:
            r["tokens"] = row["tokens"]
            r["tokens_per_s"] = round(row["tokens"] / row["wall_s"], 2) \
                if row["wall_s"] else 0.0
        card = (cards or {}).get(prog)
        roof = card_get(card, "roofline_s")
        if roof and row["calls"]:
            mean_call_s = row["wall_s"] / row["calls"]
            r["roofline_s_per_call"] = roof
            r["utilization"] = round(roof / mean_call_s, 4) \
                if mean_call_s else 0.0
        out_rows[prog] = r

    program_total = sum(r["wall_s"] for r in out_rows.values())
    total = program_total + host + idle
    return {
        "wall_s": round(wall, 6),
        "program_total_s": round(program_total, 6),
        "coverage": round(total / wall, 4) if wall else 0.0,
        "programs": dict(sorted(out_rows.items(),
                                key=lambda kv: -kv[1]["wall_s"])),
        "_host_s": round(host, 6),
        "_idle_s": round(idle, 6),
    }


def request_table(events: List[dict]) -> List[Dict[str, Any]]:
    """Per-request segments: queue wait, staging (prefill), decode
    residency, end-to-end — from the queue/slot-track spans."""
    rows: Dict[int, Dict[str, Any]] = {}

    def row(uid: int) -> Dict[str, Any]:
        return rows.setdefault(uid, {"uid": uid, "arrival_us": None,
                                     "queue_s": 0.0, "staging_s": 0.0,
                                     "decode_s": 0.0, "tokens": None})

    for ev in events:
        uid = (ev.get("args") or {}).get("uid")
        if uid is None:
            continue
        if ev.get("ph") == "X":
            dur = ev["dur"] / 1e6
            if ev["name"] == "queue":
                r = row(uid)
                r["queue_s"] += dur
                r["arrival_us"] = ev["ts"]
            elif ev["name"] == "staging":
                r = row(uid)
                r["staging_s"] += dur
                r["slot"] = ev["tid"] - TID_SLOT0
            elif ev["name"] == "decode":
                row(uid)["decode_s"] += dur
        elif ev.get("ph") == "i" and ev["name"] == "finish":
            r = row(uid)
            r["tokens"] = ev["args"].get("tokens")
            r["latency_s"] = ev["args"].get("latency_s")
    out = list(rows.values())
    out.sort(key=lambda r: (r["arrival_us"] is None, r["arrival_us"],
                            r["uid"]))
    return out


def ttft_decomposition(table: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Queueing vs prefill share of TTFT across requests.  First tokens
    are sampled from the final prefill chunk's logits, so the first
    decode step's share is 0 by construction (reported explicitly)."""
    qs = [r["queue_s"] for r in table if r["staging_s"] > 0]
    ss = [r["staging_s"] for r in table if r["staging_s"] > 0]
    if not qs:
        return {"requests": 0}
    ttfts = [a + b for a, b in zip(qs, ss)]
    tot = sum(ttfts)
    return {
        "requests": len(qs),
        "ttft_mean_s": round(sum(ttfts) / len(ttfts), 6),
        "ttft_p95_s": round(_percentile(ttfts, 0.95), 6),
        "queue_mean_s": round(sum(qs) / len(qs), 6),
        "prefill_mean_s": round(sum(ss) / len(ss), 6),
        "queue_frac": round(sum(qs) / tot, 4) if tot else 0.0,
        "prefill_frac": round(sum(ss) / tot, 4) if tot else 0.0,
        "first_decode_frac": 0.0,
    }


def slot_utilization(events: List[dict]) -> Dict[str, Any]:
    wall = wall_extent_s(events)
    busy: Dict[int, Dict[str, float]] = defaultdict(
        lambda: {"staging_s": 0.0, "decode_s": 0.0})
    for ev in _spans(events):
        if ev["tid"] >= TID_SLOT0 and ev["name"] in ("staging", "decode"):
            busy[ev["tid"] - TID_SLOT0][ev["name"] + "_s"] += ev["dur"] / 1e6
    slots = {}
    for slot, b in sorted(busy.items()):
        total = b["staging_s"] + b["decode_s"]
        slots[str(slot)] = {
            "staging_s": round(b["staging_s"], 6),
            "decode_s": round(b["decode_s"], 6),
            "busy_frac": round(total / wall, 4) if wall else 0.0,
        }
    return {"wall_s": round(wall, 6), "slots": slots}


def recompile_trips(events: List[dict]) -> Dict[str, int]:
    trips: Dict[str, int] = defaultdict(int)
    for ev in events:
        if ev.get("ph") == "i" and ev.get("name") == "recompile":
            trips[ev["args"].get("program", "?")] += \
                ev["args"].get("new_traces", 1)
    return dict(trips)


def recompile_audit(events: List[dict]) -> Dict[str, Any]:
    """Trips per program plus the registry program id each sentinel
    carried (``serve/program_registry.py``), so the audit names the
    offending compiled program, not just a sentinel label."""
    trips: Dict[str, int] = defaultdict(int)
    ids: Dict[str, str] = {}
    for ev in events:
        if ev.get("ph") == "i" and ev.get("name") == "recompile":
            prog = ev["args"].get("program", "?")
            trips[prog] += ev["args"].get("new_traces", 1)
            pid = ev["args"].get("program_id")
            if pid:
                ids[prog] = pid
    return {"trips": dict(trips), "program_ids": ids}


def snapshots(events: List[dict]) -> List[dict]:
    return [ev["args"] for ev in events
            if ev.get("ph") == "i" and ev.get("name") == "metrics_snapshot"]


# Robustness instants (docs/robustness.md) the report tallies.  All are
# zero-duration, so their presence never perturbs the phase-coverage
# reconciliation --check asserts.
FAULT_EVENTS = ("quarantine", "backend_fallback", "overload_enter",
                "overload_exit", "watchdog_hang", "watchdog_recover",
                "reject", "shed", "retry", "snapshot_poison_refused")


def fault_events(events: List[dict]) -> Dict[str, int]:
    """Tally of fault-tolerance instants in the trace (quarantines,
    fallbacks, overload transitions, sheds...)."""
    out: Dict[str, int] = defaultdict(int)
    for ev in events:
        if ev.get("ph") == "i" and ev.get("name") in FAULT_EVENTS:
            out[ev["name"]] += 1
    return dict(out)


def analyze(events: List[dict],
            cards: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    table = request_table(events)
    audit = recompile_audit(events)
    return {
        "phase_breakdown": phase_breakdown(events),
        "program_breakdown": program_breakdown(events, cards),
        "ttft_decomposition": ttft_decomposition(table),
        "requests": table,
        "slot_utilization": slot_utilization(events),
        "recompile_trips": audit["trips"],
        "recompile_program_ids": audit["program_ids"],
        "fault_events": fault_events(events),
        "metrics_snapshots": len(snapshots(events)),
    }


# ---------------------------------------------------------------------------
def _fmt_s(s: float) -> str:
    return f"{s * 1e3:9.2f} ms"


def print_report(rep: Dict[str, Any], max_requests: int = 20) -> None:
    pb = rep["phase_breakdown"]
    print("== per-phase wall breakdown ==")
    for phase, s in sorted(pb["phases_s"].items(), key=lambda kv: -kv[1]):
        print(f"  {phase:<11s} {_fmt_s(s)}  {pb['phases_frac'][phase]:6.1%}")
    print(f"  {'total':<11s} {_fmt_s(pb['phase_total_s'])}  vs wall "
          f"{_fmt_s(pb['wall_s'])}  (coverage {pb['coverage']:.1%})")

    prb = rep.get("program_breakdown") or {}
    if prb.get("programs"):
        print("\n== per-program wall breakdown ==")
        for prog, r in prb["programs"].items():
            extra = ""
            if r.get("tokens_per_s") is not None:
                extra += f"  {r['tokens_per_s']:10.1f} tok/s"
            if r.get("utilization") is not None:
                extra += f"  {r['utilization']:6.1%} of roofline"
            label = f"{prog} ({r['id']})" if r.get("id") else prog
            print(f"  {label:<24s} {_fmt_s(r['wall_s'])}  {r['frac']:6.1%}"
                  f"  x{r['calls']:<5d}{extra}")
        print(f"  {'(host)':<24s} {_fmt_s(prb['_host_s'])}")
        print(f"  {'(idle)':<24s} {_fmt_s(prb['_idle_s'])}")
        print(f"  total {_fmt_s(prb['program_total_s'])} in programs vs "
              f"wall {_fmt_s(prb['wall_s'])} "
              f"(coverage {prb['coverage']:.1%})")

    td = rep["ttft_decomposition"]
    if td.get("requests"):
        print("\n== TTFT decomposition ==")
        print(f"  requests {td['requests']}   mean "
              f"{_fmt_s(td['ttft_mean_s'])}   p95 {_fmt_s(td['ttft_p95_s'])}")
        print(f"  queueing {td['queue_frac']:6.1%}   prefill "
              f"{td['prefill_frac']:6.1%}   first decode step "
              f"{td['first_decode_frac']:.1%} (first token comes from the "
              "final prefill chunk)")

    table = rep["requests"]
    if table:
        print(f"\n== queue-time waterfall (first {max_requests} "
              "by arrival) ==")
        print(f"  {'uid':>5s} {'queue':>10s} {'prefill':>10s} "
              f"{'decode':>10s} {'tokens':>6s}")
        for r in table[:max_requests]:
            print(f"  {r['uid']:5d} {r['queue_s'] * 1e3:8.2f}ms "
                  f"{r['staging_s'] * 1e3:8.2f}ms "
                  f"{r['decode_s'] * 1e3:8.2f}ms "
                  f"{r['tokens'] if r['tokens'] is not None else '?':>6}")

    su = rep["slot_utilization"]
    if su["slots"]:
        print("\n== slot-timeline utilization ==")
        for slot, b in su["slots"].items():
            bar = "#" * int(round(b["busy_frac"] * 40))
            print(f"  slot {slot}: {b['busy_frac']:6.1%} busy "
                  f"(staging {b['staging_s'] * 1e3:7.1f} ms, decode "
                  f"{b['decode_s'] * 1e3:7.1f} ms) {bar}")

    trips = rep["recompile_trips"]
    ids = rep.get("recompile_program_ids") or {}
    shown = ({f"{k} ({ids[k]})" if k in ids else k: v
              for k, v in trips.items()} if trips else None)
    print(f"\nrecompile trips: {shown or 'none'}   metrics snapshots: "
          f"{rep['metrics_snapshots']}")
    faults = rep.get("fault_events") or {}
    if faults:
        print("fault events: " + ", ".join(
            f"{k}={v}" for k, v in sorted(faults.items())))


def check(rep: Dict[str, Any], tolerance: float = 0.05) -> List[str]:
    """Validation gate for CI (``--check``): phase total reconciles with
    wall within ``tolerance`` and the compile-once programs never
    retraced after warmup."""
    problems = []
    pb = rep["phase_breakdown"]
    if pb["wall_s"] <= 0:
        problems.append("empty trace: no engine/host spans")
    elif abs(pb["coverage"] - 1.0) > tolerance:
        problems.append(
            f"phase total {pb['phase_total_s']:.4f}s does not reconcile "
            f"with wall {pb['wall_s']:.4f}s "
            f"(coverage {pb['coverage']:.1%}, tolerance {tolerance:.0%})")
    ids = rep.get("recompile_program_ids") or {}
    for prog in CHECK_PROGRAMS:
        n = rep["recompile_trips"].get(prog, 0)
        if n:
            label = f"{prog!r} ({ids[prog]})" if prog in ids else repr(prog)
            problems.append(f"compile-once program {label} retraced "
                            f"{n} time(s) after warmup")
    return problems


def print_flight(dumps: List[dict]) -> None:
    """Human-facing render of flight-recorder dumps (header, fault and
    ring of each)."""
    if not dumps:
        print("no flight dumps in file")
        return
    for d in dumps:
        h = d["header"]
        fault = d.get("fault") or {}
        facts = ", ".join(f"{k}={v}" for k, v in sorted(fault.items())
                          if k != "kind")
        print(f"== flight dump {h.get('flight_dump')} — "
              f"{h.get('kind', '?')}" + (f" ({facts})" if facts else "") +
              f" — last {h.get('entries', 0)} of "
              f"{h.get('recorded_total', '?')} request(s) ==")
        if d["requests"]:
            print(f"  {'uid':>5s} {'status':<16s} {'slot':>4s} "
                  f"{'queue':>9s} {'staging':>9s} {'decode':>9s} "
                  f"{'tokens':>6s} {'retries':>7s}")

        def ms(x):
            return f"{x * 1e3:7.1f}ms" if x is not None else "        ?"

        for r in d["requests"]:
            print(f"  {r.get('uid', '?'):>5} {r.get('status', '?'):<16s} "
                  f"{r.get('slot') if r.get('slot') is not None else '?':>4} "
                  f"{ms(r.get('queue_s'))} {ms(r.get('staging_s'))} "
                  f"{ms(r.get('decode_s'))} {r.get('tokens', '?'):>6} "
                  f"{r.get('retries', 0):>7}")
        print()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Fold a serve trace (Chrome JSON or JSONL) into phase "
                    "breakdowns, TTFT decomposition, and slot timelines.")
    ap.add_argument("trace", nargs="?",
                    help="trace path from launch/serve --trace")
    ap.add_argument("--json", action="store_true",
                    help="print the full report as JSON instead of tables")
    ap.add_argument("--check", action="store_true",
                    help="exit nonzero unless phases reconcile with wall "
                         "(<=5%% drift) and decode/prefill_chunk never "
                         "retraced")
    ap.add_argument("--tolerance", type=float, default=0.05,
                    help="--check reconciliation tolerance (default 0.05)")
    ap.add_argument("--max-requests", type=int, default=20,
                    help="waterfall rows to print")
    ap.add_argument("--cards", metavar="PATH",
                    help="program-card JSON (name -> card dict, e.g. "
                         "ProgramRegistry.to_dict()) to fold roofline "
                         "utilization into the program breakdown")
    ap.add_argument("--flight", metavar="PATH",
                    help="render a flight-recorder JSONL dump "
                         "(launch/serve --flight-path) instead of a trace")
    args = ap.parse_args(argv)

    if args.flight:
        dumps = load_flight(args.flight)
        if args.json:
            json.dump(dumps, sys.stdout, indent=2)
            print()
        else:
            print_flight(dumps)
        # --check in flight mode: the file holds a well-formed dump.
        if args.check and not dumps:
            print("CHECK FAILED: no flight dumps parsed", file=sys.stderr)
            return 1
        return 0
    if not args.trace:
        ap.error("trace path required (or use --flight PATH)")

    cards = None
    if args.cards:
        with open(args.cards) as f:
            cards = json.load(f)
    rep = analyze(load_events(args.trace), cards=cards)
    if args.json:
        json.dump(rep, sys.stdout, indent=2)
        print()
    else:
        print_report(rep, max_requests=args.max_requests)
    if args.check:
        problems = check(rep, args.tolerance)
        for p in problems:
            print(f"CHECK FAILED: {p}", file=sys.stderr)
        if problems:
            return 1
        print(f"check OK: coverage {rep['phase_breakdown']['coverage']:.1%},"
              f" 0 post-warmup recompiles of {', '.join(CHECK_PROGRAMS)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
