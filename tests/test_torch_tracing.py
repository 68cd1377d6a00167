"""The port's serve-stack tracing against the JAX package's, on the CPU.

The tracer, the streaming metrics and ``trace_report`` give the JAX
package's events, readings and reports for the same calls; the port's
engines give the JAX engines' trace skeletons (span names, non-time
arguments, per-request uids) for the same weights, requests and options;
the registry gives the JAX ids; the sentinels trip on a new shape and not
on a served run after warmup; cards leave the pools and the launch
counters alone; and the CLI's ``--trace`` output passes
``trace_report --check``.
"""
import json
import os
import pathlib
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import trace_report as jreport
from repro.models import ModelConfig as JModelConfig, build_model as jbuild
from repro.nn.params import init_params as jinit
from repro.serve import ContinuousEngine as JContinuous, Engine as JEngine, \
    ServeConfig as JServeConfig
from repro.serve import metrics as jmetrics
from repro.serve import tracing as jtracing
from repro.serve.program_registry import budget_for as jbudget_for
from repro_torch.configs import get_config
from repro_torch.kernels import decode_step, prefill_chunk, qmatmul
from repro_torch.launch import serve as tserve, trace_report
from repro_torch.models import ModelConfig, build_model
from repro_torch.nn.params import from_jax_params
from repro_torch.serve import ContinuousEngine, Engine, ServeConfig
from repro_torch.serve import metrics, tracing
from repro_torch.serve.program_registry import ProgramBudget, \
    ProgramCard, budget_for, build_card
from test_observability import _golden_events

V = 64
DIMS = {
    "mamba2": dict(name="mamba2", family="mamba2", vocab_size=V, d_model=32,
                   n_layers=2, d_state=8, ssm_head_dim=8, chunk_size=8,
                   param_dtype="float32"),
    "dense": dict(name="dense", family="transformer", vocab_size=V,
                  d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
                  head_dim=8, d_ff=64, param_dtype="float32"),
}
SERVE = dict(max_batch=2, prefill_buckets=(16, 32), max_new_tokens=5)

# Argument keys the skeletons leave out, and why: none of a span's own
# (every non-time argument is compared).  Instants are left out whole:
# ``finish`` carries ``latency_s`` and ``metrics_snapshot`` the rates and
# histograms (times); their cadence is compared in
# ``test_metrics_every_cadence_and_content_match_jax``.
LEFT_OUT_KEYS = {}


_PAIRS = {}


def _pair(family):
    """(JAX model, JAX params, port model, port params): one weight set a
    family, built once (no test writes to it)."""
    if family not in _PAIRS:
        jm = jbuild(JModelConfig(**DIMS[family]))
        jp = jinit(jm.param_specs(), jax.random.PRNGKey(0), jnp.float32)
        tm = build_model(ModelConfig(**DIMS[family]), device="cpu")
        tp = from_jax_params(jax.tree.map(np.asarray, jp), tm.cfg,
                             device="cpu")
        _PAIRS[family] = (jm, jp, tm, tp)
    return _PAIRS[family]


def _prompts(shared=False):
    rng = np.random.default_rng(3)
    head = rng.integers(1, V, 16).tolist() if shared else []
    return [head + rng.integers(1, V, int(n)).tolist()
            for n in (8, 16, 8, 8, 16)]


def _run(engine, prompts):
    for p in prompts:
        engine.submit(p)
    done = engine.run()
    if hasattr(engine, "close"):
        engine.close()
    return {r.uid: r.out_tokens for r in done}


def _engines(family, kw, prompts, wave=False):
    """The JAX and the port engine of one option set, each traced and run
    on ``prompts``: (jax engine, jax tokens, port engine, port tokens)."""
    jm, jp, tm, tp = _pair(family)
    jcls, tcls = (JEngine, Engine) if wave else (JContinuous,
                                                 ContinuousEngine)
    je = jcls(jm, jp, JServeConfig(**SERVE, trace=True, **kw))
    te = tcls(tm, tp, ServeConfig(**SERVE, trace=True, **kw))
    return je, _run(je, prompts), te, _run(te, prompts)


def _skeleton(events):
    """Engine-track spans in emission order with their non-time
    arguments, and the per-request spans' (name, uid, track)."""
    eng = [(e["name"], tuple(sorted(
        (k, v) for k, v in e["args"].items()
        if k not in LEFT_OUT_KEYS.get(e["name"], ()))))
        for e in events if e["ph"] == "X" and e["tid"] == tracing.TID_ENGINE]
    req = [(e["name"], e["args"]["uid"], e["tid"]) for e in events
           if e["ph"] == "X" and e["name"] in ("queue", "staging", "decode")]
    return eng, req


def _strip_times(events):
    return [{k: v for k, v in e.items() if k not in ("ts", "dur")}
            for e in events]


# ---------------------------------------------------------------------------
# tracer, metrics, trace_report
# ---------------------------------------------------------------------------
def _drive_tracer(mod):
    tr = mod.Tracer()
    with tr.span("poll"):
        with tr.span("admit", rows=2) as sp:
            sp.args["admitted"] = 2
        tr.complete("decode_step", 1.0, 1.5, live=2, program="p0:decode")
    tr.complete("host_gap", 2.0, 2.1, tid=mod.TID_HOST)
    tr.complete("queue", 0.0, 1.0, tid=mod.TID_QUEUE, uid=1)
    tr.complete("staging", 1.0, 2.0, tid=mod.TID_SLOT0 + 1, uid=1, span=16)
    tr.instant("finish", uid=1, tokens=3, latency_s=0.5)
    tr.instant("recompile", program="decode", new_traces=1, trips=1)
    tr.counter("serve_gauges", {"queue_depth": 1.0, "live_slots": 2.0})
    return tr


def test_tracer_events_match_jax(tmp_path):
    """The same calls give the same events (times aside), the same saved
    Chrome JSON and JSONL shapes, and the same reset and null behaviour."""
    jt, tt = _drive_tracer(jtracing), _drive_tracer(tracing)
    assert _strip_times(tt.events) == _strip_times(jt.events)
    assert [e["name"] for e in tt.events][:2] == ["thread_name", "admit"]
    tt.save(str(tmp_path / "t.json"))
    tt.save_jsonl(str(tmp_path / "t.jsonl"))
    chrome = json.loads((tmp_path / "t.json").read_text())
    assert chrome["displayTimeUnit"] == "ms"
    assert _strip_times(chrome["traceEvents"]) == _strip_times(jt.events)
    lines = (tmp_path / "t.jsonl").read_text().splitlines()
    assert [json.loads(x)["name"] for x in lines] == \
        [e["name"] for e in jt.events]
    assert tracing.TID_ENGINE == jtracing.TID_ENGINE and \
        tracing.TID_SLOT0 == jtracing.TID_SLOT0
    assert tt.pc_from_walltime(time.time()) == \
        pytest.approx(time.perf_counter(), abs=1e-2)
    tt.reset()
    assert tt.events == []
    null = tracing.NULL_TRACER
    assert not null.enabled and null.span("a") is null.span("b")
    with null.span("x") as sp:
        sp.args["k"] = 1
    assert sp.args == {}


@pytest.mark.parametrize("kind", ["histogram", "gauge", "rate",
                                  "percentile"])
def test_streaming_metrics_match_jax(kind):
    """The same samples give the same readings."""
    rng = np.random.default_rng(5)
    xs = list(rng.lognormal(-5, 2, 300))
    if kind == "histogram":
        for n in (0, 1, 2, 17, 300):
            a, b = metrics.StreamingHistogram(), \
                jmetrics.StreamingHistogram()
            for x in xs[:n]:
                a.add(x)
                b.add(x)
            assert a.summary() == b.summary()
            for q in (0.0, 0.1, 0.5, 0.99, 1.0):
                assert a.percentile(q) == b.percentile(q)
    elif kind == "gauge":
        # Integer samples (the engines' gauges: depths, slots, bytes) give
        # the same readings bit for bit; float samples the same last, max
        # and n, and a mean within float rounding (the port keeps a
        # running sum, the JAX package sums the window afresh).
        ints = [int(v) for v in rng.integers(0, 2 ** 31, 50)]
        for samples, exact in ((ints, True), (xs[:50], False)):
            a, b = metrics.WindowedGauge(2.0), jmetrics.WindowedGauge(2.0)
            for i, x in enumerate(samples):
                a.record(x, now=0.1 * i)
                b.record(x, now=0.1 * i)
                sa = a.snapshot(now=0.1 * i + 0.05)
                sb = b.snapshot(now=0.1 * i + 0.05)
                if exact:
                    assert sa == sb
                else:
                    assert sa["mean"] == pytest.approx(sb["mean"],
                                                       rel=1e-12)
                    assert {**sa, "mean": 0} == {**sb, "mean": 0}
            assert a.snapshot(now=100.0) == b.snapshot(now=100.0)
    elif kind == "rate":
        a, b = metrics.RateMeter(1.0), jmetrics.RateMeter(1.0)
        for i in range(40):
            a.record(i % 3 + 1, now=0.05 * i)
            b.record(i % 3 + 1, now=0.05 * i)
            assert a.rate(now=0.05 * i + 0.01) == \
                b.rate(now=0.05 * i + 0.01)
    else:
        for n in (0, 1, 2, 20, 301):
            assert metrics._percentile(xs[:n], 0.95) == \
                jmetrics._percentile(xs[:n], 0.95)


@pytest.mark.parametrize("kind", ["gauge", "rate"])
def test_windows_match_a_fresh_walk(kind):
    """The running sums and the max deque give, at every reading, what a
    walk over the window's points gives (integer samples: exactly),
    through gaps that empty the window."""
    rng = np.random.default_rng(11)
    t, pts = 0.0, []
    meter = metrics.WindowedGauge(1.0) if kind == "gauge" else \
        metrics.RateMeter(1.0)
    for _ in range(400):
        t += float(rng.choice([0.01, 0.05, 0.3, 1.5]))
        v = int(rng.integers(0, 50))
        meter.record(v, now=t)
        pts.append((t, v))
        now = t + float(rng.choice([0.0, 0.2, 0.9, 2.0]))
        win = [(s, x) for s, x in pts if s >= now - 1.0]
        if kind == "gauge":
            want = ({"last": v, "mean": sum(x for _, x in win) / len(win),
                     "max": max(x for _, x in win), "n": len(win)}
                    if win else {"last": v, "mean": v, "max": v, "n": 0})
            assert meter.snapshot(now=now) == want
        else:
            want = (sum(x for _, x in win) / max(now - win[0][0], 1e-9)
                    if win else 0.0)
            assert meter.rate(now=now) == want
        pts = [(s, x) for s, x in pts if s >= now - 1.0]
        t = now


@pytest.mark.parametrize("kw,watched", [
    pytest.param(dict(), False, id="untraced"),
    pytest.param(dict(trace=True), True, id="trace"),
    pytest.param(dict(strict_recompile=True), True, id="strict"),
])
def test_programs_are_watched_only_when_read(kw, watched):
    """Call signatures and gauges cost host time every poll: an untraced,
    non-strict engine records neither (its sentinels are inert), a traced
    or strict one records the signatures, and ``metrics_every`` fills the
    windows."""
    _, _, tm, tp = _pair("mamba2")
    eng = ContinuousEngine(tm, tp, ServeConfig(**SERVE, prefill_chunk=8,
                                               **kw))
    _run(eng, _prompts())
    progs = [s._fn for s in eng.sentinels.values()]
    assert set(eng.sentinels) == {"decode", "prefill", "prefill_chunk",
                                  "pool_insert", "pool_reset"}
    assert all(p.watch == watched for p in progs)
    assert all(s.supported == watched for s in eng.sentinels.values())
    n_sigs = sum(len(p.signatures) for p in progs)
    assert (n_sigs > 0) == watched
    assert eng.metrics.gauges == {} and not eng.metrics.tok_rate._pts
    assert not eng._ppool.insert_program.watch    # no sentinel reads it
    every = ContinuousEngine(tm, tp, ServeConfig(**SERVE, prefill_chunk=8,
                                                 metrics_every=2, **kw))
    _run(every, _prompts())
    assert set(every.metrics.gauges) == {"queue_depth", "live_slots",
                                         "overloaded", "staging_depth"}
    assert every.metrics.tok_rate._pts


def _golden_variants():
    gold = _golden_events()
    return {"golden": gold,
            "clean": [e for e in gold if e["name"] != "recompile"],
            "bad_coverage": [
                {"name": "poll", "ph": "X", "pid": 0, "tid": 0, "ts": 0.0,
                 "dur": 100.0, "args": {}},
                {"name": "poll", "ph": "X", "pid": 0, "tid": 0,
                 "ts": 2900.0, "dur": 100.0, "args": {}}]}


@pytest.mark.parametrize("variant", ["golden", "clean", "bad_coverage"])
def test_trace_report_matches_jax(variant):
    """The JAX suite's golden trace (and its clean and bad-coverage
    variants) give the same report and the same check in both."""
    events = _golden_variants()[variant]
    rep, jrep = trace_report.analyze(events), jreport.analyze(events)
    assert rep == jrep
    assert trace_report.check(rep) == jreport.check(jrep)
    assert bool(trace_report.check(rep)) == (variant != "clean")


def test_trace_report_cli_and_cards(tmp_path, capsys):
    """The CLI's exit codes are JAX's on the golden trace; ``--cards``
    reads a PyTorch card with its ``None`` fields."""
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": _golden_events()}))
    for argv in ([str(path)], [str(path), "--check"],
                 [str(path), "--json"]):
        assert trace_report.main(argv) == jreport.main(argv), argv
    out = capsys.readouterr().out
    assert "per-phase wall breakdown" in out
    card = ProgramCard(name="decode", program_id="p0:decode",
                       roofline={"memory_s": 1e-4})
    assert card.flops is None and card.instructions is None
    cards = tmp_path / "cards.json"
    cards.write_text(json.dumps({"decode": card.to_dict(),
                                 "prefill_chunk": ProgramCard(
                                     "prefill_chunk", "p2").to_dict()}))
    assert trace_report.main([str(path), "--cards", str(cards)]) == 0
    rep = trace_report.analyze(_golden_events(),
                               cards=json.loads(cards.read_text()))
    row = rep["program_breakdown"]["programs"]["decode"]
    assert row["roofline_s_per_call"] == pytest.approx(1e-4)
    assert "utilization" not in \
        rep["program_breakdown"]["programs"]["prefill_chunk"]


# ---------------------------------------------------------------------------
# engines: trace skeletons against the JAX engines
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw,shared", [
    pytest.param(dict(prefill_chunk=8), False, id="chunked"),
    pytest.param(dict(prefill_chunk=8, prefix_cache_mb=1), True,
                 id="chunked_prefix_cache"),
    pytest.param(dict(), False, id="monolithic"),
])
def test_continuous_trace_skeleton_matches_jax(kw, shared):
    """The same engine-track spans, in order, with the same non-time
    arguments (program ids included), and the same per-request spans;
    the same greedy tokens; both traces pass their own check."""
    prompts = _prompts(shared)
    je, jout, te, tout = _engines("mamba2", kw, prompts)
    assert tout == jout
    assert _skeleton(te.tracer.events) == _skeleton(je.tracer.events)
    rep = trace_report.analyze(te.tracer.events)
    assert trace_report.check(rep) == []
    assert rep["ttft_decomposition"]["requests"] == len(prompts)
    if shared:
        assert te.metrics.prefix_hits > 0
        names = {e["name"] for e in te.tracer.events}
        assert {"prefix_lookup", "snapshot_export",
                "snapshot_restore"} <= names


def test_speculative_trace_matches_jax():
    """With speculation the draft, verify and rollback spans come in the
    same numbers with the same rows / k arguments (here the whole
    skeleton agrees: the tokens do)."""
    prompts = _prompts()
    je, jout, te, tout = _engines("mamba2", dict(prefill_chunk=8,
                                                 speculate_k=3), prompts)

    def spans(tr, name):
        return [(e["args"].get("rows"), e["args"].get("k"))
                for e in tr.events if e["ph"] == "X" and e["name"] == name]
    for name in ("draft", "verify", "rollback", "spec_copy"):
        assert spans(te.tracer, name) == spans(je.tracer, name), name
    assert spans(te.tracer, "draft")
    assert trace_report.check(trace_report.analyze(te.tracer.events)) == []
    if tout == jout:
        assert _skeleton(te.tracer.events) == _skeleton(je.tracer.events)


def test_wave_engine_trace_matches_jax():
    prompts = _prompts()
    je, jout, te, tout = _engines("mamba2", {}, prompts, wave=True)
    assert tout == jout
    assert _skeleton(te.tracer.events) == _skeleton(je.tracer.events)
    names = {e["name"] for e in te.tracer.events}
    assert {"poll", "prefill_bucket", "decode_step", "queue", "staging",
            "decode"} <= names
    rep = trace_report.analyze(te.tracer.events)
    assert rep["ttft_decomposition"]["requests"] == len(prompts)
    assert trace_report.check(rep) == []


def test_attention_family_trace_matches_jax():
    """A dense transformer through the chunked continuous engine."""
    prompts = _prompts()
    je, jout, te, tout = _engines("dense", dict(prefill_chunk=8), prompts)
    assert tout == jout
    assert _skeleton(te.tracer.events) == _skeleton(je.tracer.events)
    assert trace_report.check(trace_report.analyze(te.tracer.events)) == []


def test_metrics_every_cadence_and_content_match_jax():
    """Snapshots every N polls, in the trace as a ``serve_gauges`` counter
    and a ``metrics_snapshot`` instant, with the JAX snapshot's keys (the
    robustness counters' included); the same counts in both."""
    jm = jmetrics.ServeMetrics(2, tracer=jtracing.Tracer(), metrics_every=3)
    tm = metrics.ServeMetrics(2, tracer=tracing.Tracer(), metrics_every=3)
    for m in (jm, tm):
        for i in range(10):
            m.record_arrival()
            m.record_first_token(0.01 * (i + 1))
            m.record_step(2, 0.004)
            m.record_prefill(16, 0.02)
            m.record_token(2)
            m.record_prefix_lookup(8 if i % 2 else 0)
            m.observe_gauges(queue_depth=i, live_slots=2, staging_depth=1)
            m.maybe_snapshot(lambda: {"recompile_trips": {"decode": 0}})
    assert len(tm.snapshots) == len(jm.snapshots) == 3
    for ts, js in zip(tm.snapshots, jm.snapshots):
        assert set(ts) == set(js)
        for k in set(ts) - {"tokens_per_s_window", "gauges"}:
            assert ts[k] == js[k], k
        assert ts["gauges"] == js["gauges"]

    def kinds(tr):
        return [(e["ph"], e["name"]) for e in tr.events
                if e["ph"] in ("C", "i")]
    assert kinds(tm.tracer) == kinds(jm.tracer)
    assert [set(e["args"]) for e in tm.tracer.events if e["ph"] == "C"] == \
        [set(e["args"]) for e in jm.tracer.events if e["ph"] == "C"]


def test_engine_metrics_every_matches_jax():
    """The engines take the same snapshots at the same polls."""
    prompts = _prompts()
    je, _, te, _ = _engines("mamba2", dict(prefill_chunk=8,
                                           metrics_every=2), prompts)
    assert [s["polls"] for s in te.metrics.snapshots] == \
        [s["polls"] for s in je.metrics.snapshots]
    assert [s["emitted_tokens"] for s in te.metrics.snapshots] == \
        [s["emitted_tokens"] for s in je.metrics.snapshots]
    assert all(set(s["gauges"]) == {"queue_depth", "live_slots",
                                    "overloaded", "staging_depth"}
               for s in te.metrics.snapshots)
    assert [set(s) for s in te.metrics.snapshots] == \
        [set(s) for s in je.metrics.snapshots]


@pytest.mark.parametrize("kw", [dict(), dict(prefill_chunk=8),
                                dict(prefill_chunk=8, speculate_k=3)],
                         ids=["monolithic", "chunked", "speculative"])
def test_tracing_keeps_greedy_tokens(kw):
    _, _, tm, tp = _pair("mamba2")
    prompts = _prompts()
    off = _run(ContinuousEngine(tm, tp, ServeConfig(**SERVE, **kw)),
               prompts)
    on = _run(ContinuousEngine(tm, tp, ServeConfig(
        **SERVE, trace=True, metrics_every=2, **kw)), prompts)
    assert on == off


# ---------------------------------------------------------------------------
# sentinels, registry, cards
# ---------------------------------------------------------------------------
def test_sentinel_trips_on_a_new_shape_and_raises_under_strict():
    prog = tracing.TracedProgram("decode", lambda w, x: x + 1)
    sent = tracing.RecompileSentinel("decode", prog,
                                     program_id="p0:decode")
    assert sent.supported and sent.check() == 0       # empty: lazy
    prog(None, torch.zeros(2))
    assert sent.check() == 0                          # first sight arms
    prog(None, torch.zeros(2))
    assert sent.check() == 0
    tr = tracing.Tracer()
    prog(None, torch.zeros(3))
    assert sent.check(tr) == 1
    ev = [e for e in tr.events if e["name"] == "recompile"][0]
    assert ev["args"] == {"program": "decode", "new_traces": 1,
                          "trips": 1, "program_id": "p0:decode"}
    prog(None, torch.zeros(2, dtype=torch.float64))
    sent.strict = True
    with pytest.raises(tracing.RecompileError):
        sent.check()
    sent.arm()
    assert sent.trips == 0
    assert not tracing.RecompileSentinel("x", object()).supported


def test_engine_sentinels_after_warmup():
    """A whole served run after warmup trips nothing, under strict; a
    decode call at another batch shape trips ``decode``; reset_stats
    clears the trace and the metrics and re-arms."""
    _, _, tm, tp = _pair("mamba2")
    eng = ContinuousEngine(tm, tp, ServeConfig(
        **SERVE, prefill_chunk=8, trace=True, strict_recompile=True))
    _run(eng, _prompts())
    eng.reset_stats()
    assert eng.tracer.events == [] and eng.metrics.completed == 0
    _run(eng, _prompts())
    assert eng.counters["recompile_trips"] == {
        k: 0 for k in ("decode", "prefill", "prefill_chunk", "pool_insert",
                       "pool_reset")}
    assert eng.stats()["recompile_trips"]["decode"] == 0
    cache = tm.init_cache(3, eng.max_seq, torch.float32)
    with torch.inference_mode():
        eng._decode(eng.params, torch.zeros((3, 1), dtype=torch.long),
                    cache, np.zeros(3, np.int64))
    with pytest.raises(tracing.RecompileError):
        eng.check_sentinels()
    assert eng.sentinels["decode"].trips == 1
    eng.reset_stats()
    assert all(s.trips == 0 for s in eng.sentinels.values())


@pytest.mark.parametrize("kw", [
    dict(), dict(prefill_chunk=8), dict(prefill_chunk=8, speculate_k=3),
    dict(prefill_chunk=8, prefix_cache_mb=1)],
    ids=["monolithic", "chunked", "speculative", "prefix_cache"])
def test_registry_ids_match_jax(kw):
    jm, jp, tm, tp = _pair("mamba2")
    je = JContinuous(jm, jp, JServeConfig(**SERVE, **kw))
    te = ContinuousEngine(tm, tp, ServeConfig(**SERVE, **kw))
    assert te.registry.names() == je.registry.names()
    assert [te.registry.program_id(n) for n in te.registry.names()] == \
        [je.registry.program_id(n) for n in je.registry.names()]
    assert list(te.sentinels) == list(je.sentinels)
    assert {n: s.program_id for n, s in te.sentinels.items()} == \
        {n: s.program_id for n, s in je.sentinels.items()}
    je.close()
    w = Engine(tm, tp, ServeConfig(**SERVE))
    assert w.registry.names() == ["decode", "prefill"]


def _launch_counters():
    return [(fn.launches, dict(getattr(fn, "path_launches", {})))
            for fn in (decode_step.mamba2_step, prefill_chunk.mamba2_prefill,
                       qmatmul.qmatmul)]


def test_cards_leave_pools_and_counters_alone():
    """Every program's card on the CPU: the pools' bytes and the launch
    counters as they were, no signature recorded; the CPU fields."""
    _, _, tm, tp = _pair("mamba2")
    eng = ContinuousEngine(tm, tp, ServeConfig(**SERVE, prefill_chunk=8,
                                               speculate_k=3, trace=True))
    _run(eng, _prompts())
    pools = [eng.pool, eng._ppool, eng._dpool, eng._bpool]
    before = [[leaf.clone() for leaf in p.cache] for p in pools]
    sigs = {n: s._fn._cache_size() for n, s in eng.sentinels.items()}
    assert sigs["decode"] > 0 and sigs["verify"] > 0
    decode_step.mamba2_step.launches += 5
    counters = _launch_counters()
    cards = eng.registry.cards()
    assert list(cards) == eng.registry.names()
    assert _launch_counters() == counters
    decode_step.mamba2_step.launches -= 5
    for p, b in zip(pools, before):
        assert all(torch.equal(x, y) for x, y in zip(p.cache, b))
    assert {n: s._fn._cache_size() for n, s in eng.sentinels.items()} == sigs
    dec = cards["decode"]
    assert dec.ops and dec.argument_bytes > 0 and dec.output_bytes > 0
    assert dec.device_ms is None and dec.temp_bytes is None
    assert dec.roofline == {} and dec.roofline_s == 0.0
    assert dec.copies >= 2            # the new state copied into place
    d = dec.to_dict()
    assert d["flops"] is None and d["budget_violations"] == []
    assert eng.registry.card("decode") is dec
    assert eng.registry.to_dict()["decode"]["program_id"] == "p0:decode"


def test_card_counts_casts_and_budgets():
    """A cast shows as a copy with its bytes; a budget trips and passes;
    ``budget_for`` gates on the full d_model as in the JAX package."""
    w = torch.zeros(8, 4, dtype=torch.bfloat16)

    def prog(weights, x):
        return x @ weights.float()
    card = build_card("p", "p0:p", prog, (torch.zeros(2, 8),),
                      weights=w)
    assert card.copies == 1 and card.copy_bytes == 8 * 4 * 4
    assert card.argument_bytes == 8 * 4 * 2 + 2 * 8 * 4
    card.budget = ProgramBudget(max_copies=0)
    assert card.check_budget() and "copy ops" in card.check_budget()[0]
    card.budget = ProgramBudget(max_copies=1, max_temp_bytes=0)
    assert card.check_budget() == []         # no temp reading on the CPU
    for name in ("mamba2-130m", "mamba-130m"):
        full = get_config(name)
        small = get_config(name, reduced=True)
        assert budget_for(full, "decode") is not None
        assert budget_for(small, "decode") is None
        assert jbudget_for(small, "decode") is None
        assert budget_for(full, "prefill") is None


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def test_cli_trace_passes_trace_report_check(tmp_path):
    path = tmp_path / "serve_trace.json"
    engine, done = tserve.main([
        "--device", "cpu", "--reduced", "--engine", "continuous",
        "--prefill-chunk", "16", "--requests", "4", "--max-new", "4",
        "--trace", str(path), "--metrics-every", "4", "--strict-recompile"])
    assert len(done) == 4 and engine.cfg.strict_recompile
    assert path.exists() and (tmp_path / "serve_trace.jsonl").exists()
    src = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.trace_report", str(path),
         "--check"], capture_output=True, text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stderr
    assert "check OK" in res.stdout
    events = trace_report.load_events(str(tmp_path / "serve_trace.jsonl"))
    assert any(e["name"] == "metrics_snapshot" for e in events)
