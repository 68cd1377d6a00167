"""The port's flight recorder against the JAX package's, on the CPU: the
bounded ring, the request timelines, the JSONL dumps and ``load_flight``
(each package reads the other's file), the continuous engine's dumps on
fault events, and ``trace_report --flight``.

The engine cases run the JAX engine and the port's on the same weights
(``from_jax_params``), requests and plan and compare the sequence of dump
kinds, and in each dump the fault's facts and the request uids and
statuses (times differ).  The model is the JAX suite's (d_model 32,
fp32).
"""
import json
import time

import numpy as np
import pytest
import torch

from repro.serve import ContinuousEngine as JContinuous, \
    ServeConfig as JServeConfig
from repro.serve.flight_recorder import FlightRecorder as JFlightRecorder, \
    load_flight as jload_flight
from repro_torch.launch import trace_report
from repro_torch.serve import ContinuousEngine, ServeConfig
from repro_torch.serve.flight_recorder import FlightRecorder, load_flight
from test_torch_robustness import V, _hang_after_one_poll, _pair


class FakeReq:
    def __init__(self, uid, **stamps):
        self.uid = uid
        self.prompt = [1, 2, 3]
        self.out_tokens = [4, 5]
        self.retries = 0
        for k, v in stamps.items():
            setattr(self, k, v)


# ---------------------------------------------------------------------------
# the ring, the dumps, the loader
# ---------------------------------------------------------------------------
def test_ring_is_bounded_and_counts_all():
    fr, jfr = FlightRecorder(capacity=4), JFlightRecorder(capacity=4)
    for i in range(10):
        fr.record_request(FakeReq(i))
        jfr.record_request(FakeReq(i))
    assert len(fr) == 4 and fr.recorded == 10
    assert [e["uid"] for e in fr.entries()] == [6, 7, 8, 9]
    assert fr.entries() == jfr.entries()


def test_record_request_segments_match_jax():
    now = time.time()
    pc = time.perf_counter()
    stamps = dict(arrival_s=now - 1.0, admit_pc=pc - 0.5,
                  first_token_s=now - 0.3, finish_s=now - 0.1)
    fr, jfr = FlightRecorder(capacity=2), JFlightRecorder(capacity=2)
    fr.record_request(FakeReq(7, **stamps), slot=1, status="ok")
    jfr.record_request(FakeReq(7, **stamps), slot=1, status="ok")
    (e,), (je,) = fr.entries(), jfr.entries()
    assert e["uid"] == 7 and e["slot"] == 1 and e["status"] == "ok"
    assert e["prompt_tokens"] == 3 and e["tokens"] == 2
    assert e["queue_s"] == pytest.approx(0.5, abs=0.05)
    assert e["staging_s"] == pytest.approx(0.2, abs=0.05)
    assert e["decode_s"] == pytest.approx(0.2, abs=0.05)
    assert e["latency_s"] == pytest.approx(0.9, abs=0.05)
    assert set(e) == set(je)
    for k in e:     # the two epochs differ by the constructions' distance
        if isinstance(e[k], float):
            assert e[k] == pytest.approx(je[k], abs=1e-3), k
        else:
            assert e[k] == je[k], k


def test_record_request_tolerates_missing_stamps():
    fr = FlightRecorder(capacity=2)
    fr.record_request(FakeReq(1), status="shed")
    (e,) = fr.entries()
    assert e["status"] == "shed"
    assert e["queue_s"] is None and e["decode_s"] is None


def _fill(fr):
    for i in range(5):
        fr.record_request(FakeReq(i))
    h = fr.record_fault("quarantine", uid=4, slot=0)
    fr.record_request(FakeReq(99), status="poisoned")
    fr.record_fault("watchdog_hang", deadline_s=1.0)
    return h


def _untimed(dumps):
    return [{**d, "header": {k: v for k, v in d["header"].items()
                             if k != "time_s"}} for d in dumps]


def test_dump_and_load_round_trip_reads_the_jax_files(tmp_path):
    path, jpath = tmp_path / "flight.jsonl", tmp_path / "jflight.jsonl"
    fr = FlightRecorder(capacity=3, path=str(path))
    h = _fill(fr)
    _fill(JFlightRecorder(capacity=3, path=str(jpath)))
    assert h["entries"] == 3 and h["kind"] == "quarantine"
    assert fr.dumps == 2

    dumps = load_flight(str(path))
    assert len(dumps) == 2
    assert dumps[0]["fault"] == {"kind": "quarantine", "uid": 4, "slot": 0}
    assert [r["uid"] for r in dumps[0]["requests"]] == [2, 3, 4]
    assert dumps[1]["fault"]["kind"] == "watchdog_hang"
    assert dumps[1]["requests"][-1]["uid"] == 99
    assert dumps[1]["header"]["recorded_total"] == 6
    # One layout: each package reads the other's file alike.
    assert _untimed(load_flight(str(jpath))) == _untimed(dumps)
    assert _untimed(jload_flight(str(path))) == _untimed(dumps)


def test_load_flight_skips_foreign_lines(tmp_path):
    path = tmp_path / "mixed.jsonl"
    fr = FlightRecorder(capacity=2, path=str(path))
    fr.record_request(FakeReq(0))
    with open(path, "a") as f:
        f.write(json.dumps({"unrelated": "line"}) + "\n")
    fr.record_fault("shed", uid=0, reason="queue_full")
    dumps = load_flight(str(path))
    assert len(dumps) == 1
    assert dumps[0]["fault"]["reason"] == "queue_full"


def test_memory_only_recorder_never_writes(tmp_path):
    fr = FlightRecorder(capacity=2, path=None)
    fr.record_request(FakeReq(0))
    fr.record_fault("quarantine")
    assert fr.dumps == 1 and fr.last_fault["kind"] == "quarantine"
    assert list(tmp_path.iterdir()) == []


def test_concurrent_dumps_stay_whole(tmp_path):
    """The watchdog's thread dumps while the serving thread records and
    dumps: under a short switch interval, with more threads than cores,
    every dump keeps its own index and its lines."""
    import os
    import sys
    import threading
    path = tmp_path / "race.jsonl"
    fr = FlightRecorder(capacity=8, path=str(path))
    n_threads, n_dumps = 2 * (os.cpu_count() or 2) + 2, 25
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def dumper(t):
            for i in range(n_dumps):
                fr.record_request(FakeReq(1000 * t + i))
                fr.record_fault("shed", uid=t, i=i)
        threads = [threading.Thread(target=dumper, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    dumps = load_flight(str(path))
    assert fr.dumps == len(dumps) == n_threads * n_dumps
    assert sorted(d["header"]["flight_dump"] for d in dumps) == \
        list(range(n_threads * n_dumps))
    assert all(d["fault"]["kind"] == "shed" and
               len(d["requests"]) == d["header"]["entries"] for d in dumps)


# ---------------------------------------------------------------------------
# the engine's dumps on fault events, against the JAX engine's
# ---------------------------------------------------------------------------
def _dumps(kw, tmp_path, n=4, length=8, before_run=None, deadline=None):
    """The JAX and the port engine on one option set with a flight path:
    (port engine, port requests, port dumps), asserting the two dump
    sequences agree (kind, fault facts, request uids and statuses)."""
    jm, jp, tm, tp = _pair()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, V, length).tolist() for _ in range(n)]
    out = []
    for tag, eng_cls, cfg_cls, model, params in (
            ("jax", JContinuous, JServeConfig, jm, jp),
            ("port", ContinuousEngine, ServeConfig, tm, tp)):
        path = tmp_path / f"{tag}.jsonl"
        eng = eng_cls(model, params, cfg_cls(**kw, flight_records=8,
                                             flight_path=str(path)))
        for p in prompts:
            eng.submit(p, deadline_s=deadline)
        with torch.inference_mode():
            if before_run is not None:
                before_run(eng)
            done = eng.run()
        eng.close()
        dumps = load_flight(str(path)) if path.exists() else []
        out.append((eng, done, dumps, [
            (d["header"]["kind"], d["fault"],
             [(r["uid"], r["status"], r["slot"]) for r in d["requests"]])
            for d in dumps]))
    assert out[1][3] == out[0][3]
    return out[1][:3]


def test_engine_dumps_on_quarantine_and_reader_parses(tmp_path, capsys):
    eng, done, dumps = _dumps(dict(max_batch=2, prefill_buckets=(16,),
                                   max_new_tokens=4, poison_probe="logits",
                                   fault_plan="poison@3:slot=0"), tmp_path)
    assert len(done) == 4
    assert "poisoned" in sorted(r.status for r in done)
    assert eng.flight.dumps >= 1
    kinds = [d["fault"]["kind"] for d in dumps]
    assert "quarantine" in kinds
    qd = dumps[kinds.index("quarantine")]
    assert any(r["status"] == "poisoned" for r in qd["requests"])
    # finished requests keep flowing into the ring after the fault
    assert eng.flight.recorded == 4

    path = str(tmp_path / "port.jsonl")
    rc = trace_report.main(["--flight", path, "--check"])
    assert rc == 0
    assert "quarantine" in capsys.readouterr().out

    rc = trace_report.main(["--flight", path, "--json"])
    assert rc == 0
    parsed = json.loads(capsys.readouterr().out)
    assert len(parsed) == len(dumps)


def test_engine_dumps_on_watchdog_recovery_and_retries(tmp_path):
    eng, done, dumps = _dumps(dict(max_batch=2, prefill_buckets=(16,),
                                   max_new_tokens=4, prefill_chunk=8,
                                   watchdog_action="recover"), tmp_path,
                              before_run=_hang_after_one_poll)
    kinds = [d["header"]["kind"] for d in dumps]
    assert kinds == ["watchdog_hang", "retry", "retry", "watchdog_recover"]
    assert all(r.status == "ok" for r in done)
    assert eng.flight.recorded == 4


def test_engine_dumps_on_shed_and_retry_exhaustion(tmp_path):
    def expire_then_hang(eng):
        eng.poll()                      # requests 1 and 2 decoding
        eng._slot_req[0].deadline_s = time.time() - 1.0
        eng.poll()                      # 1 shed in flight, 3 admitted
        eng._on_hang()                  # 2 and 3: no retry budget left
    eng, _, dumps = _dumps(dict(max_batch=2, prefill_buckets=(16,),
                                max_new_tokens=6, shed_inflight=True,
                                watchdog_action="recover", max_retries=0),
                           tmp_path, n=3, deadline=time.time() + 3600,
                           before_run=expire_then_hang)
    assert [(r.uid, r.status) for r in eng._finished] == [
        (1, "shed_deadline"), (3, "retry_exhausted"),     # slot 0, then 1
        (2, "retry_exhausted")]
    assert [(d["header"]["kind"], d["fault"].get("reason"))
            for d in dumps] == [("shed", "deadline"),
                                ("watchdog_hang", None),
                                ("shed", "retry_exhausted"),
                                ("shed", "retry_exhausted"),
                                ("watchdog_recover", None)]


def test_engine_without_flight_config_has_no_recorder():
    _, _, tm, tp = _pair()
    eng = ContinuousEngine(tm, tp, ServeConfig(
        max_batch=2, prefill_buckets=(16,), max_new_tokens=4))
    try:
        assert eng.flight is None
    finally:
        eng.close()


def test_flight_check_fails_on_empty_file(tmp_path):
    path = tmp_path / "empty.jsonl"
    path.write_text("")
    assert trace_report.main(["--flight", str(path), "--check"]) == 1
    assert trace_report.main(["--flight", str(path)]) == 0


def test_cli_flight_dump_renders(tmp_path, capsys):
    """The serve CLI's --flight-path with a poison plan, then the report
    reader on its file."""
    from repro_torch.launch import serve
    path = tmp_path / "cli.jsonl"
    engine, done = serve.main([
        "--reduced", "--device", "cpu", "--engine", "continuous",
        "--prefill-chunk", "16", "--requests", "4", "--batch", "2",
        "--max-new", "5", "--fault-plan", "poison@4:slot=1",
        "--poison-probe", "logits", "--flight-records", "16",
        "--flight-path", str(path)])
    assert engine._watchdog is None and engine.metrics.quarantined == 1
    assert [d["header"]["kind"] for d in load_flight(str(path))] == \
        ["quarantine"]
    capsys.readouterr()
    assert trace_report.main(["--flight", str(path), "--check"]) == 0
    out = capsys.readouterr().out
    assert "quarantine" in out and "poisoned" in out
