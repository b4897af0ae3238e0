"""The port's SLO reports and incident plane (``videop2p_tpu_torch/obs/
{slo,history,flight,incident}.py``, the ledger's flight tee, and the
engine's and the stream driver's triggers) on the CPU.

``evaluate_slos`` / ``record_from_summaries`` / ``emit_slo_reports`` are held
to the JAX package's on the same records (equal events: the same float64
arithmetic, tolerance 0). The flight ring, the tee, the bundles, the
debounce, SIGUSR1 and the crash hooks are held to JAX's contract (its
``tests/test_incident.py``); the engine's ``slo=`` / ``incidents=`` and the
stream driver's ``window_poisoned`` trigger run on a tiny engine.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from tests.test_torch_parity import TEST_THREADS  # noqa: F401 — one thread a process

from videop2p_tpu.obs import slo as jslo
from videop2p_tpu_torch.obs import slo as tslo
from videop2p_tpu_torch.obs.flight import FLIGHT_DEFAULT_CAPACITY, FlightRecorder
from videop2p_tpu_torch.obs.incident import (
    INCIDENT_FIELDS,
    INCIDENT_TRIGGERS,
    IncidentManager,
)
from videop2p_tpu_torch.obs.ledger import RunLedger, read_ledger

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC_KW = dict(tiny=True, width=16, video_len=2, steps=2)
PROMPTS = ("a rabbit is jumping", "a origami rabbit is jumping")


def _bundles(root):
    return sorted(d for d in os.listdir(root)
                  if d.startswith("incident_") and ".tmp" not in d
                  and os.path.isdir(os.path.join(root, d)))


# ------------------------------------------------------------- SLOs -----


def _records(seed):
    """Seeded run records in every shape evaluate_slos meets: rates under
    and over budget, a zero denominator, absent sections, a NaN and an inf
    metric, booleans and strings the summaries carry beside numbers."""
    rng = np.random.default_rng(seed)
    requests = float(rng.integers(0, 50))
    health = {"requests": int(requests), "done": int(rng.integers(0, 50)),
              "errors": int(rng.integers(0, 4)),
              "deadline_exceeded": int(rng.integers(0, 3)),
              "error_rate": float(rng.choice([0.0, 0.004, 0.02, 0.5])),
              "scheduler": "fair", "breaker_open": bool(rng.integers(0, 2)),
              "tenants": {"A": {"done": 3}}}
    timing = {"serve_request_e2e": {"count": 9,
                                    "blocked_p99_s": float(rng.choice([1.5, 29.9, 31.0]))},
              "serve_dispatch": {"blocked_p50_s": 0.2}}
    stream = {"stream": {"seam_min_psnr": float(rng.choice(
        [float("inf"), 40.0, 15.0, 9.5, 0.0]))}}
    return health, timing, stream


@pytest.mark.parametrize("seed", range(6))
def test_slo_reports_equal_jax(seed, tmp_path):
    """The same summaries through both packages give the same objectives
    and the same ``slo_report`` events, in order."""
    from videop2p_tpu.obs import RunLedger as JaxLedger
    from videop2p_tpu.obs import read_ledger as jax_read

    health, timing, stream = _records(seed)
    for kw in (dict(health=health, timing=timing, stream=stream),
               dict(health=health), dict(timing=timing, label="x"), {}):
        ra = jslo.record_from_summaries(**kw)
        rb = tslo.record_from_summaries(**kw)
        assert ra == rb
        assert jslo.evaluate_slos(ra) == tslo.evaluate_slos(rb)
    rec = tslo.record_from_summaries(health=health, timing=timing, stream=stream)
    with JaxLedger(str(tmp_path / "jax.jsonl")) as led:
        oa = jslo.emit_slo_reports(led, rec)
    with RunLedger(str(tmp_path / "port.jsonl")) as led:
        ob = tslo.emit_slo_reports(led, rec)
    assert oa == ob and len(ob) == 4
    ea = [{k: v for k, v in e.items() if k != "t"}
          for e in jax_read(str(tmp_path / "jax.jsonl")) if e["event"] == "slo_report"]
    eb = [{k: v for k, v in e.items() if k != "t"}
          for e in read_ledger(str(tmp_path / "port.jsonl")) if e["event"] == "slo_report"]
    assert ea == eb
    assert all(set(e) == {"event", *tslo.SLO_REPORT_FIELDS} for e in eb)


def test_slo_specs_rules_and_schemas_equal_jax():
    """The objectives, the burn rules and every schema the JAX readers key
    on (``SLO_REPORT_FIELDS``, ``INCIDENT_FIELDS``, ``INCIDENT_TRIGGERS``)
    are JAX's; custom specs burn alike (value_min's inf, a zero target)."""
    import dataclasses

    from videop2p_tpu.obs import incident as jinc

    assert tslo.SLO_REPORT_FIELDS == jslo.SLO_REPORT_FIELDS
    assert [dataclasses.astuple(s) for s in tslo.DEFAULT_SLOS] == [
        dataclasses.astuple(s) for s in jslo.DEFAULT_SLOS]
    assert [dataclasses.astuple(r) for r in tslo.SLO_RULES] == [
        dataclasses.astuple(r) for r in jslo.SLO_RULES]
    assert [r.name for r in tslo.SLO_RULES] == [r.name for r in jslo.SLO_RULES]
    assert INCIDENT_FIELDS == jinc.INCIDENT_FIELDS
    assert INCIDENT_TRIGGERS == jinc.INCIDENT_TRIGGERS
    rec = {"s": {"l": {"zero": 0.0, "neg": -1.0, "big": 5.0, "inf": float("inf")}}}
    for mode in ("rate_max", "value_max", "value_min"):
        for target in (0.0, 1.0):
            for field in ("zero", "neg", "big", "inf"):
                sa = jslo.SLOSpec("n", "s", "l", field, target, mode=mode)
                sb = tslo.SLOSpec("n", "s", "l", field, target, mode=mode)
                assert jslo.evaluate_slos(rec, [sa]) == tslo.evaluate_slos(rec, [sb])


# ------------------------------------------------------ flight ring -----


def test_flight_ring_is_bounded_thread_safe_and_accounted():
    ring = FlightRecorder(capacity=64)

    def hammer(worker):
        for i in range(500):
            ring.record({"event": "load", "worker": worker, "i": i})

    threads = [threading.Thread(target=hammer, args=(w,)) for w in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(ring) == 64
    assert ring.stats() == {"capacity": 64, "buffered": 64, "seen": 2000, "dropped": 1936}
    snap = ring.snapshot()
    for w in range(4):
        idxs = [e["i"] for e in snap if e["worker"] == w]
        assert idxs == sorted(idxs)
    assert ring.overhead_probe(n=64) > 0.0
    assert ring.stats()["seen"] == 2000
    ring.record(None)  # never raises
    assert FlightRecorder(capacity=0).capacity == 1
    assert FLIGHT_DEFAULT_CAPACITY == 2048


def test_ledger_flight_tee_is_bit_exact(tmp_path):
    """Attaching a recorder changes the written JSONL by nothing (the same
    lines but the monotonic ``t``), and the ring holds exactly the records
    the ledger wrote — ``run_end`` included — as a replayable ledger."""

    def drive(led):
        led.event("fault", kind="dispatch_fail", detail="attempt=2")
        led.event("breaker", state_from="closed", state_to="open")
        for i in range(5):
            led.event("span", name="serve.dispatch", i=i)
        led.close()

    def canon(path):
        out = []
        for e in read_ledger(path):
            e.pop("t", None)
            if e["event"] == "run_start":
                e.pop("wall_time"), e.pop("git_sha")
            out.append(e)
        return out

    drive(RunLedger(str(tmp_path / "plain.jsonl"), run_id="r0"))
    teed = RunLedger(str(tmp_path / "teed.jsonl"), run_id="r0")
    ring = FlightRecorder(capacity=4)
    teed.flight = ring
    drive(teed)
    assert canon(str(tmp_path / "plain.jsonl")) == canon(str(tmp_path / "teed.jsonl"))
    snap = ring.snapshot()
    assert [e["event"] for e in snap] == ["span"] * 3 + ["run_end"]
    assert ring.stats()["seen"] == 8 and ring.stats()["dropped"] == 4
    # bit for bit: each ring record serializes to the ledger's own line
    lines = open(str(tmp_path / "teed.jsonl")).read().splitlines()
    assert [json.dumps(e, default=str) for e in snap] == lines[-4:]
    n = ring.dump_jsonl(str(tmp_path / "ring.jsonl"))
    assert n == 4 and open(str(tmp_path / "ring.jsonl")).read().splitlines() == lines[-4:]


# ------------------------------------------------- incident manager -----


def test_incident_bundle_contents_debounce_and_dead_targets(tmp_path):
    from videop2p_tpu_torch.obs.tsdb import TimeSeriesStore, load_series_sidecar

    ts = TimeSeriesStore()
    for i in range(8):
        ts.add("queue_depth", float(i), float(i % 3), {"replica": "replica0"})
    mgr = IncidentManager(str(tmp_path / "inc"), tsdb=ts, cooldown_s=3600.0,
                          cooldowns={"sigusr1": 0.0})
    led = RunLedger(str(tmp_path / "led.jsonl"), run_id="unit")
    mgr.attach_ledger(led)
    mgr.note_fingerprint("engine:unit", "fp-abc")
    mgr.register_target("engine:unit", lambda: {"healthz": {"status": "ok"}, "metrics": {}})
    mgr.register_target("router:dead",
                        lambda: (_ for _ in ()).throw(OSError("conn refused")))
    mgr.register_exemplars(
        lambda: {"serve_edit": {"p99_trace_id": "tid-a", "max_trace_id": "tid-b"}})
    led.event("fault", kind="hang", detail="attempt=5")

    bundle = mgr.trigger("breaker_open", detail="closed->open",
                         extra_files={"../escape/crash.txt": "boom"}, trips=1)
    assert bundle is not None and os.path.isdir(bundle)
    assert mgr.trigger("breaker_open", detail="flap") is None
    assert mgr.trigger("breaker_open", detail="flap") is None
    assert mgr.trigger("sigusr1", detail="on demand") is not None
    assert len(_bundles(str(tmp_path / "inc"))) == 2
    assert sorted(os.listdir(bundle)) == ["crash.txt", "flight.jsonl", "manifest.json",
                                          "series.npz", "targets.json"]
    man = json.load(open(os.path.join(bundle, "manifest.json")))
    assert man["trigger"] == "breaker_open" and man["context"] == {"trips": 1}
    assert man["fingerprints"] == {"engine:unit": "fp-abc"}
    assert man["exemplars"]["serve_edit"]["p99_trace_id"] == "tid-a"
    assert man["flight"]["buffered"] == 1 and man["flight_record_ns"] > 0
    assert man["bundle_id"] in os.path.basename(bundle)
    assert any("queue_depth" in k
               for k in load_series_sidecar(os.path.join(bundle, "series.npz")))
    targets = json.load(open(os.path.join(bundle, "targets.json")))
    assert targets["engine:unit"]["healthz"]["status"] == "ok"
    assert "conn refused" in targets["router:dead"]["error"]
    assert [e["event"] for e in read_ledger(os.path.join(bundle, "flight.jsonl"))] == ["fault"]
    led.close()
    incs = [e for e in read_ledger(led.path) if e["event"] == "incident"]
    assert len(incs) == 2 and set(incs[0]) == {"event", "t", *INCIDENT_FIELDS}
    assert mgr.summary()["by_trigger"] == {"breaker_open": 1, "sigusr1": 1}
    assert mgr.summary()["suppressed"] == {"breaker_open": 2}
    mgr.cooldowns["breaker_open"] = 0.0
    b2 = mgr.trigger("breaker_open", detail="third")
    assert json.load(open(os.path.join(b2, "manifest.json")))["suppressed_since_last"] == 2
    mgr.close()
    assert mgr.trigger("crash", detail="after close") is None


def test_sigusr1_capture_and_every_hook_restored(tmp_path):
    import faulthandler

    prev = (sys.excepthook, threading.excepthook, signal.getsignal(signal.SIGUSR1),
            faulthandler.is_enabled())
    mgr = IncidentManager(str(tmp_path / "inc"), crash_hooks=True,
                          cooldowns={"sigusr1": 0.0})
    try:
        assert sys.excepthook is not prev[0] and threading.excepthook is not prev[1]
        os.kill(os.getpid(), signal.SIGUSR1)
        deadline = time.perf_counter() + 5.0
        while not _bundles(str(tmp_path / "inc")):
            assert time.perf_counter() < deadline, "SIGUSR1 capture never landed"
            time.sleep(0.01)
        bundle = os.path.join(str(tmp_path / "inc"), _bundles(str(tmp_path / "inc"))[0])
        assert json.load(open(os.path.join(bundle, "manifest.json")))["trigger"] == "sigusr1"
        assert os.path.exists(os.path.join(str(tmp_path / "inc"), "faulthandler.log"))
    finally:
        mgr.close()
    assert (sys.excepthook, threading.excepthook, signal.getsignal(signal.SIGUSR1),
            faulthandler.is_enabled()) == prev


def test_crash_bundle_from_a_serve_cli_subprocess(tmp_path):
    """``cli.serve --device cpu --incidents DIR`` on a port another socket
    holds: the bind fails after the engine armed the plane, the unhandled
    error writes a crash bundle (traceback + every thread's stack) and the
    process exits nonzero through the chained hook."""
    root = str(tmp_path / "crash_inc")
    with socket.socket() as holder:
        holder.bind(("127.0.0.1", 0))
        holder.listen(1)
        port = holder.getsockname()[1]
        proc = subprocess.run(
            [sys.executable, "-m", "videop2p_tpu_torch.cli.serve", "--device", "cpu",
             "--tiny", "--steps", "2", "--video_len", "2", "--no_warm", "--port", str(port),
             "--out_dir", str(tmp_path / "out"), "--incidents", root],
            capture_output=True, text=True, timeout=120.0, cwd=_REPO)
    assert proc.returncode != 0
    assert "Address already in use" in proc.stderr  # the chained hook printed it
    names = _bundles(root)
    assert len(names) == 1
    bundle = os.path.join(root, names[0])
    man = json.load(open(os.path.join(bundle, "manifest.json")))
    assert man["trigger"] == "crash" and "OSError" in man["detail"]
    assert list(man["fingerprints"].values())[0]  # the engine noted its spec
    crash = open(os.path.join(bundle, "crash.txt")).read()
    assert "Address already in use" in crash and "faulthandler (all threads)" in crash
    targets = json.load(open(os.path.join(bundle, "targets.json")))
    (name, snap), = targets.items()
    assert name.startswith("engine:") and snap["healthz"]["requests"] == 0


# ------------------------------------------- engine and stream triggers -----


@pytest.fixture(scope="module")
def programs():
    from videop2p_tpu_torch.serve import ProgramSet, ProgramSpec

    ps = ProgramSet(ProgramSpec(**SPEC_KW), device="cpu")
    ps.warm(PROMPTS)
    return ps


def _request(**overrides):
    from videop2p_tpu_torch.serve import EditRequest

    kw = dict(image_path="data/rabbit", prompt=PROMPTS[0], prompts=list(PROMPTS),
              save_name="inc")
    kw.update(overrides)
    return EditRequest(**kw)


def test_engine_breaker_open_bundle_and_owned_manager_closed(programs, tmp_path):
    """``incidents=DIR`` under ``unavail@1-999``: the breaker opens, a
    ``breaker_open`` bundle holds the engine's /healthz + /metrics and the
    flight ring's fault trail, the ``incident`` event lands in the engine's
    ledger, and close() restores the crash hooks the owned manager set."""
    from videop2p_tpu_torch.serve import EditEngine, FaultPlan, ProgramSpec

    prev = (sys.excepthook, threading.excepthook, signal.getsignal(signal.SIGUSR1))
    root = str(tmp_path / "inc")
    eng = EditEngine(ProgramSpec(**SPEC_KW), out_dir=str(tmp_path / "out"), programs=programs,
                     faults=FaultPlan.parse("unavail@1-999"), max_retries=0,
                     breaker_threshold=1, incidents=root, slo=True, device="cpu")
    try:
        assert sys.excepthook is not prev[0]
        rec = eng.result(eng.submit(_request()), wait_s=60.0)
        assert rec["status"] == "error"
        assert eng.breaker.state == "open"
    finally:
        eng.close()
    assert (sys.excepthook, threading.excepthook, signal.getsignal(signal.SIGUSR1)) == prev
    (name,) = _bundles(root)
    bundle = os.path.join(root, name)
    man = json.load(open(os.path.join(bundle, "manifest.json")))
    assert man["trigger"] == "breaker_open"
    assert man["fingerprints"] == {f"engine:{eng.ledger.run_id}": eng.spec.fingerprint()}
    targets = json.load(open(os.path.join(bundle, "targets.json")))
    snap = targets[f"engine:{eng.ledger.run_id}"]
    assert snap["metrics"]["breaker"]["state"] == "open"
    assert snap["healthz"]["breaker_trips"] == 1
    flight = [e["event"] for e in read_ledger(os.path.join(bundle, "flight.jsonl"))]
    assert "fault" in flight and "breaker" in flight
    events = read_ledger(eng.ledger.path)
    kinds = [e["event"] for e in events]
    inc = [e for e in events if e["event"] == "incident"]
    assert len(inc) == 1 and inc[0]["trigger"] == "breaker_open" and inc[0]["bundle"] == bundle
    # slo=True: the objectives over the live summaries, before serve_health
    slo = [e for e in events if e["event"] == "slo_report"]
    assert [e["name"] for e in slo] == ["availability", "deadline_miss_rate"]
    assert slo[0]["actual"] == 1.0 and slo[0]["compliant"] is False
    assert max(i for i, k in enumerate(kinds) if k == "slo_report") < kinds.index("serve_health")


def test_engine_slo_reports_at_close_equal_the_live_summaries(programs, tmp_path):
    """``slo=True`` on a healthy engine: one ``slo_report`` per objective
    whose metric exists, equal to JAX's ``evaluate_slos`` over the engine's
    own closing summaries."""
    from videop2p_tpu_torch.serve import EditEngine, ProgramSpec

    eng = EditEngine(ProgramSpec(**SPEC_KW), out_dir=str(tmp_path / "out"), programs=programs,
                     slo=True, device="cpu")
    try:
        assert eng.result(eng.submit(_request()), wait_s=60.0)["status"] == "done"
        health = eng.health_record()
        timing = eng.ledger.execute_timing_summary()
    finally:
        eng.close()
    slo = [{k: v for k, v in e.items() if k not in ("event", "t")}
           for e in read_ledger(eng.ledger.path) if e["event"] == "slo_report"]
    want = jslo.evaluate_slos(jslo.record_from_summaries(health=health, timing=timing))
    assert [e["name"] for e in slo] == ["availability", "deadline_miss_rate",
                                       "served_p99_latency"]
    assert slo[:2] == want[:2] and all(e["compliant"] for e in slo)
    assert slo[2]["name"] == want[2]["name"] and slo[2]["target"] == want[2]["target"]


def test_stream_poisoned_window_fires_the_incident_trigger(programs, tmp_path):
    """A window that keeps failing degrades to passthrough and fires
    ``window_poisoned`` on the engine's manager: one bundle for the run
    (debounced), with the window's index in its context."""
    from videop2p_tpu_torch.serve import EditEngine, FaultPlan, ProgramSpec
    from videop2p_tpu_torch.stream import run_stream_job, synthetic_clip

    root = str(tmp_path / "inc")
    mgr = IncidentManager(root)
    eng = EditEngine(ProgramSpec(**SPEC_KW), out_dir=str(tmp_path / "out"), programs=programs,
                     faults=FaultPlan.parse("unavail@3-999"), max_retries=0,
                     breaker_threshold=1000, keep_videos=True, incidents=mgr, device="cpu")
    try:
        res = run_stream_job(eng, synthetic_clip(5, 16, seed=1), PROMPTS,
                             job_dir=str(tmp_path / "job"), overlap=1, max_inflight=1,
                             window_retries=0)
        assert res.health["windows_passthrough"] == 2
    finally:
        eng.close()
        mgr.close()
    recs = mgr.records()
    assert [r["trigger"] for r in recs] == ["window_poisoned"]
    assert mgr.summary()["suppressed"] == {"window_poisoned": 1}
    man = json.load(open(os.path.join(recs[0]["bundle"], "manifest.json")))
    assert man["context"]["index"] == 2 and "passthrough" in man["detail"]
    assert [e["trigger"] for e in read_ledger(eng.ledger.path)
            if e["event"] == "incident"] == ["window_poisoned"]
