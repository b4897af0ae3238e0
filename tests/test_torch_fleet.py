"""The port's fleet tier on the CPU, at the JAX serving tests' tiny spec
(``tiny=True, width=16, video_len=2, steps=2``): two in-process replicas over
one shared warm ``ProgramSet`` and one shared disk inversion store behind a
``Router`` — the cross-replica disk hit, the router's HTTP round trip and
aggregation, shedding around a replica whose breaker opened, a wedged
replica bounded by the probe timeout, router → replica traceparent
propagation, two requests served at once through the shared set giving the
bits each gives alone, the router CLI (``--spawn 2 --device cpu``) and the
router's Prometheus text and schema against the JAX package's.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from tests.test_torch_parity import TEST_THREADS  # noqa: F401 — one thread a process

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(tiny=True, width=16, video_len=2, steps=2)
PROMPTS = ("a rabbit is jumping", "a origami rabbit is jumping")


def _request(**overrides):
    from videop2p_tpu_torch.serve import EditRequest

    kw = dict(image_path="data/rabbit", prompt=PROMPTS[0], prompts=list(PROMPTS),
              save_name="origami")
    kw.update(overrides)
    return EditRequest(**kw)


@pytest.fixture(scope="module")
def programs():
    from videop2p_tpu_torch.serve import ProgramSet, ProgramSpec

    return ProgramSet(ProgramSpec(**KW), device="cpu")


def _supervisor(programs, root, **kw):
    from videop2p_tpu_torch.serve import ReplicaSupervisor

    engine_kwargs = dict(keep_videos=True, device="cpu")
    engine_kwargs.update(kw.pop("engine_kwargs", {}))
    return ReplicaSupervisor(programs.spec, 2, out_dir=str(root), programs=programs,
                             warm_prompts=PROMPTS, engine_kwargs=engine_kwargs, **kw)


@pytest.fixture(scope="module")
def fleet(programs, tmp_path_factory):
    """Two in-process replicas over ONE shared disk inversion-store root and
    one shared warm ProgramSet, behind a router's HTTP front door."""
    from videop2p_tpu_torch.serve import Router, RouterServer

    root = tmp_path_factory.mktemp("fleet")
    sup = _supervisor(programs, root)
    sup.start()
    router = Router(sup.urls, probe_ttl_s=0.05, ledger_path=str(root / "router_ledger.jsonl"))
    server = RouterServer(router).start()
    yield sup, router, server
    server.close()
    sup.stop()


def test_cross_replica_disk_store_hit_no_program_miss(fleet):
    """A request inverted on replica A is a DISK store hit on replica B
    (shared content-addressed root): rebuilt through the shared warm
    programs with src_err == 0.0, no compile event or program-cache miss,
    no fresh inversion, and the same videos bit for bit."""
    sup, _, _ = fleet
    eng_a, eng_b = sup.replicas[0].engine, sup.replicas[1].engine
    assert eng_a.programs is eng_b.programs
    assert eng_b.warm_steps == eng_a.warm_steps == {2}
    ra = eng_a.result(eng_a.submit(_request(seed=61)), wait_s=120.0)
    assert ra["status"] == "done", ra.get("error")
    assert ra["store_source"] == "fresh" and ra["src_err"] == 0.0
    misses = eng_b.programs.cache_misses
    rb = eng_b.result(eng_b.submit(_request(seed=61)), wait_s=120.0)
    assert rb["status"] == "done", rb.get("error")
    assert rb["store_hit"] is True and rb["store_source"] == "disk"
    assert rb["src_err"] == 0.0
    assert rb["compile_events"] == 0 and rb["program_cache_misses"] == 0
    assert eng_b.programs.cache_misses == misses
    assert eng_b.counters["rehydrations"] == 1
    assert eng_b.counters["fresh_inversions"] == 0
    assert rb["store_key"] == ra["store_key"]
    assert np.array_equal(eng_a.videos(ra["id"]), eng_b.videos(rb["id"]))


def test_router_http_roundtrip_and_fleet_aggregation(fleet):
    from videop2p_tpu_torch.serve import ROUTER_HEALTH_FIELDS, EngineClient, engine_available

    sup, router, server = fleet
    client = EngineClient(server.url)
    assert engine_available(server.url)
    assert not engine_available(None)
    health = client.healthz()
    assert health["ok"] and health["healthy"] == 2 and health["total"] == 2
    assert set(health["replicas"]) == {"replica0", "replica1"}
    rid = client.submit(_request(seed=62).to_dict())
    rec = client.wait(rid, timeout_s=120.0)
    assert rec["status"] == "done" and rec["src_err"] == 0.0
    assert rec["replica"] in ("replica0", "replica1")
    # the server-side wait proxies to the owning replica
    rec_srv = client.result(rid, wait_s=5.0)
    assert rec_srv["status"] == "done" and rec_srv["id"] == rid
    metrics = client.metrics()
    assert metrics["router"]["routed"] >= 1
    assert set(metrics["replicas"]) == {"replica0", "replica1"}
    assert metrics["requests"].get("done", 0) >= 1
    # machine-readable surfaces: 404 unknown id, 400 malformed body
    with pytest.raises(RuntimeError, match="404"):
        client.poll("feedfacefeed")
    with pytest.raises(RuntimeError, match="400"):
        client.submit({"prompt": "a", "bogus": True})
    record = router.health_record()
    assert set(ROUTER_HEALTH_FIELDS) <= set(record)
    assert record["replicas"] == 2 and record["routed"] >= 1
    # the fleet's Prometheus text over real HTTP: labeled replica series,
    # nobody quarantined (no prober wired)
    text = client.metrics_prometheus()
    assert "# TYPE videop2p_replica_requests_total gauge" in text
    assert 'videop2p_replica_in_flight{replica="replica0"} 0' in text
    assert 'videop2p_replica_quarantined{replica="replica0"} 0' in text
    assert "# TYPE videop2p_queue_depth gauge" in EngineClient(sup.urls[0]).metrics_prometheus()


def test_shared_programs_concurrent_requests_match_alone(programs, fleet, tmp_path):
    """Two replicas' worker threads dispatch through ONE ProgramSet at the
    same time: each request's videos equal, bit for bit, the same request
    served alone afterwards by a fresh engine (no store) over the same set."""
    from videop2p_tpu_torch.serve import EditEngine, ProgramSpec

    sup, _, _ = fleet
    engines = [r.engine for r in sup.replicas]
    reqs = [_request(image_path="data/car", seed=71), _request(image_path="data/tiger", seed=72)]
    rids = [None, None]
    start = threading.Barrier(2)

    def submit(i):
        start.wait()
        rids[i] = engines[i].submit(reqs[i])

    threads = [threading.Thread(target=submit, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    recs = [engines[i].result(rids[i], wait_s=120.0) for i in (0, 1)]
    for rec in recs:
        assert rec["status"] == "done", rec.get("error")
        assert rec["store_source"] == "fresh" and rec["src_err"] == 0.0
    alone = EditEngine(ProgramSpec(**KW), out_dir=str(tmp_path / "alone"), programs=programs,
                       keep_videos=True, device="cpu")
    try:
        for i in (0, 1):
            rec = alone.result(alone.submit(reqs[i]), wait_s=120.0)
            assert rec["status"] == "done" and rec["store_source"] == "fresh"
            assert np.array_equal(alone.videos(rec["id"]), engines[i].videos(rids[i])), i
    finally:
        alone.close()


def test_router_sheds_to_healthy_replica(programs, tmp_path):
    """Replica 0 sits in an unavailable window (every dispatch raises, its
    breaker trips open after one failure): the router routes AROUND it, the
    healthy replica serves the rest, and the router's ledger closes with
    ``router_health``."""
    from videop2p_tpu_torch.obs import read_ledger
    from videop2p_tpu_torch.serve import EngineClient, Router, RouterServer

    sup = _supervisor(programs, tmp_path,
                      engine_kwargs=dict(max_retries=0, breaker_threshold=1,
                                         breaker_open_s=60.0),
                      faults={0: "unavail@1-999"})
    sup.start()
    ledger_path = str(tmp_path / "router_ledger.jsonl")
    router = Router(sup.urls, probe_ttl_s=0.05, suspend_s=5.0, ledger_path=ledger_path)
    server = RouterServer(router).start()
    try:
        client = EngineClient(server.url, timeout_s=60.0)
        recs = [client.wait(client.submit(_request(seed=63).to_dict()), timeout_s=120.0)
                for _ in range(4)]
        health0 = sup.replicas[0].engine.health_record()
        health1 = sup.replicas[1].engine.health_record()
        record = router.health_record()
    finally:
        server.close()
        sup.stop()
    done = [r for r in recs if r["status"] == "done"]
    # the faulted replica doomed its one pre-breaker request; the router
    # shed every later one to replica 1
    assert len(done) >= 3, [(r["status"], r.get("replica")) for r in recs]
    assert all(r["replica"] == "replica1" and r["src_err"] == 0.0 for r in done)
    assert record["routed_around"] >= 1 and record["healthy"] == 1
    assert health0["breaker_trips"] >= 1
    assert health1["errors"] == 0
    assert sup.replicas == []
    events = read_ledger(ledger_path)
    closing = [e for e in events if e["event"] == "router_health"]
    assert len(closing) == 1 and closing[0]["routed_around"] >= 1


def test_router_wedged_replica_probe_timeout_routes_around():
    """A WEDGED replica (accepts TCP connections, never answers) costs the
    router its short probe timeout once and is then routed AROUND; proxied
    polls against it are bounded the same way and mark it suspect."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from videop2p_tpu_torch.serve.router import Router

    class _Wedged(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def do_GET(self):  # noqa: N802 — accept, then never answer
            time.sleep(60.0)

        do_POST = do_GET  # noqa: N815

    class _Healthy(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def _send(self, payload):
            body = json.dumps(payload).encode()
            self.send_response(200 if self.command == "GET" else 202)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802
            if self.path == "/healthz":
                self._send({"ok": True, "status": "ok"})
            else:
                self._send({"queue_depth": 0, "in_flight": 0})

        def do_POST(self):  # noqa: N802
            self.rfile.read(int(self.headers.get("Content-Length", "0")))
            self._send({"id": "feedfacefeed"})

    wedged = ThreadingHTTPServer(("127.0.0.1", 0), _Wedged)
    healthy = ThreadingHTTPServer(("127.0.0.1", 0), _Healthy)
    wedged.daemon_threads = True
    for s in (wedged, healthy):
        threading.Thread(target=s.serve_forever, daemon=True).start()
    urls = [f"http://127.0.0.1:{wedged.server_address[1]}",
            f"http://127.0.0.1:{healthy.server_address[1]}"]
    router = Router(urls, timeout_s=2.0, probe_timeout_s=0.4, probe_ttl_s=0.0, suspend_s=5.0,
                    max_retries=0)
    try:
        t0 = time.perf_counter()
        out = router.submit({"prompt": "a", "prompts": ["a", "b"], "image_path": "x"})
        assert out["replica"] == "replica1"
        assert time.perf_counter() - t0 < 10.0
        assert router.counters["routed_around"] == 1
        health = router.healthz()
        assert health["replicas"]["replica0"]["status"] == "unreachable"
        assert health["replicas"]["replica1"]["ok"]
        with router._lock:
            router._rid_map["deadbeef0000"] = router.views[0]
        t0 = time.perf_counter()
        with pytest.raises(RuntimeError, match="unreachable while proxying"):
            router.poll("deadbeef0000")
        assert time.perf_counter() - t0 < 10.0
        assert router.counters["proxy_errors"] == 1
        assert router.views[0].suspended
    finally:
        for s in (wedged, healthy):
            s.shutdown()
            s.server_close()


def test_router_replica_traceparent_round_trip(programs, tmp_path):
    """A traced request through the router's HTTP hop: the router's
    ``router.submit`` span and the replica's spans share one trace id, and
    the replica's ``serve.request`` root hangs off the router's span."""
    from videop2p_tpu_torch.obs import read_ledger
    from videop2p_tpu_torch.obs.spans import format_traceparent, make_span_id, make_trace_id
    from videop2p_tpu_torch.serve import EngineClient, Router, RouterServer

    sup = _supervisor(programs, tmp_path, engine_kwargs=dict(tracing=True))
    sup.start()
    router = Router(sup.urls, probe_ttl_s=0.05, tracing=True,
                    ledger_path=str(tmp_path / "router_ledger.jsonl"))
    server = RouterServer(router).start()
    try:
        client = EngineClient(server.url)
        tids = []
        for seed in (21, 22):
            tid, sid = make_trace_id(), make_span_id()
            rid = client.submit(_request(seed=seed).to_dict(),
                                traceparent=format_traceparent(tid, sid))
            rec = client.wait(rid, timeout_s=120.0)
            assert rec["status"] == "done", rec.get("error")
            tids.append((tid, sid))
        replica_ledgers = [r.engine.ledger.path for r in sup.replicas]
    finally:
        server.close()
        sup.stop()
    router_spans = [e for e in read_ledger(router.ledger.path) if e["event"] == "span"]
    replica_spans = [e for p in replica_ledgers for e in read_ledger(p) if e["event"] == "span"]
    for tid, caller_span in tids:
        rspan = next(s for s in router_spans if s["trace_id"] == tid)
        assert rspan["name"] == "router.submit" and rspan["parent_id"] == caller_span
        mine = [s for s in replica_spans if s["trace_id"] == tid]
        names = {s["name"] for s in mine}
        assert {"serve.request", "serve.queue", "serve.dispatch"} <= names
        root = next(s for s in mine if s["name"] == "serve.request")
        assert root["parent_id"] == rspan["span_id"]


def test_router_prometheus_and_schema_match_jax():
    """``router_metrics_prometheus`` is byte for byte the JAX package's on
    one fleet record, and the ``router_health`` schema is JAX's."""
    from videop2p_tpu.obs.prom import router_metrics_prometheus as jax_prom
    from videop2p_tpu.serve.router import ROUTER_HEALTH_FIELDS as JAX_FIELDS

    from videop2p_tpu_torch.obs.prom import router_metrics_prometheus
    from videop2p_tpu_torch.serve import ROUTER_HEALTH_FIELDS

    record = {
        "uptime_s": 12.5,
        "router": {"submitted": 4, "routed": 3, "retries": 1, "routed_around": 1,
                   "rejected": 0, "proxy_errors": 0, "quarantined": 0},
        "requests": {"done": 3, "error": 1},
        "replicas": {
            "replica0": {"url": "http://127.0.0.1:1", "routed": 1, "queue_depth": 0,
                         "in_flight": 1, "requests": {"error": 1}, "probe_age_s": 0.01,
                         "probe_status": None, "quarantined": False,
                         "store": {"entries": 1}, "breaker": {"state": "open"}},
            "replica1": {"url": "http://127.0.0.1:2", "routed": 2, "queue_depth": 2,
                         "in_flight": 0, "requests": {"done": 3}, "probe_age_s": None,
                         "probe_status": "quarantine", "quarantined": True,
                         "uptime_s": float("inf")},
        },
    }
    text = router_metrics_prometheus(record)
    assert text == jax_prom(record)
    assert 'videop2p_replica_requests_total{replica="replica1",status="done"} 3' in text
    assert ROUTER_HEALTH_FIELDS == JAX_FIELDS


def test_router_cli_parses_the_jax_flags(monkeypatch):
    from videop2p_tpu.cli.router import build_parser as jax_parser

    from videop2p_tpu_torch.cli.router import build_parser, main

    ours = {a.dest: a for a in build_parser()._actions if a.dest != "help"}
    theirs = {a.dest: a for a in jax_parser()._actions if a.dest != "help"}
    assert set(ours) == set(theirs) | {"device"}
    for dest, act in theirs.items():
        mine = ours[dest]
        assert (mine.option_strings, mine.default, mine.nargs, mine.type) == (
            act.option_strings, act.default, act.nargs, act.type), dest
    assert ours["device"].default == "cuda"
    # --incidents (item 14's rest) is ported: the router is built with it
    import videop2p_tpu_torch.serve.router as router_mod

    seen = {}

    def router(urls, **kw):
        seen.update(kw, urls=list(urls))
        raise KeyboardInterrupt  # stop before serving

    monkeypatch.setattr(router_mod, "Router", router)
    with pytest.raises(KeyboardInterrupt):
        main(["--replicas", "http://127.0.0.1:1", "--incidents", "dir"])
    assert seen["incidents"] == "dir" and seen["urls"] == ["http://127.0.0.1:1"]
    with pytest.raises(SystemExit):
        main([])


def test_router_cli_spawns_replicas_serves_and_drains(tmp_path):
    """``cli/router.py --spawn 2 --device cpu``: two ``cli/serve.py`` children
    on one shared store; the fleet's /healthz answers, a request through the
    router completes, and SIGTERM exits 0 with ``router_health`` in the
    router's ledger and ``serve_health`` in each child's."""
    from videop2p_tpu_torch.obs import read_ledger
    from videop2p_tpu_torch.serve import EngineClient, free_port

    port = free_port()
    out = tmp_path / "fleet"
    proc = subprocess.Popen(
        [sys.executable, "-m", "videop2p_tpu_torch.cli.router", "--spawn", "2", "--device",
         "cpu", "--tiny", "--steps", "2", "--video_len", "2", "--port", str(port),
         "--out_dir", str(out)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    try:
        client = EngineClient(f"http://127.0.0.1:{port}", timeout_s=30.0, retries=0)
        deadline = time.perf_counter() + 120.0
        while True:
            assert proc.poll() is None, proc.stdout.read()
            assert time.perf_counter() < deadline, "the fleet did not come up in 120 s"
            try:
                health = client.healthz()
                break
            except Exception:  # noqa: BLE001 — not listening yet
                time.sleep(0.5)
        assert health["healthy"] == 2 and health["status"] == "ok"
        rec = client.wait(client.submit(_request().to_dict()), timeout_s=120.0)
        assert rec["status"] == "done" and rec["src_err"] == 0.0, rec.get("error")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    assert rc == 0, proc.stdout.read()
    assert any(e["event"] == "router_health"
               for e in read_ledger(str(out / "router_ledger.jsonl")))
    for name in ("replica0", "replica1"):
        kinds = [e["event"] for e in read_ledger(str(out / name / "serve_ledger.jsonl"))]
        assert "serve_health" in kinds, (name, kinds[-5:])
