"""The port's fleet collector (``videop2p_tpu_torch/serve/collector.py``) and
``obs/prom.py:samples_by_name`` on the CPU.

The JSON and the Prometheus scrape paths land identical scalars — through
the JAX collector's ingest functions too, on the same records — over a
scripted target and over the port's tiny engines and router; a target that
dies records ``up = 0`` and an explicit NaN gap in every series it produced;
a burn alert fires the incident trigger. Scrapes take an injected clock
(``scrape_once(now)``): nothing here is timed.
"""

from __future__ import annotations

import json
import math
import threading
import time

import pytest

from tests.test_torch_parity import TEST_THREADS  # noqa: F401 — one thread a process

from videop2p_tpu.obs import tsdb as jts
from videop2p_tpu.serve import collector as jcol
from videop2p_tpu_torch.obs import tsdb as tts
from videop2p_tpu_torch.obs.signals import (
    S_QUEUE_DEPTH,
    S_REQUESTS,
    S_SCRAPE_ERRORS,
    S_UP,
)
from videop2p_tpu_torch.serve import collector as tcol

PROMPTS = ("a rabbit is jumping", "a origami rabbit is jumping")
METRICS = {
    "queue_depth": 2,
    "in_flight": 1,
    "request_latency": {"blocked_p50_s": 0.2, "blocked_p99_s": 0.9},
    "programs": {"serve_queue_wait": {"blocked_p99_s": 0.3, "p99_trace_id": "t1"},
                 "serve_dispatch": {"blocked_p50_s": 0.15}},
    "store": {"hit_rate": 0.5},
    "capacity": {"busy_fraction": 0.4, "padding_waste": 0.0, "cost_per_request_s": 1.5},
    "requests": {"done": 7, "error": 1},
    "tenants": {"A": {"submitted": 5, "done": 4, "shed": 1, "device_seconds": 2.5},
                "probe": {"submitted": 2, "done": 2}},
}


class FakeTarget:
    """A stdlib HTTP stand-in for an engine's /healthz + /metrics (both
    formats), which a test can kill to pin gap recording."""

    def __init__(self, metrics):
        import http.server

        from videop2p_tpu_torch.obs.prom import render_prometheus

        outer = self
        self.metrics = metrics

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def do_GET(self):  # noqa: N802
                if self.path == "/healthz":
                    body, ctype = json.dumps({"ok": True}).encode(), "application/json"
                elif "format=prometheus" in self.path:
                    body, ctype = render_prometheus(outer.metrics).encode(), "text/plain"
                elif self.path.startswith("/metrics"):
                    body, ctype = json.dumps(outer.metrics).encode(), "application/json"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=5.0)


def _latest_map(store):
    return {key: store.latest(key[0], dict(key[1])) for key in store.keys()}


@pytest.mark.parametrize("metrics", [
    METRICS,
    {"queue_depth": 0, "in_flight": 0, "requests": {}},
    {"replicas": {"replica0": {"queue_depth": 1}}, "router": {"submitted": 3}},
])
def test_ingest_equals_jax_for_both_formats(metrics):
    """The port's ``ingest_engine_metrics`` / ``ingest_prom_samples`` write
    JAX's series with JAX's values (terminal statuses zero-filled on both
    paths), and the JSON and Prometheus paths agree with each other."""
    from videop2p_tpu.obs.prom import parse_prometheus as jparse
    from videop2p_tpu_torch.obs.prom import parse_prometheus, render_prometheus

    stores = []
    for mod, store_mod, parse in ((jcol, jts, jparse), (tcol, tts, parse_prometheus)):
        js, ps = store_mod.TimeSeriesStore(), store_mod.TimeSeriesStore()
        n_json = mod.ingest_engine_metrics(js, "replica0", 1.0, metrics)
        n_prom = mod.ingest_prom_samples(ps, "replica0", 1.0,
                                         parse(render_prometheus(metrics))["samples"])
        stores.append((n_json, n_prom, _latest_map(js), _latest_map(ps)))
    assert stores[0] == stores[1]
    n_json, n_prom, js, ps = stores[1]
    if "request_latency" in metrics:
        assert js == ps and n_json == n_prom >= 12


def test_collector_formats_agree_and_a_dead_target_leaves_gaps():
    fake = FakeTarget(METRICS)
    try:
        stores = {}
        for fmt in ("json", "prometheus"):
            col = tcol.FleetCollector([("replica0", fake.url)], fmt=fmt, probe_timeout_s=5.0)
            assert col.scrape_once(now=1.0) == 1
            stores[fmt] = col.tsdb
        assert _latest_map(stores["json"]) == _latest_map(stores["prometheus"])
        col = tcol.FleetCollector([("replica0", fake.url)], probe_timeout_s=5.0)
        assert col.scrape_once(now=1.0) == 1 and col.scrape_once(now=2.0) == 1
        assert col._exemplars == {"serve_queue_wait": {"p99_trace_id": "t1",
                                                       "max_trace_id": None}}
        seen_before = set(col.tsdb.keys())
        fake.close()
        assert col.scrape_once(now=3.0) == 0
        lab = {"replica": "replica0"}
        assert col.tsdb.series(S_UP, lab)[-1] == (3.0, 0.0)
        q = col.tsdb.series(S_QUEUE_DEPTH, lab)
        assert q[-1][0] == 3.0 and math.isnan(q[-1][1])
        gapped = [k for k in seen_before if math.isnan(col.tsdb.series(k[0], dict(k[1]))[-1][1])]
        assert len(gapped) == len(col.targets[0].seen) >= 12
        assert col.tsdb.latest(S_SCRAPE_ERRORS, lab)[1] == 1.0
        assert col.scrape_errors == 1 and col.stats()["gaps"] >= 12
        rec = col.evaluate(now=3.1)
        assert rec["replicas_up"] == 0 and rec["scale_advice"] == "grow"
        assert rec["exemplars"]["serve_queue_wait"]["p99_trace_id"] == "t1"
        assert list(col.history)[-1] is rec
    finally:
        fake.close()


def test_collector_thread_scrapes_on_its_interval_and_rejects_unknown_formats():
    fake = FakeTarget(METRICS)
    try:
        col = tcol.FleetCollector([("replica0", fake.url)], interval_s=0.02,
                                  window_scale=0.001, probe_timeout_s=5.0)
        col.start()
        deadline = time.perf_counter() + 20.0
        while col.scrapes < 3 and time.perf_counter() < deadline:
            time.sleep(0.02)
        col.stop(final_evaluate=True)
        assert col.scrapes >= 3 and col.scrape_errors == 0
        assert col.signals.evaluations >= 1
        up = col.tsdb.series(S_UP, {"replica": "replica0"})
        assert all(a[0] < b[0] for a, b in zip(up, up[1:]))
    finally:
        fake.close()
    with pytest.raises(ValueError, match="json.*prometheus"):
        tcol.FleetCollector([("a", "http://127.0.0.1:1")], fmt="xml")


def test_burn_alert_fires_the_incident_trigger(tmp_path):
    """Errors sustained over both windows page, and the page and the
    evidence capture are one motion: a ``burn_alert`` bundle with the
    collector's tsdb snapshot and a snapshot of the scraped target."""
    import os

    from videop2p_tpu_torch.obs.incident import IncidentManager

    metrics = json.loads(json.dumps(METRICS))
    fake = FakeTarget(metrics)
    mgr = IncidentManager(str(tmp_path / "inc"))
    try:
        col = tcol.FleetCollector([("replica0", fake.url)], window_scale=0.01,
                                  probe_timeout_s=5.0, incidents=mgr)
        assert mgr.tsdb is col.tsdb
        for i in range(12):
            metrics["requests"] = {"done": 10 * i, "error": 3 * i}
            col.scrape_once(now=float(i))
        rec = col.evaluate(now=11.0)
        assert rec["burn_alert"] is True and rec["burn_alerts"] == 1
        (inc,) = mgr.records()
        assert inc["trigger"] == "burn_alert" and "slo-burn" in inc["detail"]
        files = sorted(os.listdir(inc["bundle"]))
        assert files == ["flight.jsonl", "manifest.json", "series.npz", "targets.json"]
        targets = json.load(open(os.path.join(inc["bundle"], "targets.json")))
        assert targets["scrape:replica0"]["healthz"] == {"ok": True}
    finally:
        mgr.close()
        fake.close()


def test_samples_by_name_equals_jax():
    from videop2p_tpu.obs.prom import parse_prometheus as jparse
    from videop2p_tpu.obs.prom import samples_by_name as jby
    from videop2p_tpu_torch.obs.prom import parse_prometheus, render_prometheus, samples_by_name

    text = render_prometheus(METRICS)
    assert samples_by_name(parse_prometheus(text)) == jby(jparse(text))
    by = samples_by_name(parse_prometheus(text))
    done = [s for s in by["videop2p_requests_total"] if s["labels"] == {"status": "done"}]
    assert done[0]["value"] == 7.0
    assert samples_by_name({}) == {}


def test_live_tiny_fleet_scrapes_agree_and_a_stopped_replica_leaves_gaps(tmp_path):
    """Two tiny in-process replicas and the router on the CPU: after a
    served request, one JSON and one Prometheus pass over all three targets
    at one clock land identical scalars; a replica whose server stops
    records up = 0 and gaps while the others stay up."""
    from videop2p_tpu_torch.serve import (
        EngineClient,
        ProgramSet,
        ProgramSpec,
        ReplicaSupervisor,
        Router,
        RouterServer,
    )

    spec = ProgramSpec(tiny=True, width=16, video_len=2, steps=2)
    sup = ReplicaSupervisor(spec, 2, out_dir=str(tmp_path / "fleet"),
                            programs=ProgramSet(spec, device="cpu"), warm_prompts=PROMPTS,
                            engine_kwargs=dict(device="cpu"))
    sup.start()
    router = Router(sup.urls, probe_ttl_s=0.0)
    server = RouterServer(router).start()
    try:
        request = {"image_path": "data/rabbit", "prompt": PROMPTS[0], "prompts": list(PROMPTS)}
        for r in sup.replicas:
            client = EngineClient(r.url)
            assert client.wait(client.submit(request), timeout_s=120.0)["status"] == "done"
        targets = [(r.name, r.url) for r in sup.replicas] + [("router", server.url)]
        stores = {}
        for fmt in ("json", "prometheus"):
            col = tcol.FleetCollector(targets, fmt=fmt, probe_timeout_s=10.0)
            assert col.scrape_once(now=5.0) == 3
            # busy_fraction is busy seconds over the live uptime: it moves
            # between the two passes, every other scalar stands still
            stores[fmt] = {k: v for k, v in _latest_map(col.tsdb).items()
                           if k[0] != "busy_fraction"}
        js, ps = stores["json"], stores["prometheus"]
        replica_keys = {k for k in js if ("replica", "router") not in k[1]}
        assert replica_keys == {k for k in ps if ("replica", "router") not in k[1]}
        assert len(replica_keys) >= 24 and all(js[k] == ps[k] for k in replica_keys)
        # the router's exposition has no per-status counters (its JSON
        # /metrics re-aggregates the replicas'): what it does carry agrees
        router_keys = set(ps) - replica_keys
        assert router_keys and router_keys <= set(js) and all(js[k] == ps[k] for k in router_keys)
        assert [js[(S_REQUESTS, (("replica", r.name), ("status", "done")))][1]
                for r in sup.replicas] == [1.0, 1.0]
        col = tcol.FleetCollector(targets, probe_timeout_s=10.0)
        assert col.scrape_once(now=1.0) == 3
        sup.replicas[1].server.close()
        assert col.scrape_once(now=2.0) == 2
        ups = {n: col.tsdb.latest(S_UP, {"replica": n}) for n, _ in targets}
        assert ups == {"replica0": (2.0, 1.0), "replica1": (2.000001, 0.0),
                       "router": (2.000002, 1.0)}
        q = col.tsdb.series(S_QUEUE_DEPTH, {"replica": "replica1"})
        assert q[0] == (1.000001, 0.0) and math.isnan(q[-1][1])
        rec = col.evaluate(now=2.1)
        assert rec["replicas_up"] == 1 and rec["replicas_total"] == 2
    finally:
        server.close()
        sup.stop()
