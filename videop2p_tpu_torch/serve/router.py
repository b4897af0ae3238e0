"""Multi-replica router: one HTTP front door over an engine fleet (port of
``videop2p_tpu/serve/router.py``).

The router load-balances over the machine-readable surfaces the replicas
already expose:

  * **placement** — candidates rank by the ``/healthz`` serving status
    first (``ok`` before ``degraded``: an open circuit breaker is routed
    AROUND, not to), then by live load (``/metrics`` ``queue_depth`` +
    ``in_flight``), then by the ``/metrics`` reservoir blocked-p99 (two idle
    replicas tie-break toward the historically faster one). Probes are
    cached for ``probe_ttl_s`` and ride a separate, hard-short socket
    timeout, so a wedged replica costs one short probe, not a request
    timeout.
  * **failure handling** — a submit that fast-fails (connection refused,
    429 load shed, 503 breaker open) marks the replica SUSPECT for
    ``suspend_s`` and falls through to the next candidate in the same pass;
    when every replica refuses, the whole pass is retried on the
    deterministic :class:`~videop2p_tpu_torch.serve.faults.RetryPolicy`
    before the router answers 503 itself. Client errors (400/404) never
    retry: they would fail identically everywhere.
  * **affinity** — ``/v1/edits/<id>`` polls go to the replica that accepted
    the id; results, artifacts and ledgers stay replica-local. What is
    fleet-global is the shared disk inversion store (``serve/replica.py``).
  * **aggregation** — the router's ``/healthz`` and ``/metrics`` (JSON and
    Prometheus) merge every replica's record under ``replicas`` plus a fleet
    summary, and ``close()`` writes one ``router_health`` ledger event
    (:data:`ROUTER_HEALTH_FIELDS`).
  * **quarantine** — a pluggable ``probe_status`` provider (a prober's
    answer-audit verdicts) can mark a wrong-but-healthy replica
    ``"quarantine"``; it is then routed around like an open breaker.

With ``tracing`` on, each routed request is a ``router.submit`` span in the
router's ledger and the chosen replica gets the child ``traceparent``, so
the router's and the replicas' ledgers join into one tree. ``incidents=``
(a bundle root, or a shared :class:`~videop2p_tpu_torch.obs.incident.
IncidentManager`) tees the router's ledger into the flight ring and makes
every replica's ``/healthz`` + ``/metrics`` a bundle snapshot target.

Stdlib only, apart from the port's own modules.
"""

from __future__ import annotations

import json
import re
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from videop2p_tpu_torch.obs.prom import (
    PROMETHEUS_CONTENT_TYPE,
    router_metrics_prometheus,
)
from videop2p_tpu_torch.obs.spans import (
    Tracer,
    format_traceparent,
    make_span_id,
    make_trace_id,
    parse_traceparent,
)
from videop2p_tpu_torch.serve.client import EngineClient
from videop2p_tpu_torch.serve.faults import EngineUnavailable, RetryPolicy

__all__ = ["Router", "RouterServer", "make_router_server",
           "ROUTER_HEALTH_FIELDS"]

# the `router_health` summary's numeric fields: the JAX package's tuple,
# so both packages' ledgers read alike
ROUTER_HEALTH_FIELDS = (
    "replicas", "healthy", "submitted", "routed", "retries",
    "routed_around", "rejected", "proxy_errors", "quarantined",
)


class _ReplicaView:
    """The router's view of one replica: a fail-fast client plus cached
    health/metrics probes and the suspect window."""

    def __init__(self, name: str, url: str, *, timeout_s: float,
                 probe_timeout_s: float = 2.0):
        self.name = name
        self.url = url.rstrip("/")
        # retries=0: the ROUTER owns retry/failover policy, the per-call
        # client must fail fast so a sick replica costs one RTT, not a
        # client-side backoff schedule
        self.client = EngineClient(url, timeout_s=timeout_s, retries=0)
        # probes ride a SEPARATE, hard-short socket timeout: rank() runs
        # on every submit, so a replica that ACCEPTS connections but never
        # answers (a wedged process, a half-dead container) must cost the
        # router probe_timeout_s once — after which it ranks unreachable
        # and traffic is routed AROUND it — not wedge the router thread
        # for the full request timeout
        self.probe_client = EngineClient(url, timeout_s=probe_timeout_s,
                                         retries=0)
        self.suspended_until = 0.0
        self.consecutive_failures = 0
        self.routed = 0
        # correctness-plane verdict: set by rank() from the
        # pluggable probe_status provider; True routes AROUND this
        # replica exactly like an open breaker
        self.quarantined = False
        self._probe: Optional[Tuple[float, Dict[str, Any], Dict[str, Any]]] = None
        self._lock = threading.Lock()

    def probe(self, ttl_s: float) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """(healthz, metrics) — cached up to ``ttl_s``; an unreachable
        replica probes as ``{"ok": False}`` rather than raising."""
        now = time.perf_counter()
        with self._lock:
            if self._probe is not None and now - self._probe[0] < ttl_s:
                return self._probe[1], self._probe[2]
        try:
            health = self.probe_client.healthz()
        except Exception as e:  # noqa: BLE001 — unreachable/wedged is a ranking fact
            health = {"ok": False, "status": "unreachable", "error": str(e)}
        metrics: Dict[str, Any] = {}
        if health.get("ok"):
            try:
                metrics = self.probe_client.metrics()
            except Exception:  # noqa: BLE001
                metrics = {}
        with self._lock:
            self._probe = (time.perf_counter(), health, metrics)
        return health, metrics

    def probe_age(self) -> Optional[float]:
        """Seconds since the cached probe was TAKEN (None before the
        first probe) — stamped on the aggregated ``/metrics`` so a
        scraper can tell TTL-cached gauges from fresh ones."""
        with self._lock:
            if self._probe is None:
                return None
            return max(time.perf_counter() - self._probe[0], 0.0)

    def invalidate(self) -> None:
        with self._lock:
            self._probe = None

    def suspend(self, seconds: float) -> None:
        self.suspended_until = time.perf_counter() + max(float(seconds), 0.0)
        self.consecutive_failures += 1
        self.invalidate()

    @property
    def suspended(self) -> bool:
        return time.perf_counter() < self.suspended_until


class RouterBadRequest(ValueError):
    """A replica answered 4xx — the request itself is wrong; never
    retried or failed over (it would fail identically everywhere)."""


class Router:
    """Load-balance edit requests over replica URLs (module docstring)."""

    def __init__(
        self,
        replica_urls: Sequence[str],
        *,
        timeout_s: float = 30.0,
        probe_timeout_s: float = 2.0,
        max_retries: int = 2,
        retry_base_s: float = 0.05,
        retry_cap_s: float = 1.0,
        suspend_s: float = 1.0,
        probe_ttl_s: float = 0.5,
        ledger: Any = None,
        ledger_path: Optional[str] = None,
        tracing: bool = False,
        incidents: Any = None,
        probe_status: Any = None,
    ):
        urls = [str(u) for u in replica_urls if str(u).strip()]
        if not urls:
            raise ValueError("router needs at least one replica URL")
        self.views = [_ReplicaView(f"replica{i}", u, timeout_s=timeout_s,
                                   probe_timeout_s=probe_timeout_s)
                      for i, u in enumerate(urls)]
        self.retry = RetryPolicy(max_retries=max_retries, base_s=retry_base_s,
                                 cap_s=retry_cap_s)
        self.suspend_s = float(suspend_s)
        self.probe_ttl_s = float(probe_ttl_s)
        self.ledger = ledger
        if ledger is None and ledger_path:
            from videop2p_tpu_torch.obs import RunLedger

            self.ledger = RunLedger(
                ledger_path,
                meta={"cli": "router", "replicas": urls,
                      "tracing": bool(tracing)},
            )
        # request-scoped tracing: the router records a `router.submit`
        # span per routed request and FORWARDS a child traceparent to the
        # chosen replica, so the router ledger and N replica ledgers join
        # into one causal tree. Off
        # (the default, or no ledger): zero per-request overhead beyond
        # one boolean check, and no header is forwarded.
        self.tracer = Tracer(self.ledger, enabled=tracing)
        self._rid_map: Dict[str, _ReplicaView] = {}
        self._lock = threading.Lock()
        self.counters: Dict[str, int] = {
            "submitted": 0, "routed": 0, "retries": 0, "routed_around": 0,
            "rejected": 0, "proxy_errors": 0, "quarantined": 0,
        }
        # correctness plane: a pluggable provider returning
        # {replica_name: "pass" | "fail" | "quarantine"} — the prober's
        # answer-audit verdicts. "quarantine" routes around the replica
        # like an open breaker. None (the default): zero per-request
        # overhead beyond one None check in rank().
        self._probe_status_provider = probe_status
        self.started = time.perf_counter()
        self._closed = False
        # incident plane: a directory means the router OWNS a manager (crash
        # hooks installed, closed with the router); an IncidentManager
        # instance means fleet-shared debounce — the router only contributes
        # its ledger tee and the replicas as probe targets
        self.incidents = None
        self._own_incidents = False
        if incidents is not None:
            from videop2p_tpu_torch.obs.incident import IncidentManager

            if isinstance(incidents, IncidentManager):
                self.incidents = incidents
            else:
                self.incidents = IncidentManager(str(incidents), crash_hooks=True)
                self._own_incidents = True
            if self.ledger is not None:
                self.incidents.attach_ledger(self.ledger)
            for v in self.views:
                self.incidents.register_target(
                    f"router:{v.name}",
                    (lambda pc: lambda: {"healthz": pc.healthz(),
                                         "metrics": pc.metrics()})(v.probe_client))

    # ---- placement -------------------------------------------------------

    def _count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def set_probe_status_provider(self, provider: Any) -> None:
        """Wire (or clear) the probe-verdict provider after construction
        — the prober is usually built after the router it protects."""
        self._probe_status_provider = provider

    def _probe_statuses(self) -> Dict[str, str]:
        if self._probe_status_provider is None:
            return {}
        try:
            return dict(self._probe_status_provider() or {})
        except Exception:  # noqa: BLE001 — a broken prober must not stop routing
            return {}

    def rank(self) -> Tuple[List[_ReplicaView], List[_ReplicaView]]:
        """``(candidates, avoided)`` — candidates ordered best-first by
        (healthy, load, p99, index); ``avoided`` is every replica skipped
        for being suspect, unreachable or breaker-degraded (they remain
        LAST-RESORT candidates so a fully-degraded fleet still routes
        rather than rejecting everything)."""
        scored = []
        avoided = []
        statuses = self._probe_statuses()
        for i, v in enumerate(self.views):
            health, metrics = v.probe(self.probe_ttl_s)
            healthy = bool(health.get("ok")) and health.get("status") == "ok"
            # a quarantined replica is wrong-but-healthy: it answers 200
            # and passes /healthz, so only the probe verdict demotes it
            v.quarantined = statuses.get(v.name) == "quarantine"
            bad = (not healthy) or v.suspended or v.quarantined
            if bad:
                avoided.append(v)
            load = 0
            p99 = 0.0
            if metrics:
                load = int(metrics.get("queue_depth") or 0) + int(
                    metrics.get("in_flight") or 0
                )
                lat = metrics.get("request_latency") or {}
                p99 = float(lat.get("blocked_p99_s") or 0.0)
            scored.append((1 if bad else 0, load, p99, i, v))
        scored.sort(key=lambda t: t[:4])
        return [t[4] for t in scored], avoided

    # ---- request surface -------------------------------------------------

    def submit(self, body: Dict[str, Any], *,
               traceparent: Optional[str] = None) -> Dict[str, Any]:
        """Route one submit; returns ``{"id", "replica"}``. Raises
        :class:`RouterBadRequest` on a 4xx answer (the caller's fault) and
        :class:`EngineUnavailable` when no replica accepts after the
        deterministic retry schedule.

        With tracing on, the inbound ``traceparent`` (or a fresh trace)
        becomes a ``router.submit`` span in the router ledger, and its
        span id is forwarded as the CHILD traceparent to whichever
        replica accepts — the replica's ``serve.request`` root parents
        under the router's span in the joined tree.
        """
        self._count("submitted")
        tid: Optional[str] = None
        span_id: Optional[str] = None
        parent: Optional[str] = None
        child_tp: Optional[str] = None
        t0 = wall0 = 0.0
        if self.tracer.enabled:
            parsed = parse_traceparent(traceparent) if traceparent else None
            tid, parent = parsed if parsed else (make_trace_id(), None)
            span_id = make_span_id()
            child_tp = format_traceparent(tid, span_id)
            wall0 = time.time_ns()
            t0 = time.perf_counter()
        attempt = 0
        last_error = "no replicas"
        while True:
            candidates, avoided = self.rank()
            avoided_ids = {id(v) for v in avoided}
            for view in candidates:
                try:
                    rid = view.client.submit(dict(body),
                                             traceparent=child_tp)
                except RuntimeError as e:
                    msg = str(e)
                    if "HTTP 400" in msg or "HTTP 404" in msg:
                        raise RouterBadRequest(msg) from e
                    # shed (429) / breaker-open (503) / unreachable: mark
                    # suspect and fall through to the next candidate
                    view.suspend(self.suspend_s)
                    last_error = f"{view.name}: {msg}"
                    continue
                except Exception as e:  # noqa: BLE001 — network-level failure
                    view.suspend(self.suspend_s)
                    last_error = f"{view.name}: {type(e).__name__}: {e}"
                    continue
                with self._lock:
                    self._rid_map[rid] = view
                    self.counters["routed"] += 1
                    if avoided_ids and id(view) not in avoided_ids:
                        # an unhealthy replica was routed AROUND
                        self.counters["routed_around"] += 1
                        if any(a.quarantined for a in avoided):
                            # ... and at least one of them for being
                            # WRONG, not merely down
                            self.counters["quarantined"] += 1
                view.routed += 1
                view.consecutive_failures = 0
                if self.ledger is not None:
                    dt = time.perf_counter() - t0 if tid else 0.0
                    self.ledger.record_execute("router_submit", dt, dt, tid)
                if tid:
                    self.tracer.emit(
                        "router.submit", trace_id=tid, span_id=span_id,
                        parent_id=parent, wall_ns=wall0,
                        duration_s=time.perf_counter() - t0,
                        rid=rid, replica=view.name, attempts=attempt + 1,
                    )
                return {"id": rid, "replica": view.name}
            if attempt >= self.retry.max_retries:
                break
            delay = self.retry.delay_s(attempt)
            self._count("retries")
            attempt += 1
            time.sleep(delay)
        self._count("rejected")
        if tid:
            self.tracer.emit(
                "router.submit", trace_id=tid, span_id=span_id,
                parent_id=parent, wall_ns=wall0,
                duration_s=time.perf_counter() - t0,
                status="rejected", attempts=attempt + 1,
            )
        raise EngineUnavailable(
            f"no replica accepted the request after {attempt + 1} pass(es) "
            f"(last: {last_error})",
            retry_after_s=self.suspend_s,
        )

    def _view_for(self, rid: str) -> _ReplicaView:
        with self._lock:
            view = self._rid_map.get(rid)
        if view is None:
            raise KeyError(f"unknown request id {rid!r} (not routed here)")
        return view

    def poll(self, rid: str) -> Dict[str, Any]:
        view = self._view_for(rid)
        try:
            rec = view.client.poll(rid)
        except RuntimeError as e:
            if "HTTP 404" in str(e):
                raise KeyError(str(e)) from e
            self._count("proxy_errors")
            raise
        except Exception as e:  # noqa: BLE001 — network-level: timed out / refused
            # the client's hard socket timeout bounds a wedged replica;
            # mark it suspect so the NEXT submit is routed around it
            # instead of this handler thread being the only one to learn
            view.suspend(self.suspend_s)
            self._count("proxy_errors")
            raise RuntimeError(
                f"{view.name} unreachable while proxying poll: "
                f"{type(e).__name__}: {e}"
            ) from e
        rec["replica"] = view.name
        return rec

    def result(self, rid: str, *, wait_s: float = 0.0) -> Dict[str, Any]:
        view = self._view_for(rid)
        try:
            rec = view.client.result(rid, wait_s=wait_s)
        except RuntimeError as e:
            if "HTTP 404" in str(e):
                raise KeyError(str(e)) from e
            self._count("proxy_errors")
            raise
        except Exception as e:  # noqa: BLE001 — network-level: timed out / refused
            view.suspend(self.suspend_s)
            self._count("proxy_errors")
            raise RuntimeError(
                f"{view.name} unreachable while proxying result: "
                f"{type(e).__name__}: {e}"
            ) from e
        rec["replica"] = view.name
        return rec

    # ---- fleet aggregation ----------------------------------------------

    def healthz(self) -> Dict[str, Any]:
        """Fleet liveness: ok when ANY replica serves; per-replica
        statuses attached. Load balancers in front of the router key on
        ``ok``; dashboards read the per-replica map."""
        per = {}
        healthy = 0
        statuses = self._probe_statuses()
        for v in self.views:
            health, _ = v.probe(self.probe_ttl_s)
            ok = bool(health.get("ok")) and health.get("status") == "ok"
            healthy += int(ok)
            per[v.name] = {
                "url": v.url,
                "ok": bool(health.get("ok")),
                "status": health.get("status"),
                "suspended": v.suspended,
                "breaker": health.get("breaker"),
                "warm": health.get("warm"),
                # correctness plane: clients and a collector
                # see quarantine here, without reading any ledger
                "probe_status": statuses.get(v.name),
                "quarantined": statuses.get(v.name) == "quarantine",
            }
        return {
            "ok": healthy > 0,
            "status": "ok" if healthy == len(self.views) else (
                "degraded" if healthy else "unavailable"),
            "replicas": per,
            "healthy": healthy,
            "total": len(self.views),
        }

    def metrics(self) -> Dict[str, Any]:
        """Fleet metrics: the router's own counters plus every replica's
        live ``/metrics`` record under its name."""
        per = {}
        fleet_requests: Dict[str, int] = {}
        statuses = self._probe_statuses()
        for v in self.views:
            _, metrics = v.probe(self.probe_ttl_s)
            age = v.probe_age()
            per[v.name] = {"url": v.url, "routed": v.routed, **metrics,
                           # how stale the snapshot is: 0-ish right after
                           # the probe above ran, up to probe_ttl_s when
                           # the TTL cache answered
                           "probe_age_s": (round(age, 6)
                                           if age is not None else None),
                           # the prober's verdict — the string
                           # rides JSON only, the bool becomes the
                           # videop2p_replica_quarantined 1/0 gauge in
                           # the Prometheus exposition
                           "probe_status": statuses.get(v.name),
                           "quarantined": statuses.get(v.name)
                           == "quarantine"}
            for status, n in (metrics.get("requests") or {}).items():
                fleet_requests[status] = fleet_requests.get(status, 0) + int(n)
        return {
            "uptime_s": round(time.perf_counter() - self.started, 3),
            "router": dict(self.counters),
            "requests": fleet_requests,
            "replicas": per,
        }

    def health_record(self) -> Dict[str, Any]:
        """The ``router_health`` summary (:data:`ROUTER_HEALTH_FIELDS`
        plus the per-replica routed map)."""
        health = self.healthz()
        with self._lock:
            counters = dict(self.counters)
        return {
            "replicas": health["total"],
            "healthy": health["healthy"],
            "submitted": counters["submitted"],
            "routed": counters["routed"],
            "retries": counters["retries"],
            "routed_around": counters["routed_around"],
            "rejected": counters["rejected"],
            "proxy_errors": counters["proxy_errors"],
            "quarantined": counters["quarantined"],
            "per_replica": {v.name: v.routed for v in self.views},
        }

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self.ledger is not None:
            self.ledger.event("router_health", **self.health_record())
        if self.incidents is not None and self._own_incidents:
            try:
                self.incidents.close()
            except Exception:  # noqa: BLE001 — obs never blocks shutdown
                pass
        if self.ledger is not None:
            self.ledger.close()

    def __enter__(self) -> "Router":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---- HTTP front door -----------------------------------------------------

_EDIT_PATH = re.compile(r"^/v1/edits/([0-9a-f]+)(/result)?$")


def _make_handler(router: Router):
    from http.server import BaseHTTPRequestHandler
    from urllib.parse import parse_qs, urlparse

    class _Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet; the ledger records
            pass

        def _send(self, code: int, payload: Dict[str, Any],
                  headers: Optional[Dict[str, str]] = None) -> None:
            body = json.dumps(payload, default=str).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _error(self, code: int, message: str, *,
                   headers: Optional[Dict[str, str]] = None,
                   **extra: Any) -> None:
            self._send(code, {"error": message, **extra}, headers=headers)

        def _send_text(self, code: int, text: str,
                       content_type: str = "text/plain; charset=utf-8"
                       ) -> None:
            body = text.encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self) -> None:  # noqa: N802 — handler contract
            url = urlparse(self.path)
            try:
                if url.path == "/healthz":
                    self._send(200, router.healthz())
                    return
                if url.path == "/metrics":
                    fmt = parse_qs(url.query).get("format", [""])[0]
                    if fmt == "prometheus":
                        self._send_text(
                            200,
                            router_metrics_prometheus(router.metrics()),
                            content_type=PROMETHEUS_CONTENT_TYPE,
                        )
                    else:
                        self._send(200, router.metrics())
                    return
                m = _EDIT_PATH.match(url.path)
                if m:
                    rid, want_result = m.group(1), bool(m.group(2))
                    if want_result:
                        wait_s = float(
                            parse_qs(url.query).get("wait_s", ["0"])[0]
                        )
                        self._send(200, router.result(rid, wait_s=wait_s))
                    else:
                        self._send(200, router.poll(rid))
                    return
                self._error(404, f"no route for {url.path}")
            except KeyError as e:
                self._error(404, str(e))
            except Exception as e:  # noqa: BLE001 — a handler crash must not kill the router
                self._error(500, f"{type(e).__name__}: {e}")

        def do_POST(self) -> None:  # noqa: N802
            url = urlparse(self.path)
            try:
                if url.path != "/v1/edits":
                    self._error(404, f"no route for {url.path}")
                    return
                length = int(self.headers.get("Content-Length", "0"))
                try:
                    body = json.loads(self.rfile.read(length) or b"{}")
                    out = router.submit(
                        body, traceparent=self.headers.get("traceparent")
                    )
                except RouterBadRequest as e:
                    self._error(400, str(e))
                    return
                except EngineUnavailable as e:
                    headers = {}
                    if e.retry_after_s is not None:
                        headers["Retry-After"] = str(
                            max(int(e.retry_after_s + 0.999), 1)
                        )
                    self._error(503, str(e), headers=headers,
                                retry_after_s=e.retry_after_s)
                    return
                except (ValueError, TypeError) as e:
                    self._error(400, str(e))
                    return
                self._send(202, out)
            except Exception as e:  # noqa: BLE001
                self._error(500, f"{type(e).__name__}: {e}")

    return _Handler


class RouterServer:
    """A ThreadingHTTPServer bound to one :class:`Router` — same surface
    as the replica servers, so every client (loadgen, UI, EngineClient)
    talks to a fleet exactly like it talks to one engine."""

    def __init__(self, router: Router, host: str = "127.0.0.1",
                 port: int = 0):
        from http.server import ThreadingHTTPServer

        self.router = router
        self.httpd = ThreadingHTTPServer((host, port), _make_handler(router))
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        host, port = self.httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "RouterServer":
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, name="router-http", daemon=True
        )
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        self.router.close()


def make_router_server(replica_urls: Sequence[str], *,
                       host: str = "127.0.0.1", port: int = 0,
                       **router_kwargs) -> RouterServer:
    return RouterServer(Router(replica_urls, **router_kwargs),
                        host=host, port=port)
