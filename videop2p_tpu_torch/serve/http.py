"""Stdlib JSON HTTP front-end for :class:`~videop2p_tpu_torch.serve.engine.
EditEngine` (port of ``videop2p_tpu/serve/http.py``: the same routes and
status codes).

Endpoints (all JSON):

  * ``POST /v1/edits``           — submit an :class:`EditRequest` body →
    ``{"id": ...}`` (202). Clips are server-local paths (``image_path``).
    An optional ``"steps"`` field selects a few-step timestep-subset edit;
    step counts outside the engine's warmed buckets return 400 with the
    warm list (unknown geometry never compiles cold mid-serve). The same
    contract covers the per-call cost knobs: ``"reuse_schedule"`` must be
    a warmed reuse schedule (400 with the warmed list otherwise) and
    ``"quant_mode"`` must equal the serving set's build-time mode (400
    naming it otherwise) — weights quantize at set build, not per request.
  * ``GET  /v1/edits/<id>``      — poll one request's record.
  * ``GET  /v1/edits/<id>/result?wait_s=N`` — block up to N s for a
    terminal record.
  * ``GET  /healthz``            — liveness + warm summary (200 always
    once the engine exists; load balancers key on ``"ok"``). ``status``
    is ``"degraded"`` while the circuit breaker is not closed, with the
    breaker snapshot attached.
  * ``GET  /metrics``            — the live SLO record: per-program /
    per-phase latency percentiles from the ledger's reservoirs,
    compile-vs-execute split, store hit rates, queue-depth / in-flight
    gauges, the breaker snapshot, resilience counters, the card's memory.

Failure semantics: a full admit queue sheds the POST
with **429** and the queue depth in the error body; an open circuit
breaker (or a closed engine) fast-fails it with **503** plus a
``Retry-After`` header carrying the breaker's remaining open window.
Clients should back off accordingly (:class:`~videop2p_tpu_torch.serve.
client.EngineClient` does, deterministically).

``ThreadingHTTPServer`` handlers only enqueue and read — every device
dispatch stays on the engine's single worker thread.
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from videop2p_tpu_torch.obs.prom import (
    PROMETHEUS_CONTENT_TYPE,
    engine_metrics_prometheus,
)
from videop2p_tpu_torch.serve.engine import EditEngine, EditRequest
from videop2p_tpu_torch.serve.faults import EngineUnavailable, QueueFull

__all__ = ["EditServer"]

_EDIT_PATH = re.compile(r"^/v1/edits/([0-9a-f]+)(/result)?$")


class _Handler(BaseHTTPRequestHandler):
    engine: EditEngine  # set by EditServer on the handler subclass
    protocol_version = "HTTP/1.1"

    # ---- plumbing --------------------------------------------------------

    def log_message(self, fmt, *args):  # quiet by default; the ledger records
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

    def _send_text(self, code: int, text: str,
                   content_type: str = "text/plain; charset=utf-8") -> None:
        body = text.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _error(self, code: int, message: str, *,
               headers: Optional[Dict[str, str]] = None,
               **extra: Any) -> None:
        self._send(code, {"error": message, **extra}, headers=headers)

    # ---- routes ----------------------------------------------------------

    def do_GET(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler contract
        url = urlparse(self.path)
        try:
            if url.path == "/healthz":
                breaker = self.engine.breaker.snapshot()
                health = self.engine.health_record()
                self._send(200, {
                    "ok": True,
                    # load balancers key on "ok" (liveness); orchestrators
                    # and dashboards key on "status" (serving health)
                    "status": ("degraded" if breaker["state"] != "closed"
                               else "ok"),
                    "breaker": breaker,
                    "warm": self.engine.programs.warmed,
                    "spec_fingerprint": self.engine.spec.fingerprint(),
                    # per-replica capacity facts ride healthz so
                    # scrapers get utilization without the full /metrics body
                    "busy_fraction": health.get("busy_fraction", 0.0),
                    "padding_waste": health.get("padding_waste", 0.0),
                })
                return
            if url.path == "/metrics":
                fmt = parse_qs(url.query).get("format", [""])[0]
                if fmt == "prometheus":
                    self._send_text(
                        200,
                        engine_metrics_prometheus(self.engine.metrics()),
                        content_type=PROMETHEUS_CONTENT_TYPE,
                    )
                else:
                    self._send(200, self.engine.metrics())
                return
            m = _EDIT_PATH.match(url.path)
            if m:
                rid, want_result = m.group(1), bool(m.group(2))
                if want_result:
                    wait_s = float(
                        parse_qs(url.query).get("wait_s", ["0"])[0]
                    )
                    self._send(200, self.engine.result(rid, wait_s=wait_s))
                else:
                    self._send(200, self.engine.poll(rid))
                return
            self._error(404, f"no route for {url.path}")
        except KeyError as e:
            self._error(404, str(e))
        except Exception as e:  # noqa: BLE001 — a handler crash must not kill the server
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
                request = EditRequest.from_dict(body)
                # the traceparent rides as a header, never in the JSON
                # body (from_dict's strict schema would reject it) — a
                # tracing-off engine ignores it entirely
                rid = self.engine.submit(
                    request, traceparent=self.headers.get("traceparent")
                )
            except QueueFull as e:
                # load shed: the bounded admit queue is full — the depth in
                # the body lets clients reason about how overloaded we are
                self._error(429, str(e), queue_depth=e.depth,
                            max_queue=e.limit,
                            headers={"Retry-After": "1"})
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
            self._send(202, {"id": rid})
        except Exception as e:  # noqa: BLE001
            self._error(500, f"{type(e).__name__}: {e}")


class EditServer:
    """A ThreadingHTTPServer bound to one engine; ``serve_forever`` in a
    daemon thread so in-process callers can keep going."""

    def __init__(self, engine: EditEngine, host: str = "127.0.0.1",
                 port: int = 0):
        handler = type("BoundHandler", (_Handler,), {"engine": engine})
        self.engine = engine
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> Tuple[str, int]:
        return self.httpd.server_address[:2]

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def start(self) -> "EditServer":
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, name="edit-http", daemon=True
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
