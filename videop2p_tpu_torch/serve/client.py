"""Stdlib HTTP client for the edit-serving engine (port of
``videop2p_tpu/serve/client.py``).

The thin urllib counterpart of :mod:`videop2p_tpu_torch.serve.http`: scripts
and ``chip_smoke.py`` talk to a running ``cli/serve.py`` through it.

Retry-aware: an overloaded (**429**, load shed) or degraded (**503**,
circuit breaker open / shutting down) engine answers with machine-readable
fast-fails; the client backs off for the server's ``Retry-After`` hint
(capped; a deterministic exponential fallback when the header is absent)
and retries up to ``retries`` times before raising. Other statuses
(400/404/500) never retry: they would fail identically.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
from typing import Any, Dict, Optional

__all__ = ["EngineClient", "engine_available"]

# the fast-fail statuses worth retrying: the server TOLD us to come back
_RETRYABLE = (429, 503)


class EngineClient:
    """JSON client over the ``/v1/edits`` + ``/healthz`` + ``/metrics`` API.

    ``retries``/``backoff_s``/``backoff_cap_s`` bound the deterministic
    retry schedule for 429/503 answers (``retries=0`` restores fail-fast).
    """

    def __init__(self, base_url: str, *, timeout_s: float = 10.0,
                 retries: int = 2, backoff_s: float = 0.25,
                 backoff_cap_s: float = 5.0):
        self.base_url = base_url.rstrip("/")
        self.timeout_s = float(timeout_s)
        self.retries = max(int(retries), 0)
        self.backoff_s = float(backoff_s)
        self.backoff_cap_s = float(backoff_cap_s)

    # ---- plumbing --------------------------------------------------------

    def _retry_delay_s(self, attempt: int,
                       retry_after: Optional[str]) -> float:
        """The server's Retry-After hint when parseable, else the capped
        jitter-free exponential fallback — both bounded by the cap so a
        pathological header cannot stall a client."""
        delay = None
        if retry_after:
            try:
                delay = float(retry_after)
            except ValueError:
                delay = None
        if delay is None:
            delay = self.backoff_s * (2.0 ** attempt)
        return min(max(delay, 0.0), self.backoff_cap_s)

    def _request(self, path: str, payload: Optional[Dict] = None,
                 timeout_s: Optional[float] = None,
                 headers: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
        data = None
        headers = dict(headers or {})
        if payload is not None:
            data = json.dumps(payload).encode()
            headers["Content-Type"] = "application/json"
        attempt = 0
        while True:
            req = urllib.request.Request(
                self.base_url + path, data=data, headers=headers
            )
            try:
                with urllib.request.urlopen(
                    req, timeout=timeout_s or self.timeout_s
                ) as resp:
                    return json.loads(resp.read() or b"{}")
            except urllib.error.HTTPError as e:
                try:
                    detail = json.loads(e.read() or b"{}").get("error", "")
                except ValueError:
                    detail = ""
                if e.code in _RETRYABLE and attempt < self.retries:
                    time.sleep(self._retry_delay_s(
                        attempt, e.headers.get("Retry-After")
                    ))
                    attempt += 1
                    continue
                raise RuntimeError(
                    f"{path} failed with HTTP {e.code}: {detail or e.reason}"
                ) from e

    # ---- API -------------------------------------------------------------

    def healthz(self) -> Dict[str, Any]:
        return self._request("/healthz")

    def metrics(self) -> Dict[str, Any]:
        return self._request("/metrics")

    def metrics_prometheus(self) -> str:
        """The ``/metrics?format=prometheus`` text exposition, verbatim."""
        req = urllib.request.Request(
            self.base_url + "/metrics?format=prometheus"
        )
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            return resp.read().decode("utf-8")

    def submit(self, request: Dict[str, Any], *,
               traceparent: Optional[str] = None) -> str:
        """Submit an edit request dict (EditRequest fields); returns the id.

        ``traceparent`` rides as an HTTP header — never in the JSON body,
        which the server's strict ``_REQUEST_FIELDS`` schema would reject —
        so a caller's trace continues server-side.
        """
        headers = {"traceparent": traceparent} if traceparent else None
        return self._request("/v1/edits", payload=request,
                             headers=headers)["id"]

    def poll(self, rid: str) -> Dict[str, Any]:
        return self._request(f"/v1/edits/{rid}")

    def result(self, rid: str, *, wait_s: float = 0.0) -> Dict[str, Any]:
        """Server-side wait (bounded per call by the client timeout)."""
        return self._request(
            f"/v1/edits/{rid}/result?wait_s={float(wait_s)}",
            timeout_s=max(self.timeout_s, float(wait_s) + 5.0),
        )

    def wait(self, rid: str, *, timeout_s: float = 600.0,
             poll_interval_s: float = 0.25) -> Dict[str, Any]:
        """Client-side wait loop until the record is terminal (``done`` /
        ``error`` / ``deadline_exceeded`` / ``engine_closed``); raises
        TimeoutError when the deadline passes first."""
        # mirrors engine.TERMINAL_STATUSES (not imported: the client stays
        # stdlib only)
        terminal = ("done", "error", "deadline_exceeded", "engine_closed")
        deadline = time.perf_counter() + float(timeout_s)
        while True:
            rec = self.poll(rid)
            if rec.get("status") in terminal:
                return rec
            if time.perf_counter() >= deadline:
                raise TimeoutError(
                    f"request {rid} still {rec.get('status')!r} after "
                    f"{timeout_s:.0f}s"
                )
            time.sleep(poll_interval_s)


def engine_available(base_url: Optional[str], *, timeout_s: float = 2.0) -> bool:
    """True when a healthy engine answers at ``base_url`` (the replica
    supervisor's start-up check). Never raises."""
    if not base_url:
        return False
    try:
        return bool(EngineClient(base_url, timeout_s=timeout_s).healthz().get("ok"))
    except Exception:  # noqa: BLE001 — availability probes must not throw
        return False
