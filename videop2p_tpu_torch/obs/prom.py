"""Prometheus text exposition for the serving ``/metrics`` records (port
of ``videop2p_tpu/obs/prom.py``, stdlib only; its output is byte for byte
the JAX package's for the same record).

``/metrics`` on a replica (``serve/http.py``) and on the router
(``serve/router.py``) serves a nested JSON record. This module
renders that SAME record — no second bookkeeping path — into the Prometheus
text exposition format (version 0.0.4), so a stock scrape job can point at
``/metrics?format=prometheus`` and get gauges.

Rendering rules (deterministic: the output is fully sorted):

  * numeric scalars become gauges named ``videop2p_<path>`` where the
    path is the underscore-joined key chain (``compile.total_s`` →
    ``videop2p_compile_total_s``);
  * the well-known fan-out sections become LABELED series instead of
    key-mangled names: ``requests`` → ``videop2p_requests_total{status=}``,
    ``tenants`` → ``videop2p_tenant_<field>{tenant=}``, ``programs`` →
    ``videop2p_program_<field>{program=}``, ``replicas`` →
    ``videop2p_replica_<field>{replica=}`` (with each replica's nested
    ``requests`` as ``videop2p_replica_requests_total{replica=,status=}``);
  * bools render as 1/0, non-finite floats as ``+Inf``/``-Inf``/``NaN``
    (all legal in the exposition format), strings and None are skipped
    (identity fields like fingerprints have no gauge meaning);
  * every metric gets one ``# HELP`` and one ``# TYPE <name> gauge``
    comment line.

:func:`parse_prometheus` is the round-tripper: it reads exposition text back
into samples, so a scraper lands the same scalars the JSON endpoint serves.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "render_prometheus",
    "parse_prometheus",
    "engine_metrics_prometheus",
    "router_metrics_prometheus",
    "samples_by_name",
]

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_PREFIX = "videop2p"
_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")
_LIST_DEPTH_CAP = 4  # defensive recursion bound on nested dicts


def _metric_name(*parts: str) -> str:
    joined = "_".join(p for p in parts if p)
    return _NAME_RE.sub("_", joined)


def _escape_label(value: str) -> str:
    return (str(value).replace("\\", "\\\\")
            .replace('"', '\\"').replace("\n", "\\n"))


def _fmt(value: Any) -> Optional[str]:
    """Exposition-format literal for a scalar, or None to skip it."""
    if isinstance(value, bool):
        return "1" if value else "0"
    if isinstance(value, (int, float)):
        f = float(value)
        if math.isnan(f):
            return "NaN"
        if math.isinf(f):
            return "+Inf" if f > 0 else "-Inf"
        return format(f, ".10g")
    return None


class _Sink:
    """Accumulates samples grouped by metric name for sorted rendering."""

    def __init__(self) -> None:
        self._series: Dict[str, List[Tuple[str, str]]] = {}

    def put(self, name: str, value: Any,
            labels: Optional[List[Tuple[str, str]]] = None) -> None:
        text = _fmt(value)
        if text is None:
            return
        label_str = ""
        if labels:
            inner = ",".join(f'{k}="{_escape_label(v)}"'
                             for k, v in labels)
            label_str = "{" + inner + "}"
        self._series.setdefault(name, []).append((label_str, text))

    def render(self) -> str:
        lines: List[str] = []
        for name in sorted(self._series):
            lines.append(f"# HELP {name} videop2p /metrics gauge.")
            lines.append(f"# TYPE {name} gauge")
            for label_str, text in sorted(self._series[name]):
                lines.append(f"{name}{label_str} {text}")
        return "\n".join(lines) + "\n" if lines else ""


def _flatten(sink: _Sink, prefix: str, value: Any,
             labels: Optional[List[Tuple[str, str]]] = None,
             depth: int = 0) -> None:
    """Numeric leaves of a nested dict as ``<prefix>_<path>`` gauges."""
    if isinstance(value, dict):
        if depth >= _LIST_DEPTH_CAP:
            return
        for k in sorted(value):
            _flatten(sink, _metric_name(prefix, str(k)), value[k],
                     labels, depth + 1)
    else:
        sink.put(prefix, value, labels)


def _put_status_counts(sink: _Sink, name: str, counts: Any,
                       labels: Optional[List[Tuple[str, str]]] = None,
                       ) -> None:
    if not isinstance(counts, dict):
        return
    for status in sorted(counts):
        sink.put(name, counts[status],
                 (labels or []) + [("status", str(status))])


def render_prometheus(metrics: Dict[str, Any], *,
                      prefix: str = _PREFIX) -> str:
    """The Prometheus text exposition of one ``/metrics`` JSON record."""
    sink = _Sink()
    for key in sorted(metrics or {}):
        value = metrics[key]
        if key == "requests":
            _put_status_counts(
                sink, _metric_name(prefix, "requests_total"), value)
        elif key == "tenants" and isinstance(value, dict):
            for tenant in sorted(value):
                _flatten(sink, _metric_name(prefix, "tenant"),
                         value[tenant], [("tenant", str(tenant))])
        elif key == "programs" and isinstance(value, dict):
            for program in sorted(value):
                _flatten(sink, _metric_name(prefix, "program"),
                         value[program], [("program", str(program))])
        elif key == "replicas" and isinstance(value, dict):
            for replica in sorted(value):
                rec = value[replica]
                if not isinstance(rec, dict):
                    continue
                rlabels = [("replica", str(replica))]
                for rk in sorted(rec):
                    rv = rec[rk]
                    if rk == "requests":
                        _put_status_counts(
                            sink,
                            _metric_name(prefix, "replica_requests_total"),
                            rv, rlabels)
                    elif not isinstance(rv, dict):
                        sink.put(_metric_name(prefix, "replica", rk),
                                 rv, rlabels)
                    # deeper replica sections (scheduler, store, ...) are
                    # scraped from the replica's own endpoint
        else:
            _flatten(sink, _metric_name(prefix, key), value)
    return sink.render()


def engine_metrics_prometheus(metrics: Dict[str, Any]) -> str:
    """Exposition text for a replica engine's ``metrics()`` record."""
    return render_prometheus(metrics)


def router_metrics_prometheus(metrics: Dict[str, Any]) -> str:
    """Exposition text for the router's fleet ``metrics()`` record."""
    return render_prometheus(metrics)


# ---- parsing (the round-trip half) ----------------------------------------

def _parse_value(text: str) -> float:
    if text == "NaN":
        return float("nan")
    if text == "+Inf":
        return float("inf")
    if text == "-Inf":
        return float("-inf")
    return float(text)


def _parse_labels(text: str) -> Dict[str, str]:
    """``k="v",k2="v2"`` (the braces already stripped) with exposition
    escapes (``\\\\``, ``\\"``, ``\\n``) undone."""
    labels: Dict[str, str] = {}
    i, n = 0, len(text)
    while i < n:
        eq = text.index("=", i)
        key = text[i:eq].strip().lstrip(",").strip()
        i = eq + 1
        if i >= n or text[i] != '"':
            raise ValueError(f"malformed label value at {text[i:]!r}")
        i += 1
        out: List[str] = []
        while i < n:
            c = text[i]
            if c == "\\" and i + 1 < n:
                nxt = text[i + 1]
                out.append({"n": "\n", '"': '"', "\\": "\\"}.get(nxt, nxt))
                i += 2
                continue
            if c == '"':
                i += 1
                break
            out.append(c)
            i += 1
        labels[key] = "".join(out)
        while i < n and text[i] in ", ":
            i += 1
    return labels


def parse_prometheus(text: str) -> Dict[str, Any]:
    """Exposition text → ``{"samples": [...], "types": {...}, "help":
    {...}}``.

    Each sample is ``{"name", "labels", "value"}``. Malformed lines raise
    (a scrape that half-parses would silently drop gauges); ``# TYPE`` /
    ``# HELP`` comments are collected, other comments and blank lines are
    skipped per the format.
    """
    samples: List[Dict[str, Any]] = []
    types: Dict[str, str] = {}
    help_text: Dict[str, str] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] == "TYPE":
                types[parts[2]] = parts[3] if len(parts) > 3 else ""
            elif len(parts) >= 3 and parts[1] == "HELP":
                help_text[parts[2]] = parts[3] if len(parts) > 3 else ""
            continue
        if "{" in line:
            name, _, rest = line.partition("{")
            # the label block may contain '}' inside quoted values — scan
            # for the closing brace outside quotes
            depth_q = False
            close = -1
            i = 0
            while i < len(rest):
                c = rest[i]
                if c == "\\" and depth_q:
                    i += 2
                    continue
                if c == '"':
                    depth_q = not depth_q
                elif c == "}" and not depth_q:
                    close = i
                    break
                i += 1
            if close < 0:
                raise ValueError(f"unterminated label block: {raw!r}")
            labels = _parse_labels(rest[:close])
            value_text = rest[close + 1:].strip().split()[0]
        else:
            fields = line.split()
            if len(fields) < 2:
                raise ValueError(f"malformed sample line: {raw!r}")
            name, value_text = fields[0], fields[1]
            labels = {}
        samples.append({
            "name": name.strip(),
            "labels": labels,
            "value": _parse_value(value_text),
        })
    return {"samples": samples, "types": types, "help": help_text}


def samples_by_name(parsed: Dict[str, Any],
                    ) -> Dict[str, List[Dict[str, Any]]]:
    """Convenience index: ``{metric name: [sample, ...]}``."""
    out: Dict[str, List[Dict[str, Any]]] = {}
    for s in parsed.get("samples", ()):
        out.setdefault(s["name"], []).append(s)
    return out
