"""Bounded ring-buffer time-series store for the fleet telemetry plane (port
of ``videop2p_tpu/obs/tsdb.py``).

The serving surfaces expose point-in-time records (``/healthz``,
``/metrics``, ``slo_report.budget_burn``) — nothing watches them OVER
TIME. :class:`TimeSeriesStore` is that substrate: the
``serve/collector.py`` scrape loop appends each polled gauge here, and
``obs/signals.py`` derives windowed burn rates, trend slopes and demand
meters from the trailing buffers.

Model:

  * a SERIES is ``(name, frozen sorted label items)`` — the same identity
    Prometheus uses, so scraped exposition samples map 1:1;
  * each series is a fixed-capacity ring (``collections.deque(maxlen=)``)
    of ``(t, value)`` pairs — memory is bounded no matter how long the
    collector runs;
  * timestamps are INJECTED BY THE CALLER and must be strictly
    monotonically increasing per series (deterministic tests drive a fake
    clock; out-of-order samples are dropped and counted, never silently
    reordered);
  * a GAP (dead replica, refused scrape) is recorded as an explicit NaN
    sample — window queries skip NaN, they NEVER interpolate across it,
    and the gap count is part of the store's health surface;
  * trailing-window queries (:meth:`mean`, :meth:`vmax`, :meth:`quantile`,
    :meth:`rate`) all align on ``(now - window_s, now]``; ``rate`` is
    counter-reset aware (a restart's counter drop contributes the
    post-reset value, not a negative rate);
  * :meth:`snapshot` persists a downsampled copy of every ring as ONE
    ``fleet_series`` ledger event + ``.npz`` sidecar
    (:func:`~videop2p_tpu_torch.obs.attention.save_obs_sidecar`), so a
    collector run is replayable offline
    (``tools/fleet_dash.py`` renders it).

Stdlib and numpy only.
"""

from __future__ import annotations

import json
import math
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np

from videop2p_tpu_torch.obs.attention import save_obs_sidecar

__all__ = [
    "FLEET_SERIES_FIELDS",
    "SeriesKey",
    "TimeSeriesStore",
    "load_series_sidecar",
]

# the `fleet_series` ledger event schema (pinned by test_bench_guard)
FLEET_SERIES_FIELDS = (
    "label",
    "series",
    "samples",
    "dropped",
    "gaps",
    "capacity",
    "t_first",
    "t_last",
    "sidecar",
)

SeriesKey = Tuple[str, Tuple[Tuple[str, str], ...]]


def _series_key(name: str, labels: Optional[Dict[str, Any]]) -> SeriesKey:
    items = tuple(sorted((str(k), str(v))
                         for k, v in (labels or {}).items()))
    return (str(name), items)


def _key_str(key: SeriesKey) -> str:
    """Canonical printable form — ``name{k="v",...}`` like the exposition
    format, used for sidecar array naming and dashboard legends."""
    name, items = key
    if not items:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in items)
    return f"{name}{{{inner}}}"


class TimeSeriesStore:
    """Label-keyed bounded time-series rings with aligned-window queries."""

    def __init__(self, capacity: int = 512):
        if capacity < 2:
            raise ValueError(f"capacity must be >= 2, got {capacity}")
        self.capacity = int(capacity)
        self._series: Dict[SeriesKey, Deque[Tuple[float, float]]] = {}
        self.dropped = 0   # out-of-order / non-monotonic samples rejected
        self.gaps = 0      # explicit NaN gap markers recorded

    # ---- ingest ----------------------------------------------------------

    def add(self, name: str, t: float, value: Any,
            labels: Optional[Dict[str, Any]] = None) -> bool:
        """Append one sample. Returns False (and counts a drop) when ``t``
        does not strictly advance the series — determinism over cleverness:
        a misbehaving clock is surfaced, never papered over."""
        try:
            v = float(value)
        except (TypeError, ValueError):
            self.dropped += 1
            return False
        t = float(t)
        key = _series_key(name, labels)
        ring = self._series.get(key)
        if ring is None:
            ring = self._series[key] = deque(maxlen=self.capacity)
        if ring and t <= ring[-1][0]:
            self.dropped += 1
            return False
        ring.append((t, v))
        if math.isnan(v):
            self.gaps += 1
        return True

    def gap(self, name: str, t: float,
            labels: Optional[Dict[str, Any]] = None) -> bool:
        """Record an explicit hole (failed scrape, dead replica). The NaN
        sample keeps the series' time axis honest; queries skip it."""
        return self.add(name, t, float("nan"), labels)

    # ---- introspection ---------------------------------------------------

    def keys(self) -> List[SeriesKey]:
        return sorted(self._series)

    def names(self) -> List[str]:
        return sorted({name for name, _ in self._series})

    def __len__(self) -> int:
        return len(self._series)

    @property
    def samples(self) -> int:
        return sum(len(ring) for ring in self._series.values())

    def series(self, name: str, labels: Optional[Dict[str, Any]] = None,
               ) -> List[Tuple[float, float]]:
        """The raw ring (including NaN gap markers), oldest first."""
        return list(self._series.get(_series_key(name, labels), ()))

    def labelsets(self, name: str) -> List[Dict[str, str]]:
        """Every label combination recorded under ``name``."""
        return [dict(items) for n, items in self.keys() if n == name]

    def latest(self, name: str, labels: Optional[Dict[str, Any]] = None,
               ) -> Optional[Tuple[float, float]]:
        """The newest FINITE sample, or None for an empty/all-gap series."""
        ring = self._series.get(_series_key(name, labels))
        if not ring:
            return None
        for t, v in reversed(ring):
            if not math.isnan(v):
                return (t, v)
        return None

    # ---- aligned trailing-window queries ---------------------------------

    def window(self, name: str, now: float, window_s: float,
               labels: Optional[Dict[str, Any]] = None,
               ) -> List[Tuple[float, float]]:
        """Finite samples in ``(now - window_s, now]`` — NaN gaps skipped,
        never interpolated."""
        lo = float(now) - float(window_s)
        return [(t, v)
                for t, v in self._series.get(_series_key(name, labels), ())
                if lo < t <= float(now) and not math.isnan(v)]

    def mean(self, name: str, now: float, window_s: float,
             labels: Optional[Dict[str, Any]] = None) -> Optional[float]:
        vals = [v for _, v in self.window(name, now, window_s, labels)]
        return (sum(vals) / len(vals)) if vals else None

    def vmax(self, name: str, now: float, window_s: float,
             labels: Optional[Dict[str, Any]] = None) -> Optional[float]:
        vals = [v for _, v in self.window(name, now, window_s, labels)]
        return max(vals) if vals else None

    def quantile(self, name: str, now: float, window_s: float, q: float,
                 labels: Optional[Dict[str, Any]] = None) -> Optional[float]:
        """Nearest-rank p-quantile (q in [0, 100]) over the window."""
        vals = sorted(v for _, v in self.window(name, now, window_s, labels))
        if not vals:
            return None
        q = min(max(float(q), 0.0), 100.0)
        rank = max(1, math.ceil(q / 100.0 * len(vals)))
        return vals[rank - 1]

    def increase(self, name: str, now: float, window_s: float,
                 labels: Optional[Dict[str, Any]] = None) -> Optional[float]:
        """Total increase of a cumulative counter over the window,
        counter-reset aware: a decrease between adjacent samples is a
        restart, contributing the post-reset absolute value (the standard
        Prometheus treatment). None with < 2 samples."""
        pts = self.window(name, now, window_s, labels)
        if len(pts) < 2:
            return None
        total = 0.0
        for (_, prev), (_, cur) in zip(pts, pts[1:]):
            total += (cur - prev) if cur >= prev else cur
        return total

    def rate(self, name: str, now: float, window_s: float,
             labels: Optional[Dict[str, Any]] = None) -> Optional[float]:
        """Per-second :meth:`increase` over the window's observed span."""
        pts = self.window(name, now, window_s, labels)
        if len(pts) < 2:
            return None
        elapsed = pts[-1][0] - pts[0][0]
        if elapsed <= 0:
            return None
        inc = self.increase(name, now, window_s, labels)
        return None if inc is None else inc / elapsed

    # ---- persistence -----------------------------------------------------

    def snapshot_arrays(self, max_points: int = 256,
                        ) -> Tuple[Dict[str, np.ndarray], List[str]]:
        """Downsampled (stride-thinned, newest-biased) arrays per series
        plus the key index. Array ``s<i>_t``/``s<i>_v`` holds series ``i``
        of the returned key list — the ``.npz`` stays self-describing via
        the ``keys`` JSON array."""
        arrays: Dict[str, np.ndarray] = {}
        keys: List[str] = []
        for i, key in enumerate(self.keys()):
            ring = list(self._series[key])
            if len(ring) > max_points:
                stride = math.ceil(len(ring) / max_points)
                # keep the NEWEST sample exactly; thin from the tail back
                ring = ring[::-1][::stride][::-1]
            ts = np.asarray([t for t, _ in ring], np.float64)
            vs = np.asarray([v for _, v in ring], np.float64)
            arrays[f"s{i}_t"] = ts
            arrays[f"s{i}_v"] = vs
            keys.append(_key_str(key))
        arrays["keys"] = np.asarray(json.dumps(keys))
        return arrays, keys

    def snapshot_record(self, *, label: str = "fleet",
                        sidecar: Optional[str] = None) -> Dict[str, Any]:
        times = [t for ring in self._series.values() for t, _ in ring]
        rec: Dict[str, Any] = {
            "label": str(label),
            "series": len(self._series),
            "samples": self.samples,
            "dropped": int(self.dropped),
            "gaps": int(self.gaps),
            "capacity": int(self.capacity),
            "t_first": round(min(times), 6) if times else None,
            "t_last": round(max(times), 6) if times else None,
            "sidecar": sidecar,
        }
        return rec

    def snapshot(self, ledger: Any = None, *, label: str = "fleet",
                 sidecar_path: Optional[str] = None,
                 max_points: int = 256) -> Dict[str, Any]:
        """Persist the store: one ``fleet_series`` ledger event, arrays in
        an ``.npz`` sidecar when a path is given. Returns the event record
        (ledger optional so tests can snapshot storeless)."""
        path = None
        if sidecar_path is not None:
            arrays, _ = self.snapshot_arrays(max_points=max_points)
            path = save_obs_sidecar(sidecar_path, arrays)
        rec = self.snapshot_record(label=label, sidecar=path)
        if ledger is not None:
            ledger.event("fleet_series", **rec)
        return rec


def load_series_sidecar(path: str) -> Dict[str, List[Tuple[float, float]]]:
    """Read a :meth:`TimeSeriesStore.snapshot` sidecar back into
    ``{key_str: [(t, v), ...]}`` (NaN gap markers preserved)."""
    from videop2p_tpu_torch.obs.attention import load_obs_sidecar

    arrays = load_obs_sidecar(path)
    keys = json.loads(str(arrays["keys"]))
    out: Dict[str, List[Tuple[float, float]]] = {}
    for i, key in enumerate(keys):
        ts = arrays[f"s{i}_t"]
        vs = arrays[f"s{i}_v"]
        out[key] = [(float(t), float(v)) for t, v in zip(ts, vs)]
    return out


def restore_store(path: str, capacity: int = 512) -> "TimeSeriesStore":
    """Rebuild a :class:`TimeSeriesStore` from a snapshot sidecar — the
    offline half of the dashboard path (render signals from a shipped
    ``.npz`` without the live fleet)."""
    tsdb = TimeSeriesStore(capacity=capacity)
    for key, pts in load_series_sidecar(path).items():
        name, labels = _parse_key_str(key)
        for t, v in pts:
            tsdb.add(name, t, v, labels)
    return tsdb


def _parse_key_str(key: str) -> Tuple[str, Dict[str, str]]:
    if "{" not in key:
        return key, {}
    name, _, rest = key.partition("{")
    labels: Dict[str, str] = {}
    for part in rest.rstrip("}").split(","):
        if not part:
            continue
        k, _, v = part.partition("=")
        labels[k] = v.strip('"')
    return name, labels
