"""Anomaly-triggered incident capture: obs Layer 7 (port of
``videop2p_tpu/obs/incident.py``).

The fleet *detects* trouble — burn alerts (obs/signals.py), breaker
trips (serve/faults.py), dispatch-watchdog deadline failures, SLO flips
— but until now nothing *captured evidence* at the moment it happened.
The :class:`IncidentManager` closes that gap: declarative triggers,
each debounced by a per-trigger cooldown, write an atomic
content-addressed **incident bundle** directory:

    <root>/incident_<sha16>/
        manifest.json   trigger, wall/monotonic anchors, ProgramSpec
                        fingerprints, git sha, flight-ring accounting,
                        reservoir p99/max trace-id exemplars
        flight.jsonl    the FlightRecorder ring dump — replayable JSONL
                        (read_ledger / trace_view / obs_diff all parse it)
        series.npz      a TimeSeriesStore window snapshot (when a tsdb is
                        attached — the collector's scrape history)
        targets.json    /healthz + /metrics snapshots from every
                        registered target at capture time
        crash.txt       (crash trigger only) the formatted traceback plus
                        a faulthandler dump of every thread

Bundles are written into a temp dir then ``os.replace``\\ d into place
(the manifest idiom) — a reader never sees a torn bundle — and
named by ``sha256`` of the manifest core, so a retried capture of the
same instant is idempotent.

Triggers wired through the stack (serve/engine.py, serve/router.py,
serve/collector.py, stream/driver.py):

    ``burn_alert``          SignalEngine.evaluate() raised the page
    ``breaker_open``        the CircuitBreaker transitioned to open
    ``deadline_exceeded``   a dispatch-watchdog batch failure
    ``window_poisoned``     a stream window degraded to passthrough
    ``crash``               unhandled exception (sys/threading excepthook)
    ``sigusr1``             on-demand capture (kill -USR1 <pid>)

Every capture also lands as an ``incident`` ledger event
(:data:`INCIDENT_FIELDS`) so obs/history.py extracts an ``incidents``
section and obs_diff's INCIDENT_RULES gate any increase with exit-1
teeth. Render a bundle with
``python -m videop2p_tpu_torch.tools.incident_report``.

Stdlib (+numpy via the sidecar path) only. Like every obs layer: capture
must never take the serving path down, so the manager catches everything
and degrades to "no bundle" rather than raising. Everything a bundle
holds is host state — the flight ring, the tsdb, the targets' host-side
``/healthz`` + ``/metrics`` records (the engine's device gauges are the
caching allocator's host counters) — so a capture after a sticky CUDA
error launches nothing on the card.
"""

from __future__ import annotations

import faulthandler
import hashlib
import json
import os
import shutil
import signal as _signal
import socket
import sys
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple

from videop2p_tpu_torch.obs.flight import FLIGHT_DEFAULT_CAPACITY, FlightRecorder
from videop2p_tpu_torch.obs.ledger import _git_sha

__all__ = [
    "INCIDENT_FIELDS",
    "INCIDENT_TRIGGERS",
    "IncidentManager",
]

# the `incident` ledger event schema (pinned by test_bench_guard):
# everything else lives in the bundle's manifest.json
INCIDENT_FIELDS = (
    "trigger",     # which declarative trigger fired (INCIDENT_TRIGGERS)
    "detail",      # short human string (breaker transition, burn reasons…)
    "bundle",      # the bundle directory path (None when capture failed)
    "bundle_id",   # sha256(manifest core)[:16] — the content address
    "wall_ns",     # wall-clock anchor (time.time_ns at capture)
    "events",      # flight-ring events dumped into the bundle
    "suppressed",  # same-trigger captures debounced since the last bundle
)

INCIDENT_TRIGGERS = (
    "burn_alert",
    "breaker_open",
    "deadline_exceeded",
    "window_poisoned",
    "crash",
    "sigusr1",
    # a failed known-answer probe or a cross-replica answer
    # divergence (serve/prober.py) — the bundle carries the offending
    # canary request, both content hashes and the flight ring
    "probe_failed",
)

_DEFAULT_COOLDOWN_S = 60.0


class IncidentManager:
    """Declarative incident triggers → debounced atomic capture bundles.

    One manager may serve a whole in-process fleet: every attached
    ledger tees its events into the shared :class:`FlightRecorder`,
    every registered target contributes ``/healthz`` + ``/metrics``
    snapshots to each bundle, and the per-trigger cooldown debounces
    across all of them (a breaker flapping open on two replicas is one
    incident, not a bundle storm).

    Parameters
    ----------
    root:         bundle directory root (created eagerly).
    cooldown_s:   default per-trigger debounce window (monotonic).
    cooldowns:    per-trigger overrides, e.g. ``{"crash": 0.0}``.
    capacity:     flight-ring size when no recorder is passed in.
    tsdb:         optional TimeSeriesStore snapshotted into each bundle.
    crash_hooks:  install sys/threading excepthooks + a faulthandler
                  file + the SIGUSR1 on-demand handler now (restored by
                  :meth:`close`).
    """

    def __init__(
        self,
        root: str,
        *,
        flight: Optional[FlightRecorder] = None,
        capacity: int = FLIGHT_DEFAULT_CAPACITY,
        cooldown_s: float = _DEFAULT_COOLDOWN_S,
        cooldowns: Optional[Dict[str, float]] = None,
        tsdb: Optional[Any] = None,
        crash_hooks: bool = False,
    ):
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)
        self.flight = flight or FlightRecorder(capacity)
        self.cooldown_s = float(cooldown_s)
        self.cooldowns = dict(cooldowns or {})
        self.tsdb = tsdb
        self.incidents: List[Dict[str, Any]] = []  # ledger-shaped records
        self._ledgers: List[Any] = []
        self._targets: List[Tuple[str, Callable[[], Dict[str, Any]]]] = []
        self._exemplar_providers: List[
            Callable[[], Dict[str, Dict[str, Any]]]] = []
        self._fingerprints: Dict[str, Any] = {}
        self._last: Dict[str, float] = {}
        self._suppressed: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._hooks_installed = False
        self._fh_file = None
        self._fh_was_enabled = False
        self._prev_excepthook = None
        self._prev_threading_hook = None
        self._prev_sigusr1 = None
        self._closed = False
        if crash_hooks:
            self.install_crash_hooks()

    # ---- wiring ----------------------------------------------------------

    def attach_ledger(self, ledger: Any) -> None:
        """Tee a :class:`RunLedger`'s events into the flight ring and
        mirror every ``incident`` event into it."""
        try:
            ledger.flight = self.flight
        except Exception:  # noqa: BLE001 — obs never kills a run
            return
        with self._lock:
            if ledger not in self._ledgers:
                self._ledgers.append(ledger)

    def register_target(self, name: str,
                        probe: Callable[[], Dict[str, Any]]) -> None:
        """``probe()`` returns ``{"healthz": ..., "metrics": ...}`` for
        one known target; called (guarded) at every capture."""
        with self._lock:
            self._targets.append((str(name), probe))

    def register_exemplars(
            self, provider: Callable[[], Dict[str, Dict[str, Any]]]) -> None:
        """``provider()`` returns per-program reservoir summaries (the
        ``execute_timing_summary`` shape) — the manifest keeps each
        program's ``p99_trace_id``/``max_trace_id`` so the bundle NAMES
        the traces that burned the budget."""
        with self._lock:
            self._exemplar_providers.append(provider)

    def note_fingerprint(self, name: str, fingerprint: Any) -> None:
        """Record a ProgramSpec fingerprint for the manifest."""
        with self._lock:
            self._fingerprints[str(name)] = fingerprint

    # ---- capture ---------------------------------------------------------

    def exemplars(self) -> Dict[str, Dict[str, Any]]:
        """Current per-program trace-id exemplars across providers."""
        with self._lock:
            providers = list(self._exemplar_providers)
        out: Dict[str, Dict[str, Any]] = {}
        for provider in providers:
            try:
                for program, summary in (provider() or {}).items():
                    out[str(program)] = {
                        "p99_trace_id": summary.get("p99_trace_id"),
                        "max_trace_id": summary.get("max_trace_id"),
                    }
            except Exception:  # noqa: BLE001 — exemplars are best-effort
                continue
        return out

    def trigger(self, kind: str, detail: str = "",
                extra_files: Optional[Dict[str, str]] = None,
                **context: Any) -> Optional[str]:
        """Fire one declarative trigger. Returns the bundle path, or
        ``None`` when debounced (cooldown) or capture failed. Never
        raises — incident capture must not take the serving path down."""
        try:
            return self._trigger(str(kind), str(detail), extra_files,
                                 context)
        except Exception:  # noqa: BLE001 — capture failure is not an outage
            return None

    def _trigger(self, kind: str, detail: str,
                 extra_files: Optional[Dict[str, str]],
                 context: Dict[str, Any]) -> Optional[str]:
        now = time.perf_counter()
        with self._lock:
            if self._closed:
                return None
            cooldown = float(self.cooldowns.get(kind, self.cooldown_s))
            last = self._last.get(kind)
            if last is not None and (now - last) < cooldown:
                self._suppressed[kind] = self._suppressed.get(kind, 0) + 1
                return None
            self._last[kind] = now
            suppressed = self._suppressed.pop(kind, 0)
            fingerprints = dict(self._fingerprints)
            targets = list(self._targets)
            ledgers = list(self._ledgers)

        ring = self.flight.snapshot()
        wall_ns = time.time_ns()
        manifest: Dict[str, Any] = {
            "trigger": kind,
            "detail": detail,
            "wall_ns": wall_ns,
            "wall_time": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "monotonic_s": round(now, 6),
            "pid": os.getpid(),
            "hostname": socket.gethostname(),
            "git_sha": _git_sha(),
            "fingerprints": fingerprints,
            "cooldown_s": cooldown,
            "suppressed_since_last": suppressed,
            "flight": self.flight.stats(),
            "flight_record_ns": self.flight.overhead_probe(),
            "exemplars": self.exemplars(),
            "context": {k: v for k, v in sorted(context.items())},
        }
        try:
            core = json.dumps(manifest, sort_keys=True, default=str)
        except (TypeError, ValueError):
            core = f"{kind}|{detail}|{wall_ns}"
        bundle_id = hashlib.sha256(core.encode()).hexdigest()[:16]
        manifest["bundle_id"] = bundle_id
        final = os.path.join(self.root, f"incident_{bundle_id}")

        if not os.path.isdir(final):
            tmp = f"{final}.tmp.{os.getpid()}"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            # flight ring → replayable JSONL
            with open(os.path.join(tmp, "flight.jsonl"), "w") as f:
                for e in ring:
                    try:
                        f.write(json.dumps(e, default=str) + "\n")
                    except (TypeError, ValueError):
                        pass
            # tsdb window snapshot via the .npz sidecar path
            if self.tsdb is not None:
                try:
                    from videop2p_tpu_torch.obs.attention import save_obs_sidecar

                    arrays, _ = self.tsdb.snapshot_arrays()
                    save_obs_sidecar(os.path.join(tmp, "series.npz"), arrays)
                    manifest["series"] = self.tsdb.snapshot_record(
                        label=kind, sidecar="series.npz")
                except Exception:  # noqa: BLE001 — a torn tsdb skips the snapshot
                    manifest["series"] = None
            # /healthz + /metrics from every known target
            snaps: Dict[str, Any] = {}
            for name, probe in targets:
                try:
                    snaps[name] = probe()
                except Exception as e:  # noqa: BLE001 — a dead target IS evidence
                    snaps[name] = {"error": repr(e)}
            with open(os.path.join(tmp, "targets.json"), "w") as f:
                json.dump(snaps, f, indent=1, default=str)
            for fname, text in (extra_files or {}).items():
                try:
                    with open(os.path.join(tmp, os.path.basename(fname)),
                              "w") as f:
                        f.write(text)
                except OSError:
                    pass
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f, indent=1, sort_keys=True, default=str)
                f.flush()
                os.fsync(f.fileno())
            try:
                os.replace(tmp, final)  # atomic: readers never see a torn bundle
            except OSError:
                shutil.rmtree(tmp, ignore_errors=True)
                if not os.path.isdir(final):
                    return None

        rec = {
            "trigger": kind, "detail": detail, "bundle": final,
            "bundle_id": bundle_id, "wall_ns": wall_ns,
            "events": len(ring), "suppressed": suppressed,
        }
        with self._lock:
            self.incidents.append({"event": "incident", **rec})
        for led in ledgers:
            try:
                led.event("incident", **rec)
            except Exception:  # noqa: BLE001
                pass
        return final

    # ---- crash hooks -----------------------------------------------------

    def install_crash_hooks(self) -> None:
        """Chain ``sys.excepthook`` + ``threading.excepthook`` (crash
        bundles with a faulthandler dump of every thread), open a
        faulthandler file for interpreter-level crashes, and install the
        SIGUSR1 on-demand capture handler (main thread only)."""
        if self._hooks_installed:
            return
        self._hooks_installed = True

        prev_sys = sys.excepthook
        self._prev_excepthook = prev_sys

        def _hook(tp, val, tb):  # noqa: ANN001
            try:
                self._crash_bundle(tp, val, tb, source="excepthook")
            except Exception:  # noqa: BLE001
                pass
            prev_sys(tp, val, tb)

        sys.excepthook = _hook

        prev_thread = threading.excepthook
        self._prev_threading_hook = prev_thread

        def _thook(args):  # noqa: ANN001
            try:
                self._crash_bundle(args.exc_type, args.exc_value,
                                   args.exc_traceback, source="thread")
            except Exception:  # noqa: BLE001
                pass
            prev_thread(args)

        threading.excepthook = _thook

        # hard crashes (segfault, fatal signal) can't run Python — give
        # faulthandler a file under the bundle root so SOMETHING survives
        # (one already enabled, e.g. on stderr, is enabled again at close)
        self._fh_was_enabled = faulthandler.is_enabled()
        try:
            self._fh_file = open(
                os.path.join(self.root, "faulthandler.log"), "w")
            faulthandler.enable(file=self._fh_file)
        except (OSError, ValueError):
            self._fh_file = None

        # on-demand capture: kill -USR1 <pid> (main thread only)
        try:
            self._prev_sigusr1 = _signal.signal(
                _signal.SIGUSR1,
                lambda signum, frame: self.trigger(
                    "sigusr1", detail="on-demand capture (SIGUSR1)"))
        except (ValueError, OSError, AttributeError):
            self._prev_sigusr1 = None

    def _crash_bundle(self, tp, val, tb, *, source: str) -> None:
        """One crash bundle: the formatted traceback plus a faulthandler
        dump of every live thread (the hung-peer view)."""
        text = "".join(traceback.format_exception(tp, val, tb))
        try:
            # faulthandler writes at the fd level — it needs a REAL file
            # (StringIO has no fileno), so stage the dump through a temp
            import tempfile

            with tempfile.TemporaryFile(mode="w+") as buf:
                faulthandler.dump_traceback(file=buf, all_threads=True)
                buf.seek(0)
                text += ("\n--- faulthandler (all threads) ---\n"
                         + buf.read())
        except Exception:  # noqa: BLE001
            pass
        self.trigger(
            "crash",
            detail=f"{source}: {getattr(tp, '__name__', tp)}: {val}",
            extra_files={"crash.txt": text},
        )

    # ---- summaries / shutdown --------------------------------------------

    def records(self) -> List[Dict[str, Any]]:
        """Ledger-shaped ``incident`` records captured so far (what a
        loadgen run copies into its own ledger)."""
        with self._lock:
            return [dict(r) for r in self.incidents]

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            by_trigger: Dict[str, int] = {}
            for r in self.incidents:
                t = str(r.get("trigger"))
                by_trigger[t] = by_trigger.get(t, 0) + 1
            return {
                "incidents": len(self.incidents),
                "by_trigger": by_trigger,
                "suppressed": dict(self._suppressed),
                "flight": self.flight.stats(),
            }

    def close(self) -> None:
        """Restore the crash hooks (only if still ours) and stop
        capturing. Attached ledgers keep their flight tee — the ring just
        stops being bundled."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        if self._hooks_installed:
            _ours = "IncidentManager.install_crash_hooks"
            if getattr(sys.excepthook, "__qualname__", "").startswith(_ours):
                sys.excepthook = self._prev_excepthook or sys.__excepthook__
            if getattr(threading.excepthook, "__qualname__",
                       "").startswith(_ours):
                threading.excepthook = (self._prev_threading_hook
                                        or threading.__excepthook__)
            if self._prev_sigusr1 is not None:
                try:
                    _signal.signal(_signal.SIGUSR1, self._prev_sigusr1)
                except (ValueError, OSError):
                    pass
            try:
                if self._fh_file is not None:
                    faulthandler.disable()
                    self._fh_file.close()
                    if self._fh_was_enabled:
                        faulthandler.enable(file=sys.__stderr__)
            except (OSError, ValueError, AttributeError):
                pass
            self._hooks_installed = False
