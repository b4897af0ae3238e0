"""RunLedger: one JSONL event stream per run (port of
``videop2p_tpu/obs/ledger.py``).

Events, each one line (line-buffered, so a killed run keeps everything
written so far; one lock, so concurrent writers never tear a line; silent
after :meth:`RunLedger.close`):

  * ``run_start`` — run id, torch and CUDA versions, the device, its name
    and its power limit (``nvidia-smi``), caller metadata;
  * ``phase`` — emitted by ``utils/profiling.py:phase_timer`` while a
    ledger is active;
  * ``program_call`` — one call of a program of the serving
    ``ProgramSet`` (:func:`instrumented_program`): its label, whether it
    was a miss (the first call after the program was built into the set's
    cache) and its dispatch wall time;
  * ``compile`` — a kernel build by ``ops/_build.py`` (nvcc) or the first
    call of a program, the port's counterparts of an XLA compile;
  * ``execute_timing`` — per program label, the reservoir summary of
    ``dispatch`` (the call's return) and ``blocked`` (after
    ``torch.cuda.synchronize``) seconds (``obs/timing.py``), at close;
  * ``memory`` — ``torch.cuda.memory_stats`` of the device, with
    ``supported: false`` on the CPU;
  * ``fault`` / ``breaker`` — the serving resilience layer's events.

The port has no counterpart to XLA's program analysis
(``videop2p_tpu/obs/introspect.py``): no ``program_analysis`` event is
written, and the cost model's static flop and HBM-byte fields read 0.0.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import shutil
import socket
import subprocess
import threading
import time
import uuid
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch

from videop2p_tpu_torch.obs.timing import LatencyReservoir, latency_enabled

__all__ = ["RunLedger", "current_ledger", "program_label", "instrumented_program",
           "read_ledger"]

# the active-ledger stack: a CLI or an engine pushes one ledger for its
# lifetime; a nested ledger shadows the outer one
_ACTIVE: List["RunLedger"] = []
_ACTIVE_LOCK = threading.Lock()

# program label a kernel build fired while it is set is attributed to
_PROGRAM: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "videop2p_torch_obs_program", default=None)

_BUILD_LISTENER_INSTALLED = False


def current_ledger() -> Optional["RunLedger"]:
    """The innermost active ledger, or None (everything in this module is a
    no-op until a RunLedger is activated)."""
    with _ACTIVE_LOCK:
        return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def program_label(name: str) -> Iterator[None]:
    """Attribute kernel builds fired inside this block to ``name``."""
    token = _PROGRAM.set(name)
    try:
        yield
    finally:
        _PROGRAM.reset(token)


def _install_build_listener() -> None:
    """Register ONE process-wide listener on ``ops/_build.py`` that forwards
    each kernel build (source, seconds) to the active ledger as a
    ``compile`` event."""
    global _BUILD_LISTENER_INSTALLED
    if _BUILD_LISTENER_INSTALLED:
        return
    from videop2p_tpu_torch.ops import _build

    def on_build(source: str, seconds: float) -> None:
        led = current_ledger()
        if led is not None:
            led._on_compile(seconds, _PROGRAM.get(), metric="nvcc", source=source)

    _build.BUILD_LISTENERS.append(on_build)
    _BUILD_LISTENER_INSTALLED = True


def _git_sha() -> Optional[str]:
    try:
        out = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                             capture_output=True, text=True, timeout=5.0,
                             cwd=os.path.dirname(os.path.abspath(__file__)))
    except (OSError, subprocess.TimeoutExpired):
        return None
    return (out.stdout.strip() or None) if out.returncode == 0 else None


def _power_limit() -> Optional[str]:
    """``nvidia-smi``'s power limit of the first card, or None."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    try:
        out = subprocess.run([smi, "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=10.0)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def _device_record(device: Optional[torch.device]) -> Dict[str, Any]:
    rec: Dict[str, Any] = {"device": None if device is None else str(device)}
    if device is not None and device.type == "cuda":
        try:
            rec["device_name"] = torch.cuda.get_device_name(device)
            rec["device_count"] = torch.cuda.device_count()
        except Exception:  # noqa: BLE001 — metadata must never kill a run
            rec["device_name"] = None
        rec["power_limit"] = _power_limit()
    return rec


class RunLedger:
    """Append-only JSONL event stream for one run.

    Use as a context manager (activates on enter, closes on exit) or call
    :meth:`activate` / :meth:`close`. Every event carries ``t`` (seconds
    since the run started, monotonic); ``run_start`` anchors it to the wall
    clock. ``device`` is the device the run computes on (its name and power
    limit go into ``run_start``; :meth:`memory_snapshot` reads it).
    """

    def __init__(self, path: str, *, run_id: Optional[str] = None,
                 meta: Optional[Dict[str, Any]] = None, device=None,
                 latency: bool = False):
        self.path = path
        self.run_id = run_id or uuid.uuid4().hex[:12]
        self.device = None if device is None else torch.device(device)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._fh = open(path, "a", buffering=1)  # line-buffered: kill-safe
        self._lock = threading.Lock()
        # optional flight-recorder tee (obs/flight.py): an IncidentManager
        # attaches a FlightRecorder here and every event record is ALSO
        # appended to its bounded ring; with None (the default) the cost is
        # one attribute check and the written stream is the same either way
        self.flight: Optional[Any] = None
        self._t0 = time.perf_counter()
        self._closed = False
        self._activated = False
        self.compile_seconds: List[float] = []
        # per-program execute-timing reservoirs (obs/timing.py): on with
        # ``latency`` or VIDEOP2P_OBS_LATENCY=1; summaries flush at close
        self.latency = bool(latency)
        self._timing: Dict[str, LatencyReservoir] = {}
        self._timing_lock = threading.Lock()
        _install_build_listener()
        start: Dict[str, Any] = {
            "run_id": self.run_id,
            "git_sha": _git_sha(),
            "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda,
            "hostname": socket.gethostname(),
            "pid": os.getpid(),
            "wall_time": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            **_device_record(self.device),
        }
        start.update(meta or {})
        self.event("run_start", **start)

    # ---- event writing ---------------------------------------------------

    def event(self, kind: str, /, **fields: Any) -> None:
        """Append one event; never raises. ``kind`` is positional-only so a
        field may itself be named ``kind`` (the ``fault`` events)."""
        rec = {"event": kind, "t": round(time.perf_counter() - self._t0, 4)}
        rec.update(fields)
        flight = self.flight
        if flight is not None:
            flight.record(rec)  # bounded ring append; never raises
        try:
            line = json.dumps(rec, default=str)
        except (TypeError, ValueError):
            line = json.dumps({"event": "encode_error", "kind": kind})
        with self._lock:
            if self._closed:
                return
            try:
                self._fh.write(line + "\n")
            except (OSError, ValueError):
                pass

    def phase(self, name: str, seconds: float, **fields: Any) -> None:
        self.event("phase", name=name, seconds=round(float(seconds), 4), **fields)

    def fault(self, kind: str, **fields: Any) -> None:
        """One fault observation: an injected fault firing, a retry, a
        watchdog timeout."""
        self.event("fault", kind=kind, **fields)

    def breaker(self, state_from: str, state_to: str, **fields: Any) -> None:
        """One circuit-breaker transition."""
        self.event("breaker", state_from=state_from, state_to=state_to, **fields)

    def timing_enabled(self) -> bool:
        return self.latency or latency_enabled()

    def record_execute(self, program: str, dispatch_s: float, blocked_s: float,
                       trace_id: Optional[str] = None) -> None:
        """Add one dispatch's (return, synchronized) seconds to the
        program's reservoir; nothing is written before
        :meth:`flush_execute_timing` or close."""
        with self._timing_lock:
            res = self._timing.get(program)
            if res is None:
                res = self._timing[program] = LatencyReservoir()
        res.add(dispatch_s, blocked_s, trace_id)

    def execute_timing_summary(self) -> Dict[str, Dict[str, float]]:
        """Live per-program reservoir summaries, without writing events
        (what ``/metrics`` reads). Programs with no dispatch are left out."""
        with self._timing_lock:
            items = sorted(self._timing.items())
        out: Dict[str, Dict[str, float]] = {}
        for program, res in items:
            summary = res.summary()
            if summary:
                out[program] = summary
        return out

    def flush_execute_timing(self) -> None:
        """One ``execute_timing`` event per program with dispatches."""
        for program, summary in self.execute_timing_summary().items():
            self.event("execute_timing", program=program, **summary)

    def _on_compile(self, seconds: float, program: Optional[str], *,
                    metric: str = "first_call", **fields: Any) -> None:
        self.compile_seconds.append(float(seconds))
        self.event("compile", seconds=round(float(seconds), 4), program=program,
                   metric=metric, **fields)

    def memory_snapshot(self, note: Optional[str] = None) -> None:
        """The device's ``torch.cuda.memory_stats`` (allocated, reserved and
        peak bytes); on the CPU ``supported`` is false and the fields None."""
        dev = self.device
        stats: Dict[str, Any] = {}
        supported = dev is not None and dev.type == "cuda"
        if supported:
            try:
                ms = torch.cuda.memory_stats(dev)
                stats = {"bytes_in_use": ms.get("allocated_bytes.all.current"),
                         "peak_bytes_in_use": ms.get("allocated_bytes.all.peak"),
                         "reserved_bytes": ms.get("reserved_bytes.all.current"),
                         "bytes_limit": torch.cuda.get_device_properties(dev).total_memory}
            except Exception:  # noqa: BLE001 — observability never kills a run
                supported = False
        self.event("memory", note=note, supported=supported,
                   device=None if dev is None else str(dev), **stats)

    # ---- lifecycle -------------------------------------------------------

    def activate(self) -> "RunLedger":
        """Push onto the active stack so ``phase_timer``, the kernel-build
        listener and :func:`instrumented_program` find this ledger."""
        with _ACTIVE_LOCK:
            if not self._activated:
                _ACTIVE.append(self)
                self._activated = True
        return self

    def close(self) -> None:
        with _ACTIVE_LOCK:
            if self in _ACTIVE:
                _ACTIVE.remove(self)
            self._activated = False
        with self._lock:
            if self._closed:
                return
        try:
            self.flush_execute_timing()
        except Exception:  # noqa: BLE001 — closing must always succeed
            pass
        self.event("run_end", compile_events=len(self.compile_seconds))
        with self._lock:
            self._closed = True
            try:
                self._fh.close()
            except OSError:
                pass

    def __enter__(self) -> "RunLedger":
        return self.activate()

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # best effort: every event was line-flushed already
        try:
            if not self._closed:
                self.close()
        except Exception:  # noqa: BLE001
            pass


class _Program:
    """A callable that records its calls in the active ledger."""

    def __init__(self, fn: Callable, program: str, sync: Callable[[], None]):
        self.fn = fn
        self.program = program
        self.sync = sync
        self.calls = 0
        self.__name__ = f"instrumented[{program}]"

    def __call__(self, *args, **kwargs):
        first = self.calls == 0
        self.calls += 1
        led = current_ledger()
        if led is None:
            return self.fn(*args, **kwargs)
        t0 = time.perf_counter()
        with program_label(self.program):
            out = self.fn(*args, **kwargs)
        dt = time.perf_counter() - t0
        fields: Dict[str, Any] = {"program": self.program, "cache_miss": first,
                                  "dispatch_s": round(dt, 4)}
        blocked = None
        if led.timing_enabled():
            # opt-in: waiting for the card here trades away the overlap of
            # host and card for a measured latency; the values are the same
            self.sync()
            blocked = time.perf_counter() - t0
            led.record_execute(self.program, dt, blocked)
            fields["blocked_s"] = round(blocked, 4)
        led.event("program_call", **fields)
        if first:
            led._on_compile(dt if blocked is None else blocked, self.program)
        return out


def instrumented_program(fn: Callable, *, program: str,
                         sync: Optional[Callable[[], None]] = None) -> Callable:
    """``fn`` with ledger instrumentation: each call records a
    ``program_call`` event under ``program``; its first call is also a
    ``compile`` event (the port's counterpart of a jit cache miss); with
    execute timing on, ``sync`` (e.g. ``torch.cuda.synchronize``) runs
    after the call and both latencies go to the program's reservoir. With
    no active ledger the wrapper only counts the call."""
    return _Program(fn, program, sync or (lambda: None))


def read_ledger(path: str) -> List[Dict[str, Any]]:
    """Parse a ledger file back into event dicts (a torn final line from a
    killed run is skipped)."""
    events = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except ValueError:
                continue
    return events
