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
    call of a program, the port's counterparts of an XLA compile (the first
    call's seconds include its program analysis, below);
  * ``program_analysis`` — the first call of each instrumented program,
    analysed as it runs (``obs/introspect.py``: flops, transcendentals,
    bytes, memory, a fingerprint and an op histogram, under the JAX
    package's field names, plus ``analysis_s``); ``analysis_observers``
    (the serving cost model) see each record. A first call that is not
    analysed writes ``program_analysis_skipped`` with JAX's reason
    (``analyze_false``, ``disabled`` by ``VIDEOP2P_OBS_NO_ANALYSIS=1`` —
    the CLIs' ``--no_program_analysis`` — or ``analysis_error``);
  * ``trace_analysis`` / ``trace_analysis_skipped`` — a mined device trace
    (``obs/trace.py:trace_window``), and ``trace`` — a trace directory
    written by ``utils/profiling.py:trace``;
  * ``execute_timing`` — per program label, the reservoir summary of
    ``dispatch`` (the call's return) and ``blocked`` (after
    ``torch.cuda.synchronize``) seconds (``obs/timing.py``), at close;
  * ``memory`` — ``torch.cuda.memory_stats`` of the device, with
    ``supported: false`` on the CPU;
  * ``telemetry`` — a pipeline loop's decoded per-step statistics
    (``obs/telemetry.py``), under its program's label;
  * ``comm_analysis`` — on a mesh, the collectives a program's first call
    issued on this rank, by kind and bytes (``obs/comm.py``), beside its
    ``program_analysis``; ``device_telemetry`` — a loop's per-device probe
    summary; ``divergence`` — one cross-replica divergence (must be 0.0);
  * ``host_phase`` — with more than one process (``torchrun``), every
    ``phase`` again with the process's identity
    (``parallel/distributed.py:host_phase_record``), where JAX emits it
    with more than one host process;
  * ``fault`` / ``breaker`` — the serving resilience layer's events.

With ``max_bytes`` a write that would cross the bound first shifts the file
to ``<stem>.1.jsonl`` (older segments shift up) and the fresh file opens
with a ``ledger_rotated`` marker; :func:`read_ledger` reads the chain back
oldest first.

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
           "read_ledger", "analysis_enabled"]

# the active-ledger stack: a CLI or an engine pushes one ledger for its
# lifetime; a nested ledger shadows the outer one
_ACTIVE: List["RunLedger"] = []
_ACTIVE_LOCK = threading.Lock()

# program label a kernel build fired while it is set is attributed to
_PROGRAM: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "videop2p_torch_obs_program", default=None)

_BUILD_LISTENER_INSTALLED = False

# kill switch of the automatic program analysis on each instrumented
# program's first call; the CLIs expose it as --no_program_analysis
_ANALYSIS_ENV = "VIDEOP2P_OBS_NO_ANALYSIS"


def analysis_enabled() -> bool:
    return os.environ.get(_ANALYSIS_ENV, "0") != "1"


def current_ledger() -> Optional["RunLedger"]:
    """The innermost active ledger, or None (everything in this module is a
    no-op until a RunLedger is activated)."""
    with _ACTIVE_LOCK:
        return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def program_label(name: str) -> Iterator[None]:
    """Attribute kernel builds fired inside this block to ``name``; while
    ``torch.profiler`` records, the block is also a ``record_function``
    range named ``name`` (a trace's module events, ``obs/trace.py``)."""
    token = _PROGRAM.set(name)
    try:
        if torch._C._autograd._profiler_enabled():
            with torch.profiler.record_function(name):
                yield
        else:
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
    # `backend` and `mesh` under the JAX package's names (its report and
    # history read them); a port run is on one device, with no mesh
    rec: Dict[str, Any] = {"device": None if device is None else str(device),
                           "backend": None if device is None else device.type,
                           "mesh": None}
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
                 latency: bool = False, max_bytes: Optional[int] = None):
        self.path = path
        self.run_id = run_id or uuid.uuid4().hex[:12]
        self.device = None if device is None else torch.device(device)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._fh = open(path, "a", buffering=1)  # line-buffered: kill-safe
        self.max_bytes = int(max_bytes) if max_bytes else None
        try:
            self._bytes = os.path.getsize(path)
        except OSError:
            self._bytes = 0
        self._rotations = 0
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
        # this process's host_phase records (a multi-process run)
        self.host_phases: List[Dict[str, Any]] = []
        # per-program execute-timing reservoirs (obs/timing.py): on with
        # ``latency`` or VIDEOP2P_OBS_LATENCY=1; summaries flush at close
        self.latency = bool(latency)
        self._timing: Dict[str, LatencyReservoir] = {}
        self._timing_lock = threading.Lock()
        # callables run once by close(), after the run_end event
        self._on_close: List[Callable[[], None]] = []
        # program-analysis observers: callables of (program, record) run on
        # every program_analysis event (the serving CostModel registers
        # here); one that raises never blocks the event
        self.analysis_observers: List[Callable[[str, Dict[str, Any]], None]] = []
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
        data = line + "\n"
        with self._lock:
            if self._closed:
                return
            if (self.max_bytes is not None and self._bytes > 0
                    and self._bytes + len(data) > self.max_bytes):
                self._rotate_locked()
            try:
                self._fh.write(data)
                self._bytes += len(data)
            except (OSError, ValueError):
                pass

    def _rotate_locked(self) -> None:
        """Shift the full file aside and reopen it fresh (the caller holds
        the lock): ``<stem>.1.jsonl`` is the newest rotated segment, older
        ones shift up first; the new file opens with a ``ledger_rotated``
        marker."""
        try:
            self._fh.close()
        except OSError:
            pass
        stem = self.path[:-len(".jsonl")] if self.path.endswith(".jsonl") else self.path
        try:
            n = 1
            while os.path.exists(f"{stem}.{n}.jsonl"):
                n += 1
            for i in range(n - 1, 0, -1):
                os.replace(f"{stem}.{i}.jsonl", f"{stem}.{i + 1}.jsonl")
            os.replace(self.path, f"{stem}.1.jsonl")
        except OSError:
            pass
        self._rotations += 1
        rotated_bytes, self._bytes = self._bytes, 0
        try:
            self._fh = open(self.path, "a", buffering=1)
        except OSError:
            return  # writes degrade to event()'s silent drop
        marker = {"event": "ledger_rotated",
                  "t": round(time.perf_counter() - self._t0, 4),
                  "run_id": self.run_id, "previous": f"{stem}.1.jsonl",
                  "rotated_bytes": rotated_bytes, "index": self._rotations}
        try:
            data = json.dumps(marker) + "\n"
            self._fh.write(data)
            self._bytes += len(data)
        except (OSError, ValueError):
            pass

    def telemetry(self, program: str, record: Dict[str, Any]) -> None:
        """One decoded telemetry record of ``program``."""
        self.event("telemetry", program=program, **record)

    def program_analysis(self, program: str, record: Dict[str, Any]) -> None:
        """One program's analysis record (``obs/introspect.py``); the
        ``analysis_observers`` see the same (program, record) pair."""
        for cb in list(self.analysis_observers):
            try:
                cb(program, record)
            except Exception:  # noqa: BLE001 — observability never raises
                pass
        self.event("program_analysis", program=program, **record)

    def phase(self, name: str, seconds: float, **fields: Any) -> None:
        self.event("phase", name=name, seconds=round(float(seconds), 4), **fields)
        # a multi-process run tags the measurement with the process's
        # identity too, so merged records show the straggler skew
        # (parallel/distributed.py:phase_skew); the records are kept for
        # gather_host_phases, which brings every rank's to rank 0
        try:
            from videop2p_tpu_torch.parallel.distributed import emit_host_phase, process_count

            if process_count() > 1:
                emit_host_phase(name, seconds, self)
        except Exception:  # noqa: BLE001 — observability never breaks timing
            pass

    def comm_analysis(self, program: str, record: Dict[str, Any]) -> None:
        """One program's collective accounting (``obs/comm.py``)."""
        self.event("comm_analysis", program=program, **record)

    def device_telemetry(self, program: str, record: Dict[str, Any]) -> None:
        """A decoded per-device telemetry summary
        (``obs/comm.py:summarize_device_stats``) of ``program``."""
        self.event("device_telemetry", program=program, **record)

    def divergence(self, label: str, value: float, **fields: Any) -> None:
        """One cross-replica divergence (``obs/comm.py:replica_divergence``):
        must be 0.0."""
        self.event("divergence", label=label, value=float(value), **fields)

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
        # JAX's per-device list beside the flat fields, so that its
        # history engine reads the peak of either package's event
        devices = [{"device": (dev.index or 0) if dev is not None else 0, "coords": None,
                    "process_index": 0,
                    "bytes_in_use": stats.get("bytes_in_use"),
                    "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
                    "bytes_limit": stats.get("bytes_limit"), "live_bytes": None}]
        self.event("memory", note=note, supported=supported,
                   device=None if dev is None else str(dev), devices=devices,
                   live_arrays=None, **stats)

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
        for fn in self._on_close:
            fn()

    def on_close(self, fn: Callable[[], None]) -> None:
        """Run ``fn`` once when the ledger closes (after its last event)."""
        self._on_close.append(fn)

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

    def __init__(self, fn: Callable, program: str, sync: Callable[[], None],
                 analyze: bool = True):
        self.fn = fn
        self.program = program
        self.sync = sync
        self.analyze = analyze
        self.calls = 0
        self.__name__ = f"instrumented[{program}]"

    def __call__(self, *args, **kwargs):
        first = self.calls == 0
        self.calls += 1
        led = current_ledger()
        if led is None:
            return self.fn(*args, **kwargs)
        skip = analysis = comm = mesh = None
        if first:
            skip = ("analyze_false" if not self.analyze
                    else None if analysis_enabled() else "disabled")
            if skip is None:
                from videop2p_tpu_torch.obs.introspect import ProgramAnalysis, call_device
                from videop2p_tpu_torch.parallel.mesh import CommRecorder, active_mesh

                analysis = ProgramAnalysis(call_device((args, kwargs)))
                mesh = active_mesh()
                # on a mesh: the collectives of the call (comm_analysis)
                comm = CommRecorder() if mesh is not None else None
        t0 = time.perf_counter()
        with program_label(self.program), (analysis or contextlib.nullcontext()), \
                (comm or contextlib.nullcontext()):
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
            if skip is not None:
                led.event("program_analysis_skipped", program=self.program, reason=skip)
            else:
                try:
                    record = analysis.record((args, kwargs), out)
                except Exception:  # noqa: BLE001 — observability never kills a run
                    led.event("program_analysis_skipped", program=self.program,
                              reason="analysis_error")
                else:
                    led.program_analysis(self.program, record)
                if comm is not None:
                    from videop2p_tpu_torch.obs.comm import comm_analysis_record

                    led.comm_analysis(self.program, comm_analysis_record(
                        comm, mesh=mesh, args=(args, kwargs), out=out))
        return out


def instrumented_program(fn: Callable, *, program: str,
                         sync: Optional[Callable[[], None]] = None,
                         analyze: bool = True) -> Callable:
    """``fn`` with ledger instrumentation: each call records a
    ``program_call`` event under ``program``; its first call is also a
    ``compile`` event (the port's counterpart of a jit cache miss) and,
    unless ``analyze`` is False or ``VIDEOP2P_OBS_NO_ANALYSIS=1``, runs
    under a program analysis (``obs/introspect.py``) written as a
    ``program_analysis`` event after it (else ``program_analysis_skipped``
    with the reason); the analysis only observes, so the call's outputs are
    the same bits either way. With execute timing on, ``sync`` (e.g.
    ``torch.cuda.synchronize``) runs after the call and both latencies go
    to the program's reservoir. With no active ledger the wrapper only
    counts the call."""
    return _Program(fn, program, sync or (lambda: None), analyze)


def read_ledger(path: str) -> List[Dict[str, Any]]:
    """Parse a ledger file back into event dicts (a torn final line from a
    killed run is skipped). Rotation-aware: the segments ``<stem>.N.jsonl``
    … ``<stem>.1.jsonl`` a ``max_bytes`` ledger shifted aside are read
    first, oldest first."""
    stem = path[:-len(".jsonl")] if path.endswith(".jsonl") else path
    n = 1
    while os.path.exists(f"{stem}.{n}.jsonl"):
        n += 1
    events = []
    for p in [f"{stem}.{i}.jsonl" for i in range(n - 1, 0, -1)] + [path]:
        with open(p) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    events.append(json.loads(line))
                except ValueError:
                    continue
    return events
