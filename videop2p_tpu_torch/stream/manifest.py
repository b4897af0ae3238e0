"""The per-window job manifest: what makes a streaming job RESUMABLE (port
of ``videop2p_tpu/stream/manifest.py``).

A streaming edit job persists, under one job directory:

  * ``manifest.json`` — the job identity (program-set fingerprint, clip
    content hash, prompts and parameters, window geometry) plus one entry
    per window: content-addressed key, status (``pending`` / ``done`` /
    ``passthrough``), attempt count, ``src_err``, the output sidecar path
    and its sha256. Written ATOMICALLY (temp + ``os.replace``) after every
    window transition, so a SIGKILL between windows never tears it.
  * ``windows/w<index>.npz`` — each completed window's frames (a window in
    flight at a kill is simply recomputed on resume).

Resume: a restarted job re-validates the manifest against its own identity
and every completed entry against its sidecar (present, loadable, sha
match, finite). Valid entries are SKIPPED — no request, no inversion for
them — and the remaining windows recompute through the warm engine, whose
disk inversion store makes even a lost sidecar cheap (the window's
trajectory rehydrates bit for bit). Plan, crossfade and programs are
deterministic, so the resumed job's final frames equal an uninterrupted
run's bit for bit.

A torn, truncated or alien manifest (the fault plan's ``corrupt:manifest``
directive, or a real partial write) is detected at load, counted and
RECOVERED from: entries are rebuilt from the sidecars, each of which
carries its own window key and identity hash.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, List, Optional

import numpy as np

__all__ = ["JobManifest", "WINDOW_STATUSES", "MANIFEST_VERSION"]

MANIFEST_VERSION = 1

# per-window terminal statuses: "done" = edited through the engine;
# "passthrough" = the window was poisoned (retries exhausted) and degraded
# to its source frames, recorded — the job completes instead of dying
WINDOW_STATUSES = ("pending", "done", "passthrough")


def _sha256(arr: np.ndarray) -> str:
    return hashlib.sha256(
        np.ascontiguousarray(np.asarray(arr)).tobytes()
    ).hexdigest()[:16]


def _atomic_write_text(path: str, text: str) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class JobManifest:
    """One streaming job's persisted state (module docstring).

    ``identity`` is everything that determines the job's outputs (spec
    fingerprint, clip sha, prompts, parameters, geometry): a manifest whose
    identity does not match is another job's and is never resumed into.
    ``faults`` (a :class:`~videop2p_tpu_torch.serve.faults.FaultPlan`)
    threads the ``corrupt:manifest`` directive through the save path.
    """

    def __init__(self, job_dir: str, identity: Dict[str, Any], *,
                 faults: Optional[Any] = None):
        self.job_dir = job_dir
        self.path = os.path.join(job_dir, "manifest.json")
        self.windows_dir = os.path.join(job_dir, "windows")
        self.identity = json.loads(json.dumps(identity, sort_keys=True,
                                              default=str))
        self.faults = faults
        self.entries: Dict[int, Dict[str, Any]] = {}
        # resume bookkeeping (stream_health reports these)
        self.corrupt_detected = 0
        self.recovered_entries = 0
        os.makedirs(self.windows_dir, exist_ok=True)

    # ---- persistence -----------------------------------------------------

    def save(self) -> None:
        """Atomic write of the full manifest. The chaos seam fires here:
        with an active ``corrupt:manifest`` directive the bytes that land
        are deliberately torn (truncated mid-document) — exactly the
        artifact a kill inside a NON-atomic writer would leave, which the
        load path must detect and recover from."""
        doc = json.dumps({
            "version": MANIFEST_VERSION,
            "identity": self.identity,
            "windows": [self.entries[i] for i in sorted(self.entries)],
        }, indent=1, sort_keys=True, default=str)
        if self.faults is not None and self.faults.corrupts("manifest"):
            doc = doc[: max(len(doc) // 2, 1)]
        _atomic_write_text(self.path, doc)

    def load(self) -> bool:
        """Load + validate a persisted manifest into ``entries``.

        Returns True when a usable manifest was loaded. A missing file is
        a fresh job (False, nothing counted). A corrupt file — unparsable
        JSON, wrong version, wrong identity, malformed entries — counts
        ``corrupt_detected`` and falls back to :meth:`recover` (sidecar
        scan), which can still rescue every completed window."""
        try:
            with open(self.path) as f:
                doc = json.load(f)
        except FileNotFoundError:
            return False
        except (ValueError, OSError):
            self.corrupt_detected += 1
            return self.recover()
        if (not isinstance(doc, dict)
                or doc.get("version") != MANIFEST_VERSION
                or doc.get("identity") != self.identity
                or not isinstance(doc.get("windows"), list)):
            self.corrupt_detected += 1
            return self.recover()
        entries = {}
        for e in doc["windows"]:
            if not (isinstance(e, dict) and isinstance(e.get("index"), int)
                    and e.get("status") in WINDOW_STATUSES
                    and isinstance(e.get("key"), str)):
                self.corrupt_detected += 1
                return self.recover()
            entries[e["index"]] = e
        self.entries = entries
        return True

    def recover(self) -> bool:
        """Rebuild entries from the window sidecars alone: each ``.npz``
        carries its own window key and status, so completed windows are
        re-validated against the CURRENT job identity without trusting
        the (lost) manifest. Invalid/alien sidecars are ignored."""
        self.entries = {}
        try:
            names = sorted(os.listdir(self.windows_dir))
        except OSError:
            return False
        for name in names:
            if not name.endswith(".npz"):
                continue
            path = os.path.join(self.windows_dir, name)
            loaded = self._load_sidecar(path)
            if loaded is None:
                continue
            meta, _ = loaded
            idx = int(meta["index"])
            self.entries[idx] = {
                "index": idx,
                "key": str(meta["key"]),
                "status": str(meta["status"]),
                "attempts": int(meta.get("attempts", 1)),
                "src_err": meta.get("src_err"),
                "store_source": meta.get("store_source"),
                "output": os.path.relpath(path, self.job_dir),
                "sha256": str(meta["sha256"]),
            }
            self.recovered_entries += 1
        if self.entries:
            self.save()
        return bool(self.entries)

    # ---- per-window state ------------------------------------------------

    def _sidecar_path(self, index: int) -> str:
        return os.path.join(self.windows_dir, f"w{int(index):04d}.npz")

    def complete_window(
        self,
        index: int,
        key: str,
        frames: np.ndarray,
        *,
        status: str = "done",
        attempts: int = 1,
        src_err: Optional[float] = None,
        store_source: Optional[str] = None,
        error: Optional[str] = None,
    ) -> Dict[str, Any]:
        """Persist one window's terminal state: the edited (or, for
        ``passthrough``, source) frames to the sidecar FIRST, then the
        manifest entry atomically — a kill between the two leaves a valid
        sidecar the recovery scan picks up."""
        if status not in ("done", "passthrough"):
            raise ValueError(f"not a terminal window status: {status!r}")
        frames = np.asarray(frames, np.float32)
        sha = _sha256(frames)
        path = self._sidecar_path(index)
        meta = {
            "index": int(index), "key": str(key), "status": status,
            "attempts": int(attempts), "sha256": sha,
            "src_err": src_err, "store_source": store_source,
            "identity_sha": self.identity_sha(),
        }
        tmp = f"{path}.tmp.{os.getpid()}.npz"
        with open(tmp, "wb") as f:
            np.savez(f, frames=frames,
                     meta=np.frombuffer(
                         json.dumps(meta, default=str).encode(), np.uint8
                     ))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        entry = {
            "index": int(index), "key": str(key), "status": status,
            "attempts": int(attempts), "src_err": src_err,
            "store_source": store_source,
            "output": os.path.relpath(path, self.job_dir),
            "sha256": sha,
        }
        if error:
            entry["error"] = str(error)
        self.entries[int(index)] = entry
        self.save()
        return entry

    def identity_sha(self) -> str:
        return hashlib.sha256(
            json.dumps(self.identity, sort_keys=True, default=str).encode()
        ).hexdigest()[:16]

    def _load_sidecar(self, path: str):
        """(meta, frames) when the sidecar is valid FOR THIS JOB, else
        None: loadable npz, meta parses, identity matches, frames finite,
        sha over the bytes matches the recorded one."""
        try:
            with np.load(path) as z:
                frames = np.asarray(z["frames"], np.float32)
                meta = json.loads(bytes(z["meta"].tobytes()).decode())
        except Exception:  # noqa: BLE001 — any unreadable sidecar is invalid
            return None
        if not isinstance(meta, dict):
            return None
        if meta.get("identity_sha") != self.identity_sha():
            return None
        if meta.get("status") not in ("done", "passthrough"):
            return None
        if not np.all(np.isfinite(frames)):
            return None
        if _sha256(frames) != meta.get("sha256"):
            return None
        return meta, frames

    def valid_output(self, index: int) -> Optional[np.ndarray]:
        """The persisted frames for a completed window, fully validated
        (entry ↔ sidecar ↔ identity ↔ sha) — None means the window must
        be recomputed. An entry whose sidecar went bad is dropped so the
        manifest converges back to the truth on disk."""
        entry = self.entries.get(int(index))
        if entry is None or entry.get("status") not in ("done", "passthrough"):
            return None
        path = os.path.join(self.job_dir, entry.get("output", ""))
        loaded = self._load_sidecar(path)
        if loaded is None:
            self.entries.pop(int(index), None)
            return None
        meta, frames = loaded
        if meta.get("key") != entry.get("key") \
                or meta.get("sha256") != entry.get("sha256"):
            self.entries.pop(int(index), None)
            return None
        return frames

    # ---- summaries -------------------------------------------------------

    def counts(self) -> Dict[str, int]:
        out = {s: 0 for s in WINDOW_STATUSES}
        for e in self.entries.values():
            out[e.get("status", "pending")] = \
                out.get(e.get("status", "pending"), 0) + 1
        return out

    def to_dict(self) -> Dict[str, Any]:
        return {
            "version": MANIFEST_VERSION,
            "identity": dict(self.identity),
            "windows": [self.entries[i] for i in sorted(self.entries)],
            "corrupt_detected": self.corrupt_detected,
            "recovered_entries": self.recovered_entries,
        }
