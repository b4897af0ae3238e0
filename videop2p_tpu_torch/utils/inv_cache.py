"""Persist and reuse DDIM-inversion products across Stage-2 runs (the
port's own copy of ``videop2p_tpu/utils/inv_cache.py``; numpy and stdlib
only).

The inversion trajectory (x_T is its last entry) and the null-text
embeddings are stored under the results directory, keyed by everything that
determines them (clip, source prompt, step count, geometry, dependent-noise
settings, checkpoint identity). A repeat edit of the same clip, e.g. one
that iterates on the edit prompt, skips DDIM inversion and null-text
optimization. The key function and the entry layout are the JAX package's,
byte for byte: the same determinants give the same digest, and an entry
either package wrote loads in the other.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = [
    "content_fingerprint",
    "inversion_cache_key",
    "load_inversion",
    "save_inversion",
]


_SAMPLE_BYTES = 4096


def _content_sample(path: str, size: int) -> str:
    """Hex digest of 4 KiB blocks at the file's head, tail, and quarter
    points. mtime+size alone is not a content identity: tools that preserve
    mtimes while changing bytes (``rsync -t`` restores, archive extraction,
    ``cp -p`` over same-size files) would otherwise produce a false cache
    hit and replay a stale inversion trajectory for different content.
    Interior blocks matter too: a checkpoint shard whose only change is one
    mid-file tensor keeps its header and trailer bytes. ≤20 KiB of reads
    per file is cheap even for multi-GB shards. (A sub-4 KiB interior
    change between sample points can still collide — this is a
    fingerprint, not a full hash; ``--no_reuse_inversion`` is the escape
    hatch.)"""
    h = hashlib.sha256()
    offsets = sorted({
        0,
        max(size // 4 - _SAMPLE_BYTES // 2, 0),
        max(size // 2 - _SAMPLE_BYTES // 2, 0),
        max(3 * size // 4 - _SAMPLE_BYTES // 2, 0),
        max(size - _SAMPLE_BYTES, 0),
    })
    try:
        with open(path, "rb") as f:
            for off in offsets:
                f.seek(off)
                h.update(f.read(_SAMPLE_BYTES))
    except OSError:
        return "<unreadable>"
    return h.hexdigest()[:16]


def content_fingerprint(path: str) -> str:
    """Digest of a file tree's (relpath, size, mtime_ns, head/tail-sample)
    tuples — a cheap content identity for a checkpoint dir or a clip.
    Re-tuning a checkpoint in place or swapping a clip's frames changes the
    fingerprint, so cache keys built on it miss instead of silently reusing
    stale products — including when the change preserves mtimes (the
    per-file content sample catches that case). Missing paths fingerprint
    as such (random-init smoke runs)."""
    entries = []
    if os.path.isfile(path):
        st = os.stat(path)
        entries.append((os.path.basename(path), st.st_size, st.st_mtime_ns,
                        _content_sample(path, st.st_size)))
    elif os.path.isdir(path):
        for root, dirs, files in os.walk(path):
            # Stage-2 writes its results (GIFs, this cache) INSIDE the
            # checkpoint dir — a run's own outputs must not churn the key
            dirs[:] = [
                d for d in dirs
                if not d.startswith("results_dp") and d != "inv_cache"
            ]
            for f in sorted(files):
                p = os.path.join(root, f)
                try:
                    st = os.stat(p)
                except OSError:
                    continue
                entries.append(
                    (os.path.relpath(p, path), st.st_size, st.st_mtime_ns,
                     _content_sample(p, st.st_size))
                )
    else:
        entries.append(("<missing>", 0, 0, ""))
    blob = json.dumps(sorted(entries))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def inversion_cache_key(**determinants) -> str:
    """Stable digest of everything that determines the inversion products.

    Callers pass the clip path, source prompt, num steps, width/frames,
    dependent-noise settings, seed and a checkpoint identity; any change
    produces a fresh key (stale hits are impossible by construction).
    """
    blob = json.dumps(
        {k: determinants[k] for k in sorted(determinants)}, sort_keys=True, default=str
    )
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _cache_dir(results_dir: str, key: str) -> str:
    return os.path.join(results_dir, "inv_cache", key)


def load_inversion(
    results_dir: str, key: str, *, want_null: bool, null_tag: str = ""
) -> Optional[Tuple[np.ndarray, Optional[np.ndarray]]]:
    """Return (trajectory, null_embeddings-or-None) on a hit, else None.

    ``want_null``: full (official) mode needs the null-text embeddings too —
    a trajectory-only entry (saved by a --fast run) is then a miss for the
    null part but still skips the inversion walk. ``null_tag`` distinguishes
    null-optimization settings (e.g. inner-step count) sharing a trajectory.
    """
    d = _cache_dir(results_dir, key)
    traj_path = os.path.join(d, "trajectory.npy")
    if not os.path.exists(traj_path):
        return None
    trajectory = np.load(traj_path)
    null_path = os.path.join(d, f"null_embeddings{null_tag}.npy")
    null = np.load(null_path) if want_null and os.path.exists(null_path) else None
    return trajectory, null


def save_inversion(
    results_dir: str,
    key: str,
    trajectory=None,
    null_embeddings=None,
    *,
    null_tag: str = "",
    meta: Optional[Dict] = None,
) -> str:
    """Persist the trajectory (+ optional null embeddings) atomically; null
    embeddings may be added later to an existing trajectory entry (pass
    ``trajectory=None`` then — callers should not re-materialize an array
    the guard below would discard anyway)."""
    d = _cache_dir(results_dir, key)
    os.makedirs(d, exist_ok=True)

    # write-temp-then-os.replace for EVERY entry file, with the temp name
    # unique per process: a kill mid-write can never leave a torn visible
    # entry (readers see the old file or the new one, nothing in between),
    # and two processes persisting the same key never scribble over each
    # other's temp (first os.replace wins; both bodies are identical by
    # construction — the key is content-addressed)
    def _atomic_save(name: str, arr) -> None:
        tmp = os.path.join(d, f".{name}.{os.getpid()}.tmp.npy")
        with open(tmp, "wb") as f:
            np.save(f, np.asarray(arr))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(d, f"{name}.npy"))

    if trajectory is not None and not os.path.exists(
        os.path.join(d, "trajectory.npy")
    ):
        _atomic_save("trajectory", trajectory)
    if null_embeddings is not None and not os.path.exists(
        os.path.join(d, f"null_embeddings{null_tag}.npy")
    ):
        _atomic_save(f"null_embeddings{null_tag}", null_embeddings)
    if meta is not None:
        # meta.json gets the same treatment — it was the one file in the
        # entry a kill could tear (plain open+dump)
        tmp = os.path.join(d, f".meta.{os.getpid()}.tmp.json")
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=1, default=str)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(d, "meta.json"))
    return d
