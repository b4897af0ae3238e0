"""Content-addressed inversion-product store for the serving engine (port
of ``videop2p_tpu/serve/store.py``).

Two layers over one key space (``utils/inv_cache.py:inversion_cache_key``:
every determinant of the products is in the key, so a stale hit is
impossible by construction):

  * **device-resident LRU** — the serving hot path. An entry holds the
    whole :class:`~videop2p_tpu_torch.pipelines.cached.CachedSource` capture
    plus the encoded source latents (the ``anchor`` the edit checks
    ``src_err`` against), on the card, so a repeat edit of a clip skips VAE
    encode AND the DDIM inversion and replays its source stream with
    ``src_err == 0.0``. Entries are bounded by a byte budget (the bytes of
    every tensor of the entry) with least-recently-used eviction; an entry
    above the whole budget is refused, never resident.
  * **disk persistence** (optional) — the trajectory (the small,
    checkpoint-portable product) is written through to ``utils/inv_cache``
    under a shared root, so CLI runs, sweeps (``cli/sweep.py
    --inv_store``) and engine restarts can reuse it. The capture is not
    persisted: it is rebuilt from ``trajectory[0]`` through the warm
    inversion program. :meth:`InversionStore.load_disk` is that read path:
    the trajectory is VALIDATED (finite, non-empty) before use, and the
    fault plan's ``corrupt:PAT`` seam corrupts entries deterministically to
    prove the detection.

``load_persisted_inversion`` / ``save_persisted_inversion`` are the disk
layer the CLIs share: ``utils/inv_cache.py`` with an explicit root, so a
sweep, a one-shot CLI run and a serving engine reuse one inversion of a
clip.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

import numpy as np

from videop2p_tpu_torch.utils.inv_cache import load_inversion, save_inversion

__all__ = ["InversionStore", "StoreEntry", "tree_nbytes", "load_persisted_inversion",
           "save_persisted_inversion"]


def tree_nbytes(tree: Any) -> int:
    """Bytes of every tensor of a products tree (a ``CachedSource``'s
    trajectory, maps and blend sequence, and the anchor)."""
    from videop2p_tpu_torch.serve.batching import tree_tensors

    return sum(t.numel() * t.element_size() for t in tree_tensors(tree))


class StoreEntry:
    """One resident entry: the device products plus bookkeeping."""

    __slots__ = ("products", "nbytes", "hits", "meta")

    def __init__(self, products: Any, nbytes: int, meta: Optional[Dict] = None):
        self.products = products
        self.nbytes = int(nbytes)
        self.hits = 0
        self.meta = dict(meta or {})


class InversionStore:
    """Byte-budgeted LRU of device-resident inversion products.

    ``products`` is any tree of tensors (the engine stores ``(cached:
    CachedSource, anchor: latents)``); the store needs only its bytes.
    Thread-safe: the HTTP handlers read :meth:`stats` while the engine's
    worker puts and gets entries.
    """

    def __init__(self, byte_budget: int, *, persist_dir: Optional[str] = None,
                 faults: Optional[Any] = None):
        if byte_budget <= 0:
            raise ValueError(f"byte_budget must be positive, got {byte_budget}")
        self.byte_budget = int(byte_budget)
        self.persist_dir = persist_dir
        # fault-injection seam (serve/faults.py FaultPlan): corrupts disk
        # loads deterministically; None in production
        self.faults = faults
        self._entries: "OrderedDict[str, StoreEntry]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.rejected_oversize = 0
        self.disk_hits = 0
        self.disk_corrupt = 0

    # ---- resident layer --------------------------------------------------

    def get(self, key: str) -> Optional[Any]:
        """Products on a hit (the entry becomes most recently used), else
        None."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            entry.hits += 1
            self.hits += 1
            return entry.products

    def put(self, key: str, products: Any, *, trajectory: Optional[np.ndarray] = None,
            meta: Optional[Dict] = None) -> bool:
        """Insert (or refresh) an entry, evicting least-recently-used entries
        until the budget holds. An entry larger than the whole budget is
        refused (``rejected_oversize``) rather than evicting everything for
        an entry that can never hit. ``trajectory`` (inversion-walk order,
        a host array) is written through to the disk layer when persistence
        is configured. Returns True when resident."""
        nbytes = tree_nbytes(products)
        if self.persist_dir is not None and trajectory is not None:
            save_persisted_inversion(self.persist_dir, key, trajectory, meta=meta)
        with self._lock:
            if nbytes > self.byte_budget:
                self.rejected_oversize += 1
                self._entries.pop(key, None)
                return False
            self._entries.pop(key, None)
            while self._entries and self._bytes_locked() + nbytes > self.byte_budget:
                self._entries.popitem(last=False)  # least recently used
                self.evictions += 1
            self._entries[key] = StoreEntry(products, nbytes, meta)
            return True

    def _bytes_locked(self) -> int:
        return sum(e.nbytes for e in self._entries.values())

    # ---- crash-recovery read path ----------------------------------------

    def load_disk(self, key: str) -> Optional[np.ndarray]:
        """The persisted trajectory for ``key`` (inversion-walk order,
        ``trajectory[0]`` = the encoded source latents), or None when absent
        OR invalid. A corrupted entry (non-finite values, an empty or
        malformed array, a file that does not load) is detected here and
        counted in ``disk_corrupt``, so the engine falls back to a fresh
        inversion instead of serving garbage."""
        if not self.persist_dir:
            return None
        try:
            loaded = load_persisted_inversion(self.persist_dir, key)
        except Exception:  # noqa: BLE001 — a broken entry is a miss, not a crash
            with self._lock:
                self.disk_corrupt += 1
            return None
        if loaded is None:
            return None
        traj = loaded[0]
        if traj is not None and self.faults is not None and self.faults.corrupts(key):
            # deterministic injected corruption of the anchor the rebuild
            # would start from: what the validation below must catch
            traj = np.array(traj, copy=True)
            traj[0] = np.nan
        if (traj is None or getattr(traj, "size", 0) == 0 or traj.ndim < 2
                or not np.all(np.isfinite(traj))):
            with self._lock:
                self.disk_corrupt += 1
            return None
        with self._lock:
            self.disk_hits += 1
        return np.asarray(traj)

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._entries

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def keys(self):
        with self._lock:
            return list(self._entries)

    def stats(self) -> Dict[str, Any]:
        """The ``/metrics`` store section: residency, budget and hit rates."""
        with self._lock:
            entries = len(self._entries)
            in_use = self._bytes_locked()
        total = self.hits + self.misses
        return {
            "entries": entries,
            "bytes_in_use": in_use,
            "byte_budget": self.byte_budget,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "rejected_oversize": self.rejected_oversize,
            "disk_hits": self.disk_hits,
            "disk_corrupt": self.disk_corrupt,
            "hit_rate": round(self.hits / total, 4) if total else None,
        }


# ---- disk layer (shared with the CLIs) -----------------------------------


def load_persisted_inversion(
    root: str, key: str, *, want_null: bool = False, null_tag: str = ""
) -> Optional[Tuple[np.ndarray, Optional[np.ndarray]]]:
    """(trajectory, null_embeddings-or-None) from the disk layer, or None."""
    if not root:
        return None
    return load_inversion(root, key, want_null=want_null, null_tag=null_tag)


def save_persisted_inversion(
    root: str,
    key: str,
    trajectory: Optional[np.ndarray] = None,
    null_embeddings: Optional[np.ndarray] = None,
    *,
    null_tag: str = "",
    meta: Optional[Dict] = None,
) -> Optional[str]:
    """Write products to the disk layer (atomic, first writer wins: see
    ``utils/inv_cache.save_inversion``); never raises (persistence is an
    amortization, not a correctness dependency)."""
    if not root:
        return None
    try:
        os.makedirs(root, exist_ok=True)
        return save_inversion(root, key, trajectory, null_embeddings, null_tag=null_tag,
                              meta=meta)
    except OSError:
        return None
