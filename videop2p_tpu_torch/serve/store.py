"""The disk layer of the inversion-product store (port of
``videop2p_tpu/serve/store.py``'s ``load_persisted_inversion`` and
``save_persisted_inversion``).

These wrappers are ``utils/inv_cache.py`` with an explicit root: the CLI's
per-results-directory persistence and a shared ``--inv_store`` root go
through the same content-addressed entry layout, so a sweep and a one-shot
CLI run reuse one inversion of a clip. The in-memory ``InversionStore`` of
the serving engine waits for the serving port (ROADMAP Queue 1 item 14).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from videop2p_tpu_torch.utils.inv_cache import load_inversion, save_inversion

__all__ = ["load_persisted_inversion", "save_persisted_inversion"]


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
