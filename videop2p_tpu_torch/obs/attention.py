"""The observability sidecar: numpy arrays beside the ledger events that
point at them (the part of ``videop2p_tpu/obs/attention.py`` the fleet
planes read: :func:`save_obs_sidecar` / :func:`load_obs_sidecar`, used by
``obs/tsdb.py``'s snapshot and ``obs/incident.py``'s bundles).

The attention-map records (``attn_step_record``, ``summarize_attn_record``
and the rest, the run CLIs' ``--attn_maps``) come with the rest of
``obs/`` (ROADMAP Queue 1 item 14, step 3).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

__all__ = ["save_obs_sidecar", "load_obs_sidecar"]


def save_obs_sidecar(path: str, arrays: Dict[str, np.ndarray]) -> str:
    """Write the observability arrays as one compressed ``.npz`` the ledger
    events point at. numpy-only — readable on any box."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    np.savez_compressed(path, **{k: np.asarray(v) for k, v in arrays.items()})
    return path


def load_obs_sidecar(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
