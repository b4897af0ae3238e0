"""Training metrics as JSON lines (port of ``videop2p_tpu/utils/metrics.py``
without its TensorBoard mirror and run-ledger view): one object a logged
step, ``{"step", "wall_s", <scalars>}``, appended to
``<run_dir>/metrics.jsonl``, line-buffered so a killed run keeps what it
logged."""

from __future__ import annotations

import json
import os
import time
from typing import Dict

__all__ = ["MetricsLogger"]


class MetricsLogger:
    def __init__(self, run_dir: str):
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(run_dir, "metrics.jsonl")
        self._fh = open(self.path, "a", buffering=1)
        self._t0 = time.perf_counter()

    def log(self, step: int, scalars: Dict[str, float]) -> None:
        rec = {"step": int(step), "wall_s": round(time.perf_counter() - self._t0, 3)}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._fh.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        self._fh.close()
