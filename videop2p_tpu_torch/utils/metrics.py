"""Training metrics: a JSONL log, an optional TensorBoard mirror and a view
over the run ledger (port of ``videop2p_tpu/utils/metrics.py``).

:class:`MetricsLogger` appends one object a logged step, ``{"step",
"wall_s", <scalars>}``, to ``<run_dir>/metrics.jsonl``, line-buffered so a
killed run keeps what it logged. With ``tensorboard=True``, and where
``torch.utils.tensorboard`` imports, the scalars are also mirrored into
``<run_dir>/tb/`` (flushed every ``TB_FLUSH_EVERY`` logs and at close). The
mirror is off by default: the import pulls in TensorFlow where it is
installed, which takes seconds. With a run ledger (``ledger=`` or the
active one, ``obs/ledger.py``) every logged step is also a ``metric``
event of the ledger.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

__all__ = ["MetricsLogger"]

TB_PROJECT = "text2video-fine-tune"
TB_FLUSH_EVERY = 20


class MetricsLogger:
    def __init__(self, run_dir: str, *, ledger=None, tensorboard: bool = False):
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(run_dir, "metrics.jsonl")
        self._fh = open(self.path, "a", buffering=1)
        self._t0 = time.perf_counter()
        self._since_flush = 0
        self._ledger = ledger
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=os.path.join(run_dir, "tb"), comment=TB_PROJECT)
            except Exception:  # noqa: BLE001 — TensorBoard is optional; the JSONL is not
                self._tb = None

    def _active_ledger(self):
        if self._ledger is not None:
            return self._ledger
        from videop2p_tpu_torch.obs.ledger import current_ledger

        return current_ledger()

    def log(self, step: int, scalars: Dict[str, float]) -> None:
        rec = {"step": int(step), "wall_s": round(time.perf_counter() - self._t0, 3)}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._fh.write(json.dumps(rec) + "\n")
        led = self._active_ledger()
        if led is not None:
            led.event("metric", **rec)
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), int(step))
            self._since_flush += 1
            if self._since_flush >= TB_FLUSH_EVERY:
                self._tb.flush()
                self._since_flush = 0

    def close(self) -> None:
        self._fh.close()
        if self._tb is not None:
            # flush before close: it survives a writer whose close() raises
            self._tb.flush()
            self._tb.close()

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> Optional[bool]:
        self.close()
        return None
