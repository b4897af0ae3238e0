"""Render a self-contained HTML edit report from a run ledger + sidecar
(port of ``tools/edit_report.py``: a shim over ``obs/report.py:main``, as
``python -m videop2p_tpu_torch.obs.report``).

Usage:  python -m videop2p_tpu_torch.tools.edit_report <ledger.jsonl>
            [-o report.html] [--sidecar obs_sidecar.npz]

Renders the LAST run of the ledger (ledger files append across
invocations): per-word cross-attention heatmap grids across DDIM steps,
LocalBlend mask overlays on the edited frames, the null-text loss
sparkline, the edit-quality table (PSNR/SSIM), the "Where time goes"
section (execute-latency distributions + device-trace breakdowns —
``trace`` events whose directory still exists are mined), and the
regression verdicts — everything base64-embedded in one HTML file. The
sidecar ``.npz`` is located from the ledger's ``attn_maps``/``quality``
events when not given explicitly.
"""

from __future__ import annotations

import sys

from videop2p_tpu_torch.obs.report import main

if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
