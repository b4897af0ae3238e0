"""Hyperparameter sweep over the dependent-noise settings (port of
``videop2p_tpu/cli/sweep.py``).

A grid over ``decay_rate × eta × dependent_weights``: each cell runs the
(tune, p2p) config pair as subprocesses of the port's own CLIs. The stages
communicate through the dependent-suffix path contract, so the sweep only
passes identical flags to both; the scene is a parameter. ``--device`` goes
to both stages; every other flag is JAX's.

Run:  python -m videop2p_tpu_torch.cli.sweep --scene rabbit-jump \
          --decay_rates 0.1 0.3 --etas 0.0 0.1 --dependent_weights 0.0 0.2
"""

from __future__ import annotations

import argparse
import itertools
import subprocess
import sys
from typing import List, Optional


def cell_commands(
    tune_config: str,
    p2p_config: str,
    *,
    decay_rate: float,
    eta: float,
    dependent_weight: float,
    window_size: int,
    ar_sample: bool,
    ar_coeff: float,
    num_frames: int,
    fast: bool,
    dependent_p2p: bool,
    extra: List[str],
    inv_store: Optional[str] = None,
    device: Optional[str] = None,
) -> List[List[str]]:
    """The two subprocess argvs for one grid cell.

    ``inv_store`` routes every cell's Stage-2 inversion persistence through
    one shared content-addressed root (the ``serve/store.py`` disk layer):
    cells whose inversion determinants agree (same clip, checkpoint, steps,
    dependent settings) reuse one DDIM inversion instead of re-walking it
    per scenario; cells that differ miss by key construction, so sharing is
    always safe. ``device`` (e.g. "cpu") goes to both stages."""
    common = [
        "--dependent",
        "--decay_rate", str(decay_rate),
        "--eta", str(eta),
        "--dependent_weights", str(dependent_weight),
        "--window_size", str(window_size),
        "--ar_coeff", str(ar_coeff),
        "--num_frames", str(num_frames),
    ]
    if ar_sample:
        common.append("--ar_sample")
    if device is not None:
        common += ["--device", device]
    tune = [sys.executable, "-m", "videop2p_tpu_torch.cli.run_tuning",
            "--config", tune_config] + common + extra
    p2p = [sys.executable, "-m", "videop2p_tpu_torch.cli.run_videop2p",
           "--config", p2p_config] + common + extra
    if inv_store:
        p2p += ["--inv_store", inv_store]
    if fast:
        p2p.append("--fast")
    if dependent_p2p:
        p2p.append("--dependent_p2p")
    return [tune, p2p]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", type=str, default="rabbit-jump",
                    help="config pair stem: configs/<scene>-{tune,p2p}.yaml")
    ap.add_argument("--tune_config", type=str, default=None)
    ap.add_argument("--p2p_config", type=str, default=None)
    ap.add_argument("--decay_rates", type=float, nargs="+", default=[0.1])
    ap.add_argument("--etas", type=float, nargs="+", default=[0.0])
    ap.add_argument("--dependent_weights", type=float, nargs="+", default=[0.0])
    ap.add_argument("--window_size", type=int, default=8)
    ap.add_argument("--ar_sample", action="store_true")
    ap.add_argument("--ar_coeff", type=float, default=0.1)
    ap.add_argument("--num_frames", type=int, default=8)
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--dependent_p2p", action="store_true")
    ap.add_argument("--skip_tune", action="store_true",
                    help="reuse existing Stage-1 checkpoints, only re-edit")
    ap.add_argument("--inv_store", type=str, default="inv_store",
                    help="shared inversion-store root every cell's Stage-2 "
                         "run persists/reuses DDIM inversions through "
                         "(serve/store.py disk layer; content-addressed "
                         "keys make sharing always safe)")
    ap.add_argument("--no_inv_store", action="store_true",
                    help="per-cell inversion persistence only (the "
                         "pre-store layout under each results dir)")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device of both stages (their default: cuda)")
    ap.add_argument("--dry_run", action="store_true", help="print commands only")
    # everything the sweep doesn't recognize is forwarded to both stages in
    # original order (flag-style extras like `--tiny` or `--width 256` work
    # without a `--` separator; a positional catch-all would split a flag
    # from its value)
    args, unknown = ap.parse_known_args(argv)
    args.extra = unknown

    tune_config = args.tune_config or f"configs/{args.scene}-tune.yaml"
    p2p_config = args.p2p_config or f"configs/{args.scene}-p2p.yaml"
    grid = list(itertools.product(args.decay_rates, args.etas, args.dependent_weights))
    print(f"[sweep] {len(grid)} cells over {args.scene}")
    failures = 0
    for decay_rate, eta, dw in grid:
        cmds = cell_commands(
            tune_config, p2p_config,
            decay_rate=decay_rate, eta=eta, dependent_weight=dw,
            window_size=args.window_size, ar_sample=args.ar_sample,
            ar_coeff=args.ar_coeff, num_frames=args.num_frames,
            fast=args.fast, dependent_p2p=args.dependent_p2p,
            extra=list(args.extra),
            inv_store=None if args.no_inv_store else args.inv_store,
            device=args.device,
        )
        if args.skip_tune:
            cmds = cmds[1:]
        for cmd in cmds:
            print("[sweep]", " ".join(cmd))
            if args.dry_run:
                continue
            ret = subprocess.call(cmd)
            if ret != 0:
                print(f"[sweep] FAILED (exit {ret}): dr={decay_rate} eta={eta} dw={dw}")
                failures += 1
                break  # don't run p2p on a failed tune
    print(f"[sweep] done, {failures} failed cell(s)")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
