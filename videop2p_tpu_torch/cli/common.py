"""What both CLI stages share: the fork's dependent-noise flags, the
Stage-1 ↔ Stage-2 checkpoint-path contract and the config reader (the
port's own copy of ``add_dependent_args``, ``dependent_suffix``,
``resolve_pipeline_dir`` and ``load_config`` from
``videop2p_tpu/cli/common.py``).

Stage 1 writes its tuned pipeline to ``<path><suffix>``, the suffix spelling
out the dependent-noise settings; Stage 2, given the same flags, resolves the
same directory and writes its results under it.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict

__all__ = ["add_dependent_args", "dependent_suffix", "resolve_pipeline_dir",
           "load_config"]


def load_config(path: str) -> Dict[str, Any]:
    """A YAML config as a dict (needs PyYAML)."""
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def add_dependent_args(parser: argparse.ArgumentParser) -> None:
    """The fork's flags, with the JAX CLI's defaults. Stage 2 parses
    ``--loss_sig`` and ``--num_frames`` and does not use them (the sampler
    takes the clip's frame count)."""
    parser.add_argument("--dependent", default=False, action="store_true")
    parser.add_argument("--ar_sample", default=False, action="store_true")
    parser.add_argument("--decay_rate", default=0.1, type=float)
    parser.add_argument("--window_size", default=60, type=int)
    parser.add_argument("--ar_coeff", default=0.1, type=float)
    parser.add_argument("--loss_sig", default=False, action="store_true")
    parser.add_argument("--num_frames", default=60, type=int)
    parser.add_argument("--eta", default=0.0, type=float)
    parser.add_argument("--dependent_weights", default=0.0, type=float)


def dependent_suffix(*, dependent: bool, decay_rate: float, window_size: int,
                     ar_sample: bool, ar_coeff: float, eta: float,
                     dependent_weights: float) -> str:
    """The checkpoint directory's suffix: every setting in its Python
    ``str`` spelling, e.g. ``_dependentTrue_dr0.3_ws4_arTrue_ac0.1_eta0.0_dw0.2``."""
    return "_dependent{d}_dr{dr}_ws{ws}_ar{ar}_ac{ac}_eta{e}_dw{dw}".format(
        d=dependent, dr=decay_rate, ws=window_size, ar=ar_sample, ac=ar_coeff,
        e=eta, dw=dependent_weights)


def _is_pipeline_dir(path: str) -> bool:
    return os.path.isdir(os.path.join(path, "unet")) or os.path.isfile(
        os.path.join(path, "model_index.json"))


def resolve_pipeline_dir(base_path: str, **suffix_kwargs) -> str:
    """The checkpoint directory for ``base_path`` and the settings of
    :func:`dependent_suffix`: the suffixed directory when it holds a
    pipeline, else ``base_path`` when it does (a caller that already holds
    the suffixed directory), else the suffixed directory (loading then finds
    no checkpoint and says so)."""
    suffixed = base_path + dependent_suffix(**suffix_kwargs)
    if _is_pipeline_dir(suffixed):
        return suffixed
    if _is_pipeline_dir(base_path):
        if suffixed != base_path:
            print(f"[resolve_pipeline_dir] {base_path!r} is already a pipeline "
                  "dir — not appending the dependent suffix")
        return base_path
    return suffixed
