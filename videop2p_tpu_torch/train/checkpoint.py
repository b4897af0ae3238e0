"""Training checkpoints (port of ``videop2p_tpu/train/checkpoint.py``, in
torch's own format where JAX writes orbax).

``<output_dir>/checkpoint-<step>/train_state.pt`` holds the step, the run
seed (each step's generator derives from it and the step, so it is the
whole of the generators' state), the trainable tensors by name and the
optimizer state (Adam moments and count, the accumulation buffer and
mini-step). Restoring copies them into a live :class:`TrainState`, whose
trainable tensors are the UNet's own, so a resumed run continues with the
same bits as an uninterrupted one. :func:`latest_checkpoint` is the
reference's "latest" rule: the highest ``checkpoint-<n>`` suffix.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

from videop2p_tpu_torch.train.tuner import TrainState

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_checkpoint"]

_FILE = "train_state.pt"


def _to(value, device):
    if isinstance(value, torch.Tensor):
        return value.detach().to(device, copy=True)
    if isinstance(value, list):
        return [_to(v, device) for v in value]
    return value


def save_checkpoint(output_dir: str, state: TrainState, step: int, *, seed: int) -> str:
    """Write ``<output_dir>/checkpoint-<step>``; returns its path."""
    path = os.path.join(os.path.abspath(output_dir), f"checkpoint-{step}")
    os.makedirs(path, exist_ok=True)
    payload = {
        "step": int(state.step),
        "seed": int(seed),
        "names": list(state.trainable),
        "trainable": {k: _to(v, "cpu") for k, v in state.trainable.items()},
        "opt_state": {k: _to(v, "cpu") for k, v in state.opt_state.items()},
    }
    tmp = os.path.join(path, _FILE + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, _FILE))
    return path


@torch.no_grad()
def restore_checkpoint(path: str, state: TrainState, *, seed: int) -> TrainState:
    """Copy the checkpoint at ``path`` into ``state`` (its trainable
    tensors in place, on their device). Raises when the checkpoint's
    trainable set or run seed differs from this run's: either would change
    the trajectory it continues."""
    payload = torch.load(os.path.join(path, _FILE), map_location="cpu", weights_only=True)
    if payload["names"] != list(state.trainable):
        raise ValueError(f"checkpoint {path!r} trains another parameter set")
    if payload["seed"] != int(seed):
        raise ValueError(f"checkpoint {path!r} was written by a run seeded "
                         f"{payload['seed']}, this run is seeded {seed}")
    for name, p in state.trainable.items():
        p.copy_(payload["trainable"][name])
    device = next(iter(state.trainable.values())).device
    state.opt_state = {k: _to(v, device) for k, v in payload["opt_state"].items()}
    state.step = payload["step"]
    return state


def latest_checkpoint(output_dir: str) -> Optional[str]:
    """The highest-numbered ``checkpoint-<n>`` directory, or None."""
    if not os.path.isdir(output_dir):
        return None
    best, best_step = None, -1
    for name in os.listdir(output_dir):
        m = re.fullmatch(r"checkpoint-(\d+)", name)
        if m and int(m.group(1)) > best_step:
            best, best_step = name, int(m.group(1))
    return os.path.join(output_dir, best) if best else None
