"""The demo UI's in-process inference wrapper and its engine-backed edit path
(port of ``videop2p_tpu/ui/inference.py``).

:class:`InferencePipeline` loads a tuned experiment checkpoint once into a
:class:`~videop2p_tpu_torch.serve.programs.ProgramSet` (bf16 models on the
card unless a device is given), then samples a video for any prompt —
from the newest stored Stage-1 inversion latent when its shape fits, else
from fresh noise — and writes it as a GIF. Repeat samples with the same
step count and guidance reuse the warm ``sample_decode`` program.

:func:`edit_via_engine` is the UI's serving path: with a ``cli/serve.py``
engine up (``VIDEOP2P_SERVE_URL`` or the app's ``--engine``), the Edit tab
submits to it over HTTP (``serve/client.py``), and falls back to the
subprocess CLI when the engine is absent or the request fails.
"""

from __future__ import annotations

import glob
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

__all__ = ["InferencePipeline", "edit_via_engine"]


class InferencePipeline:
    """``mixed_precision`` "bf16" as the JAX package's; ``device`` CUDA
    unless the caller asks for the CPU."""

    def __init__(self, checkpoint_dir: Optional[str] = None, *, device="cuda",
                 mixed_precision: str = "bf16"):
        self.device = torch.device(device)
        self.mixed_precision = mixed_precision
        self.checkpoint_dir: Optional[str] = None
        self._programs = None
        if checkpoint_dir:
            self.load(checkpoint_dir)

    def load(self, checkpoint_dir: str) -> None:
        """(Re)load a tuned pipeline directory; a no-op when it is loaded."""
        if checkpoint_dir == self.checkpoint_dir and self._programs is not None:
            return
        from videop2p_tpu_torch.serve.programs import ProgramSet, ProgramSpec

        self._programs = ProgramSet(
            ProgramSpec(checkpoint=checkpoint_dir, mixed_precision=self.mixed_precision),
            device=self.device)
        self.checkpoint_dir = checkpoint_dir

    @property
    def programs(self):
        """The loaded :class:`ProgramSet` (None before :meth:`load`)."""
        return self._programs

    def _latest_inv_latent(self) -> Optional[np.ndarray]:
        """The newest Stage-1 validation inversion latent
        (``inv_latents/*.npy``), if any."""
        assert self.checkpoint_dir is not None
        paths = glob.glob(os.path.join(self.checkpoint_dir, "inv_latents", "*.npy"))
        if not paths:
            return None
        return np.load(max(paths, key=os.path.getmtime))

    def run(self, prompt: str, *, video_length: int = 8, num_steps: int = 50,
            guidance_scale: float = 7.5, seed: int = 0, use_inv_latent: bool = True,
            out_path: str = "out.gif", height: int = 512, width: int = 512) -> str:
        """Sample one video and write it to ``out_path``; returns the path.
        Fresh noise comes from a ``torch.Generator`` on the set's device
        seeded with ``seed``."""
        if self._programs is None:
            raise RuntimeError("load() a checkpoint dir first")
        from videop2p_tpu_torch.utils.video_io import save_video_gif

        ps = self._programs
        expected_shape = (1, video_length, height // 8, width // 8, 4)
        x_t = None
        if use_inv_latent:
            inv = self._latest_inv_latent()
            if inv is not None:
                if tuple(inv.shape) == expected_shape:
                    x_t = torch.as_tensor(inv, dtype=torch.float32, device=ps.device)
                else:
                    print(f"[inference] stored inversion latent {inv.shape} does not "
                          f"match the requested video {expected_shape} — sampling "
                          "from fresh noise instead")
        if x_t is None:
            gen = torch.Generator(ps.device).manual_seed(int(seed))
            x_t = torch.randn(expected_shape, generator=gen, device=ps.device)
        cond = ps.encode_prompts([prompt])
        uncond = ps.encode_prompts([""])[0]
        # CFG sample + decode as one warm instrumented program
        video01 = ps.sample(x_t, cond, uncond, steps=num_steps,
                            guidance_scale=guidance_scale)
        return save_video_gif(video01[0].cpu().numpy(), out_path, fps=8)


def edit_via_engine(engine_url: Optional[str], p2p_cfg: Dict[str, Any], *,
                    timeout_s: float = 600.0) -> Optional[str]:
    """One P2P edit through a serving engine; None means "use the
    subprocess fallback" (no or an unhealthy engine, or a failed request).

    ``p2p_cfg`` is the Stage-2 config dict the UI assembles
    (:meth:`~videop2p_tpu_torch.ui.trainer.Trainer.build_p2p_config`); the
    fields the engine does not key on (``pretrained_model_path``: the
    server serves one checkpoint; ``video_len``: fixed by its geometry) are
    dropped. Returns the edited GIF's path (on the server) on success."""
    from videop2p_tpu_torch.serve.client import EngineClient, engine_available

    if not engine_available(engine_url):
        return None
    request = {k: p2p_cfg[k] for k in ("image_path", "prompt", "prompts", "save_name",
                                       "is_word_swap", "blend_word", "eq_params",
                                       "cross_replace_steps", "self_replace_steps")
               if k in p2p_cfg}
    try:
        client = EngineClient(engine_url)
        rid = client.submit(request)
        record = client.wait(rid, timeout_s=timeout_s)
    except Exception as e:  # noqa: BLE001 — engine trouble falls back, never crashes the UI
        print(f"[ui] engine edit failed ({e}) — falling back to subprocess")
        return None
    if record.get("status") != "done":
        print(f"[ui] engine edit error: {record.get('error')} — falling back to subprocess")
        return None
    print(f"[ui] engine edit done in {record.get('total_s')}s (store hit: "
          f"{record.get('store_hit')}, compiles: {record.get('compile_events')})")
    return record.get("edit_gif")
