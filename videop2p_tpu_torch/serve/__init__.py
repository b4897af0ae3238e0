"""Serving: the disk layer of the inversion store (the in-memory store and
the engine are ROADMAP Queue 1 item 14)."""

from videop2p_tpu_torch.serve.store import load_persisted_inversion, save_persisted_inversion

__all__ = ["load_persisted_inversion", "save_persisted_inversion"]
