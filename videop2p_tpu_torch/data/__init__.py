"""Frame loading: the single-video dataset and the Stage-2 frame loader."""

from videop2p_tpu_torch.data.dataset import SingleVideoDataset, load_frame_sequence

__all__ = ["SingleVideoDataset", "load_frame_sequence"]
