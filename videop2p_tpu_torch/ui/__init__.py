"""Demo and distribution layer (port of ``videop2p_tpu/ui/``): the
config-building trainer, the inference wrapper, the Hub upload and the
Gradio app. ``gradio`` and ``huggingface_hub`` are optional: each is
imported only where it is used."""

from videop2p_tpu_torch.ui.inference import InferencePipeline
from videop2p_tpu_torch.ui.trainer import Trainer, find_exp_dirs, save_model_card
from videop2p_tpu_torch.ui.upload import ModelUploader, Uploader, UploadTarget

__all__ = [
    "Trainer",
    "InferencePipeline",
    "find_exp_dirs",
    "save_model_card",
    "ModelUploader",
    "Uploader",
    "UploadTarget",
]
