"""The models of the edit: the 3-D UNet, the VAE and the CLIP text encoder."""

from videop2p_tpu_torch.models.clip import CLIPTextConfig, CLIPTextEncoder
from videop2p_tpu_torch.models.unet import UNet3DConditionModel, UNet3DConfig
from videop2p_tpu_torch.models.vae import (
    AutoencoderKL,
    VAEConfig,
    decode_video,
    encode_video,
)

__all__ = [
    "CLIPTextConfig",
    "CLIPTextEncoder",
    "UNet3DConditionModel",
    "UNet3DConfig",
    "AutoencoderKL",
    "VAEConfig",
    "decode_video",
    "encode_video",
]
