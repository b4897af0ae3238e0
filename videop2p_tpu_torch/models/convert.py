"""Weights carried across from the JAX package, and the port's seeded random
init.

``state_dict_from_jax`` takes the JAX package's parameter trees (nested dicts
of numpy arrays, with or without the top-level ``"params"``) and returns the
port's state dicts. The name and transpose rules are this package's own copy
of ``videop2p_tpu/models/convert.py``: ``_flax_path_to_torch`` and
``_from_flax_tensor`` (:65-147), ``unet3d_params_to_torch`` (:197-210), and
the flax→torch direction of ``_vae_flax_to_torch`` (:243-280) and
``clip_params_from_torch`` (:321).

``init_weights`` fills a module from a seeded ``torch.Generator`` on the
module's device, so a full SD-1.5-width model initializes on the card.

Checkpoints on disk use the diffusers / transformers names. The port's UNet
and VAE keys are diffusers' own (its VAE attention also loads from the older
``query``/``key``/``value``/``proj_attn`` names); the CLIP text encoder's
carry transformers' ``text_model.`` prefix on disk. ``read_safetensors`` /
``save_safetensors`` are the port's own reader and writer of the
``.safetensors`` format (an 8-byte little-endian header length, a JSON header
``{name: {dtype, shape, data_offsets}}``, then the raw little-endian bytes);
``load_state_dict`` also reads torch ``.bin`` files. ``load_weights`` copies
a state dict into a module: a key the module lacks raises, and so does a
missing one, except those ``keep_init`` allows (the UNet's temporal
``_temp.`` parameters when a 2-D checkpoint inflates).
"""

from __future__ import annotations

import json
import os
import re
import struct
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

__all__ = [
    "state_dict_from_jax",
    "unet_state_dict_from_jax",
    "unet_jax_paths",
    "quantize_unet_params",
    "vae_state_dict_from_jax",
    "clip_state_dict_from_jax",
    "init_weights",
    "read_safetensors",
    "save_safetensors",
    "load_state_dict",
    "load_weights",
    "is_temporal_key",
    "vae_state_dict_from_diffusers",
    "clip_state_dict_from_transformers",
    "clip_state_dict_to_transformers",
]

Path = Tuple[str, ...]

_SEG_MAP = {
    "downsample": "downsamplers.0",
    "upsample": "upsamplers.0",
    "proj_geglu": "net.0.proj",
}
_INDEXED = ("down_blocks_", "up_blocks_", "attentions_", "resnets_", "layers_")


def _flatten(tree: Mapping, prefix: Path = ()) -> Dict[Path, np.ndarray]:
    out = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            out.update(_flatten(value, prefix + (key,)))
        else:
            out[prefix + (key,)] = np.asarray(value)
    return out


def _params(tree: Mapping) -> Mapping:
    return tree["params"] if "params" in tree else tree


def _unet_key(path: Path) -> Tuple[str, str]:
    """(torch key, kind) for one flax UNet param path; kind ∈ {conv, dense,
    norm, raw} selects the tensor transform."""
    leaf = path[-1]
    body = list(path[:-1])
    kind = "raw"
    # InflatedConv wraps an nn.Conv named "conv": drop that segment
    if body and body[-1] == "conv":
        body = body[:-1]
        if leaf == "kernel":
            kind = "conv"
    segs = []
    for t in body:
        if t.startswith("blocks_"):
            segs.append(f"transformer_blocks.{t.split('_')[1]}")
        elif t.startswith(_INDEXED):
            base, i = t.rsplit("_", 1)
            segs.append(f"{base}.{i}")
        elif t in _SEG_MAP:
            segs.append(_SEG_MAP[t])
        elif t == "proj_out" and segs and segs[-1] == "ff":
            segs.append("net.2")
        elif t == "to_out":
            segs.append("to_out.0")
        else:
            segs.append(t)
    if kind != "conv":
        kind = {"kernel": "dense", "scale": "norm"}.get(leaf, "raw")
    torch_leaf = {"kernel": "weight", "scale": "weight", "bias": "bias",
                  "embedding": "weight"}[leaf]
    return ".".join(segs + [torch_leaf]), kind


def _from_flax_tensor(t: np.ndarray, kind: str, conv1x1: bool = False) -> np.ndarray:
    if kind == "conv":
        return np.transpose(t, (3, 2, 0, 1))
    if kind == "dense":
        w = np.transpose(t)
        return w[:, :, None, None] if conv1x1 else w
    return t


def _tensor(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a))  # a writable copy


# the inverse of _unet_key's segment rules: torch segments → one flax token
_TORCH_PAIRS = {("downsamplers", "0"): "downsample", ("upsamplers", "0"): "upsample",
                ("to_out", "0"): "to_out", ("net", "2"): "proj_out"}
_TORCH_INDEXED = ("down_blocks", "up_blocks", "attentions", "resnets", "layers")


def _flax_module_tokens(name: str) -> list:
    """A torch module name of the UNet → its flax module path tokens."""
    segs, out, i = name.split(".") if name else [], [], 0
    while i < len(segs):
        s, nxt = segs[i], segs[i + 1] if i + 1 < len(segs) else None
        if s == "net" and nxt == "0" and i + 2 < len(segs) and segs[i + 2] == "proj":
            out.append("proj_geglu")
            i += 3
        elif (s, nxt) in _TORCH_PAIRS:
            out.append(_TORCH_PAIRS[s, nxt])
            i += 2
        elif s == "transformer_blocks":
            out.append(f"blocks_{nxt}")
            i += 2
        elif s in _TORCH_INDEXED and nxt is not None and nxt.isdigit():
            out.append(f"{s}_{nxt}")
            i += 2
        else:
            out.append(s)
            i += 1
    return out


def unet_jax_paths(module: nn.Module) -> Dict[str, Path]:
    """{port UNet parameter name: its flax parameter path}, the inverse of
    :func:`unet_state_dict_from_jax`'s name map: a convolution's weight sits
    under the flax ``conv`` submodule as ``kernel``, a linear or 1×1
    projection's weight is a ``kernel``, a norm's weight a ``scale``, an
    embedding's an ``embedding``."""
    from videop2p_tpu_torch.models.attention import Conv1x1

    out = {}
    for mname, mod in module.named_modules():
        body = _flax_module_tokens(mname)
        for pname, _ in mod.named_parameters(recurse=False):
            if isinstance(mod, nn.Conv2d):
                path = body + ["conv", "kernel" if pname == "weight" else pname]
            elif isinstance(mod, (nn.Linear, Conv1x1)):
                path = body + ["kernel" if pname == "weight" else pname]
            elif isinstance(mod, nn.Embedding):
                path = body + ["embedding"]
            else:
                path = body + ["scale" if pname == "weight" else pname]
            out[f"{mname}.{pname}" if mname else pname] = tuple(path)
    return out


def unet_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax video-UNet params → the port's UNet state dict. The transformer's
    ``proj_in``/``proj_out`` become 1×1 conv weights (out, in, 1, 1)."""
    out = {}
    for path, leaf in _flatten(_params(params)).items():
        key, kind = _unet_key(path)
        conv1x1 = (kind == "dense" and len(path) >= 3
                   and path[-2] in ("proj_in", "proj_out")
                   and path[-3].startswith("attentions_"))
        out[key] = _tensor(_from_flax_tensor(leaf, kind, conv1x1))
    return out


@torch.no_grad()
def quantize_unet_params(unet: nn.Module, mode: str = "w8",
                         weight_dtype: str = "int8") -> nn.Module:
    """Post-training quantization of the UNet in place (JAX:
    ``convert.py:quantize_unet_params``): every weight of two or more
    dimensions (the linear, convolution and 1×1 projection weights, JAX's
    ``kernel`` leaves) outside the full-precision islands ``SKIP_MODULES``
    becomes a :class:`~videop2p_tpu_torch.models.quant.QuantizedWeight`;
    biases and norms stay. ``w8a8`` also sets the activation fake-quant
    seam. ``mode="off"`` returns ``unet`` untouched."""
    from videop2p_tpu_torch.models.quant import (
        SKIP_MODULES,
        fake_quant_act,
        quant_weight_dtype,
        quantize_weight,
        set_act_quant,
        validate_quant_mode,
    )

    mode = validate_quant_mode(mode)
    if mode == "off":
        return unet
    dtype = quant_weight_dtype(weight_dtype)
    for name, module in list(unet.named_modules()):
        weight = module._parameters.get("weight")
        if (weight is None or weight.dim() < 2
                or any(s in name.split(".") for s in SKIP_MODULES)):
            continue
        del module._parameters["weight"]
        module.weight = quantize_weight(weight, dtype=dtype)
    if mode == "w8a8":
        set_act_quant(unet, fake_quant_act)
    return unet


def _vae_key(path: Path) -> str:
    toks = list(path)
    leaf = toks.pop()
    segs = []
    for t in toks:
        parts = t.split("_")
        if t.startswith(("down_", "up_")) and parts[1].isdigit():
            kind = "down" if parts[0] == "down" else "up"
            if parts[2] in ("downsample", "upsample"):
                segs.append(f"{kind}_blocks.{parts[1]}.{parts[2]}rs.0.conv")
            else:
                segs.append(f"{kind}_blocks.{parts[1]}.{parts[2]}.{parts[3]}")
        elif t.startswith("mid_resnets_"):
            segs.append(f"mid_block.resnets.{parts[-1]}")
        elif t == "mid_attn":
            segs.append("mid_block.attentions.0")
        elif t == "to_out":
            segs.append("to_out.0")
        else:
            segs.append(t)
    return ".".join(segs) + "." + {"kernel": "weight", "scale": "weight",
                                   "bias": "bias"}[leaf]


def vae_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    out = {}
    for path, leaf in _flatten(_params(params)).items():
        if path[-1] == "kernel":
            leaf = (np.transpose(leaf, (3, 2, 0, 1)) if leaf.ndim == 4
                    else np.transpose(leaf))
        out[_vae_key(path)] = _tensor(leaf)
    return out


def clip_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    out = {}
    for path, leaf in _flatten(_params(params)).items():
        toks, name = list(path[:-1]), path[-1]
        if toks == ["token_embedding"]:
            key = "embeddings.token_embedding.weight"
        elif not toks and name == "position_embedding":
            key = "embeddings.position_embedding.weight"
        elif toks[0] == "final_layer_norm":
            key = f"final_layer_norm.{'bias' if name == 'bias' else 'weight'}"
        else:
            i = toks[0].rsplit("_", 1)[1]
            rest = toks[1:]
            if rest[0] in ("fc1", "fc2"):
                mod = f"encoder.layers.{i}.mlp.{rest[0]}"
            elif rest[0] == "self_attn":
                mod = f"encoder.layers.{i}.self_attn.{rest[1]}"
            else:
                mod = f"encoder.layers.{i}.{rest[0]}"
            key = f"{mod}.{'bias' if name == 'bias' else 'weight'}"
        if name == "kernel":
            leaf = np.transpose(leaf)
        out[key] = _tensor(leaf)
    return out


def state_dict_from_jax(unet_params: Optional[Mapping] = None,
                        vae_params: Optional[Mapping] = None,
                        clip_params: Optional[Mapping] = None) -> dict:
    """The port's state dicts ``{"unet", "vae", "text_encoder"}`` (None where
    no tree was given) from the JAX package's parameter trees."""
    return {
        "unet": None if unet_params is None else unet_state_dict_from_jax(unet_params),
        "vae": None if vae_params is None else vae_state_dict_from_jax(vae_params),
        "text_encoder": (None if clip_params is None
                         else clip_state_dict_from_jax(clip_params)),
    }


@torch.no_grad()
def init_weights(module: nn.Module, seed: int) -> nn.Module:
    """Seeded random init in place, on the module's own device: biases 0,
    norm scales 1, embeddings N(0, 0.02²), linear/conv weights N(0, 1/fan_in)
    (the scale of flax's lecun-normal default). The temporal attention's
    output projection starts at zero, as the JAX init's ``zero_init_out``
    does, so an inflated model starts as its 2-D self."""
    gens = {}
    for name, p in module.named_parameters():
        gen = gens.get(p.device)
        if gen is None:
            gen = gens[p.device] = torch.Generator(device=p.device).manual_seed(seed)
        if name.endswith("bias") or "attn_temp.to_out" in name:
            p.zero_()
        elif p.dim() == 1:
            p.fill_(1.0)
        elif "embedding" in name:
            p.normal_(0.0, 0.02, generator=gen)
        else:
            p.normal_(0.0, p[0].numel() ** -0.5, generator=gen)
    return module


# --------------------------------------------------------------------- #
# checkpoint files
# --------------------------------------------------------------------- #

# I64: transformers' CLIP checkpoints carry an int64 position-ids buffer
_ST_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
              "I64": torch.int64}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file as CPU tensors. The file is read once into one
    host buffer and every tensor is a view of it (a tensor whose offset is
    not a multiple of its item size is copied out)."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        buf = bytearray(size - 8 - n)
        if f.readinto(buf) != len(buf):
            raise IOError(f"{path!r} is shorter than its header says")
    base = torch.frombuffer(buf, dtype=torch.uint8) if buf else torch.empty(0, dtype=torch.uint8)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path!r}: tensor {name!r} has dtype {info['dtype']}, "
                             f"not one of {sorted(_ST_DTYPES)}")
        dtype = _ST_DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        raw = base[start:end]
        if start % dtype.itemsize:
            raw = raw.clone()
        out[name] = raw.view(dtype).reshape(info["shape"])
    return out


def save_safetensors(tensors: Mapping[str, torch.Tensor], path: str,
                     metadata: Optional[Dict[str, str]] = None) -> int:
    """Write ``tensors`` (any device) as a ``.safetensors`` file, the widest
    dtypes first so that every tensor sits at a multiple of its item size,
    the header padded to 8 bytes. Returns the bytes written."""
    order = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header: Dict[str, dict] = {"__metadata__": dict(metadata)} if metadata else {}
    offset = 0
    for name in order:
        t = tensors[name]
        if t.dtype not in _ST_NAMES:
            raise ValueError(f"tensor {name!r} has dtype {t.dtype}, not one of "
                             f"{sorted(str(d) for d in _ST_NAMES)}")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in order:
            t = tensors[name].detach().contiguous().reshape(-1)
            if t.numel():
                f.write(memoryview(t.cpu().view(torch.uint8).numpy()))
    return 8 + len(blob) + offset


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` or torch ``.bin`` weights file as CPU tensors."""
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    return dict(torch.load(path, map_location="cpu", weights_only=True))


def is_temporal_key(key: str) -> bool:
    """A parameter that a 2-D checkpoint lacks (the reference's ``_temp.``
    rule): the temporal attention and its norm."""
    return "_temp." in key


@torch.no_grad()
def load_weights(module: nn.Module, state_dict: Mapping[str, torch.Tensor], *,
                 keep_init: Callable[[str], bool] = lambda key: False) -> Dict[str, list]:
    """Copy ``state_dict`` into ``module``'s parameters (one copy a tensor,
    to the parameter's device and dtype). Raises on a key the module lacks,
    on a shape that differs and on a missing key that ``keep_init`` does not
    allow; returns ``{"kept_init": [...], "unused": []}``, the missing keys
    that keep the module's own values."""
    params = dict(module.named_parameters())
    unused = sorted(k for k in state_dict if k not in params)
    if unused:
        raise KeyError(f"{len(unused)} checkpoint keys the model lacks, e.g. {unused[:5]}")
    missing = sorted(k for k in params if k not in state_dict)
    bad = [k for k in missing if not keep_init(k)]
    if bad:
        raise KeyError(f"{len(bad)} model keys missing from the checkpoint, e.g. {bad[:5]}")
    for key, src in state_dict.items():
        dst = params[key]
        if src.shape != dst.shape:
            raise ValueError(f"shape mismatch for {key!r}: checkpoint "
                             f"{tuple(src.shape)}, model {tuple(dst.shape)}")
        dst.copy_(src)
    return {"kept_init": missing, "unused": unused}


_VAE_OLD_ATTN = {"query": "to_q", "key": "to_k", "value": "to_v", "proj_attn": "to_out.0"}
_VAE_OLD_RE = re.compile(r"\.attentions\.(\d+)\.(query|key|value|proj_attn)\.")


def vae_state_dict_from_diffusers(state_dict: Mapping[str, torch.Tensor]
                                  ) -> Dict[str, torch.Tensor]:
    """A diffusers AutoencoderKL state dict under the port's names: the
    attention's older ``query``/``key``/``value``/``proj_attn`` become
    ``to_q``/``to_k``/``to_v``/``to_out.0``; the newer names pass."""
    return {_VAE_OLD_RE.sub(lambda m: f".attentions.{m.group(1)}."
                            f"{_VAE_OLD_ATTN[m.group(2)]}.", k): v
            for k, v in state_dict.items()}


_CLIP_PREFIX = "text_model."
# a buffer of transformers' CLIP (the position ids 0..76), not a parameter
_CLIP_BUFFERS = ("embeddings.position_ids",)


def clip_state_dict_from_transformers(state_dict: Mapping[str, torch.Tensor]
                                      ) -> Dict[str, torch.Tensor]:
    """A transformers CLIPTextModel state dict under the port's names: the
    ``text_model.`` prefix dropped, the position-ids buffer left out."""
    out = {}
    for k, v in state_dict.items():
        k = k[len(_CLIP_PREFIX):] if k.startswith(_CLIP_PREFIX) else k
        if k not in _CLIP_BUFFERS:
            out[k] = v
    return out


def clip_state_dict_to_transformers(state_dict: Mapping[str, torch.Tensor]
                                    ) -> Dict[str, torch.Tensor]:
    """The port's CLIP state dict under transformers' names."""
    return {_CLIP_PREFIX + k: v for k, v in state_dict.items()}
