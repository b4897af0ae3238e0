"""CLIP text encoder, the SD-1.x conditioning model (port of
``videop2p_tpu/models/clip.py``): token + position embeddings, a pre-LN
causal transformer with QuickGELU, final LayerNorm. Returns the last hidden
state (B, L, D). Parameter names follow ``transformers.CLIPTextModel``'s
``text_model`` (``embeddings.token_embedding.weight``, ...)."""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

__all__ = ["CLIPTextConfig", "CLIPTextEncoder"]


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5

    @classmethod
    def tiny(cls, **overrides) -> "CLIPTextConfig":
        cfg = dict(vocab_size=128, hidden_size=16, intermediate_size=32,
                   num_hidden_layers=2, num_attention_heads=2,
                   max_position_embeddings=77)
        cfg.update(overrides)
        return cls(**cfg)


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings,
                                               cfg.hidden_size)


class _Attention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.heads = cfg.num_attention_heads
        d = cfg.hidden_size
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        d = c // self.heads
        q = self.q_proj(x) * (d ** -0.5)
        q, k, v = (t.reshape(b, n, self.heads, d).transpose(1, 2)
                   for t in (q, self.k_proj(x), self.v_proj(x)))
        sim = torch.matmul(q, k.transpose(-1, -2)) + mask
        probs = torch.softmax(sim.float(), dim=-1).to(q.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(b, n, c)
        return self.out_proj(out)


class _MLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fc1(x)
        return self.fc2(h * torch.sigmoid(1.702 * h))  # QuickGELU


class _Layer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.self_attn = _Attention(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = _MLP(cfg)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList([_Layer(cfg) for _ in range(cfg.num_hidden_layers)])


class CLIPTextEncoder(nn.Module):
    """``forward(input_ids (B, L) int) -> last_hidden_state (B, L, D)``."""

    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.config = config
        self.embeddings = _Embeddings(config)
        self.encoder = _Encoder(config)
        self.final_layer_norm = nn.LayerNorm(config.hidden_size,
                                             eps=config.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        n = input_ids.shape[1]
        # ids wrap into the table (a no-op at the real vocabulary; keeps tiny
        # configs defined for real tokenizer ids), as in the JAX encoder
        ids = input_ids.long() % self.config.vocab_size
        x = (self.embeddings.token_embedding(ids)
             + self.embeddings.position_embedding.weight[None, :n])
        mask = torch.full((n, n), float("-inf"), device=x.device).triu(1)[None, None]
        for layer in self.encoder.layers:
            x = layer(x, mask.to(x.dtype))
        return self.final_layer_norm(x)
