"""CLIP text encoder in PyTorch: prompt conditioning for SD.

Port of ``sid_lsg_tpu/models/clip_text.py``: SD1.5's CLIP ViT-L/14 text tower
(quick_gelu) and SD2.x's OpenCLIP ViT-H tower (gelu) through
``CLIPTextConfig``.  Attention is causal and takes the plain path on every
device.  Parameter names are the transformers ``CLIPTextModel`` keys without
the ``text_model.`` prefix.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .configs import CLIPTextConfig
from .layers import LayerNorm32, multihead_attention


def _act(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="none")
    raise ValueError(name)


class CLIPAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = multihead_attention(self.q_proj(x), self.k_proj(x), self.v_proj(x), self.num_heads,
                                  causal=True)
        return self.out_proj(out)


class CLIPEncoderLayer(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        d, eps = config.hidden_size, config.layer_norm_eps
        self.act = _act(config.hidden_act)
        self.layer_norm1 = LayerNorm32(d, eps=eps)
        self.self_attn = CLIPAttention(d, config.num_attention_heads)
        self.layer_norm2 = LayerNorm32(d, eps=eps)
        self.mlp = nn.ModuleDict({"fc1": nn.Linear(d, config.intermediate_size),
                                  "fc2": nn.Linear(config.intermediate_size, d)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x))
        h = self.mlp["fc1"](self.layer_norm2(x))
        h = self.act(h.float()).to(x.dtype)
        return x + self.mlp["fc2"](h)


def _embedding(num: int, dim: int) -> nn.Embedding:
    """An ``nn.Embedding`` left uninitialised: the port loads every weight
    or draws it with ``layers.init_weights_``, and the default ``normal_`` on
    the meta device (``pipeline._skeletons``) imports ``torch._dynamo``,
    about 2.5 s at a process's first model."""
    return nn.Embedding(num, dim, _weight=torch.empty(num, dim))


class CLIPTextModel(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.config = config
        self.embeddings = nn.ModuleDict({
            "token_embedding": _embedding(config.vocab_size, config.hidden_size),
            "position_embedding": _embedding(config.max_position_embeddings, config.hidden_size),
        })
        self.encoder = nn.ModuleDict({"layers": nn.ModuleList(
            [CLIPEncoderLayer(config) for _ in range(config.num_hidden_layers)])})
        self.final_layer_norm = LayerNorm32(config.hidden_size, eps=config.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """(B, L) token ids -> (B, L, hidden) last hidden state (after the final LN)."""
        pos_ids = torch.arange(input_ids.shape[1], device=input_ids.device)[None, :]
        x = (self.embeddings["token_embedding"](input_ids)
             + self.embeddings["position_embedding"](pos_ids))
        for layer in self.encoder["layers"]:
            x = layer(x)
        return self.final_layer_norm(x)
