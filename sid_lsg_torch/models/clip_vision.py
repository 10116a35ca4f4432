"""CLIP vision tower and joint image/text scorer: the CLIP-score model.

Port of ``sid_lsg_tpu/models/clip_vision.py``: a CLIP ViT (patch conv, class
token, pre-LN transformer, post-LN, linear projection) beside the causal
``CLIPTextModel`` with EOT pooling and a text projection; unit-norm
features, cosine score.  ``VIT_G_14`` is laion2b ViT-g/14 (the metric
detector), ``VIT_H_14`` the tower HPSv2 fine-tunes, ``TINY_CLIP`` the test
preset.  ``convert_open_clip`` maps an open_clip state dict (``visual.*`` /
``transformer.resblocks.*``) onto the port's names.

The vision tower's attention goes through ``ops.attention``, so through K1
on the card (f32; head dim 88 at g/14, 80 at H/14).  Host uint8 images are
preprocessed as open_clip's inference transform does (Pillow BICUBIC
short-side resize with torchvision's int truncation, centre crop), by
``utils.resample`` without Pillow.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..utils.resample import resize_float, resize_uint8
from .clip_text import CLIPTextModel, _act
from .configs import CLIPTextConfig
from .layers import Attention, LayerNorm32, init_weights_
from .tokenizer import HashTokenizer

OPENAI_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_STD = (0.26862954, 0.26130258, 0.27577711)


def openclip_preprocess_uint8(images_uint8, size: int) -> np.ndarray:
    """open_clip's inference image transform on the host: torchvision
    ``Resize(size)`` (shorter side -> ``size``, Pillow BICUBIC, antialiased)
    then ``CenterCrop(size)``; float32 pixels in [0, 1], (N, size, size, 3)."""
    arr = np.asarray(images_uint8, dtype=np.uint8)
    h, w = arr.shape[1:3]
    if w <= h:  # torchvision _compute_resized_output_size (int truncation)
        nw, nh = size, max(int(size * h / w), size)
    else:
        nh, nw = size, max(int(size * w / h), size)
    arr = resize_uint8(arr, (nh, nw), "bicubic")
    left, top = (nw - size) // 2, (nh - size) // 2
    return arr[:, top:top + size, left:left + size].astype(np.float32) / 255.0


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1408
    intermediate_size: int = 6144
    num_hidden_layers: int = 40
    num_attention_heads: int = 16
    projection_dim: int = 1024
    layer_norm_eps: float = 1e-5
    # 'gelu' (open_clip ViT-g/H towers) | 'quick_gelu' (OpenAI ViT-L towers).
    hidden_act: str = "gelu"


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    vision: CLIPVisionConfig
    text: CLIPTextConfig
    projection_dim: int


_OPEN_CLIP_TEXT = CLIPTextConfig(hidden_size=1024, intermediate_size=4096, num_hidden_layers=24,
                                 num_attention_heads=16, hidden_act="gelu")

# laion2b_s12b_b42k ViT-g/14 (the metric detector).
VIT_G_14 = CLIPConfig(vision=CLIPVisionConfig(), text=_OPEN_CLIP_TEXT, projection_dim=1024)

# ViT-H/14: the tower HPSv2 fine-tunes.
VIT_H_14 = CLIPConfig(
    vision=CLIPVisionConfig(hidden_size=1280, intermediate_size=5120, num_hidden_layers=32,
                            num_attention_heads=16, projection_dim=1024),
    text=_OPEN_CLIP_TEXT, projection_dim=1024)

TINY_CLIP = CLIPConfig(
    vision=CLIPVisionConfig(image_size=32, patch_size=8, hidden_size=32, intermediate_size=64,
                            num_hidden_layers=2, num_attention_heads=2, projection_dim=16),
    text=CLIPTextConfig(vocab_size=1000, hidden_size=32, intermediate_size=64,
                        num_hidden_layers=2, num_attention_heads=2),
    projection_dim=16)


def config_from_open_clip(state_dict) -> CLIPConfig:
    """The ``CLIPConfig`` of an open_clip checkpoint from its own shapes
    (g/14 for metrics, H/14 for HPSv2, tiny for tests)."""
    shape = lambda k: tuple(np.shape(state_dict[k]))
    width = shape("visual.class_embedding")[0]
    n_pos = shape("visual.positional_embedding")[0]
    patch = shape("visual.conv1.weight")[2]
    grid = int(round((n_pos - 1) ** 0.5))
    layers = lambda prefix, at: 1 + max(int(k.split(".")[at]) for k in state_dict
                                        if k.startswith(prefix) and k.endswith(".ln_1.weight"))
    txt_width = shape("ln_final.weight")[0]
    # Fused qkv shapes do not give the head count: open_clip ViTs use 64-dim
    # heads except H/14 (1280 / 16 = 80) and g/14 (1408 / 16 = 88).
    vis_heads = 16 if width in (1280, 1408) else max(width // 64, 1)
    return CLIPConfig(
        vision=CLIPVisionConfig(
            image_size=grid * patch, patch_size=patch, hidden_size=width,
            intermediate_size=shape("visual.transformer.resblocks.0.mlp.c_fc.weight")[0],
            num_hidden_layers=layers("visual.transformer.resblocks.", 3),
            num_attention_heads=vis_heads, projection_dim=shape("visual.proj")[1]),
        text=CLIPTextConfig(
            vocab_size=shape("token_embedding.weight")[0], hidden_size=txt_width,
            intermediate_size=shape("transformer.resblocks.0.mlp.c_fc.weight")[0],
            num_hidden_layers=layers("transformer.resblocks.", 2),
            num_attention_heads=max(txt_width // 64, 1),
            max_position_embeddings=shape("positional_embedding")[0], hidden_act="gelu"),
        projection_dim=shape("text_projection")[1])


class CLIPVisionLayer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        d = cfg.hidden_size
        self.act = _act(cfg.hidden_act)
        self.ln_1 = LayerNorm32(d, eps=cfg.layer_norm_eps)
        self.attn = Attention(d, cfg.num_attention_heads, d // cfg.num_attention_heads,
                              qkv_bias=True)
        self.ln_2 = LayerNorm32(d, eps=cfg.layer_norm_eps)
        self.mlp_fc1 = nn.Linear(d, cfg.intermediate_size)
        self.mlp_fc2 = nn.Linear(cfg.intermediate_size, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x))
        h = self.act(self.mlp_fc1(self.ln_2(x)).float()).to(x.dtype)
        return x + self.mlp_fc2(h)


class CLIPVisionModel(nn.Module):
    """Pixels in [0, 1] (B, H, W, 3) -> projected image embedding (B, proj)."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.config = cfg
        d, grid = cfg.hidden_size, cfg.image_size // cfg.patch_size
        self.patch_embed = nn.Conv2d(3, d, cfg.patch_size, stride=cfg.patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(d))
        self.positional_embedding = nn.Parameter(torch.empty(grid * grid + 1, d))
        self.ln_pre = LayerNorm32(d, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList([CLIPVisionLayer(cfg) for _ in range(cfg.num_hidden_layers)])
        self.ln_post = LayerNorm32(d, eps=cfg.layer_norm_eps)
        self.proj = nn.Parameter(torch.empty(d, cfg.projection_dim))

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        mean = torch.tensor(OPENAI_MEAN, device=pixels.device)
        std = torch.tensor(OPENAI_STD, device=pixels.device)
        x = ((pixels.float() - mean) / std).permute(0, 3, 1, 2)
        if x.shape[-1] != cfg.image_size:  # jax.image.resize's antialiased bicubic
            x = resize_float(x, (cfg.image_size, cfg.image_size), "bicubic")
        x = self.patch_embed(x.to(self.patch_embed.weight.dtype))
        x = x.flatten(2).transpose(1, 2)
        cls = self.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(x.dtype)[None]
        x = self.ln_pre(x)
        for layer in self.layers:
            x = layer(x)
        return self.ln_post(x[:, 0]).float() @ self.proj


class CLIPScorer:
    """Joint image/text features and the cosine CLIP score."""

    def __init__(self, config: CLIPConfig = TINY_CLIP,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None, tokenizer=None,
                 seed: int = 0, device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        with torch.device("meta"):
            self.vision = CLIPVisionModel(config.vision)
            self.text = CLIPTextModel(config.text)
        self.vision.to_empty(device=self.device)
        self.text.to_empty(device=self.device)
        # The text tower's position table bounds the ids (HashTokenizer frames to it).
        self.tokenizer = tokenizer or HashTokenizer(
            vocab_size=config.text.vocab_size,
            model_max_length=config.text.max_position_embeddings)
        if state_dict is None:
            state_dict = self._random_state_dict(seed)
        self.vision.load_state_dict({k[len("vision."):]: v for k, v in state_dict.items()
                                     if k.startswith("vision.")}, strict=True)
        self.text.load_state_dict({k[len("text."):]: v for k, v in state_dict.items()
                                   if k.startswith("text.")}, strict=True)
        self.text_projection = state_dict["text_projection"].to(self.device, torch.float32)
        self.vision.eval().requires_grad_(False)
        self.text.eval().requires_grad_(False)

    @torch.no_grad()
    def _random_state_dict(self, seed: int) -> Dict[str, torch.Tensor]:
        """flax's default initialisers from ``seed`` (normal(0.02) for the
        class token, positions and image projection)."""
        gen = torch.Generator(self.device).manual_seed(seed)
        init_weights_(self.vision, gen)
        init_weights_(self.text, gen)
        for p in (self.vision.class_embedding, self.vision.positional_embedding, self.vision.proj):
            p.normal_(0.0, 0.02, generator=gen)
        t = self.config.text
        proj = torch.randn(t.hidden_size, self.config.projection_dim, generator=gen,
                           device=self.device) * t.hidden_size ** -0.5
        return {**{f"vision.{k}": v for k, v in self.vision.state_dict().items()},
                **{f"text.{k}": v for k, v in self.text.state_dict().items()},
                "text_projection": proj}

    @torch.no_grad()
    def image_features(self, images_uint8) -> torch.Tensor:
        """uint8 (N, H, W, 3) images -> unit-norm features; a size other than
        the tower's goes through ``openclip_preprocess_uint8``."""
        images = np.asarray(images_uint8)
        size = self.config.vision.image_size
        if images.dtype == np.uint8 and images.shape[1:3] != (size, size):
            pixels = openclip_preprocess_uint8(images, size)
        else:
            pixels = images.astype(np.float32) / 255.0
        f = self.vision(torch.from_numpy(pixels).to(self.device))
        return f / f.norm(dim=-1, keepdim=True)

    @torch.no_grad()
    def text_features(self, prompts: Sequence[str]) -> torch.Tensor:
        ids = torch.as_tensor(self.tokenizer(list(prompts)), dtype=torch.long, device=self.device)
        h = self.text(ids)
        eot = (ids == self.tokenizer.eos_token_id).int().argmax(dim=-1)
        f = h[torch.arange(h.shape[0], device=self.device), eot].float() @ self.text_projection
        return f / f.norm(dim=-1, keepdim=True)

    def score(self, images_uint8, prompts: Sequence[str]) -> np.ndarray:
        """Per-sample cosine similarity of image and caption."""
        return (self.image_features(images_uint8) * self.text_features(prompts)).sum(-1).cpu().numpy()


def convert_open_clip(state_dict, config: CLIPConfig) -> Dict[str, torch.Tensor]:
    """An open_clip state dict -> the ``CLIPScorer`` state dict (``vision.*``,
    ``text.*``, ``text_projection``), f32 on the CPU."""
    sd = {k: torch.as_tensor(np.asarray(v, dtype=np.float32)) for k, v in state_dict.items()}
    out: Dict[str, torch.Tensor] = {}

    def block(src: str, dst: str, names: Dict[str, str]) -> None:
        qkv_w, qkv_b = sd[f"{src}.attn.in_proj_weight"], sd[f"{src}.attn.in_proj_bias"]
        d = qkv_w.shape[0] // 3
        for i, proj in enumerate(("q", "k", "v")):
            out[f"{dst}.{names[proj]}.weight"] = qkv_w[i * d:(i + 1) * d]
            out[f"{dst}.{names[proj]}.bias"] = qkv_b[i * d:(i + 1) * d]
        pairs = {"attn.out_proj": names["out"], "ln_1": names["ln_1"], "ln_2": names["ln_2"],
                 "mlp.c_fc": names["fc1"], "mlp.c_proj": names["fc2"]}
        for s, t in pairs.items():
            out[f"{dst}.{t}.weight"] = sd[f"{src}.{s}.weight"]
            out[f"{dst}.{t}.bias"] = sd[f"{src}.{s}.bias"]

    vis_names = {"q": "attn.to_q", "k": "attn.to_k", "v": "attn.to_v", "out": "attn.to_out.0",
                 "ln_1": "ln_1", "ln_2": "ln_2", "fc1": "mlp_fc1", "fc2": "mlp_fc2"}
    txt_names = {"q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj",
                 "out": "self_attn.out_proj", "ln_1": "layer_norm1", "ln_2": "layer_norm2",
                 "fc1": "mlp.fc1", "fc2": "mlp.fc2"}
    for i in range(config.vision.num_hidden_layers):
        block(f"visual.transformer.resblocks.{i}", f"vision.layers.{i}", vis_names)
    for i in range(config.text.num_hidden_layers):
        block(f"transformer.resblocks.{i}", f"text.encoder.layers.{i}", txt_names)
    for s, t in {"ln_pre": "ln_pre", "ln_post": "ln_post"}.items():
        out[f"vision.{t}.weight"] = sd[f"visual.{s}.weight"]
        out[f"vision.{t}.bias"] = sd[f"visual.{s}.bias"]
    out.update({
        "vision.patch_embed.weight": sd["visual.conv1.weight"],
        "vision.class_embedding": sd["visual.class_embedding"],
        "vision.positional_embedding": sd["visual.positional_embedding"],
        "vision.proj": sd["visual.proj"],
        "text.embeddings.token_embedding.weight": sd["token_embedding.weight"],
        "text.embeddings.position_embedding.weight": sd["positional_embedding"],
        "text.final_layer_norm.weight": sd["ln_final.weight"],
        "text.final_layer_norm.bias": sd["ln_final.bias"],
        "text_projection": sd["text_projection"],
    })
    return out
