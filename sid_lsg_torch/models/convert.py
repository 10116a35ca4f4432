"""Carry weights from the JAX package's parameter pytrees into port state dicts.

``params_from_jax(tree, config, part)`` takes one of the JAX package's
parameter trees (``pipeline.params['unet' | 'vae' | 'text']``) as nested dicts
of numpy arrays and returns the port's state dict for that part: diffusers /
transformers key names, conv kernels HWIO -> OIHW, dense kernels
(in, out) -> (out, in).  It walks the same structure as the JAX package's
``models/convert.py`` exporters, so every key the port's modules hold is
filled and a missing leaf raises ``KeyError``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .configs import CLIPTextConfig, SDConfig, UNetConfig, VAEConfig


class _Carry:
    def __init__(self, tree: dict):
        self.tree = tree
        self.sd: Dict[str, torch.Tensor] = {}

    def _leaf(self, path: str) -> np.ndarray:
        node = self.tree
        for p in path.split("/"):
            node = node[p]
        return np.asarray(node, dtype=np.float32)

    def has(self, path: str) -> bool:
        try:
            self._leaf(path)
        except KeyError:
            return False
        return True

    def put(self, key: str, value: np.ndarray) -> None:
        self.sd[key] = torch.from_numpy(np.ascontiguousarray(value))

    def linear(self, path: str, key: str, bias: bool = True) -> None:
        self.put(f"{key}.weight", self._leaf(f"{path}/kernel").T)
        if bias:
            self.put(f"{key}.bias", self._leaf(f"{path}/bias"))

    def conv(self, path: str, key: str) -> None:
        self.put(f"{key}.weight", np.transpose(self._leaf(f"{path}/kernel"), (3, 2, 0, 1)))
        self.put(f"{key}.bias", self._leaf(f"{path}/bias"))

    def norm(self, path: str, key: str) -> None:
        self.put(f"{key}.weight", self._leaf(f"{path}/scale"))
        self.put(f"{key}.bias", self._leaf(f"{path}/bias"))

    def ln(self, path: str, key: str) -> None:  # LayerNorm32 wraps a flax LayerNorm 'ln'
        self.norm(f"{path}/ln", key)

    def embed(self, path: str, key: str) -> None:
        self.put(f"{key}.weight", self._leaf(f"{path}/embedding"))


def _attention(c: _Carry, path: str, key: str, qkv_bias: bool) -> None:
    for name in ("to_q", "to_k", "to_v"):
        c.linear(f"{path}/{name}", f"{key}.{name}", bias=qkv_bias)
    c.linear(f"{path}/to_out", f"{key}.to_out.0")


def _transformer(c: _Carry, path: str, key: str, cfg: UNetConfig) -> None:
    c.norm(f"{path}/norm", f"{key}.norm")
    proj = c.linear if cfg.use_linear_projection else c.conv
    proj(f"{path}/proj_in", f"{key}.proj_in")
    proj(f"{path}/proj_out", f"{key}.proj_out")
    for d in range(cfg.transformer_layers_per_block):
        p, k = f"{path}/blocks_{d}", f"{key}.transformer_blocks.{d}"
        for n in ("norm1", "norm2", "norm3"):
            c.ln(f"{p}/{n}", f"{k}.{n}")
        _attention(c, f"{p}/attn1", f"{k}.attn1", qkv_bias=False)
        _attention(c, f"{p}/attn2", f"{k}.attn2", qkv_bias=False)
        c.linear(f"{p}/ff/net_0/proj", f"{k}.ff.net.0.proj")
        c.linear(f"{p}/ff/net_2", f"{k}.ff.net.2")


def _resnet(c: _Carry, path: str, key: str, temb: bool) -> None:
    c.norm(f"{path}/norm1", f"{key}.norm1")
    c.conv(f"{path}/conv1", f"{key}.conv1")
    if temb:
        c.linear(f"{path}/time_emb_proj", f"{key}.time_emb_proj")
    c.norm(f"{path}/norm2", f"{key}.norm2")
    c.conv(f"{path}/conv2", f"{key}.conv2")
    if c.has(f"{path}/conv_shortcut/kernel"):
        c.conv(f"{path}/conv_shortcut", f"{key}.conv_shortcut")


def _unet(c: _Carry, cfg: UNetConfig) -> None:
    n = len(cfg.block_out_channels)
    c.conv("conv_in", "conv_in")
    c.linear("time_embedding/linear_1", "time_embedding.linear_1")
    c.linear("time_embedding/linear_2", "time_embedding.linear_2")
    for i in range(n):
        for j in range(cfg.layers_per_block):
            _resnet(c, f"down_{i}_resnet_{j}", f"down_blocks.{i}.resnets.{j}", temb=True)
            if cfg.cross_attention_levels[i]:
                _transformer(c, f"down_{i}_attn_{j}", f"down_blocks.{i}.attentions.{j}", cfg)
        if i < n - 1:
            c.conv(f"down_{i}_downsample/conv", f"down_blocks.{i}.downsamplers.0.conv")
    _resnet(c, "mid_resnet_0", "mid_block.resnets.0", temb=True)
    _transformer(c, "mid_attn", "mid_block.attentions.0", cfg)
    _resnet(c, "mid_resnet_1", "mid_block.resnets.1", temb=True)
    for i in range(n):
        k = n - 1 - i  # the port's (diffusers') up-block index of JAX level i
        for j in range(cfg.layers_per_block + 1):
            _resnet(c, f"up_{i}_resnet_{j}", f"up_blocks.{k}.resnets.{j}", temb=True)
            if cfg.cross_attention_levels[i]:
                _transformer(c, f"up_{i}_attn_{j}", f"up_blocks.{k}.attentions.{j}", cfg)
        if i > 0:
            c.conv(f"up_{i}_upsample/conv", f"up_blocks.{k}.upsamplers.0.conv")
    c.norm("conv_norm_out", "conv_norm_out")
    c.conv("conv_out", "conv_out")


def _vae_decode(c: _Carry, cfg: VAEConfig) -> None:
    n = len(cfg.block_out_channels)
    c.conv("decoder/conv_in", "decoder.conv_in")
    _resnet(c, "decoder/mid_resnet_0", "decoder.mid_block.resnets.0", temb=False)
    c.norm("decoder/mid_attn/group_norm", "decoder.mid_block.attentions.0.group_norm")
    _attention(c, "decoder/mid_attn/attn", "decoder.mid_block.attentions.0", qkv_bias=True)
    _resnet(c, "decoder/mid_resnet_1", "decoder.mid_block.resnets.1", temb=False)
    for i in range(n):
        for j in range(cfg.layers_per_block + 1):
            _resnet(c, f"decoder/up_{i}_resnet_{j}", f"decoder.up_blocks.{i}.resnets.{j}",
                    temb=False)
        if i < n - 1:
            c.conv(f"decoder/up_{i}_upsample/conv", f"decoder.up_blocks.{i}.upsamplers.0.conv")
    c.norm("decoder/conv_norm_out", "decoder.conv_norm_out")
    c.conv("decoder/conv_out", "decoder.conv_out")
    c.conv("post_quant_conv", "post_quant_conv")


def _clip_text(c: _Carry, cfg: CLIPTextConfig) -> None:
    c.embed("token_embedding", "embeddings.token_embedding")
    c.embed("position_embedding", "embeddings.position_embedding")
    for i in range(cfg.num_hidden_layers):
        p, k = f"layers_{i}", f"encoder.layers.{i}"
        c.ln(f"{p}/layer_norm1", f"{k}.layer_norm1")
        c.ln(f"{p}/layer_norm2", f"{k}.layer_norm2")
        for src, dst in (("to_q", "q_proj"), ("to_k", "k_proj"), ("to_v", "v_proj"),
                         ("to_out", "out_proj")):
            c.linear(f"{p}/self_attn/{src}", f"{k}.self_attn.{dst}")
        c.linear(f"{p}/fc1", f"{k}.mlp.fc1")
        c.linear(f"{p}/fc2", f"{k}.mlp.fc2")
    c.ln("final_layer_norm", "final_layer_norm")


def params_from_jax(tree: dict, config: SDConfig, part: str) -> Dict[str, torch.Tensor]:
    """JAX parameter tree of ``part`` ('unet' | 'vae' | 'text') -> port state dict (f32)."""
    c = _Carry(tree)
    if part == "unet":
        _unet(c, config.unet)
    elif part == "vae":
        _vae_decode(c, config.vae)
    elif part == "text":
        _clip_text(c, config.text)
    else:
        raise ValueError(f"unknown part {part!r}; expected 'unet', 'vae' or 'text'")
    return c.sd
