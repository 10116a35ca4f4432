"""Carry weights into port state dicts: from HF checkpoint files and from the
JAX package's parameter pytrees.

``load_sd_checkpoint(model_dir)`` reads an HF-layout checkpoint directory
into the same state dicts (the JAX package's ``load_sd_checkpoint``): the
checkpoint's keys are brought to the port's by ``normalise_state_dict``.

``params_from_jax(tree, config, part)`` takes one of the JAX package's
parameter trees (``pipeline.params['unet' | 'vae' | 'text']``) as nested dicts
of numpy arrays and returns the port's state dict for that part: diffusers /
transformers key names, conv kernels HWIO -> OIHW, dense kernels
(in, out) -> (out, in).  It walks the same structure as the JAX package's
``models/convert.py`` exporters, so every key the port's modules hold is
filled and a missing leaf raises ``KeyError``.

``disc_params_from_jax(params, spectral, vit_cfg)`` does the same for the
SiDA projected discriminator: its ``params`` (``head_*`` and, when present,
``dino``) and its ``spectral`` collection (the ``u`` vectors) become the
state dict of ``models.stylegan_discriminator.ProjectedDiscriminator``.

The legacy nets: ``normalise_edm_state_dict`` brings an EDM torch state dict
to the keys of ``models.edm_networks``; ``edm_params_from_jax`` and
``stylegan_t_params_from_jax`` carry the JAX package's EDM nets and
StyleGAN-T generator.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from .configs import CLIPTextConfig, SDConfig, UNetConfig, VAEConfig
from .stylegan_discriminator import ViTConfig


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


def _vae_mid(c: _Carry, part: str) -> None:
    _resnet(c, f"{part}/mid_resnet_0", f"{part}.mid_block.resnets.0", temb=False)
    c.norm(f"{part}/mid_attn/group_norm", f"{part}.mid_block.attentions.0.group_norm")
    _attention(c, f"{part}/mid_attn/attn", f"{part}.mid_block.attentions.0", qkv_bias=True)
    _resnet(c, f"{part}/mid_resnet_1", f"{part}.mid_block.resnets.1", temb=False)


def _vae(c: _Carry, cfg: VAEConfig) -> None:
    n = len(cfg.block_out_channels)
    c.conv("encoder/conv_in", "encoder.conv_in")
    for i in range(n):
        for j in range(cfg.layers_per_block):
            _resnet(c, f"encoder/down_{i}_resnet_{j}", f"encoder.down_blocks.{i}.resnets.{j}",
                    temb=False)
        if i < n - 1:
            c.conv(f"encoder/down_{i}_downsample/conv",
                   f"encoder.down_blocks.{i}.downsamplers.0.conv")
    _vae_mid(c, "encoder")
    c.norm("encoder/conv_norm_out", "encoder.conv_norm_out")
    c.conv("encoder/conv_out", "encoder.conv_out")
    c.conv("quant_conv", "quant_conv")
    c.conv("decoder/conv_in", "decoder.conv_in")
    _vae_mid(c, "decoder")
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


def unet_params_from_jax(tree: dict, config: UNetConfig) -> Dict[str, torch.Tensor]:
    """JAX UNet parameter tree -> port UNet state dict (f32)."""
    c = _Carry(tree)
    _unet(c, config)
    return c.sd


class _Names(_Carry):
    """Walks the UNet as ``_Carry`` does and records, for each flax leaf
    path, the port key it fills (each ``put`` follows its ``_leaf``)."""

    def __init__(self):
        super().__init__({})
        self.names: Dict[str, str] = {}
        self._path = ""

    def _leaf(self, path: str) -> np.ndarray:
        self._path = path
        return np.zeros((1, 1, 1, 1), np.float32)

    def put(self, key: str, value: np.ndarray) -> None:
        self.names[self._path] = key


def lora_params_from_jax(tree: dict, config: UNetConfig) -> Dict[str, torch.Tensor]:
    """JAX LoRA factors (``{'<flax site path>': {'a': (in, r), 'b': (r, out)}}``,
    ``training/lora.py``) -> the port's (``'<diffusers site>.a'`` / ``.b``,
    same layouts), f32."""
    names = _Names()
    _unet(names, config)
    out: Dict[str, torch.Tensor] = {}
    for site, factors in tree.items():
        key = names.names[f"{site}/kernel"]
        assert key.endswith(".weight"), key
        for f in ("a", "b"):
            out[f"{key[:-len('weight')]}{f}"] = torch.from_numpy(
                np.array(factors[f], dtype=np.float32))
    return out


def params_from_jax(tree: dict, config: SDConfig, part: str) -> Dict[str, torch.Tensor]:
    """JAX parameter tree of ``part`` ('unet' | 'vae' | 'text') -> port state dict (f32)."""
    if part == "unet":
        return unet_params_from_jax(tree, config.unet)
    c = _Carry(tree)
    if part == "vae":
        _vae(c, config.vae)
    elif part == "text":
        _clip_text(c, config.text)
    else:
        raise ValueError(f"unknown part {part!r}; expected 'unet', 'vae' or 'text'")
    return c.sd


# ---------------------------------------------------------------------------
# HF-layout checkpoint files

StateDict = Dict[str, torch.Tensor]

# The VAE mid attention's older diffusers names (the published SD1.5 VAE file).
_LEGACY_VAE_ATTN = {"query": "to_q", "key": "to_k", "value": "to_v", "proj_attn": "to_out.0"}
_LEGACY_VAE_KEY = re.compile(r"^(.*\.attentions\.\d+)\.(query|key|value|proj_attn)\.(weight|bias)$")


def normalise_state_dict(sd: StateDict, part: str) -> StateDict:
    """A checkpoint's state dict of ``part`` -> the port's keys, in f32: the
    text tower's ``text_model.`` prefix stripped, the VAE attention's
    ``query``/``key``/``value``/``proj_attn`` renamed where its ``to_q`` is
    absent, and the ``position_ids`` buffers (which no module reads) dropped.
    Every other key is kept, so a strict load names what does not fit."""
    out: StateDict = {}
    for key, value in sd.items():
        if part == "text" and key.startswith("text_model."):
            key = key[len("text_model."):]
        if key.endswith("position_ids"):
            continue
        m = _LEGACY_VAE_KEY.match(key) if part == "vae" else None
        if m and f"{m.group(1)}.to_q.weight" not in sd:
            key = f"{m.group(1)}.{_LEGACY_VAE_ATTN[m.group(2)]}.{m.group(3)}"
        if key in out:
            raise KeyError(f"{part}: two checkpoint keys map to {key}")
        out[key] = value.float()
    return out


def check_state_dict(sd: StateDict, module: nn.Module, what: str) -> None:
    """Raise unless ``sd`` has exactly ``module``'s keys at its shapes."""
    want = module.state_dict()
    missing, extra = sorted(set(want) - set(sd)), sorted(set(sd) - set(want))
    if missing or extra:
        raise KeyError(f"{what}: missing keys {missing[:5]} ({len(missing)}), unexpected keys "
                       f"{extra[:5]} ({len(extra)})")
    bad = [k for k, v in want.items() if tuple(sd[k].shape) != tuple(v.shape)]
    if bad:
        raise ValueError(f"{what}: {bad[0]} has shape {tuple(sd[bad[0]].shape)}, the model "
                         f"{tuple(want[bad[0]].shape)} ({len(bad)} such keys)")


_WEIGHT_FILES = ("diffusion_pytorch_model.safetensors", "model.safetensors",
                 "diffusion_pytorch_model.bin", "pytorch_model.bin")


def _find_weights(subdir: str) -> str:
    for name in _WEIGHT_FILES:
        path = os.path.join(subdir, name)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no weight file under {subdir} (looked for "
                            f"{', '.join(_WEIGHT_FILES)})")


def _load_weights(path: str) -> StateDict:
    from ..runtime.checkpoint import read_safetensors

    if path.endswith(".safetensors"):
        return read_safetensors(path)
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v for k, v in obj.items() if torch.is_tensor(v)}


def load_sd_checkpoint(model_dir: str) -> Dict[str, StateDict]:
    """An HF-layout checkpoint directory (``unet/``, ``vae/``,
    ``text_encoder/``) -> the port's state dicts ``{'unet', 'vae', 'text'}``
    (CPU, f32), keys normalised by ``normalise_state_dict``."""
    subdirs = {"unet": "unet", "vae": "vae", "text": "text_encoder"}
    return {part: normalise_state_dict(_load_weights(_find_weights(os.path.join(model_dir, sub))),
                                       part)
            for part, sub in subdirs.items()}


def _dino(c: _Carry, cfg: ViTConfig) -> None:
    c.conv("patch_embed", "dino.patch_embed.proj")
    c.put("dino.cls_token", c._leaf("cls_token"))
    c.put("dino.pos_embed", c._leaf("pos_embed"))
    for i in range(cfg.layers):
        p, k = f"blocks_{i}", f"dino.blocks.{i}"
        c.norm(f"{p}/norm1", f"{k}.norm1")
        c.norm(f"{p}/norm2", f"{k}.norm2")
        c.linear(f"{p}/qkv", f"{k}.attn.qkv")
        c.linear(f"{p}/proj", f"{k}.attn.proj")
        c.linear(f"{p}/fc1", f"{k}.mlp.fc1")
        c.linear(f"{p}/fc2", f"{k}.mlp.fc2")


def disc_params_from_jax(params: dict, spectral: Optional[dict],
                         vit_cfg: ViTConfig) -> Dict[str, torch.Tensor]:
    """JAX ``ProjectedDiscriminator`` params (and ``spectral`` u vectors, or
    None) -> the port's state dict (f32).  Spectral kernels (features,
    c_in * k) and FullyConnectedLayer weights (out, in) keep their layout;
    the backbone's dense kernels transpose and its conv goes HWIO -> OIHW.
    Without a ``dino`` entry only the heads are carried (e.g. gradients)."""
    c = _Carry({"params": params, "spectral": spectral or {}})
    for head in sorted(k for k in params if k.startswith("head_")):
        src, dst = f"params/{head}", f"heads.{head[len('head_'):]}"
        convs = ["main0/conv", "main1/conv", "cls"]
        for conv in convs:
            c.put(f"{dst}.{conv.replace('/', '.')}.weight", c._leaf(f"{src}/{conv}/kernel"))
            c.put(f"{dst}.{conv.replace('/', '.')}.bias", c._leaf(f"{src}/{conv}/bias"))
            if spectral is not None:
                c.put(f"{dst}.{conv.replace('/', '.')}.u", c._leaf(f"spectral/{head}/{conv}/u"))
        for bn in ("main0/bn", "main1/bn"):
            c.put(f"{dst}.{bn.replace('/', '.')}.weight", c._leaf(f"{src}/{bn}/weight"))
            c.put(f"{dst}.{bn.replace('/', '.')}.bias", c._leaf(f"{src}/{bn}/bias"))
        if c.has(f"{src}/cmapper/weight"):
            c.put(f"{dst}.cmapper.weight", c._leaf(f"{src}/cmapper/weight"))
            c.put(f"{dst}.cmapper.bias", c._leaf(f"{src}/cmapper/bias"))
    if "dino" in params:
        c.tree = params["dino"]
        _dino(c, vit_cfg)
    return c.sd


# ---------------------------------------------------------------------------
# The legacy nets: EDM's SongUNet / DhariwalUNet and the StyleGAN-T generator


def _flat(tree: dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flat(v, path))
        else:
            out[path] = np.array(v, dtype=np.float32)
    return out


def normalise_edm_state_dict(sd: StateDict) -> StateDict:
    """An EDM torch state dict (a net's, or a preconditioner's with the
    ``model.`` prefix) -> the state dict of ``models.edm_networks``'
    SongUNet / DhariwalUNet, in f32: what the JAX ``convert_edm_unet`` does
    before it renames.  The prefix is stripped and the constant
    ``resample_filter`` buffers and iDDPM's ``u`` table are dropped (the
    port's modules rebuild them); every other key is kept, so a strict load
    names what does not fit."""
    out: StateDict = {}
    for key, value in sd.items():
        parts = key.split(".")
        if parts[0] == "model":
            parts = parts[1:]
        if parts[-1] == "resample_filter" or parts == ["u"]:
            continue
        out[".".join(parts)] = torch.as_tensor(value).float()
    return out


def edm_params_from_jax(tree: dict) -> StateDict:
    """JAX ``models.edm_networks`` params -> the port's state dict (f32): the
    inverse of the JAX ``convert_edm_unet``.  ``enc_16_block0`` becomes
    ``enc.16x16_block0``, HWIO kernels OIHW, dense (in, out) kernels
    (out, in), GroupNorm ``scale`` ``weight``."""
    sd: StateDict = {}
    for path, w in _flat(tree).items():
        mods, leaf = path.split("/")[:-1], path.split("/")[-1]
        head = mods[0].split("_", 2)
        if head[0] in ("enc", "dec"):
            mods = [head[0], f"{head[1]}x{head[1]}_{head[2]}"] + mods[1:]
        if leaf == "kernel":
            leaf, w = "weight", np.transpose(w, (3, 2, 0, 1)) if w.ndim == 4 else w.T
        elif leaf == "scale":
            leaf = "weight"
        sd[".".join(mods + [leaf])] = torch.from_numpy(np.ascontiguousarray(w))
    return sd


def stylegan_t_params_from_jax(variables: dict) -> StateDict:
    """JAX ``models.stylegan_t.Generator`` variables (``params`` and, when
    present, ``stats``) -> the port's state dict (f32).  The port keeps the
    JAX names and layouts, so each path's ``/`` becomes ``.``; ``stats``'
    ``x_avg`` is the buffer ``mapping.x_avg``."""
    sd: StateDict = {}
    for collection in ("params", "stats"):
        for path, w in _flat(variables.get(collection, {})).items():
            sd[path.replace("/", ".")] = torch.from_numpy(np.ascontiguousarray(w))
    return sd
