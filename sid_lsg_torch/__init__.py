"""SiD-LSG in PyTorch for NVIDIA Hopper: the port of ``sid_lsg_tpu``.

Layer map (mirrors the JAX package):
  cli/        -- generate_onestep, sid_train, encode_latents and sid_metrics entry points
  pipeline.py -- SDPipeline: text tower + UNet + VAE + scheduler; checkpoint loading
  training/   -- the distillation step, optimizer state, LoRA, Trainer loop
  metrics/    -- FID, CLIP score, precision/recall, HPSv2 (InceptionV3, CLIP ViT)
  data/, runtime/, utils/ -- prompts, latent corpora, COCO eval sets, weight files and
                 state dumps, Pillow's resamplers, profiler and host helpers
  diffusion/  -- DDPM schedule math, SiD sampler and denoiser, per-seed latents
  models/     -- UNet2DCondition, AutoencoderKL, CLIP text and vision towers, InceptionV3, configs,
                 tokenizers, weights from HF checkpoints and the JAX package
  ops/        -- CUDA kernels (csrc/) beside their plain PyTorch versions
  csrc/       -- the kernels' CUDA C++ sources, built for sm_90a
"""

__version__ = "0.1.0"

_LAZY = {"SDPipeline": "sid_lsg_torch.pipeline"}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'sid_lsg_torch' has no attribute {name!r}")
