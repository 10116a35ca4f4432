"""SiD-LSG in PyTorch for NVIDIA Hopper: the port of ``sid_lsg_tpu``.

Layer map (mirrors the JAX package):
  cli/        -- generate_onestep and sid_train entry points
  pipeline.py -- SDPipeline: text tower + UNet + VAE decoder + scheduler
  training/   -- the distillation step, optimizer state, LoRA, Trainer loop
  data/, runtime/, utils/ -- prompts, generator snapshots, host helpers
  diffusion/  -- DDPM schedule math, SiD sampler and denoiser, per-seed latents
  models/     -- UNet2DCondition, AutoencoderKL decoder, CLIP text tower,
                 configs, tokenizer, weights carried from the JAX package
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
