#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (``sid_lsg_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--baseline ROOT]

``--baseline ROOT`` names another checkout (an unpacked ``git archive`` of
a parent commit, say): its kernels are built from ``ROOT/sid_lsg_torch/csrc``
and its K1, K4, K5, K6 and K7 are timed beside this tree's at every shape of
phases 6, 11 and 16, in the same run on the same card (its K7 through its
own ``sid_lsg_torch/ops/bias_act.py``, ``load_baseline_bias_act``);
where it has the two-kernel K2 (``sidlsg_gn_stats`` with a scratch buffer),
its K2 + K3 are timed beside this tree's GroupNorm route at every GroupNorm
key.

It drives the port's paths at full SD1.5 width on random weights from a
seed, loaded from an HF-layout checkpoint that it writes first, through the
CUDA kernels built from ``sid_lsg_torch/csrc``: one-step text-to-image
generation (batch 4, 512x512, init_timestep 625; phases 2-6), the VAE
encode and ``encode_latents`` (phases 6a-6b), the SiD-LSG distillation train
step (phases 7-11, with ``load_generator`` and ``--resume`` in 10a) and the
SiDA adversarial train step on the encoded corpus (phases 12-16).

1. Build: compile the kernels with nvcc for sm_90a; print the build time,
   the card's name and power limit, the registers and spills of K1's, K4's,
   K5's and K6's kernels (``-Xptxas -v``) and the dynamic shared memory of
   each of their instantiations.
1b. Checkpoint: ``random_state_dicts("sd15", seed 0)`` written in F16 as an
   HF-layout directory (``write_safetensors``, ``write_hf_config_jsons``)
   under a temporary directory that is removed at exit, with the published
   SD1.5 files' quirks: the text tower under ``text_model.`` with an int64
   ``position_ids`` buffer, the VAE mid attentions under ``query``, ``key``,
   ``value`` and ``proj_attn``; and a ``tokenizer/`` of the 512 byte tokens,
   the two specials and a few merges.  Its write time and size are printed.
2. Load: ``SDPipeline.from_pretrained(dir, bf16)`` (load time printed); its
   config must be SD1.5's, its tokenizer the BPE ``CLIPTokenizer``, and its
   embeddings and x0 must equal, bit for bit, those of a pipeline built
   directly from the same state dicts rounded through f16.  Warm-up
   generation: text -> UNet -> x0 -> VAE decode once; the launch counters
   record every distinct kernel input shape of the path; x0 must be finite
   and the images of the right shape and not constant.
3. Kernel check: each kernel against its plain PyTorch version at every
   shape the generation launched, in that shape's dtype, TF32 off (K8
   against ``group_norm_ref``, K2 against ``gn_stats_ref``).  f32
   outputs within atol 1e-4 / rtol 1e-3; bf16 outputs within atol 2e-2 /
   rtol 2e-2 of the plain version computed in f32 from the same bf16 inputs,
   and every output within 1e-2 of its plain version in relative L2 norm.
   K1's v is scaled by sqrt(S_k / e) so that its outputs are of order 1 at
   every S_k: with unit-normal q, k, v a typical |out| is sqrt(e / S_k),
   which at S_k = 4096 is about the bf16 atol itself.  Then K1 and K4 in
   f32 at the JAX package's parity shapes (``tests/test_pallas_parity.py``:
   standard-normal q, k, v; K4 on the gradients of sum(sin(out))): err/tol
   printed at its tolerances (forward atol 2e-5 / rtol 1e-4, gradients atol
   5e-5 / rtol 1e-3), held to the f32 gate above.
4. Small reference: the tiny preset on the card (kernels) against the same
   weights on the CPU (plain versions), f32: x0 within atol 5e-4 /
   rtol 1e-3, images within one uint8 step; the VAE encoder's mean and
   logvar within atol 5e-4 / rtol 1e-3.
5. Main path: the launch counters are zeroed, ``SDPipeline.generate`` runs
   once, and every kernel must have launched, with one K8 launch for each
   GroupNorm that ``gn_plan`` sends to ``fused`` and one K2 and one K3 for
   each of the rest; then the per-batch time over
   ten runs, and one run under torch.profiler for the device's busy time,
   idle share and time by kernel name.
6. Timing: each kernel with CUDA events at the main path's shapes, beside its
   bound, its plain version and a library yardstick (SDPA for K1,
   ``F.group_norm`` (+SiLU) for K8, ``torch.var_mean`` for K2).  Times
   are summed over one main-path run: sum over shapes of launches x ms.
   With ``--baseline``, K1 of the baseline beside K1 at each shape.  The
   GroupNorm kernels (K8, K2, K3) are timed on the device alone (the calls
   queued behind a spin kernel, so the host's launch time does not show),
   once with inputs warm in L2 and once with L2 flushed by a 256 MB write
   before each call; with ``--baseline``, the baseline's K2 + K3 beside
   them.
6a. VAE encode: ``SDPipeline.encode_images`` warmed up on the generated
   batch (4, 512, 512, 3); counters zeroed, one encode (the encode path's
   run): K1 launched once (the mid attention, f32, D = 512), every
   GroupNorm launching the kernels ``gn_plan`` routes it to, latents finite;
   K1, K8, K2 and K3 checked at every shape of the encode as phase 3 checks;
   seconds per encode and per decode of the batch (median of 5); the
   kernels timed at the encode's shapes as phase 6 times them.
6b. ``encode_latents``: the CLI on 8 PNGs (the generated images and their
   mirror images, ``pngio.write_png``) with the checkpoint at batch 4; its
   wall time and images/s of the encode alone at batch 4; the corpus that
   ``LatentDataset`` reads must equal ``encode_images`` of the same images
   (the VAE scaling included) within bf16 rounding (rtol 2^-8, atol 2^-8 of
   the RMS), and ``encode_images`` must give the same bits on a second call
   and on the same batch stored NCHW on the card.

7. Train step: a ``Trainer`` built from the ``sid_train`` flags in
   ``TRAIN_ARGS`` (``--sd_model`` the phase-1b checkpoint, batch 4 in one
   microbatch, kappa 1.5, bf16,
   remat ``flash``); counters zeroed, one step (the training path's main
   run): both losses finite, G, psi and the EMA changed, K1, K4 and the
   GroupNorm kernels launched as ``gn_plan`` routes the step's maps, and
   no K1 launch inside the backward sweep; then one step with remat ``full``,
   where the backward sweep launches K1 once per attention of the forwards
   that carry grad.
8. Kernel check of the training path: K4, K5 and K6 against
   ``flash_attn_bwd_ref`` at every shape the step gave K4, K4 against
   K5 + K6, and the two-pass backward (``flash_attn_bwd_twopass``: one
   delta pre-pass, K5, K6) run twice for the same bits, which are also those
   of K5 and K6 called apart; K1, K8, K2 and K3 at
   the step's shapes phase 3 did not check.  The
   backward's outputs are linear in dO and differ in size by orders of
   magnitude, so each is compared after scaling by the power of two that
   brings its plain version to RMS about 1 (the same as scaling dO, exactly
   in bf16).  Tolerances as phase 3.
9. Small reference for training: the tiny preset, f32, one psi-phase and
   one theta-phase gradient on the card and on the CPU from the same weights
   and the same CPU-generator draws: losses within rtol 1e-4, every gradient
   tensor within rtol 1e-3 and atol 1e-4 * max|ref|.
10. Train-step timing: median seconds per step over 5 steps, images/s, peak
   device memory; one step under torch.profiler (busy, idle share, top
   kernels); the step's FLOPs (FlopCounterMode plus the attention kernels'
   FLOPs from the recorded shapes, which the counter cannot see) as ``mfu``
   over 989 TFLOP/s.  Then the same trainer under SIDLSG_FLASH_BWD=twopass
   (restored after): counters zeroed, one step under torch.profiler (the
   two-pass path's main run: losses finite, K5 and K6 once per attention
   backward, K4 never, and the delta pre-pass once per two-pass backward
   by the trace's kernel names), and the median of 3 steps beside the
   fused median.
10a. Generator files: the trainer's EMA exported by ``export_generator``;
   ``from_pretrained(dir).load_generator(file)`` must sample x0 equal, bit
   for bit, to the EMA applied directly (``unet_apply_fn``); a ``Trainer``
   built with ``--resume file`` must start with G, psi and the EMA equal to
   it, bit for bit.  Times printed.
11. Backward kernel timing: K4, K5 and K6 at the step's shapes with CUDA
   events, each printed at each shape and summed over one step (K4's
   launches x time; K5 and K6 at the two-pass step's launches, which are
   K4's), beside bound, plain version and SDPA's backward (forward +
   backward minus forward), and the two-pass backward as one call; K1 at
   the step's shapes, summed over one step (with ``--baseline``, the
   baseline's K1, K4, K5 and K6 beside them); the
   GroupNorm kernels at the step's keys as phase 6 times them, summed over
   one step.

12. SiDA step: a ``Trainer`` from ``SIDA_ARGS`` (``TRAIN_ARGS`` plus the
   adversarial weights 0.1, the ``dino`` tower with a random DINO ViT-S/16,
   the real latents of phase 6b's corpus through ``--adv_data``); counters
   zeroed, one step (the SiDA path's main
   run): the six losses and logits finite, G, psi, the judge's heads, the
   EMA and every spectral ``u`` changed, K1, K4, K7 and the GroupNorm
   kernels (as ``gn_plan`` routes the step's maps) launched, K4 at the
   VAE's f32 (mb, 1, 4096, 512) and the DINO's f32 (mb, 6, 197, 64).  Then
   (after phase 15) one step of the ``encoder`` tower: losses finite, K1-K4
   launched.
13. Kernel check of the SiDA path, as phases 3 and 8: K7 against
   ``bias_act_ref`` at every shape the step gave it, in the path's
   activation and in all nine with gain 1.3 and clamp 5, plus one
   (8, 512, 32, 32) bias-on-axis-1 shape in f32 and bf16 that is off the
   path; K4, K5 and K6 at the step's new f32 shapes, within the f32
   tolerance (atol 1e-4 / rtol 1e-3 after phase 8's scaling); K1, K8, K2
   and K3 at its new shapes.
14. Small reference for SiDA: the tiny preset with TINY_VIT, f32, each
   tower, card against CPU from the same weights and CPU-generator draws:
   losses within rtol 1e-4, the psi-phase (psi and heads) and theta-phase
   gradients within phase 9's tolerances; K4 and (dino) K7 launched on the
   card.  The conv biases in front of a BatchNormLocal have an exact
   gradient of 0 (the normalisation removes a per-channel constant): both
   sides are required below 1e-6 of the largest head gradient instead.
15. SiDA step timing: median seconds over 5 steps, images/s, peak device
   memory, one traced step; printed beside phase 10's.
16. SiDA kernel timing, summed over one step: K7 host-paced (CUDA events
   around back-to-back calls, as in the kernels line), on the device alone
   (calls queued behind a spin kernel) and its host time per call
   (``time.perf_counter`` around calls with no synchronisation), each the
   median and range over five rounds and beside ``torch.add``'s (and the
   baseline K7's), with its bound and plain version; K7 at (8, 512, 32, 32) in f32 and bf16
   on the device alone beside its bytes bound; K4, K5 and K6 each at the
   new f32 shapes beside bound, plain version and SDPA's backward, with the
   SDPA backend named (with ``--baseline``, the baseline's K4, K5 and K6);
   K1 at the step's shapes that phases 6 and 11 did not time (the DINO
   ViT's (4, 6, 197, 64) f32); with ``--baseline``, the baseline's K1 and
   K4 beside them; the GroupNorm kernels at the step's keys, summed over one
   SiDA step.

Any failure raises and exits non-zero.  The last line is the result object.
"""

from __future__ import annotations

import argparse
import atexit
import collections
import contextlib
import ctypes
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

PROMPTS = [
    "a photo of an astronaut riding a horse on the moon",
    "a red fox in a snowy forest, golden hour",
    "a bowl of ramen on a wooden table",
    "an oil painting of a lighthouse in a storm",
]
BATCH = 4
INIT_TIMESTEP = 625
TOL_F32 = dict(atol=1e-4, rtol=1e-3)
TOL_BF16 = dict(atol=2e-2, rtol=2e-2)
REL_L2 = 1e-2  # ||got - ref|| / ||ref|| per output, all dtypes
# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, f32 CUDA cores, HBM3.
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
PEAK_BYTES = 3.35e12
SOURCES = {
    "flash_attn_fwd": ("sid_lsg_torch/csrc/flash_attn_fwd.cu", "sid_lsg_tpu/ops/attention.py:127"),
    "gn_fused": ("sid_lsg_torch/csrc/gn_fused.cu", "sid_lsg_tpu/ops/groupnorm.py:111"),
    "gn_stats": ("sid_lsg_torch/csrc/gn_stats.cu", "sid_lsg_tpu/ops/groupnorm.py:161"),
    "gn_apply": ("sid_lsg_torch/csrc/gn_apply.cu", "sid_lsg_tpu/ops/groupnorm.py:196"),
    "flash_attn_bwd": ("sid_lsg_torch/csrc/flash_attn_bwd.cu", "sid_lsg_tpu/ops/attention.py:234"),
    "flash_attn_bwd_dq": ("sid_lsg_torch/csrc/flash_attn_bwd_twopass.cu",
                          "sid_lsg_tpu/ops/attention.py:326"),
    "flash_attn_bwd_dkv": ("sid_lsg_torch/csrc/flash_attn_bwd.cu", "sid_lsg_tpu/ops/attention.py:378"),
    "bias_act": ("sid_lsg_torch/csrc/bias_act.cu", "sid_lsg_tpu/ops/bias_act.py:92"),
}
SERVING_KERNELS = ("flash_attn_fwd", "gn_fused", "gn_stats", "gn_apply")
GN_KERNELS = ("gn_fused", "gn_stats", "gn_apply")
BWD_KERNELS = ("flash_attn_bwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv")
# The training path: `python -m sid_lsg_torch.cli.sid_train` with these flags
# (the paper's kappa = 1.5, remat `flash`); --max-ticks 1 keeps the schedule
# short of a state dump, which the port refuses.  `--sd_model` becomes the
# phase-1b checkpoint (`with_flag`).
TRAIN_ARGS = ["--outdir", "chiprun_out/train", "--sd_model", "sd15", "--batch", "4",
              "--batch-micro", "4", "--cfg_train_fake", "1.5", "--cfg_eval_fake", "1.5",
              "--cfg_eval_real", "1.5", "--init_timestep", "625", "--bf16", "1", "--grad-ckpt", "1",
              "--remat-policy", "flash", "--max-ticks", "1"]
TRAIN_BATCH = 4
TIMED_STEPS = 5
TWOPASS_STEPS = 3  # timed steps of the same trainer under SIDLSG_FLASH_BWD=twopass
# The SiDA path: the train step above with the adversarial terms through the
# projected DINO ViT-S/16 pixel judge (random backbone), the real latents
# from phase 6b's corpus (`--adv_data`, added at run time).
SIDA_ARGS = TRAIN_ARGS + ["--adv_weight_d", "0.1", "--adv_weight_g", "0.1", "--adv_tower", "dino",
                          "--adv_vit", "s16"]
SIDA_BATCH = TRAIN_BATCH
TOL_LOSS = 1e-4  # phase 9: relative, losses
TOL_GRAD = 1e-3  # phase 9: relative, and 1e-4 * max|ref| absolute, per gradient tensor


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def with_flag(args, flag: str, value: str):
    """``args`` with ``flag``'s value set to ``value`` (appended if absent)."""
    args = list(args)
    if flag in args:
        args[args.index(flag) + 1] = value
        return args
    return args + [flag, value]


def trainer_from_args(args):
    from sid_lsg_torch.cli import sid_train
    from sid_lsg_torch.training.loop import Trainer

    return Trainer(sid_train.config_from_args(sid_train.build_parser().parse_args(args)))


# The VAE mid attentions' names in the published SD1.5 VAE file.
LEGACY_VAE_ATTN = {"to_q": "query", "to_k": "key", "to_v": "value", "to_out.0": "proj_attn"}


def write_tokenizer(tok_dir: str) -> None:
    """A small CLIP vocab: the 512 byte tokens, a few merges, the two specials."""
    from sid_lsg_torch.models.tokenizer import bytes_to_unicode

    os.makedirs(tok_dir, exist_ok=True)
    chars = list(bytes_to_unicode().values())
    merges = ["t h", "th e</w>", "a n", "o n</w>", "o f</w>", "i n", "r e", "e r</w>", "o r",
              "a r", "h o", "s t"]
    vocab = chars + [c + "</w>" for c in chars] + [m.replace(" ", "") for m in merges]
    vocab += ["<|startoftext|>", "<|endoftext|>"]
    with open(os.path.join(tok_dir, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump({tok: i for i, tok in enumerate(vocab)}, f)
    with open(os.path.join(tok_dir, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(merges) + "\n")
    with open(os.path.join(tok_dir, "tokenizer_config.json"), "w", encoding="utf-8") as f:
        json.dump({"pad_token": "<|endoftext|>", "model_max_length": 77}, f)


def write_checkpoint(model_dir: str) -> dict:
    """Phase 1b: SD1.5's random weights (seed 0) in F16 as an HF-layout
    directory with the published files' quirks; returns the written state
    dicts read back as f32, on the card."""
    import torch

    from sid_lsg_torch.models import SD15
    from sid_lsg_torch.models.configs import write_hf_config_jsons
    from sid_lsg_torch.pipeline import random_state_dicts
    from sid_lsg_torch.runtime.checkpoint import write_safetensors

    half = {part: {k: v.half() for k, v in sd.items()}
            for part, sd in random_state_dicts(SD15, "cuda", seed=0).items()}

    def legacy(key: str) -> str:
        for new, old in LEGACY_VAE_ATTN.items():
            key = key.replace(f"mid_block.attentions.0.{new}.", f"mid_block.attentions.0.{old}.")
        return key

    files = {
        "unet/diffusion_pytorch_model.safetensors": half["unet"],
        "vae/diffusion_pytorch_model.safetensors": {legacy(k): v for k, v in half["vae"].items()},
        "text_encoder/model.safetensors": {
            **{f"text_model.{k}": v for k, v in half["text"].items()},
            "text_model.embeddings.position_ids": torch.arange(77)[None]},
    }
    vae_keys = files["vae/diffusion_pytorch_model.safetensors"]
    require(sum(k.endswith(".query.weight") for k in vae_keys) == 2,
            "the legacy VAE attention names were not written")
    write_hf_config_jsons(model_dir, SD15)
    for rel, tensors in files.items():
        write_safetensors(tensors, os.path.join(model_dir, rel))
    write_tokenizer(os.path.join(model_dir, "tokenizer"))
    return {part: {k: v.float() for k, v in sd.items()} for part, sd in half.items()}


def dir_bytes(root: str) -> int:
    return sum(os.path.getsize(os.path.join(d, n)) for d, _, names in os.walk(root) for n in names)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def close_errors(got, ref, atol, rtol):
    """(max abs error, max rel error where |ref| > atol, max of |err| / (atol + rtol |ref|),
    ||err|| / ||ref||); elementwise within tolerance iff the third is <= 1."""
    ref = ref.float()
    err = (got.float() - ref).abs()
    big = ref.abs() > atol
    rel = (err[big] / ref.abs()[big]).max().item() if bool(big.any()) else 0.0
    rel_l2 = (err.norm() / ref.norm().clamp_min(1e-30)).item()
    return err.max().item(), rel, (err / (atol + rtol * ref.abs())).max().item(), rel_l2


def time_ms(fn, min_iters: int = 10, min_total_ms: float = 30.0) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    iters = max(min_iters, min(1000, int(min_total_ms / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# The kernel library of another checkout (``--baseline``), whose K1 and K4
# are timed beside this one's at the same shapes in the same run; None
# without the option.
BASELINE = None


# The argument types of the two-kernel K2's C entry (``sidlsg_gn_stats``:
# x, part, mean, rstd, groups_total, span, splits, chunk, eps, dtype,
# stream), which this tree's kernels no longer have.
_PARENT_GN_STATS = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                            ctypes.c_longlong, ctypes.c_float, ctypes.c_int,
                                            ctypes.c_void_p]


def load_baseline(root: str):
    """Build the kernels of the checkout at ``root`` (its
    ``sid_lsg_torch/csrc``) into this tree's build directory and load them."""
    from sid_lsg_torch.ops import _build

    csrc = Path(root) / "sid_lsg_torch" / "csrc"
    require(csrc.is_dir(), f"--baseline {root}: no sid_lsg_torch/csrc there")
    t0 = time.perf_counter()
    lib = _build.load(_build.build(csrc), required=False)
    if hasattr(lib, "sidlsg_gn_stats"):
        lib.sidlsg_gn_stats.argtypes = _PARENT_GN_STATS
        lib.sidlsg_gn_stats.restype = ctypes.c_int
    print(f"[baseline] kernels of {root} built in {time.perf_counter() - t0:.3f} s")
    return lib


def baseline_gn_stats(lib, x, groups: int, eps: float):
    """The two-kernel K2 of the baseline (its ``gn_partial`` into a scratch
    buffer, then ``gn_finalize``), called as its wrapper called it."""
    import torch

    from sid_lsg_torch.ops._build import dtype_code

    b = x.shape[0]
    groups_total = b * groups
    span = x.numel() // groups_total
    splits = min(1024, -(-span // 8192))
    chunk = -(-span // splits)
    chunk = -(-chunk // 8) * 8
    part = torch.empty(groups_total * splits * 2, dtype=torch.float32, device=x.device)
    mean = torch.empty((b, groups), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    err = lib.sidlsg_gn_stats(x.data_ptr(), part.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                              groups_total, span, splits, chunk, float(eps), dtype_code(x),
                              torch.cuda.current_stream().cuda_stream)
    require(err == 0, f"baseline gn_stats: CUDA error {err}")
    return mean, rstd


def baseline_gn_apply(lib, x, mean, rstd, gamma, beta, groups: int, silu: bool):
    """The baseline's K3 (f32 contiguous statistics and affine)."""
    import torch

    from sid_lsg_torch.ops._build import dtype_code

    b, c = x.shape[:2]
    y = torch.empty_like(x)
    err = lib.sidlsg_gn_apply(x.data_ptr(), y.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                              gamma.data_ptr(), beta.data_ptr(), b, c, groups, x.numel() // (b * c),
                              int(silu), dtype_code(x), torch.cuda.current_stream().cuda_stream)
    require(err == 0, f"baseline gn_apply: CUDA error {err}")
    return y


def baseline_group_norm(lib, x, gamma, beta, groups: int, eps: float, silu: bool):
    """The baseline's K2 + K3, as its ``_GroupNorm.forward`` ran them."""
    return baseline_gn_apply(lib, x, *baseline_gn_stats(lib, x, groups, eps), gamma, beta, groups,
                             silu)


_FLUSH = None  # 256 MB written before each call of a cold timing, five times the L2


def device_ms(fn, cold: bool = False, iters: int = 20) -> float:
    """Device time of one call of ``fn`` in ms, host launch time excluded:
    the calls are queued behind a spin kernel of about 10 ms, so the device
    runs them back to back.  Warm: CUDA events around ``iters`` calls, over
    ``iters``.  Cold: before each call a 256 MB write evicts the inputs from
    the 50 MB L2, and CUDA events around each call give the median."""
    import torch

    global _FLUSH
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters if cold else 1)]
    if cold and _FLUSH is None:
        _FLUSH = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    torch.cuda._sleep(20_000_000)
    if cold:
        for a, b in events:
            _FLUSH.zero_()
            a.record()
            fn()
            b.record()
    else:
        events[0][0].record()
        for _ in range(iters):
            fn()
        events[0][1].record()
    torch.cuda.synchronize()
    if cold:
        return statistics.median(a.elapsed_time(b) for a, b in events)
    return events[0][0].elapsed_time(events[0][1]) / iters


class GNCalls:
    """Counts the GroupNorms a run makes, by the route ``gn_plan`` gives
    them, by wrapping ``ops.group_norm`` (which every GroupNorm module looks
    up at each call) while active."""

    def __enter__(self):
        from sid_lsg_torch import ops

        self._ops, self._fn = ops, ops.group_norm
        self.routes = {"fused": 0, "tiled": 0}

        def group_norm(x, gamma, beta, num_groups=32, eps=1e-5, silu=False):
            self.routes[ops.gn_plan(x.shape, x.dtype, num_groups)[0]] += 1
            return self._fn(x, gamma, beta, num_groups, eps, silu)

        ops.group_norm = group_norm
        return self

    def __exit__(self, *exc):
        self._ops.group_norm = self._fn


def require_gn_routes(label: str, launches: dict, calls: GNCalls) -> None:
    """One K8 launch per GroupNorm routed ``fused``, one K2 and one K3 per
    GroupNorm routed ``tiled``, and at least one GroupNorm."""
    r = calls.routes
    print(f"[{label}] GroupNorms: {r['fused']} fused (K8), {r['tiled']} tiled (K2 + K3); "
          f"GroupNorm kernel launches {sum(launches[k] for k in GN_KERNELS)} "
          f"(gn_fused {launches['gn_fused']}, gn_stats {launches['gn_stats']}, gn_apply "
          f"{launches['gn_apply']})")
    require(r["fused"] + r["tiled"] > 0, f"{label}: no GroupNorm ran")
    require(launches["gn_fused"] == r["fused"] and launches["gn_stats"] == r["tiled"]
            and launches["gn_apply"] == r["tiled"],
            f"{label}: GroupNorm launches {launches} do not follow gn_plan's routes {r}")


@contextlib.contextmanager
def attention_library(lib):
    """Route ``ops.attention``'s wrappers to the kernel library ``lib``."""
    mod = sys.modules["sid_lsg_torch.ops.attention"]
    saved = mod.library
    mod.library = lambda: lib
    try:
        yield
    finally:
        mod.library = saved


def baseline_ms(fn) -> float:
    """``time_ms(fn)`` with the baseline's kernels (0.0 without a baseline)."""
    if BASELINE is None:
        return 0.0
    with attention_library(BASELINE):
        return time_ms(fn)


# The kernel functions of K1, K4, K5 and K6 (K6 is K4's sweep without its
# dQ section, under names of its own), by their names in the build log.
PTXAS_KERNELS = {"fwd_bf16_wgmma": "K1", "fwd_f32_tf32x3": "K1", "bwd_bf16_wgmma": "K4",
                 "bwd_f32_tf32x3": "K4", "bwd_dq_bf16_wgmma": "K5", "bwd_dq_f32_tf32x3": "K5",
                 "bwd_dkv_bf16_wgmma": "K6", "bwd_dkv_f32_tf32x3": "K6"}


def mangled_function(name: str):
    """The function's own name in an Itanium-mangled name: the last of the
    length-prefixed components of ``_ZN<namespaces><name>[I...]E...`` (nvcc
    names an anonymous namespace after the file and a hash), or the one
    component of ``_Z<name>...``; None for anything else."""
    m = re.match(r"_Z(N?)", name)
    func, i = None, m.end() if m else len(name)
    while (n := re.match(r"\d+", name[i:])):
        i += n.end()
        func, i = name[i:i + int(n.group())], i + int(n.group())
        if not m.group(1):
            break
    return func


def print_kernel_build(lib_path) -> None:
    """Registers and spills of K1's, K4's, K5's and K6's kernels from
    ``-Xptxas -v``, and the dynamic shared memory each instantiation's
    launch takes."""
    from sid_lsg_torch.ops import _build

    rows = []
    for row in _build.ptxas_report(lib_path):
        if mangled_function(row[0]) in PTXAS_KERNELS:
            rows.append((PTXAS_KERNELS[mangled_function(row[0])],) + row)
    require({r[0] for r in rows} == set(PTXAS_KERNELS.values()),
            f"the build log names kernels of only {sorted({r[0] for r in rows})}")
    names = [r[1] for r in rows]
    if shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                               text=True).stdout.split("\n")
    for name, (kernel, _, regs, st, ld) in zip(names, rows):
        print(f"[ptxas] {kernel} {name.strip()}: {regs} registers, spill stores {st} B, spill "
              f"loads {ld} B")
    lib = _build.library()
    for code, dps in ((1, (16, 32, 48, 64, 80, 160)), (0, (64, 192, 320, 512))):
        for dp in dps:
            print(f"[smem] {'bf16' if code else 'f32'} head dim {dp}: K1 "
                  f"{lib.sidlsg_flash_attn_fwd_smem(code, dp)} B, K4 "
                  f"{lib.sidlsg_flash_attn_bwd_smem(code, dp)} B, K5 "
                  f"{lib.sidlsg_flash_attn_bwd_dq_smem(code, dp)} B, K6 "
                  f"{lib.sidlsg_flash_attn_bwd_dkv_smem(code, dp)} B of dynamic shared memory")


def time_fwd_keys(keys, gen, label: str) -> dict:
    """K1 at each recorded launch key, summed over the launches: this tree's
    kernel, the baseline's, the plain version, the bound and SDPA."""
    tot = {"ms": 0.0, "base_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "ops_ms": 0.0,
           "bytes_ms": 0.0, "library_ms": 0.0}
    for key, n in sorted(keys.items(), key=lambda kv: str(kv[0])):
        kern, plain, lib, _, (nbytes, flops, op_type) = kernel_cases("flash_attn_fwd", key, gen)
        ops_ms, bytes_ms = flops / PEAK_FLOPS[op_type] * 1e3, nbytes / PEAK_BYTES * 1e3
        row = {"ms": time_ms(kern), "base_ms": baseline_ms(kern), "plain_ms": time_ms(plain),
               "bound_ms": max(ops_ms, bytes_ms), "ops_ms": ops_ms, "bytes_ms": bytes_ms,
               "library_ms": time_ms(lib)}
        for f in tot:
            tot[f] += n * row[f]
        print(f"[time] flash_attn_fwd {key} x{n}: {row['ms']:.4f} ms, baseline "
              f"{row['base_ms']:.4f}, plain {row['plain_ms']:.4f}, bound {row['bound_ms']:.4f}, "
              f"SDPA {row['library_ms']:.4f}")
    print(f"[time] K1 per {label}: {tot['ms']:.4f} ms, baseline {tot['base_ms']:.4f} ms, bound "
          f"{tot['bound_ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, SDPA {tot['library_ms']:.4f} ms")
    return tot


def trace(label: str, fn, top: int = 15, host_top: int = 0) -> None:
    """Print the device time of one call of ``fn`` by kernel name, from a
    torch.profiler trace: busy = union of the CUDA kernels' intervals, idle
    share = 1 - busy over the host's wall time of the call; with
    ``host_top``, also the host-side ops with the most self CPU time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.time_range.end > e.time_range.start:
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    if not spans:
        print(f"[trace] {label}: the profiler recorded no device kernels: device busy time "
              f"not measured")
        return
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    busy_ms = busy_us / 1e3
    print(f"[trace] {label}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, "
          f"idle share {1 - busy_ms / wall_ms:.3f}, {len(spans)} kernels")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"[trace]   {ms:9.3f} ms  {name[:110]}")
    if host_top:
        host = [e for e in prof.key_averages() if e.device_type == DeviceType.CPU]
        total_ms = sum(e.self_cpu_time_total for e in host) / 1e3
        print(f"[trace] {label}: host ops' self CPU time {total_ms:.3f} ms over "
              f"{sum(e.count for e in host)} calls; the largest:")
        for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:host_top]:
            print(f"[trace]   {e.self_cpu_time_total / 1e3:9.3f} ms  x{e.count:<6d} {e.key[:90]}")


def kernel_cases(name, key, gen):
    """For one recorded launch key: (kernel fn, plain fn, library fn or None,
    tolerance, (bytes, flops, dtype)) on fresh random inputs of that shape."""
    import torch
    import torch.nn.functional as F

    from sid_lsg_torch import ops

    dev = torch.device("cuda")
    if name == "flash_attn_fwd":
        qs, ks, dt = key
        dtype = getattr(torch, dt.split(".")[1])
        q = torch.randn(qs, generator=gen, device=dev).to(dtype)
        k = torch.randn(ks, generator=gen, device=dev).to(dtype)
        b, h, sq, d = qs
        sk = ks[2]
        v = (torch.randn(ks, generator=gen, device=dev) * math.sqrt(sk / math.e)).to(dtype)
        esize = q.element_size()
        work = ((2 * b * h * sq * d + 2 * b * h * sk * d) * esize + 4 * b * h * sq,
                4 * b * h * sq * sk * d, dt)
        return (lambda: ops.flash_attn_fwd(q, k, v),
                lambda: ops.attention_ref(q.float(), k.float(), v.float()),
                lambda: F.scaled_dot_product_attention(q, k, v),
                TOL_BF16 if dtype == torch.bfloat16 else TOL_F32, work)
    c = gn_cases(name, key, gen)
    return c["kern"], c["plain"], c["library"], c["tol"], c["work"]


def gn_cases(name, key, gen) -> dict:
    """For one recorded launch key of K8, K2 or K3, on fresh inputs of that
    shape (x = 2 * normal + 0.5 in the key's dtype): the kernel, its plain
    version, the library yardstick (None for K3), the baseline's kernels
    (K2 + K3 for K8, K2 for K2, K3 for K3; None without ``--baseline``), the
    tolerance and (bytes, operations, type)."""
    import torch
    import torch.nn.functional as F

    from sid_lsg_torch import ops

    dev = torch.device("cuda")
    shape, dt, groups = key[:3]
    dtype = getattr(torch, dt.split(".")[1])
    x = (torch.randn(shape, generator=gen, device=dev) * 2 + 0.5).to(dtype)
    n, c = shape[:2]
    numel, es = x.numel(), x.element_size()
    tol = TOL_BF16 if dtype == torch.bfloat16 else TOL_F32
    lib = BASELINE if BASELINE is not None and hasattr(BASELINE, "sidlsg_gn_stats") else None
    if name == "gn_stats":
        return {"kern": lambda: ops.gn_stats(x, groups, 1e-5),
                "plain": lambda: ops.gn_stats_ref(x.float(), groups, 1e-5),
                "library": lambda: torch.var_mean(x.view(n, groups, -1), dim=-1, correction=0),
                "baseline": lib and (lambda: baseline_gn_stats(lib, x, groups, 1e-5)),
                "tol": TOL_F32, "work": (numel * es + 8 * n * groups, 3 * numel, "torch.float32")}
    silu = key[3]
    gamma = torch.randn(c, generator=gen, device=dev) + 1
    beta = torch.randn(c, generator=gen, device=dev)
    if name == "gn_fused":
        g16, b16 = gamma.to(dtype), beta.to(dtype)
        act = F.silu if silu else (lambda y: y)
        return {"kern": lambda: ops.gn_fused(x, gamma, beta, groups, 1e-5, silu),
                "plain": lambda: ops.group_norm_ref(x.float(), gamma, beta, groups, 1e-5, silu),
                "library": lambda: act(F.group_norm(x, groups, g16, b16, 1e-5)),
                "baseline": lib and (lambda: baseline_group_norm(lib, x, gamma, beta, groups, 1e-5,
                                                                 silu)),
                "tol": tol, "work": (2 * numel * es + 8 * c, (9 if silu else 5) * numel,
                                     "torch.float32")}
    mean, rstd = ops.gn_stats_ref(x.float(), groups, 1e-5)
    return {"kern": lambda: ops.gn_apply(x, mean, rstd, gamma, beta, silu),
            "plain": lambda: ops.gn_apply_ref(x.float(), mean, rstd, gamma, beta, silu),
            "library": None,
            "baseline": lib and (lambda: baseline_gn_apply(lib, x, mean, rstd, gamma, beta, groups,
                                                           silu)),
            "tol": tol, "work": (2 * numel * es + 8 * c + 8 * n * groups, (6 if silu else 2) * numel,
                                 "torch.float32")}


# Per (kernel, key): the GroupNorm timings of ``time_gn_key``, so that the
# train and SiDA steps reuse the serving batch's.
_GN_TIMES: dict = {}


def time_gn_key(name, key, gen) -> dict:
    """One GroupNorm kernel at one launch key: its device time warm and
    cold, bound, plain version, library yardstick (warm and cold; for K3
    keys ``F.group_norm`` (+SiLU), the library call of the whole K2 + K3
    pair) and the baseline's (warm and cold), in ms a launch."""
    import torch
    import torch.nn.functional as F

    if (name, key) in _GN_TIMES:
        return _GN_TIMES[(name, key)]
    c = gn_cases(name, key, gen)
    nbytes, flops, op_type = c["work"]
    ops_ms, bytes_ms = flops / PEAK_FLOPS[op_type] * 1e3, nbytes / PEAK_BYTES * 1e3
    lib = c["library"]
    if name == "gn_apply":  # the pair's library call: F.group_norm (+SiLU) on the same shape
        shape, dt, groups, silu = key
        dtype = getattr(torch, dt.split(".")[1])
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        w, b = torch.ones(shape[1], device="cuda", dtype=dtype), torch.zeros(shape[1], device="cuda",
                                                                              dtype=dtype)
        act = F.silu if silu else (lambda y: y)
        lib = lambda: act(F.group_norm(x, groups, w, b, 1e-5))
    row = {"ms": device_ms(c["kern"]), "cold_ms": device_ms(c["kern"], cold=True),
           "plain_ms": device_ms(c["plain"], iters=5), "bound_ms": max(ops_ms, bytes_ms),
           "ops_ms": ops_ms, "bytes_ms": bytes_ms,
           "library_ms": device_ms(lib), "library_cold_ms": device_ms(lib, cold=True),
           "base_ms": device_ms(c["baseline"]) if c["baseline"] else 0.0,
           "base_cold_ms": device_ms(c["baseline"], cold=True) if c["baseline"] else 0.0}
    _GN_TIMES[(name, key)] = row
    return row


GN_FIELDS = ("ms", "cold_ms", "plain_ms", "bound_ms", "ops_ms", "bytes_ms", "library_ms",
             "library_cold_ms", "base_ms", "base_cold_ms")
GN_YARDSTICK = {"gn_fused": "F.group_norm(+SiLU)", "gn_stats": "torch.var_mean",
                "gn_apply": "F.group_norm(+SiLU) of the K2 + K3 pair"}
GN_BASELINE = {"gn_fused": "baseline K2 + K3", "gn_stats": "baseline K2", "gn_apply": "baseline K3"}


def time_gn_keys(keys: dict, gen, label: str) -> dict:
    """K8, K2 and K3 at each launch key of one path run (``keys``: name ->
    Counter of keys), summed over the launches: {name: totals}.  Prints a
    line per key and the sums, and the whole GroupNorm forward of the run
    against ``F.group_norm`` (+SiLU) and the baseline's K2 + K3."""
    tot = {name: dict.fromkeys(GN_FIELDS, 0.0) for name in GN_KERNELS}
    for name in GN_KERNELS:
        for key, n in sorted(keys[name].items(), key=lambda kv: str(kv[0])):
            row = time_gn_key(name, key, gen)
            for f in GN_FIELDS:
                tot[name][f] += n * row[f]
            print(f"[gn-time] {name} {key} x{n}: warm {row['ms']:.5f} ms, cold {row['cold_ms']:.5f}, "
                  f"bound {row['bound_ms']:.5f}, {GN_YARDSTICK[name]} warm {row['library_ms']:.5f} "
                  f"cold {row['library_cold_ms']:.5f}, {GN_BASELINE[name]} warm {row['base_ms']:.5f} "
                  f"cold {row['base_cold_ms']:.5f}, plain {row['plain_ms']:.5f}")
    for name in GN_KERNELS:
        t = tot[name]
        print(f"[gn-time] {name} per {label}: {sum(keys[name].values())} launches, warm "
              f"{t['ms']:.4f} ms, cold {t['cold_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms, "
              f"{GN_YARDSTICK[name]} warm {t['library_ms']:.4f} cold {t['library_cold_ms']:.4f} ms, "
              f"{GN_BASELINE[name]} warm {t['base_ms']:.4f} cold {t['base_cold_ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms")
    f, s2, a = tot["gn_fused"], tot["gn_stats"], tot["gn_apply"]
    print(f"[gn-time] GroupNorm forward per {label}: {sum(sum(keys[k].values()) for k in GN_KERNELS)} "
          f"launches; this tree warm {f['ms'] + s2['ms'] + a['ms']:.4f} ms, cold "
          f"{f['cold_ms'] + s2['cold_ms'] + a['cold_ms']:.4f} ms; F.group_norm(+SiLU) warm "
          f"{f['library_ms'] + a['library_ms']:.4f} cold {f['library_cold_ms'] + a['library_cold_ms']:.4f} "
          f"ms; baseline K2 + K3 warm {f['base_ms'] + s2['base_ms'] + a['base_ms']:.4f} cold "
          f"{f['base_cold_ms'] + s2['base_cold_ms'] + a['base_cold_ms']:.4f} ms")
    return tot


def gn_entry(name, launches, max_abs, tot) -> dict:
    """The kernels-line entry of K8, K2 or K3 from ``time_gn_keys``'s totals
    (warm times)."""
    return {"name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1], "launches": launches, "max_abs_err": max_abs,
            "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": "operations" if tot["ops_ms"] > tot["bytes_ms"] else "bytes",
            "library_ms": tot["library_ms"] if name != "gn_apply" else None}


def check_outputs(label, got, ref, tol, scale_each: bool = False) -> float:
    """Compare each output with its plain version (``scale_each``: both
    scaled by the power of two that brings the plain one to RMS about 1);
    print and require the tolerance; return the largest absolute error."""
    import torch

    worst = 0.0
    for i, (g, r) in enumerate(zip(got, ref)):
        t = TOL_F32 if g.dtype == torch.float32 else tol
        if scale_each:
            rms = r.float().square().mean().sqrt().item()
            c = 2.0 ** round(-math.log2(max(rms, 1e-30)))
            g, r = g.float() * c, r.float() * c
        abs_err, rel_err, ratio, rel_l2 = close_errors(g, r, **t)
        worst = max(worst, abs_err)
        print(f"[check] {label} out{i}: max abs {abs_err:.3e}, max rel {rel_err:.3e}, "
              f"max err/tol {ratio:.3f} (atol {t['atol']}, rtol {t['rtol']}), "
              f"rel L2 {rel_l2:.3e} (<= {REL_L2}), max |ref| {r.abs().max().item():.3e}")
        require(ratio <= 1.0 and rel_l2 <= REL_L2, f"{label} output {i} out of tolerance")
    return worst


def check_forward_kernel(name, key, gen) -> float:
    """K1, K2 or K3 against its plain version at one recorded shape."""
    import torch

    kern, plain, _, tol, _ = kernel_cases(name, key, gen)
    got, ref = kern(), plain()
    torch.cuda.synchronize()
    if not isinstance(got, tuple):
        got, ref = (got,), (ref,)
    return check_outputs(f"{name} {key}", got, ref, tol)


def check_parity_f32(gen) -> None:
    """K1 and K4 in f32 at the JAX package's parity shapes and inputs
    (``tests/test_pallas_parity.py:22-50``: standard-normal q, k, v; K4 on
    the gradients of sum(sin(out)), so dO = cos(out)): err/tol printed at
    its tolerances, each output held to the f32 gate."""
    import torch

    from sid_lsg_torch import ops

    dev = torch.device("cuda")
    for sq, sk, d in ((128, 128, 64), (200, 77, 40), (64, 256, 32)):
        q, k, v = (torch.randn(2, 3, s_, d, generator=gen, device=dev) for s_ in (sq, sk, sk))
        out, _ = ops.flash_attn_fwd(q, k, v)
        ref, _ = ops.attention_ref(q, k, v)
        torch.cuda.synchronize()
        ratio = close_errors(out, ref, atol=2e-5, rtol=1e-4)[2]
        print(f"[parity] K1 f32 (2, 3, {sq}, {sk}, {d}): err/tol {ratio:.3f} at the JAX parity "
              f"tolerance (atol 2e-5, rtol 1e-4)")
        check_outputs(f"flash_attn_fwd f32 parity shape (2, 3, {sq}, {sk}, {d})", (out,), (ref,),
                      TOL_F32)
    q = torch.randn(1, 2, 160, 32, generator=gen, device=dev)
    k, v = (torch.randn(1, 2, 96, 32, generator=gen, device=dev) for _ in range(2))
    out, lse = ops.attention_ref(q, k, v)
    args = (q, k, v, out, lse, torch.cos(out), 32 ** -0.5)
    got, ref = ops.flash_attn_bwd(*args), ops.flash_attn_bwd_ref(*args)
    torch.cuda.synchronize()
    for name, a, b in zip("qkv", got, ref):
        ratio = close_errors(a, b, atol=5e-5, rtol=1e-3)[2]
        print(f"[parity] K4 f32 d{name} at q (1, 2, 160, 32), k/v (1, 2, 96, 32): err/tol "
              f"{ratio:.3f} at the JAX parity tolerance (atol 5e-5, rtol 1e-3)")
    check_outputs("flash_attn_bwd f32 parity shape", got, ref, TOL_F32)


def attention_flops(keys, per_element: int) -> float:
    """per_element * B * H * S_q * S_k * D summed over recorded launches."""
    total = 0.0
    for (qs, ks, _), n in keys.items():
        b, h, sq, d = qs
        total += n * per_element * b * h * sq * ks[2] * d
    return total


def bwd_cases(key, gen):
    """For one shape K4 was launched at: inputs made as K1's check makes
    them, the plain backward (f32) and, per backward kernel, (kernel fn,
    plain outputs it is held to, bytes, flops); plus SDPA's forward with
    grad and its forward + backward on the same inputs, and the two-pass
    backward as one call (``flash_attn_bwd_twopass``)."""
    import torch
    import torch.nn.functional as F

    from sid_lsg_torch import ops

    qs, ks, dt = key
    dtype = getattr(torch, dt.split(".")[1])
    b, h, sq, d = qs
    sk = ks[2]
    dev = torch.device("cuda")
    q = torch.randn(qs, generator=gen, device=dev).to(dtype)
    k = torch.randn(ks, generator=gen, device=dev).to(dtype)
    v = (torch.randn(ks, generator=gen, device=dev) * math.sqrt(sk / math.e)).to(dtype)
    dout = torch.randn(qs, generator=gen, device=dev).to(dtype)
    out, lse = ops.attention_ref(q.float(), k.float(), v.float())
    out = out.to(dtype)
    scale = d ** -0.5
    args = (q, k, v, out, lse, dout, scale)
    f32 = (q.float(), k.float(), v.float(), out.float(), lse, dout.float(), scale)
    plain = lambda: ops.flash_attn_bwd_ref(*f32)
    ref = plain()
    es, bh = q.element_size(), b * h
    cases = {
        "flash_attn_bwd": (lambda: ops.flash_attn_bwd(*args), ref,
                           4 * bh * (sq + sk) * d * es + 4 * bh * sq, 10 * bh * sq * sk * d),
        "flash_attn_bwd_dq": (lambda: (ops.flash_attn_bwd_dq(*args),), ref[:1],
                              bh * (4 * sq + 2 * sk) * d * es + 4 * bh * sq, 6 * bh * sq * sk * d),
        "flash_attn_bwd_dkv": (lambda: ops.flash_attn_bwd_dkv(*args), ref[1:],
                               bh * (3 * sq + 4 * sk) * d * es + 4 * bh * sq, 8 * bh * sq * sk * d),
    }
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
    sdpa_fwd = lambda: F.scaled_dot_product_attention(ql, kl, vl)
    sdpa_both = lambda: torch.autograd.grad(sdpa_fwd(), (ql, kl, vl), dout)
    return cases, plain, (sdpa_fwd, sdpa_both), lambda: ops.flash_attn_bwd_twopass(*args)


class K1Sweep:
    """Counts calls of K1's wrapper made inside the autograd engine's
    backward sweep (the remat recompute) and those made by forwards whose
    queries carry grad, by wrapping ``ops.attention.flash_attn_fwd`` (which
    the custom op's forward looks up at each call) while active."""

    def __init__(self):
        self.backward = 0
        self.forward_grad = 0

    def __enter__(self):
        import torch

        self._module = sys.modules["sid_lsg_torch.ops.attention"]
        self._fwd = self._module.flash_attn_fwd

        def fwd(q, *args, **kwargs):
            if torch._C._current_autograd_node() is not None:
                self.backward += 1
            elif q.requires_grad:
                self.forward_grad += 1
            return self._fwd(q, *args, **kwargs)

        self._module.flash_attn_fwd = fwd
        return self

    def __exit__(self, *exc):
        self._module.flash_attn_fwd = self._fwd


STRUCTURAL_ZERO = ("main0.conv.bias", "main1.conv.bias")


def tiny_train_grads(device, tower=None):
    """Phases 9 and 14 on one device: the tiny preset's psi-phase and
    theta-phase losses and gradients in f32 from fixed weights and
    CPU-generator draws; with ``tower``, the adversarial terms of that tower
    (the pixel judge on TINY_VIT) and its heads among the psi-phase tensors."""
    import torch

    from sid_lsg_torch.diffusion.ddpm import DDPMScheduler, SchedulerConfig
    from sid_lsg_torch.models import TINY, AutoencoderKL
    from sid_lsg_torch.models.stylegan_discriminator import (
        TINY_VIT,
        ProjectedDiscriminator,
        head_params,
        init_disc_weights_,
    )
    from sid_lsg_torch.models.unet import unet_apply_fn
    from sid_lsg_torch.pipeline import random_state_dicts
    from sid_lsg_torch.training.adversarial import make_pixel_disc
    from sid_lsg_torch.training.distill import DISC_PREFIX, DistillConfig, make_loss_fns

    sds = random_state_dicts(TINY, "cpu", seed=0)
    teacher = sds["unet"]
    wgen = torch.Generator().manual_seed(1)
    fake = {k: v + 0.02 * torch.randn(v.shape, generator=wgen) for k, v in teacher.items()}
    g = {k: v + 0.02 * torch.randn(v.shape, generator=wgen) for k, v in teacher.items()}
    on = lambda tree, grad: {k: v.to(device).requires_grad_(grad) for k, v in tree.items()}
    dim = TINY.unet.cross_attention_dim
    adv = dict(adv_weight_D=0.1, adv_weight_G=0.1, adv_tower=tower) if tower else {}
    cfg = DistillConfig(latent_size=TINY.unet.sample_size, latent_channels=TINY.unet.in_channels,
                        cfg_train_fake=1.5, cfg_eval_fake=1.5, cfg_eval_real=1.5,
                        dtype=torch.float32, **adv)
    pixel, heads = None, {}
    if tower == "dino":
        vae = AutoencoderKL(TINY.vae)
        vae.load_state_dict(sds["vae"])
        disc = ProjectedDiscriminator(dim, TINY_VIT, power_iters=3)
        init_disc_weights_(disc, torch.Generator().manual_seed(3))
        pixel = make_pixel_disc(vae.to(device).requires_grad_(False),
                                disc.to(device).requires_grad_(False), TINY.vae.scaling_factor)
        heads = {DISC_PREFIX + k: v.detach().clone() for k, v in head_params(disc).items()}
    encode = unet_apply_fn(TINY.unet, torch.float32, encoder_only=True) if tower == "encoder" else None
    sched = DDPMScheduler(SchedulerConfig.sd(TINY.prediction_type), device=device)
    L = make_loss_fns(unet_apply_fn(TINY.unet, torch.float32), sched, cfg, unet_encode=encode,
                      pixel_disc=pixel)
    draws = torch.Generator().manual_seed(5)
    mb = 2
    z, noise, t, init_t = L.draw(draws, mb, device)
    emb = (torch.randn(mb, 77, dim, generator=draws) * 0.5).to(device)
    unc = (torch.randn(77, dim, generator=draws) * 0.5).to(device).expand(mb, 77, dim)
    adv_psi = adv_g = None
    if tower:
        adv_psi = {"lat_real": torch.randn(mb, 4, 8, 8, generator=draws).to(device),
                   "emb_real": (torch.randn(mb, 77, dim, generator=draws) * 0.5).to(device),
                   **L.draw_adv_psi(draws, mb, device)}
        adv_g = L.draw_adv_g(draws, mb)
    with torch.no_grad():
        images = L.generate(on(g, False), z, emb, init_t)
    pf = {**on(fake, True), **on(heads, True)}
    loss_f, aux_f = L.psi_loss(pf, on(teacher, False), images, noise, emb, unc, t, float(mb), adv_psi)
    grads_f = torch.autograd.grad(loss_f, list(pf.values()))
    pg = on(g, True)
    loss_g, aux_g = L.g_loss(pg, {k: v.detach() for k, v in pf.items()}, on(teacher, False), z,
                             noise, emb, unc, t, init_t, float(mb), None, adv_g)
    grads_g = torch.autograd.grad(loss_g, list(pg.values()))
    losses = {"psi": float(loss_f.detach()), "theta": float(loss_g.detach())}
    if tower:
        losses.update(adv_d_loss=float(aux_f["adv_d_loss"]), adv_g_loss=float(aux_g["adv_g_loss"]))
    return losses, {"psi": dict(zip(pf, (x.cpu() for x in grads_f))),
                    "theta": dict(zip(pg, (x.cpu() for x in grads_g)))}


def compare_tiny(label, card, cpu) -> None:
    """Phase 9's rule on the outputs of ``tiny_train_grads`` on the card and
    on the CPU: each loss within TOL_LOSS, each gradient tensor within
    TOL_GRAD and 1e-4 * max|ref|; the structurally zero conv biases of the
    judge's heads below 1e-6 of the largest head gradient on both sides."""
    (loss_card, grads_card), (loss_cpu, grads_cpu) = card, cpu
    for k, b in loss_cpu.items():
        require(abs(loss_card[k] - b) <= TOL_LOSS * abs(b), f"{label}: {k} {loss_card[k]} vs {b}")
    for phase, cpu_grads in grads_cpu.items():
        heads_max = max([float(v.abs().max()) for k, v in cpu_grads.items()
                         if k.startswith("disc.")] or [0.0])
        worst = 0.0
        for k, ref in cpu_grads.items():
            got = grads_card[phase][k]
            if k.endswith(STRUCTURAL_ZERO):
                for side, v in (("card", got), ("CPU", ref)):
                    require(float(v.abs().max()) <= 1e-6 * heads_max,
                            f"{label}: {side} gradient of {k} not ~0 ({float(v.abs().max()):.3e})")
                continue
            atol = 1e-4 * max(float(ref.abs().max()), 1e-8)
            ratio = float(((got - ref).abs() / (atol + TOL_GRAD * ref.abs())).max())
            worst = max(worst, ratio)
            require(ratio <= 1.0, f"{label}: {phase} gradient of {k} err/tol {ratio:.3f}")
        print(f"[{label}] {phase}: {len(cpu_grads)} gradient tensors, max err/tol {worst:.3f} "
              f"(rtol {TOL_GRAD}, atol 1e-4 max|ref|)")


def check_bwd(key, gen, max_abs):
    """K4, K5 and K6 against the plain backward at one shape K4 was launched
    at, K4 against K5 + K6, at the tolerance of the shape's dtype (each
    output scaled as phase 8 says), and the two-pass backward run twice for
    the same bits, which must be those of K5 and K6 called apart; raises
    ``max_abs`` per kernel to its largest error; returns
    ``bwd_cases(key, gen)``."""
    import torch

    cases, plain, sdpa, twopass = bwd_cases(key, gen)
    tol = TOL_F32 if key[2] == "torch.float32" else TOL_BF16
    outs = {}
    for name, (kern, ref, _, _) in cases.items():
        outs[name] = kern()
        torch.cuda.synchronize()
        max_abs[name] = max(max_abs.get(name, 0.0),
                            check_outputs(f"{name} {key}", outs[name], ref, tol, scale_each=True))
    check_outputs(f"flash_attn_bwd vs two-pass {key}", outs["flash_attn_bwd"],
                  outs["flash_attn_bwd_dq"] + outs["flash_attn_bwd_dkv"], tol, scale_each=True)
    first, again = twopass(), twopass()
    torch.cuda.synchronize()
    same = [torch.equal(a, b) for a, b in zip(first, again)]
    apart = [torch.equal(a, b) for a, b in
             zip(first, outs["flash_attn_bwd_dq"] + outs["flash_attn_bwd_dkv"])]
    print(f"[check] K5 + K6 {key}: two runs bit for bit equal {same}; equal to K5 and K6 called "
          f"apart {apart}")
    require(all(same), f"K5 + K6 at {key}: two runs differ")
    require(all(apart), f"K5 + K6 at {key}: the two-pass call differs from K5 and K6 apart")
    return cases, plain, sdpa, twopass


# Substrings of the device kernel names of the backward's kernels in a trace.
TRACE_BWD_NAMES = {"delta": ("bwd_delta",), "K4": ("bwd_bf16_wgmma", "bwd_f32_tf32x3"),
                   "K5": ("bwd_dq_",), "K6": ("bwd_dkv_",)}


def twopass_steps(trainer, fused_launches: dict) -> dict:
    """Phase 10's second half: ``trainer`` under SIDLSG_FLASH_BWD=twopass
    (restored after).  Counters zeroed, one step under torch.profiler (the
    two-pass path's main run): losses finite, K5 and K6 once per attention
    backward (as many as K4's launches in the fused step), no K4, and in the
    trace one delta pre-pass per two-pass backward; then the median of
    TWOPASS_STEPS timed steps.  Returns that run's launches and the median."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sid_lsg_torch.ops import registry

    saved = os.environ.get("SIDLSG_FLASH_BWD")
    os.environ["SIDLSG_FLASH_BWD"] = "twopass"
    try:
        registry.reset()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            metrics = trainer.step()
            torch.cuda.synchronize()
        launches = registry.counts()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        traced = {k: sum(any(sub in n for sub in subs) for n in names)
                  for k, subs in TRACE_BWD_NAMES.items()}
        losses = {k: float(metrics[k]) for k in ("fake_score_loss", "g_loss")}
        print(f"[twopass] main step: losses {losses}, launches {launches}; traced device kernels "
              f"of the backward {traced}")
        require(all(math.isfinite(x) for x in losses.values()), f"twopass losses not finite: {losses}")
        want = fused_launches["flash_attn_bwd"]
        require(launches["flash_attn_bwd"] == 0 and want > 0
                and launches["flash_attn_bwd_dq"] == launches["flash_attn_bwd_dkv"] == want,
                f"twopass: K5/K6/K4 launches {launches} where K5 = K6 = {want} and K4 = 0")
        require(traced == {"delta": want, "K4": 0, "K5": want, "K6": want},
                f"twopass: traced kernels {traced} where the delta pre-pass, K5 and K6 each run "
                f"{want} times and K4 never")
        step_s = []
        for _ in range(TWOPASS_STEPS):
            t0 = time.perf_counter()
            trainer.step()
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
    finally:
        if saved is None:
            os.environ.pop("SIDLSG_FLASH_BWD", None)
        else:
            os.environ["SIDLSG_FLASH_BWD"] = saved
    return {"launches": launches, "median_s": statistics.median(step_s), "step_s": step_s}


def host_seconds(fn, runs: int = 5) -> list:
    """Seconds per call of ``fn`` on the host clock, each ending in a
    device synchronisation, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def encode_phase(pipe, images, x0, gen, card: str) -> None:
    """Phase 6a: the VAE encode of the generated batch."""
    import torch

    from sid_lsg_torch.ops import registry

    z = pipe.encode_images(images)  # warm-up
    torch.cuda.synchronize()
    registry.reset()
    with GNCalls() as gn_calls:
        z = pipe.encode_images(images)
        torch.cuda.synchronize()
    launches = registry.counts()
    enc_keys = {name: registry.launches_by_key(name) for name in SERVING_KERNELS}
    print(f"[encode] latents {tuple(z.shape)}, launches {launches}")
    require(z.shape == (BATCH, 64, 64, 4) and bool(torch.isfinite(z).all()),
            f"encode: latents {tuple(z.shape)} not finite")
    require(launches["flash_attn_fwd"] == 1, "encode: K1 did not launch once")
    require_gn_routes("encode", launches, gn_calls)
    for name in SERVING_KERNELS:
        for key in sorted(enc_keys[name], key=str):
            check_forward_kernel(name, key, gen)
    enc_s = host_seconds(lambda: pipe.encode_images(images))
    dec_s = host_seconds(lambda: pipe.decode(x0))
    print(f"[encode-time] seconds per encode of the batch (4, 512, 512, 3): {enc_s}, median "
          f"{statistics.median(enc_s)}; per decode of the batch: {dec_s}, median "
          f"{statistics.median(dec_s)}; on {card}")
    time_fwd_keys(enc_keys["flash_attn_fwd"], gen, "encode batch")
    time_gn_keys(enc_keys, gen, "encode batch")


def encode_latents_phase(pipe, images, ckpt: str, tmp: str, card: str) -> str:
    """Phase 6b: ``encode_latents`` on 8 PNGs; returns the corpus path."""
    import numpy as np
    import torch

    from sid_lsg_torch.cli import encode_latents
    from sid_lsg_torch.cli.pngio import write_png
    from sid_lsg_torch.data.latents import LatentDataset

    src = os.path.join(tmp, "images")
    os.makedirs(src)
    host = images.cpu().numpy()
    pngs = [host[i] for i in range(BATCH)] + [np.ascontiguousarray(host[i, :, ::-1])
                                               for i in range(BATCH)]
    for i, img in enumerate(pngs):
        write_png(os.path.join(src, f"{i:06d}.png"), img)
        with open(os.path.join(src, f"{i:06d}.txt"), "w") as f:
            f.write(PROMPTS[i % BATCH] + (", mirrored" if i >= BATCH else ""))
    corpus = os.path.join(tmp, "corpus.npz")
    t0 = time.perf_counter()
    encode_latents.main(["--source", src, "--dest", corpus, "--repo_id", ckpt, "--batch",
                         str(BATCH)])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    pairs = encode_latents.list_pairs(src)
    run_s = host_seconds(lambda: encode_latents.encode_corpus(pipe, pairs, BATCH, progress=False),
                         runs=3)
    med = statistics.median(run_s)
    print(f"[encode_latents] CLI on {len(pngs)} PNGs ({host.shape[2]}x{host.shape[1]}, batch "
          f"{BATCH}) in {cli_s:.3f} s, "
          f"checkpoint load included; the PNG reading and encode alone: {run_s} s, median {med}, "
          f"{len(pngs) / med} images/s; on {card}")
    ds = LatentDataset(corpus)
    got = torch.from_numpy(np.asarray(ds.latents, np.float32))
    encode = lambda: torch.cat([pipe.encode_images(torch.from_numpy(np.stack(pngs[i:i + BATCH])))
                                for i in range(0, len(pngs), BATCH)]).cpu()
    want, again = encode(), encode()
    from_card = pipe.encode_images(images).cpu()
    tol = 2.0 ** -8
    rms = want.square().mean().sqrt().item()
    ratio = ((got - want).abs() / (tol * (want.abs() + rms))).max().item()
    diff = lambda a, b: (a - b).abs().max().item()
    print(f"[encode_latents] corpus {tuple(got.shape)} f16, captions {len(ds.captions)}; against "
          f"encode_images of the same images (RMS {rms:.4e}): max abs {diff(got, want):.3e}, "
          f"err/tol {ratio:.3f} (rtol 2^-8, atol 2^-8 RMS); a second encode_images differs by "
          f"{diff(again, want):.3e}, the encode of the card's NCHW-strided batch by "
          f"{diff(from_card, want[:BATCH]):.3e}")
    require(len(ds) == len(pngs) and ds.captions[0] == PROMPTS[0], "corpus captions")
    require(ratio <= 1.0, "the corpus disagrees with encode_images beyond bf16 rounding")
    require(torch.equal(again, want) and torch.equal(from_card, want[:BATCH]),
            "encode_images depends on the call or on the input's strides")
    return corpus


def generator_files_phase(ema, ckpt: str, tmp: str, train_args) -> None:
    """Phase 10a: the EMA exported, then ``load_generator`` and ``--resume``."""
    import torch

    from sid_lsg_torch.diffusion.rng import StackedRandomGenerator
    from sid_lsg_torch.diffusion.sampling import sid_sampler
    from sid_lsg_torch.models.unet import unet_apply_fn
    from sid_lsg_torch.pipeline import SDPipeline
    from sid_lsg_torch.runtime.checkpoint import export_generator

    path = os.path.join(tmp, "network-snapshot-1-000000.safetensors")
    t0 = time.perf_counter()
    export_generator(ema, path)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pipe = SDPipeline.from_pretrained(ckpt, dtype=torch.bfloat16, device="cuda")
    pipe.load_generator(path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    latents = StackedRandomGenerator(range(BATCH), "cuda").randn((BATCH, 4, 64, 64))
    latents = latents.permute(0, 2, 3, 1)
    emb = pipe.encode_prompts(PROMPTS)
    x0 = pipe.generate_latents(latents, emb, init_timestep=INIT_TIMESTEP)
    apply = unet_apply_fn(pipe.config.unet, torch.bfloat16)
    with torch.inference_mode():
        init_t = torch.full((BATCH,), INIT_TIMESTEP, dtype=torch.int32, device="cuda")
        x0_ema = sid_sampler(lambda x, t, c: apply(ema, x, t, c), latents.permute(0, 3, 1, 2), emb,
                             init_t, pipe.scheduler, num_steps=1, dtype=torch.bfloat16)
    x0_ema = x0_ema.permute(0, 2, 3, 1)
    same = torch.equal(x0, x0_ema)
    print(f"[generator] EMA exported in {export_s:.3f} s ({os.path.getsize(path)} bytes); "
          f"from_pretrained + load_generator in {load_s:.3f} s; x0 bit-equal to the EMA applied "
          f"directly: {same} (max |diff| {(x0 - x0_ema).abs().max().item():.3e})")
    require(same, "load_generator's x0 differs from the EMA's")
    del pipe, x0, x0_ema
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    trainer = trainer_from_args(train_args + ["--resume", path])
    torch.cuda.synchronize()
    st = trainer.state
    unequal = {part: sum(not torch.equal(tree[k].detach(), ema[k]) for k in ema)
               for part, tree in (("G", st.params_G), ("psi", st.params_fake), ("EMA", st.ema))}
    print(f"[generator] Trainer with --resume built in {time.perf_counter() - t0:.3f} s; tensors "
          f"unequal to the export: {unequal} of {len(ema)}")
    require(all(set(tree) == set(ema) for tree in (st.params_G, st.params_fake, st.ema))
            and not any(unequal.values()), "--resume did not start from the exported EMA")
    del trainer, st
    torch.cuda.empty_cache()


def train_phases(card: str, gen, serving_keys, ckpt: str, tmp: str):
    """Phases 7-11; returns the kernels-line entries of K4, K5 and K6, the
    step's launch keys and phase 10's numbers."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from sid_lsg_torch.models.unet import unet_apply_fn
    from sid_lsg_torch.ops import registry
    from sid_lsg_torch.training.distill import make_train_step

    # 7. Train step at full width, remat flash, counters zeroed.
    train_args = with_flag(TRAIN_ARGS, "--sd_model", ckpt)
    t0 = time.perf_counter()
    trainer = trainer_from_args(train_args)
    torch.cuda.synchronize()
    print(f"[train] Trainer (the sd15 checkpoint, mb {TRAIN_BATCH}, kappa 1.5, bf16, remat "
          f"flash) built in {time.perf_counter() - t0:.3f} s, checkpoint load included")
    st = trainer.state
    before = {part: {k: v.detach().clone() for k, v in getattr(st, part).items()}
              for part in ("params_G", "params_fake", "ema")}
    registry.reset()
    t0 = time.perf_counter()
    with K1Sweep() as sweep, GNCalls() as gn_calls:
        metrics = trainer.step()
        torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    train_launches = registry.counts()
    train_keys = {name: registry.launches_by_key(name) for name in registry.KERNELS}
    losses = {k: float(metrics[k]) for k in ("fake_score_loss", "g_loss")}
    print(f"[train] main step in {first_s:.3f} s: losses {losses}, launches {train_launches}, "
          f"K1 in forwards with grad {sweep.forward_grad}, K1 in the backward sweep "
          f"{sweep.backward}")
    require(all(math.isfinite(x) for x in losses.values()), f"losses not finite: {losses}")
    for name in ("flash_attn_fwd", "flash_attn_bwd"):
        require(train_launches[name] > 0, f"{name} was not launched by the train step")
    require_gn_routes("train", train_launches, gn_calls)
    require(sweep.forward_grad > 0 and sweep.backward == 0,
            "remat flash: the backward sweep launched the forward attention kernel")
    for part, old in before.items():
        new = getattr(st, part)
        changed = sum(not torch.equal(old[k], new[k].detach()) for k in old)
        print(f"[train] {part}: {changed} of {len(old)} tensors changed")
        require(changed >= 0.99 * len(old), f"{part}: only {changed} of {len(old)} tensors changed")
    del before
    step_full = make_train_step(unet_apply_fn(trainer.pipe.config.unet, torch.bfloat16, "full"),
                                trainer.pipe.scheduler, trainer.dcfg, trainer.opt_g,
                                trainer.opt_fake)
    registry.reset()
    full_s = []
    with K1Sweep() as full:
        for _ in range(2):
            t0 = time.perf_counter()
            trainer.state, _ = step_full(trainer.state, trainer.teacher, trainer.next_batch(),
                                         trainer.generator)
            torch.cuda.synchronize()
            full_s.append(time.perf_counter() - t0)
    full.forward_grad //= 2
    full.backward //= 2
    print(f"[train] remat full: K1 in forwards with grad {full.forward_grad}, in the backward "
          f"sweep {full.backward} per step; remat flash: {sweep.forward_grad} and "
          f"{sweep.backward}; remat full seconds per step {full_s}")
    require(full.backward == full.forward_grad == sweep.forward_grad > 0,
            "remat full: not one backward-sweep K1 launch per attention")

    # 8. Kernel check at the step's shapes.
    max_abs = {name: 0.0 for name in BWD_KERNELS}
    bwd = {key: check_bwd(key, gen, max_abs)
           for key in sorted(train_keys["flash_attn_bwd"], key=str)}
    for name in SERVING_KERNELS:
        for key in sorted(set(train_keys[name]) - set(serving_keys[name]), key=str):
            check_forward_kernel(name, key, gen)

    # 9. Small reference for training: tiny, f32, card vs CPU.
    registry.reset()
    tiny_card = tiny_train_grads("cuda")
    tiny_launches = registry.counts()
    tiny_cpu = tiny_train_grads("cpu")
    print(f"[tiny-train] losses card {tiny_card[0]}, CPU {tiny_cpu[0]}; card launches "
          f"{tiny_launches}")
    for name in ("flash_attn_fwd", "flash_attn_bwd", "gn_fused"):
        require(tiny_launches[name] > 0, f"tiny train: {name} not launched on the card")
    compare_tiny("tiny-train", tiny_card, tiny_cpu)

    # 10. Train-step timing, trace, FLOPs.
    torch.cuda.reset_peak_memory_stats()
    step_s = []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        trainer.step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    med = statistics.median(step_s)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"[train-time] seconds per step (SD1.5, batch {TRAIN_BATCH}, kappa 1.5, bf16, remat "
          f"flash): {step_s}, median {med}, {TRAIN_BATCH / med} images/s, peak device memory "
          f"{peak_gib:.3f} GiB on {card}")
    trace("one train step", trainer.step, top=20, host_top=20)
    with FlopCounterMode(display=False) as counter:
        trainer.step()
    counted = counter.get_total_flops()
    attn = (attention_flops(train_keys["flash_attn_fwd"], 4)
            + attention_flops(train_keys["flash_attn_bwd"], 10))
    total = counted + attn
    print(f"[train-flops] per step: FlopCounterMode {counted:.6e} (the remat recompute of "
          f"convolutions and projections included), attention kernels {attn:.6e}, total "
          f"{total:.6e}; mfu {total / med / PEAK_FLOPS['torch.bfloat16']:.4f} (over 989 TFLOP/s "
          f"at the median step time)")
    twopass = twopass_steps(trainer, train_launches)
    print(f"[train-time] seconds per step under SIDLSG_FLASH_BWD=twopass (K5 + K6): "
          f"{twopass['step_s']}, median {twopass['median_s']}; fused (K4): median {med}; on {card}")
    ema = trainer.state.ema
    del trainer
    torch.cuda.empty_cache()
    generator_files_phase(ema, ckpt, tmp, train_args)
    del ema
    torch.cuda.empty_cache()
    phase10 = {"median_s": med, "images_per_s": TRAIN_BATCH / med, "peak_gib": peak_gib}

    # 11. Backward kernel timing at the step's shapes, summed over one step.
    entries = []
    rows = {name: {"ms": 0.0, "base_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "ops_ms": 0.0,
                   "bytes_ms": 0.0, "library_ms": 0.0} for name in BWD_KERNELS}
    twopass_ms = 0.0
    for key, (cases, plain, (sdpa_fwd, sdpa_both), twopass_fn) in sorted(bwd.items(),
                                                                          key=lambda kv: str(kv[0])):
        n = train_keys["flash_attn_bwd"][key]
        plain_ms = time_ms(plain)
        sdpa_bwd_ms = time_ms(sdpa_both) - time_ms(sdpa_fwd)
        tp_ms = time_ms(twopass_fn)
        twopass_ms += n * tp_ms
        print(f"[time] flash_attn_bwd_twopass {key} x{n}: {tp_ms:.4f} ms (one call: delta, K5, K6)")
        for name, (kern, _, nbytes, flops) in cases.items():
            ops_ms = flops / PEAK_FLOPS[key[2]] * 1e3
            bytes_ms = nbytes / PEAK_BYTES * 1e3
            ms = time_ms(kern)
            base = baseline_ms(kern)
            r = rows[name]
            for f, x in (("ms", ms), ("base_ms", base), ("plain_ms", plain_ms),
                         ("bound_ms", max(ops_ms, bytes_ms)), ("ops_ms", ops_ms),
                         ("bytes_ms", bytes_ms), ("library_ms", sdpa_bwd_ms)):
                r[f] += n * x
            print(f"[time] {name} {key} x{n}: {ms:.4f} ms, baseline {base:.4f}, plain "
                  f"{plain_ms:.4f}, bound {max(ops_ms, bytes_ms):.4f}, SDPA backward "
                  f"{sdpa_bwd_ms:.4f}")
    for name in BWD_KERNELS:
        r = rows[name]
        launched = train_launches if name == "flash_attn_bwd" else twopass["launches"]
        entries.append({
            "name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1], "launches": launched[name],
            "max_abs_err": max_abs[name], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": "operations" if r["ops_ms"] > r["bytes_ms"] else "bytes",
            "library_ms": r["library_ms"] if name == "flash_attn_bwd" else None,
        })
    k4, k5, k6 = (rows[n] for n in BWD_KERNELS)
    print(f"[time] per train step: K4 {k4['ms']:.4f} ms, baseline {k4['base_ms']:.4f} ms, bound "
          f"{k4['bound_ms']:.4f} ms; K5 {k5['ms']:.4f} ms, baseline {k5['base_ms']:.4f} ms, bound "
          f"{k5['bound_ms']:.4f} ms; K6 {k6['ms']:.4f} ms, baseline {k6['base_ms']:.4f} ms, bound "
          f"{k6['bound_ms']:.4f} ms; K5 + K6 {k5['ms'] + k6['ms']:.4f} ms (baseline "
          f"{k5['base_ms'] + k6['base_ms']:.4f} ms), as one two-pass call {twopass_ms:.4f} ms; SDPA "
          f"backward {k4['library_ms']:.4f} ms")
    time_fwd_keys(train_keys["flash_attn_fwd"], gen, "train step")
    time_gn_keys(train_keys, gen, "train step")
    return entries, train_keys, phase10

def fingerprints(tree) -> "torch.Tensor":
    """Per tensor of ``tree``: (sum, sum of squares) in f64, on the host."""
    import torch

    with torch.no_grad():
        return torch.stack([torch.stack([v.double().sum(), v.double().square().sum()])
                            for v in tree.values()]).cpu()


def load_baseline_bias_act(root: str):
    """The baseline's ``sid_lsg_torch/ops/bias_act.py``, loaded beside this
    tree's package (its relative imports take this tree's ``_build`` and
    ``registry``) with its ``library`` bound to the baseline's kernels: the
    baseline's K7 behind the baseline's own host path."""
    import importlib.util

    import sid_lsg_torch.ops  # noqa: F401  (the package the module's relative imports name)

    path = Path(root) / "sid_lsg_torch" / "ops" / "bias_act.py"
    spec = importlib.util.spec_from_file_location("sid_lsg_torch.ops._baseline_bias_act", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # dataclasses look their module up there
    spec.loader.exec_module(mod)
    mod.library = lambda: BASELINE
    return mod


# The baseline's bias_act module (None without ``--baseline``).
BASELINE_BIAS_ACT = None


def bias_act_case(key, gen, act=None, gain=None, clamp=None) -> dict:
    """K7 at one recorded launch key (or that shape with another activation,
    gain and clamp), on fresh inputs: the kernel, its plain version, the
    library call (``torch.add`` for a linear bias, else None), the
    baseline's K7 (None without ``--baseline``), the tolerance and (bytes,
    operations, type)."""
    import torch

    from sid_lsg_torch import ops

    shape, dt, dim, path_act, has_bias, alpha, path_gain, path_clamp = key
    if act is None:
        act, gain, clamp = path_act, path_gain, path_clamp
    else:
        alpha = None
    dtype = getattr(torch, dt.split(".")[1])
    x = (torch.randn(shape, generator=gen, device="cuda") * 2).to(dtype)
    b = torch.randn(shape[dim], generator=gen, device="cuda").to(dtype) if has_bias else None
    bview = None if b is None else b.view([-1 if i == dim else 1 for i in range(len(shape))])
    n, es = x.numel(), x.element_size()
    return {"kern": lambda: ops.bias_act_fwd(x, b, dim, act, alpha, gain, clamp),
            "plain": lambda: ops.bias_act_ref(x.float(), None if b is None else b.float(), dim,
                                              act, alpha, gain, clamp),
            "library": (lambda: torch.add(x, bview)) if act == "linear" and b is not None else None,
            "baseline": BASELINE_BIAS_ACT and (lambda: BASELINE_BIAS_ACT.bias_act_fwd(
                x, b, dim, act, alpha, gain, clamp)),
            "tol": TOL_BF16 if dtype == torch.bfloat16 else TOL_F32,
            "work": (2 * n * es + (0 if b is None else b.numel() * es), 4 * n, "torch.float32")}


def check_bias_act(key, gen, label, **kw) -> float:
    import torch

    c = bias_act_case(key, gen, **kw)
    got, ref = c["kern"](), c["plain"]()
    torch.cuda.synchronize()
    return check_outputs(f"bias_act {label} {key} {kw}", (got,), (ref,), c["tol"])


def host_us(fn, calls: int = 2000) -> float:
    """Host time of one call of ``fn`` in microseconds: ``time.perf_counter``
    around ``calls`` calls with no synchronisation, after a synchronised
    warm-up (what the host pays per call, whatever the device does)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


K7_ROUNDS = 5
K7_TIMES = ("ms", "device_ms", "host_us")  # host-paced, device alone, host per call
K7_PREFIXES = ("", "library_", "base_")  # K7, torch.add, the baseline's K7


def time_bias_act(c) -> dict:
    """K7 on one case of ``bias_act_case``, beside ``torch.add`` and the
    baseline's K7 (0.0 where absent), in ``K7_ROUNDS`` rounds that take each
    in turn: host-paced (``ms``: ``time_ms``, CUDA events around
    back-to-back calls, as the attention kernels are timed), on the device
    alone (``device_ms``: 100 calls queued behind the spin kernel) and host
    time per call (``host_us``), each the median over the rounds with its
    (least, most) under ``<name>_range``; the plain version host-paced; the
    bound."""
    nbytes, flops, op_type = c["work"]
    ops_ms, bytes_ms = flops / PEAK_FLOPS[op_type] * 1e3, nbytes / PEAK_BYTES * 1e3
    fns = dict(zip(K7_PREFIXES, (c["kern"], c["library"], c["baseline"])))
    samples = collections.defaultdict(list)
    for _ in range(K7_ROUNDS):
        for prefix, fn in fns.items():
            if fn:
                for name, timer in zip(K7_TIMES, (time_ms, lambda f: device_ms(f, iters=100),
                                                  host_us)):
                    samples[prefix + name].append(timer(fn))
    row = {"plain_ms": time_ms(c["plain"]), "bound_ms": max(ops_ms, bytes_ms), "ops_ms": ops_ms,
           "bytes_ms": bytes_ms}
    for field in (p + name for p in K7_PREFIXES for name in K7_TIMES):
        vals = samples.get(field, [0.0])
        row[field] = statistics.median(vals)
        row[field + "_range"] = (min(vals), max(vals))
    return row


def k7_text(row, field: str, scale: float, unit: str) -> str:
    """One K7 time of ``time_bias_act``'s row (or a sum of rows) beside
    torch.add's and the baseline's: medians, ranges and the ratio to
    torch.add."""
    def one(prefix):
        lo, hi = row[prefix + field + "_range"]
        return f"{row[prefix + field] * scale:.3f} [{lo * scale:.3f}-{hi * scale:.3f}]"
    ratio = row[field] / row["library_" + field] if row["library_" + field] else 0.0
    return (f"K7 {one('')} {unit} (torch.add {one('library_')}, K7/torch.add {ratio:.3f}; "
            f"baseline K7 {one('base_')})")


def sida_phases(card: str, gen, checked, phase10, ckpt: str, corpus: str) -> dict:
    """Phases 12-16; returns the kernels-line entry of K7."""
    import torch
    from torch.nn.attention import SDPBackend

    from sid_lsg_torch import ops
    from sid_lsg_torch.models.stylegan_discriminator import spectral_buffers
    from sid_lsg_torch.ops import registry

    # 12. SiDA step at full width (dino tower), counters zeroed.
    sida_args = with_flag(with_flag(SIDA_ARGS, "--sd_model", ckpt), "--adv_data", corpus)
    t0 = time.perf_counter()
    trainer = trainer_from_args(sida_args)
    torch.cuda.synchronize()
    print(f"[sida] Trainer (the sd15 checkpoint, mb {SIDA_BATCH}, dino ViT-S/16 random, real "
          f"latents from the encode_latents corpus) built in {time.perf_counter() - t0:.3f} s")
    require(trainer.latents is not None and len(trainer.latents.dataset) == 2 * BATCH,
            "the SiDA trainer does not read the encode_latents corpus")
    st = trainer.state
    psi = {k: v for k, v in st.params_fake.items() if not k.startswith("disc.")}
    heads = {k: v for k, v in st.params_fake.items() if k.startswith("disc.")}
    parts = {"params_G": st.params_G, "psi": psi, "disc heads": heads, "ema": st.ema}
    before = {name: fingerprints(tree) for name, tree in parts.items()}
    u_before = {k: v.clone() for k, v in spectral_buffers(trainer.disc).items()}
    registry.reset()
    t0 = time.perf_counter()
    with GNCalls() as gn_calls:
        metrics = trainer.step()
        torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = registry.counts()
    sida_keys = {name: registry.launches_by_key(name) for name in registry.KERNELS}
    names = ("fake_score_loss", "g_loss", "adv_d_loss", "adv_g_loss", "d_logit_real", "d_logit_fake")
    vals = {k: float(metrics[k]) for k in names}
    print(f"[sida] main step in {first_s:.3f} s: {vals}, launches {launches}")
    require(all(math.isfinite(x) for x in vals.values()), f"SiDA losses not finite: {vals}")
    for name in ("flash_attn_fwd", "flash_attn_bwd", "bias_act"):
        require(launches[name] > 0, f"{name} was not launched by the SiDA step")
    require_gn_routes("sida", launches, gn_calls)
    for want in (((SIDA_BATCH, 1, 4096, 512),) * 2 + ("torch.float32",),
                 ((SIDA_BATCH, 6, 197, 64),) * 2 + ("torch.float32",)):
        require(sida_keys["flash_attn_bwd"][want] > 0, f"K4 was not launched at {want}")
    st = trainer.state
    after = {"params_G": st.params_G, "ema": st.ema,
             "psi": {k: v for k, v in st.params_fake.items() if not k.startswith("disc.")},
             "disc heads": {k: v for k, v in st.params_fake.items() if k.startswith("disc.")}}
    for name, old in before.items():
        new = fingerprints(after[name])
        changed = int((new != old).any(dim=1).sum())
        print(f"[sida] {name}: {changed} of {len(old)} tensors changed")
        require(changed >= 0.99 * len(old), f"{name}: only {changed} of {len(old)} tensors changed")
    u_changed = sum(not torch.equal(v, u_before[k]) for k, v in spectral_buffers(trainer.disc).items())
    print(f"[sida] spectral u: {u_changed} of {len(u_before)} changed")
    require(u_changed == len(u_before), "not every spectral u was refreshed")

    # 15. SiDA step timing and trace (the dino trainer), beside phase 10.
    torch.cuda.reset_peak_memory_stats()
    step_s = []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        trainer.step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    med = statistics.median(step_s)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"[sida-time] seconds per SiDA step (SD1.5, batch {SIDA_BATCH}, kappa 1.5, bf16, remat "
          f"flash, dino ViT-S/16): {step_s}, median {med}, {SIDA_BATCH / med} images/s, peak device "
          f"memory {peak_gib:.3f} GiB; phase 10's step: median {phase10['median_s']}, "
          f"{phase10['images_per_s']} images/s, peak {phase10['peak_gib']:.3f} GiB; on {card}")
    trace("one SiDA step", trainer.step, top=20, host_top=15)
    del trainer, st, parts, psi, heads, after
    torch.cuda.empty_cache()

    # 12 (second half). One step of the encoder tower.
    trainer = trainer_from_args(with_flag(sida_args, "--adv_tower", "encoder"))
    registry.reset()
    t0 = time.perf_counter()
    with GNCalls() as gn_calls:
        metrics = trainer.step()
        torch.cuda.synchronize()
    enc_launches = registry.counts()
    vals = {k: float(metrics[k]) for k in names}
    print(f"[sida] encoder tower step in {time.perf_counter() - t0:.3f} s: {vals}, launches "
          f"{enc_launches}")
    require(all(math.isfinite(x) for x in vals.values()), f"encoder-tower losses not finite: {vals}")
    for name in ("flash_attn_fwd", "flash_attn_bwd"):
        require(enc_launches[name] > 0, f"{name} was not launched by the encoder-tower step")
    require_gn_routes("sida encoder", enc_launches, gn_calls)
    del trainer
    torch.cuda.empty_cache()

    # 13. Kernel check at the SiDA step's shapes.
    max_abs = 0.0
    for key in sorted(sida_keys["bias_act"], key=str):
        max_abs = max(max_abs, check_bias_act(key, gen, "path"))
        for act in ops.activation_funcs:
            check_bias_act(key, gen, "path shape", act=act, gain=1.3, clamp=5.0)
    for dt in ("torch.float32", "torch.bfloat16"):
        off = ((8, 512, 32, 32), dt, 1, "linear", True, 0.0, 1.0, -1.0)
        for act in ops.activation_funcs:
            check_bias_act(off, gen, "off the path", act=act, gain=1.3, clamp=5.0)
    new_bwd = sorted(set(sida_keys["flash_attn_bwd"]) - checked["flash_attn_bwd"], key=str)
    bwd = {key: check_bwd(key, gen, {}) for key in new_bwd}
    for name in SERVING_KERNELS:
        for key in sorted(set(sida_keys[name]) - checked[name], key=str):
            check_forward_kernel(name, key, gen)

    # 14. Small reference for SiDA: tiny + TINY_VIT, card vs CPU, both towers.
    for tower in ("encoder", "dino"):
        registry.reset()
        tiny_card = tiny_train_grads("cuda", tower)
        tiny = registry.counts()
        tiny_cpu = tiny_train_grads("cpu", tower)
        print(f"[tiny-sida] {tower}: losses card {tiny_card[0]}, CPU {tiny_cpu[0]}; card launches "
              f"{tiny}")
        for name in ("flash_attn_bwd",) + (("bias_act",) if tower == "dino" else ()):
            require(tiny[name] > 0, f"tiny SiDA {tower}: {name} not launched on the card")
        compare_tiny(f"tiny-sida {tower}", tiny_card, tiny_cpu)

    # 16. SiDA kernel timing, summed over one step.
    tot = collections.defaultdict(float)
    for key, n in sorted(sida_keys["bias_act"].items(), key=lambda kv: str(kv[0])):
        row = time_bias_act(bias_act_case(key, gen))
        for f, v in row.items():
            if f.endswith("_range"):
                tot[f] = tuple(n * x + y for x, y in zip(v, tot.get(f, (0.0, 0.0))))
            else:
                tot[f] += n * v
        print(f"[k7-time] bias_act {key} x{n}, medians [ranges] over {K7_ROUNDS} rounds: "
              f"host-paced {k7_text(row, 'ms', 1e3, 'us')}; device alone "
              f"{k7_text(row, 'device_ms', 1e3, 'us')}; host per call "
              f"{k7_text(row, 'host_us', 1.0, 'us')}; plain {row['plain_ms'] * 1e3:.3f} us; bound "
              f"{row['bound_ms'] * 1e3:.5f} us")
    calls = launches["bias_act"]
    print(f"[k7-time] per SiDA step ({calls} launches): host-paced {k7_text(tot, 'ms', 1.0, 'ms')}; "
          f"device alone {k7_text(tot, 'device_ms', 1.0, 'ms')}; plain {tot['plain_ms']:.5f} ms; "
          f"bound {tot['bound_ms']:.7f} ms")
    for dt in ("torch.float32", "torch.bfloat16"):
        off = ((8, 512, 32, 32), dt, 1, "linear", True, 0.0, 1.0, -1.0)
        row = time_bias_act(bias_act_case(off, gen))
        print(f"[k7-time] bias_act {off} (off the path): device alone "
              f"{k7_text(row, 'device_ms', 1e3, 'us')}; bytes bound {row['bytes_ms'] * 1e3:.3f} us "
              f"(share {row['bytes_ms'] / row['device_ms']:.3f})")
    k4 = dict.fromkeys(("ms", "base_ms", "k5_ms", "k5_base_ms", "k6_ms", "k6_base_ms", "twopass_ms",
                        "bound_ms", "k5_bound_ms", "k6_bound_ms", "plain_ms", "sdpa_ms"), 0.0)
    for key, (cases, plain, (sdpa_fwd, sdpa_both), twopass_fn) in bwd.items():
        n = sida_keys["flash_attn_bwd"][key]
        bounds = {name: max(flops / PEAK_FLOPS[key[2]], nbytes / PEAK_BYTES) * 1e3
                  for name, (_, _, nbytes, flops) in cases.items()}
        kern, k5, k6 = (cases[name][0] for name in BWD_KERNELS)
        row = {"ms": time_ms(kern), "base_ms": baseline_ms(kern), "k5_ms": time_ms(k5),
               "k5_base_ms": baseline_ms(k5), "k6_ms": time_ms(k6), "k6_base_ms": baseline_ms(k6),
               "twopass_ms": time_ms(twopass_fn),
               "bound_ms": bounds["flash_attn_bwd"], "k5_bound_ms": bounds["flash_attn_bwd_dq"],
               "k6_bound_ms": bounds["flash_attn_bwd_dkv"], "plain_ms": time_ms(plain),
               "sdpa_ms": time_ms(sdpa_both) - time_ms(sdpa_fwd)}
        q = torch.empty(key[0], device="cuda", dtype=getattr(torch, key[2].split(".")[1]))
        backend = SDPBackend(torch._fused_sdp_choice(q, q, q)).name
        for f in k4:
            k4[f] += n * row[f]
        print(f"[time] flash_attn_bwd {key} x{n}: K4 {row['ms']:.4f} ms (baseline "
              f"{row['base_ms']:.4f}, bound {row['bound_ms']:.4f}); K5 {row['k5_ms']:.4f} (baseline "
              f"{row['k5_base_ms']:.4f}, bound {row['k5_bound_ms']:.4f}); K6 {row['k6_ms']:.4f} "
              f"(baseline {row['k6_base_ms']:.4f}, bound {row['k6_bound_ms']:.4f}); two-pass call "
              f"{row['twopass_ms']:.4f}; plain {row['plain_ms']:.4f}; SDPA backward "
              f"{row['sdpa_ms']:.4f} ({backend})")
    print(f"[time] per SiDA step at the new f32 shapes: K4 {k4['ms']:.4f} ms (baseline "
          f"{k4['base_ms']:.4f}, bound {k4['bound_ms']:.4f}); K5 {k4['k5_ms']:.4f} ms (baseline "
          f"{k4['k5_base_ms']:.4f}, bound {k4['k5_bound_ms']:.4f}); K6 {k4['k6_ms']:.4f} ms (baseline "
          f"{k4['k6_base_ms']:.4f}, bound {k4['k6_bound_ms']:.4f}); K5 + K6 "
          f"{k4['k5_ms'] + k4['k6_ms']:.4f} ms (baseline {k4['k5_base_ms'] + k4['k6_base_ms']:.4f}), "
          f"as one two-pass call {k4['twopass_ms']:.4f} ms; plain {k4['plain_ms']:.4f}; SDPA backward "
          f"{k4['sdpa_ms']:.4f} ms")
    new_fwd = {key: n for key, n in sida_keys["flash_attn_fwd"].items()
               if key not in checked["flash_attn_fwd"]}
    time_fwd_keys(new_fwd, gen, "SiDA step at the shapes the train step lacks")
    time_gn_keys(sida_keys, gen, "SiDA step")
    # ms, plain_ms and library_ms host-paced, as K1's and K4's; K7's and
    # torch.add's device-alone time and host us per call beside them.
    return {"name": "bias_act", "route": "cuda", "source": SOURCES["bias_act"][0],
            "replaces": SOURCES["bias_act"][1], "launches": calls,
            "max_abs_err": max_abs, "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"],
            "bound_by": "operations" if tot["ops_ms"] > tot["bytes_ms"] else "bytes",
            "library_ms": tot["library_ms"], "device_ms": tot["device_ms"],
            "library_device_ms": tot["library_device_ms"], "host_us": tot["host_us"] / calls,
            "library_host_us": tot["library_host_us"] / calls}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--baseline", default=None,
                        help="root of another checkout whose K1, K4 and GroupNorm kernels are "
                             "timed beside this one's (built from its sid_lsg_torch/csrc)")
    baseline = parser.parse_args(argv).baseline
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    from sid_lsg_torch.diffusion.rng import StackedRandomGenerator
    from sid_lsg_torch.models import SD15, TINY, CLIPTokenizer
    from sid_lsg_torch.ops import _build, registry
    from sid_lsg_torch.pipeline import SDPipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 1. Build.
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    build_s = time.perf_counter() - t0
    print(f"[build] {lib_path} in {build_s:.3f} s")
    print(f"[card] {card}")
    print_kernel_build(lib_path)
    if baseline:
        global BASELINE, BASELINE_BIAS_ACT
        BASELINE = load_baseline(baseline)
        BASELINE_BIAS_ACT = load_baseline_bias_act(baseline)

    # 1b. The checkpoint, under a temporary directory removed at exit.
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    atexit.register(shutil.rmtree, tmp, True)
    ckpt = os.path.join(tmp, "sd15")
    t0 = time.perf_counter()
    rounded = write_checkpoint(ckpt)
    torch.cuda.synchronize()
    print(f"[ckpt] SD1.5-width HF-layout checkpoint (random weights, seed 0, F16) written in "
          f"{time.perf_counter() - t0:.3f} s: {dir_bytes(ckpt)} bytes")

    # 2. Load, against a pipeline built directly from the same weights; warm-up
    # generation, which records every kernel input shape of the path.
    t0 = time.perf_counter()
    pipe = SDPipeline.from_pretrained(ckpt, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    print(f"[load] from_pretrained of the checkpoint (bf16, on the card) in "
          f"{time.perf_counter() - t0:.3f} s on {card}")
    cfg = pipe.config
    require((cfg.unet, cfg.vae, cfg.text) == (SD15.unet, SD15.vae, SD15.text),
            f"the checkpoint's config is not SD1.5's: {cfg}")
    require(isinstance(pipe.tokenizer, CLIPTokenizer), f"tokenizer {type(pipe.tokenizer)}")
    direct = SDPipeline(SD15, rounded, tokenizer=pipe.tokenizer, dtype=torch.bfloat16,
                        device="cuda")
    del rounded
    latents = StackedRandomGenerator(range(BATCH), "cuda").randn((BATCH, 4, 64, 64)).permute(0, 2, 3, 1)
    emb, emb_direct = pipe.encode_prompts(PROMPTS), direct.encode_prompts(PROMPTS)
    x0 = pipe.generate_latents(latents, emb, init_timestep=INIT_TIMESTEP)
    x0_direct = direct.generate_latents(latents, emb_direct, init_timestep=INIT_TIMESTEP)
    same = torch.equal(emb, emb_direct) and torch.equal(x0, x0_direct)
    print(f"[load] loaded vs built from the state dicts: embeddings and x0 bit-equal {same} (max "
          f"|x0 diff| {(x0 - x0_direct).abs().max().item():.3e})")
    require(same, "the loaded pipeline's x0 differs from the directly built one's")
    del direct, emb_direct, x0_direct
    torch.cuda.empty_cache()
    registry.reset()
    emb = pipe.encode_prompts(PROMPTS)
    x0 = pipe.generate_latents(latents, emb, init_timestep=INIT_TIMESTEP)
    images = pipe.decode(x0)
    torch.cuda.synchronize()
    require(x0.shape == (BATCH, 64, 64, 4) and bool(torch.isfinite(x0).all()), "x0 not finite")
    require(images.shape == (BATCH, 512, 512, 3) and images.dtype == torch.uint8,
            f"images {tuple(images.shape)} {images.dtype}")
    per_image_std = images.float().flatten(1).std(dim=1)
    require(bool((per_image_std > 0).all()), f"constant image(s): std {per_image_std.tolist()}")
    keys = {name: registry.launches_by_key(name) for name in SERVING_KERNELS}
    print(f"[warm-up] x0 finite, images {tuple(images.shape)} std {per_image_std.tolist()}")

    # 3. Kernel check at every shape the generation launched.
    gen = torch.Generator("cuda").manual_seed(1234)
    max_abs = {}
    for name in SERVING_KERNELS:
        require(keys[name], f"{name}: the warm-up generation never launched it")
        max_abs[name] = max(check_forward_kernel(name, key, gen) for key in sorted(keys[name], key=str))
    check_parity_f32(gen)

    # 4. Small reference: tiny preset, card (kernels) vs CPU (plain versions), f32.
    cpu = SDPipeline.random_init("tiny", dtype=torch.float32, device="cpu", seed=0)
    sds = {"unet": cpu.unet.state_dict(), "vae": cpu.vae.state_dict(),
           "text": cpu.text_model.state_dict()}
    card_tiny = SDPipeline(TINY, sds, dtype=torch.float32, device="cuda")
    small = StackedRandomGenerator([7, 8], "cpu").randn((2, 4, 8, 8)).permute(0, 2, 3, 1)
    x0_cpu = cpu.generate_latents(small, cpu.encode_prompts(PROMPTS[:2]))
    x0_card = card_tiny.generate_latents(small, card_tiny.encode_prompts(PROMPTS[:2])).cpu()
    img_cpu = cpu.decode(x0_cpu)
    img_card = card_tiny.decode(x0_cpu).cpu()
    x0_abs, _, x0_ratio, _ = close_errors(x0_card, x0_cpu, atol=5e-4, rtol=1e-3)
    img_delta = (img_card.int() - img_cpu.int()).abs().max().item()
    print(f"[tiny] card vs CPU: x0 max abs {x0_abs:.3e} (err/tol {x0_ratio:.3f}), "
          f"images max uint8 delta {img_delta}")
    require(x0_ratio <= 1.0 and img_delta <= 1, "tiny preset: card disagrees with the CPU")
    pixels = torch.rand((2, 3, 16, 16), generator=torch.Generator().manual_seed(5)) * 2 - 1
    with torch.inference_mode():
        moments_cpu = cpu.vae.encode_moments(pixels)
        registry.reset()
        moments_card = card_tiny.vae.encode_moments(pixels.cuda())
        enc_tiny = registry.counts()
    for name, got, ref in zip(("mean", "logvar"), moments_card, moments_cpu):
        m_abs, _, m_ratio, _ = close_errors(got.cpu(), ref, atol=5e-4, rtol=1e-3)
        print(f"[tiny] encoder {name} card vs CPU: max abs {m_abs:.3e} (err/tol {m_ratio:.3f}); "
              f"card launches {enc_tiny}")
        require(m_ratio <= 1.0, f"tiny encoder {name}: card disagrees with the CPU")
    require(enc_tiny["flash_attn_fwd"] == 1, "tiny encoder: K1 not launched on the card")

    # 5. Main path: counters zeroed, one generate, every kernel launched.
    registry.reset()
    t0 = time.perf_counter()
    with GNCalls() as gn_calls:
        images = pipe.generate(PROMPTS, latents, init_timestep=INIT_TIMESTEP)
        torch.cuda.synchronize()
    batch_s = [time.perf_counter() - t0]
    launches = registry.counts()
    main_keys = {name: registry.launches_by_key(name) for name in SERVING_KERNELS}
    print(f"[main] launches {launches}")
    for name in SERVING_KERNELS:
        require(launches[name] > 0, f"{name} was not launched on the main path")
    require_gn_routes("main", launches, gn_calls)
    require(images.shape == (BATCH, 512, 512, 3), f"images {tuple(images.shape)}")
    for _ in range(9):
        t0 = time.perf_counter()
        pipe.generate(PROMPTS, latents, init_timestep=INIT_TIMESTEP)
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t0)
    print(f"[main] per-batch seconds (batch {BATCH}, 512x512, 1 step): {batch_s}, "
          f"median {statistics.median(batch_s)} on {card}")
    trace("one generate", lambda: pipe.generate(PROMPTS, latents, init_timestep=INIT_TIMESTEP))

    # 6. Timing at the main path's shapes, summed over one main-path run.
    tot = time_fwd_keys(main_keys["flash_attn_fwd"], gen, "batch")
    kernels = [{
        "name": "flash_attn_fwd", "route": "cuda", "source": SOURCES["flash_attn_fwd"][0],
        "replaces": SOURCES["flash_attn_fwd"][1], "launches": launches["flash_attn_fwd"],
        "max_abs_err": max_abs["flash_attn_fwd"], "ms": tot["ms"], "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"],
        "bound_by": "operations" if tot["ops_ms"] > tot["bytes_ms"] else "bytes",
        "library_ms": tot["library_ms"],
    }]
    gn_tot = time_gn_keys(main_keys, gen, "serving batch")
    kernels += [gn_entry(name, launches[name], max_abs[name], gn_tot[name]) for name in GN_KERNELS]

    del card_tiny, cpu
    encode_phase(pipe, images, x0, gen, card)
    corpus = encode_latents_phase(pipe, images, ckpt, tmp, card)
    del pipe
    torch.cuda.empty_cache()
    train_entries, train_keys, phase10 = train_phases(card, gen, keys, ckpt, tmp)
    kernels += train_entries
    checked = {name: set(keys.get(name, ())) | set(train_keys[name]) for name in registry.KERNELS}
    kernels.append(sida_phases(card, gen, checked, phase10, ckpt, corpus))

    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
