#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (``sid_lsg_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It drives the port's three paths at full SD1.5 width on random weights from
a seed, through the CUDA kernels built from ``sid_lsg_torch/csrc``: one-step
text-to-image generation (batch 4, 512x512, init_timestep 625; phases 2-6),
the SiD-LSG distillation train step (phases 7-11) and the SiDA adversarial
train step (phases 12-16).

1. Build: compile the kernels with nvcc for sm_90a; print the build time and
   the card's name and power limit.
2. Warm-up generation: text -> UNet -> x0 -> VAE decode once; the launch
   counters record every distinct kernel input shape of the path; x0 must be
   finite and the images of the right shape and not constant.
3. Kernel check: each kernel against its plain PyTorch version at every
   shape the generation launched, in that shape's dtype, TF32 off.  f32
   outputs within atol 1e-4 / rtol 1e-3; bf16 outputs within atol 2e-2 /
   rtol 2e-2 of the plain version computed in f32 from the same bf16 inputs,
   and every output within 1e-2 of its plain version in relative L2 norm.
   K1's v is scaled by sqrt(S_k / e) so that its outputs are of order 1 at
   every S_k: with unit-normal q, k, v a typical |out| is sqrt(e / S_k),
   which at S_k = 4096 is about the bf16 atol itself.
4. Small reference: the tiny preset on the card (kernels) against the same
   weights on the CPU (plain versions), f32: x0 within atol 5e-4 /
   rtol 1e-3, images within one uint8 step.
5. Main path: the launch counters are zeroed, ``SDPipeline.generate`` runs
   once, and every kernel must have launched; then the per-batch time over
   ten runs, and one run under torch.profiler for the device's busy time,
   idle share and time by kernel name.
6. Timing: each kernel with CUDA events at the main path's shapes, beside its
   bound, its plain version and a library yardstick (SDPA for K1,
   ``torch.var_mean`` for K2; F.group_norm+SiLU for K2+K3 together).  Times
   are summed over one main-path run: sum over shapes of launches x ms.

7. Train step: a ``Trainer`` built from the ``sid_train`` flags in
   ``TRAIN_ARGS`` (SD1.5, batch 4 in one microbatch, kappa 1.5, bf16,
   remat ``flash``); counters zeroed, one step (the training path's main
   run): both losses finite, G, psi and the EMA changed, K1-K4 launched, and
   no K1 launch inside the backward sweep; then one step with remat ``full``,
   where the backward sweep launches K1 once per attention of the forwards
   that carry grad.
8. Kernel check of the training path: K4, K5 and K6 against
   ``flash_attn_bwd_ref`` at every shape the step gave K4, and K4 against
   K5 + K6; K1, K2 and K3 at the step's shapes phase 3 did not check.  The
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
   over 989 TFLOP/s.
11. Backward kernel timing: K4, K5 and K6 at the step's shapes with CUDA
   events, summed over one step (K4's launches x time; K5 and K6 as if they
   replaced K4), beside bound, plain version and SDPA's backward (forward +
   backward minus forward).

12. SiDA step: a ``Trainer`` from ``SIDA_ARGS`` (``TRAIN_ARGS`` plus the
   adversarial weights 0.1, the ``dino`` tower with a random DINO ViT-S/16,
   synthetic real latents); counters zeroed, one step (the SiDA path's main
   run): the six losses and logits finite, G, psi, the judge's heads, the
   EMA and every spectral ``u`` changed, K1-K4 and K7 launched, K4 at the
   VAE's f32 (mb, 1, 4096, 512) and the DINO's f32 (mb, 6, 197, 64).  Then
   (after phase 15) one step of the ``encoder`` tower: losses finite, K1-K4
   launched.
13. Kernel check of the SiDA path, as phases 3 and 8: K7 against
   ``bias_act_ref`` at every shape the step gave it, in the path's
   activation and in all nine with gain 1.3 and clamp 5, plus one
   (8, 512, 32, 32) bias-on-axis-1 shape in f32 and bf16 that is off the
   path; K4, K5 and K6 at the step's new f32 shapes, within the f32
   tolerance (atol 1e-4 / rtol 1e-3 after phase 8's scaling); K1-K3 at its
   new shapes.
14. Small reference for SiDA: the tiny preset with TINY_VIT, f32, each
   tower, card against CPU from the same weights and CPU-generator draws:
   losses within rtol 1e-4, the psi-phase (psi and heads) and theta-phase
   gradients within phase 9's tolerances; K4 and (dino) K7 launched on the
   card.  The conv biases in front of a BatchNormLocal have an exact
   gradient of 0 (the normalisation removes a per-channel constant): both
   sides are required below 1e-6 of the largest head gradient instead.
15. SiDA step timing: median seconds over 5 steps, images/s, peak device
   memory, one traced step; printed beside phase 10's.
16. SiDA kernel timing, summed over one step: K7 beside its bound, plain
   version and ``torch.add``; K4 (and K5 + K6) at the new f32 shapes beside
   bound, plain version and SDPA's backward, with the SDPA backend named.

Any failure raises and exits non-zero.  The last line is the result object.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

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
    "gn_stats": ("sid_lsg_torch/csrc/gn_stats.cu", "sid_lsg_tpu/ops/groupnorm.py:161"),
    "gn_apply": ("sid_lsg_torch/csrc/gn_apply.cu", "sid_lsg_tpu/ops/groupnorm.py:196"),
    "flash_attn_bwd": ("sid_lsg_torch/csrc/flash_attn_bwd.cu", "sid_lsg_tpu/ops/attention.py:234"),
    "flash_attn_bwd_dq": ("sid_lsg_torch/csrc/flash_attn_bwd_twopass.cu",
                          "sid_lsg_tpu/ops/attention.py:326"),
    "flash_attn_bwd_dkv": ("sid_lsg_torch/csrc/flash_attn_bwd_twopass.cu",
                           "sid_lsg_tpu/ops/attention.py:378"),
    "bias_act": ("sid_lsg_torch/csrc/bias_act.cu", "sid_lsg_tpu/ops/bias_act.py:92"),
}
SERVING_KERNELS = ("flash_attn_fwd", "gn_stats", "gn_apply")
BWD_KERNELS = ("flash_attn_bwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv")
# The training path: `python -m sid_lsg_torch.cli.sid_train` with these flags
# (the paper's kappa = 1.5, remat `flash`); --max-ticks 1 keeps the schedule
# short of a state dump, which the port refuses.
TRAIN_ARGS = ["--outdir", "chiprun_out/train", "--sd_model", "sd15", "--batch", "4",
              "--batch-micro", "4", "--cfg_train_fake", "1.5", "--cfg_eval_fake", "1.5",
              "--cfg_eval_real", "1.5", "--init_timestep", "625", "--bf16", "1", "--grad-ckpt", "1",
              "--remat-policy", "flash", "--max-ticks", "1"]
TRAIN_BATCH = 4
TIMED_STEPS = 5
# The SiDA path: the train step above with the adversarial terms through the
# projected DINO ViT-S/16 pixel judge (random backbone, synthetic real latents).
SIDA_ARGS = TRAIN_ARGS + ["--adv_weight_d", "0.1", "--adv_weight_g", "0.1", "--adv_tower", "dino",
                          "--adv_vit", "s16"]
SIDA_BATCH = TRAIN_BATCH
TOL_LOSS = 1e-4  # phase 9: relative, losses
TOL_GRAD = 1e-3  # phase 9: relative, and 1e-4 * max|ref| absolute, per gradient tensor


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


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
    shape, dt, groups = key[:3]
    dtype = getattr(torch, dt.split(".")[1])
    x = (torch.randn(shape, generator=gen, device=dev) * 2 + 0.5).to(dtype)
    n, c = shape[:2]
    numel = x.numel()
    if name == "gn_stats":
        work = (numel * x.element_size() + 8 * n * groups, 3 * numel, "torch.float32")
        return (lambda: ops.gn_stats(x, groups, 1e-5),
                lambda: ops.gn_stats_ref(x.float(), groups, 1e-5),
                lambda: torch.var_mean(x.view(n, groups, -1), dim=-1, correction=0),
                TOL_F32, work)
    silu = key[3]
    gamma = torch.randn(c, generator=gen, device=dev) + 1
    beta = torch.randn(c, generator=gen, device=dev)
    mean, rstd = ops.gn_stats_ref(x.float(), groups, 1e-5)
    work = (2 * numel * x.element_size() + 8 * c + 8 * n * groups, (6 if silu else 2) * numel,
            "torch.float32")
    return (lambda: ops.gn_apply(x, mean, rstd, gamma, beta, silu),
            lambda: ops.gn_apply_ref(x.float(), mean, rstd, gamma, beta, silu),
            None, TOL_BF16 if dtype == torch.bfloat16 else TOL_F32, work)


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
    grad and its forward + backward on the same inputs."""
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
    return cases, plain, (sdpa_fwd, sdpa_both)


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
    at, and K4 against K5 + K6, at the tolerance of the shape's dtype (each
    output scaled as phase 8 says); raises ``max_abs`` per kernel to its
    largest error; returns ``bwd_cases(key, gen)``."""
    import torch

    cases, plain, sdpa = bwd_cases(key, gen)
    tol = TOL_F32 if key[2] == "torch.float32" else TOL_BF16
    outs = {}
    for name, (kern, ref, _, _) in cases.items():
        outs[name] = kern()
        torch.cuda.synchronize()
        max_abs[name] = max(max_abs.get(name, 0.0),
                            check_outputs(f"{name} {key}", outs[name], ref, tol, scale_each=True))
    check_outputs(f"flash_attn_bwd vs two-pass {key}", outs["flash_attn_bwd"],
                  outs["flash_attn_bwd_dq"] + outs["flash_attn_bwd_dkv"], tol, scale_each=True)
    return cases, plain, sdpa


def train_phases(card: str, gen, serving_keys):
    """Phases 7-11; returns the kernels-line entries of K4, K5 and K6, the
    step's launch keys and phase 10's numbers."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from sid_lsg_torch.cli import sid_train
    from sid_lsg_torch.models.unet import unet_apply_fn
    from sid_lsg_torch.ops import registry
    from sid_lsg_torch.training.distill import make_train_step
    from sid_lsg_torch.training.loop import Trainer

    # 7. Train step at full width, remat flash, counters zeroed.
    t0 = time.perf_counter()
    trainer = Trainer(sid_train.config_from_args(sid_train.build_parser().parse_args(TRAIN_ARGS)))
    torch.cuda.synchronize()
    print(f"[train] Trainer (sd15, random weights, mb {TRAIN_BATCH}, kappa 1.5, bf16, remat "
          f"flash) built in {time.perf_counter() - t0:.3f} s")
    st = trainer.state
    before = {part: {k: v.detach().clone() for k, v in getattr(st, part).items()}
              for part in ("params_G", "params_fake", "ema")}
    registry.reset()
    t0 = time.perf_counter()
    with K1Sweep() as sweep:
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
    for name in ("flash_attn_fwd", "flash_attn_bwd", "gn_stats", "gn_apply"):
        require(train_launches[name] > 0, f"{name} was not launched by the train step")
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
    for name in ("flash_attn_fwd", "flash_attn_bwd", "gn_stats", "gn_apply"):
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
    del trainer
    torch.cuda.empty_cache()
    phase10 = {"median_s": med, "images_per_s": TRAIN_BATCH / med, "peak_gib": peak_gib}

    # 11. Backward kernel timing at the step's shapes, summed over one step.
    entries = []
    rows = {name: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "ops_ms": 0.0, "bytes_ms": 0.0,
                   "library_ms": 0.0} for name in BWD_KERNELS}
    for key, (cases, plain, (sdpa_fwd, sdpa_both)) in sorted(bwd.items(), key=lambda kv: str(kv[0])):
        n = train_keys["flash_attn_bwd"][key]
        plain_ms = time_ms(plain)
        sdpa_bwd_ms = time_ms(sdpa_both) - time_ms(sdpa_fwd)
        for name, (kern, _, nbytes, flops) in cases.items():
            ops_ms = flops / PEAK_FLOPS[key[2]] * 1e3
            bytes_ms = nbytes / PEAK_BYTES * 1e3
            ms = time_ms(kern)
            r = rows[name]
            for f, x in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", max(ops_ms, bytes_ms)),
                         ("ops_ms", ops_ms), ("bytes_ms", bytes_ms), ("library_ms", sdpa_bwd_ms)):
                r[f] += n * x
            print(f"[time] {name} {key} x{n}: {ms:.4f} ms, plain {plain_ms:.4f}, bound "
                  f"{max(ops_ms, bytes_ms):.4f}, SDPA backward {sdpa_bwd_ms:.4f}")
    for name in BWD_KERNELS:
        r = rows[name]
        entries.append({
            "name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1], "launches": train_launches[name],
            "max_abs_err": max_abs[name], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": "operations" if r["ops_ms"] > r["bytes_ms"] else "bytes",
            "library_ms": r["library_ms"] if name == "flash_attn_bwd" else None,
        })
    print(f"[time] per train step: K4 {rows['flash_attn_bwd']['ms']:.4f} ms, K5 + K6 "
          f"{rows['flash_attn_bwd_dq']['ms'] + rows['flash_attn_bwd_dkv']['ms']:.4f} ms, SDPA "
          f"backward {rows['flash_attn_bwd']['library_ms']:.4f} ms")
    return entries, train_keys, phase10

def fingerprints(tree) -> "torch.Tensor":
    """Per tensor of ``tree``: (sum, sum of squares) in f64, on the host."""
    import torch

    with torch.no_grad():
        return torch.stack([torch.stack([v.double().sum(), v.double().square().sum()])
                            for v in tree.values()]).cpu()


def bias_act_case(key, gen, act=None, gain=None, clamp=None):
    """K7 at one recorded launch key (or that shape with another activation,
    gain and clamp): (kernel fn, plain fn, library fn or None, tolerance,
    (bytes, operations, type))."""
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
    work = (2 * n * es + (0 if b is None else b.numel() * es), 4 * n, "torch.float32")
    lib = (lambda: torch.add(x, bview)) if act == "linear" and b is not None else None
    return (lambda: ops.bias_act_fwd(x, b, dim, act, alpha, gain, clamp),
            lambda: ops.bias_act_ref(x.float(), None if b is None else b.float(), dim, act, alpha,
                                     gain, clamp),
            lib, TOL_BF16 if dtype == torch.bfloat16 else TOL_F32, work)


def check_bias_act(key, gen, label, **kw) -> float:
    import torch

    kern, plain, _, tol, _ = bias_act_case(key, gen, **kw)
    got, ref = kern(), plain()
    torch.cuda.synchronize()
    return check_outputs(f"bias_act {label} {key} {kw}", (got,), (ref,), tol)


def sida_phases(card: str, gen, checked, phase10) -> dict:
    """Phases 12-16; returns the kernels-line entry of K7."""
    import torch
    from torch.nn.attention import SDPBackend

    from sid_lsg_torch import ops
    from sid_lsg_torch.cli import sid_train
    from sid_lsg_torch.models.stylegan_discriminator import spectral_buffers
    from sid_lsg_torch.ops import registry
    from sid_lsg_torch.training.loop import Trainer

    # 12. SiDA step at full width (dino tower), counters zeroed.
    t0 = time.perf_counter()
    trainer = Trainer(sid_train.config_from_args(sid_train.build_parser().parse_args(SIDA_ARGS)))
    torch.cuda.synchronize()
    print(f"[sida] Trainer (sd15, mb {SIDA_BATCH}, dino ViT-S/16 random, synthetic real latents) "
          f"built in {time.perf_counter() - t0:.3f} s")
    st = trainer.state
    psi = {k: v for k, v in st.params_fake.items() if not k.startswith("disc.")}
    heads = {k: v for k, v in st.params_fake.items() if k.startswith("disc.")}
    parts = {"params_G": st.params_G, "psi": psi, "disc heads": heads, "ema": st.ema}
    before = {name: fingerprints(tree) for name, tree in parts.items()}
    u_before = {k: v.clone() for k, v in spectral_buffers(trainer.disc).items()}
    registry.reset()
    t0 = time.perf_counter()
    metrics = trainer.step()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = registry.counts()
    sida_keys = {name: registry.launches_by_key(name) for name in registry.KERNELS}
    names = ("fake_score_loss", "g_loss", "adv_d_loss", "adv_g_loss", "d_logit_real", "d_logit_fake")
    vals = {k: float(metrics[k]) for k in names}
    print(f"[sida] main step in {first_s:.3f} s: {vals}, launches {launches}")
    require(all(math.isfinite(x) for x in vals.values()), f"SiDA losses not finite: {vals}")
    for name in ("flash_attn_fwd", "gn_stats", "gn_apply", "flash_attn_bwd", "bias_act"):
        require(launches[name] > 0, f"{name} was not launched by the SiDA step")
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
    enc_args = [a if a != "dino" else "encoder" for a in SIDA_ARGS]
    trainer = Trainer(sid_train.config_from_args(sid_train.build_parser().parse_args(enc_args)))
    registry.reset()
    t0 = time.perf_counter()
    metrics = trainer.step()
    torch.cuda.synchronize()
    enc_launches = registry.counts()
    vals = {k: float(metrics[k]) for k in names}
    print(f"[sida] encoder tower step in {time.perf_counter() - t0:.3f} s: {vals}, launches "
          f"{enc_launches}")
    require(all(math.isfinite(x) for x in vals.values()), f"encoder-tower losses not finite: {vals}")
    for name in ("flash_attn_fwd", "gn_stats", "gn_apply", "flash_attn_bwd"):
        require(enc_launches[name] > 0, f"{name} was not launched by the encoder-tower step")
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
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "ops_ms": 0.0, "bytes_ms": 0.0,
           "library_ms": 0.0}
    for key, n in sorted(sida_keys["bias_act"].items(), key=lambda kv: str(kv[0])):
        kern, plain, lib, _, (nbytes, flops, op_type) = bias_act_case(key, gen)
        ops_ms, bytes_ms = flops / PEAK_FLOPS[op_type] * 1e3, nbytes / PEAK_BYTES * 1e3
        row = {"ms": time_ms(kern), "plain_ms": time_ms(plain), "bound_ms": max(ops_ms, bytes_ms),
               "ops_ms": ops_ms, "bytes_ms": bytes_ms, "library_ms": time_ms(lib) if lib else 0.0}
        for f in tot:
            tot[f] += n * row[f]
        print(f"[time] bias_act {key} x{n}: {row['ms']:.5f} ms, plain {row['plain_ms']:.5f}, bound "
              f"{row['bound_ms']:.7f}, torch.add {row['library_ms']:.5f}")
    print(f"[time] per SiDA step: K7 {tot['ms']:.5f} ms, plain {tot['plain_ms']:.5f}, bound "
          f"{tot['bound_ms']:.7f}, torch.add {tot['library_ms']:.5f}")
    k4 = {"ms": 0.0, "twopass_ms": 0.0, "bound_ms": 0.0, "plain_ms": 0.0, "sdpa_ms": 0.0}
    for key, (cases, plain, (sdpa_fwd, sdpa_both)) in bwd.items():
        n = sida_keys["flash_attn_bwd"][key]
        kern, _, nbytes, flops = cases["flash_attn_bwd"]
        ops_ms, bytes_ms = flops / PEAK_FLOPS[key[2]] * 1e3, nbytes / PEAK_BYTES * 1e3
        ms, plain_ms = time_ms(kern), time_ms(plain)
        twopass_ms = time_ms(cases["flash_attn_bwd_dq"][0]) + time_ms(cases["flash_attn_bwd_dkv"][0])
        sdpa_ms = time_ms(sdpa_both) - time_ms(sdpa_fwd)
        q = torch.empty(key[0], device="cuda", dtype=getattr(torch, key[2].split(".")[1]))
        backend = SDPBackend(torch._fused_sdp_choice(q, q, q)).name
        for f, x in (("ms", ms), ("twopass_ms", twopass_ms), ("bound_ms", max(ops_ms, bytes_ms)),
                     ("plain_ms", plain_ms), ("sdpa_ms", sdpa_ms)):
            k4[f] += n * x
        print(f"[time] flash_attn_bwd {key} x{n}: {ms:.4f} ms, K5 + K6 {twopass_ms:.4f}, plain "
              f"{plain_ms:.4f}, bound {max(ops_ms, bytes_ms):.4f} "
              f"({'operations' if ops_ms > bytes_ms else 'bytes'}), SDPA backward {sdpa_ms:.4f} "
              f"({backend})")
    print(f"[time] per SiDA step at the new f32 shapes: K4 {k4['ms']:.4f} ms, K5 + K6 "
          f"{k4['twopass_ms']:.4f}, bound {k4['bound_ms']:.4f}, plain {k4['plain_ms']:.4f}, SDPA "
          f"backward {k4['sdpa_ms']:.4f} ms")
    return {"name": "bias_act", "route": "cuda", "source": SOURCES["bias_act"][0],
            "replaces": SOURCES["bias_act"][1], "launches": launches["bias_act"],
            "max_abs_err": max_abs, "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"],
            "bound_by": "operations" if tot["ops_ms"] > tot["bytes_ms"] else "bytes",
            "library_ms": tot["library_ms"]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from sid_lsg_torch import ops
    from sid_lsg_torch.diffusion.rng import StackedRandomGenerator
    from sid_lsg_torch.models import TINY
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

    # 2. Warm-up generation; records every kernel input shape of the path.
    t0 = time.perf_counter()
    pipe = SDPipeline.random_init("sd15", dtype=torch.bfloat16, device="cuda", seed=0)
    torch.cuda.synchronize()
    print(f"[init] sd15 random weights in {time.perf_counter() - t0:.3f} s")
    latents = StackedRandomGenerator(range(BATCH), "cuda").randn((BATCH, 4, 64, 64)).permute(0, 2, 3, 1)
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

    # 5. Main path: counters zeroed, one generate, every kernel launched.
    registry.reset()
    t0 = time.perf_counter()
    images = pipe.generate(PROMPTS, latents, init_timestep=INIT_TIMESTEP)
    torch.cuda.synchronize()
    batch_s = [time.perf_counter() - t0]
    launches = registry.counts()
    main_keys = {name: registry.launches_by_key(name) for name in SERVING_KERNELS}
    print(f"[main] launches {launches}")
    for name in SERVING_KERNELS:
        require(launches[name] > 0, f"{name} was not launched on the main path")
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
    kernels = []
    pair = {"kernels_ms": 0.0, "library_ms": 0.0}
    single = {"launches": 0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    for name in SERVING_KERNELS:
        tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "ops_ms": 0.0, "bytes_ms": 0.0,
               "library_ms": 0.0}
        for key, n in sorted(main_keys[name].items(), key=lambda kv: str(kv[0])):
            kern, plain, lib, _, (nbytes, flops, op_type) = kernel_cases(name, key, gen)
            ops_ms = flops / PEAK_FLOPS[op_type] * 1e3
            bytes_ms = nbytes / PEAK_BYTES * 1e3
            row = {"kernel": name, "key": str(key), "launches": n, "ms": time_ms(kern),
                   "plain_ms": time_ms(plain), "library_ms": time_ms(lib) if lib else None,
                   "bound_ms": max(ops_ms, bytes_ms), "ops_ms": ops_ms, "bytes_ms": bytes_ms}
            for f in ("ms", "plain_ms", "bound_ms", "ops_ms", "bytes_ms"):
                tot[f] += n * row[f]
            tot["library_ms"] += n * (row["library_ms"] or 0.0)
            if name != "flash_attn_fwd" and math.prod(key[0][1:]) * 4 <= 6 * 2**20:
                # The maps the JAX single-block kernel takes (HW * C * 4 <= 6 MiB).
                single["launches"] += n if name == "gn_stats" else 0
                for f in ("ms", "plain_ms", "bound_ms"):
                    single[f] += n * row[f]
            print(f"[time] {name} {key} x{n}: {row['ms']:.4f} ms, plain {row['plain_ms']:.4f}, "
                  f"bound {row['bound_ms']:.4f}, library {row['library_ms']}")
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1], "launches": launches[name],
            "max_abs_err": max_abs[name], "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"],
            "bound_by": "operations" if tot["ops_ms"] > tot["bytes_ms"] else "bytes",
            "library_ms": tot["library_ms"] if name != "gn_apply" else None,
        })
    # K2 + K3 together against one F.group_norm (+ SiLU) per GroupNorm of the path.
    for key, n in main_keys["gn_apply"].items():
        shape, dt, groups, silu = key
        x = torch.randn(shape, generator=gen, device="cuda").to(getattr(torch, dt.split(".")[1]))
        gamma = torch.ones(shape[1], device="cuda")
        beta = torch.zeros(shape[1], device="cuda")
        ours = lambda: ops.group_norm(x, gamma, beta, groups, 1e-5, silu)
        ref = lambda: (F.silu if silu else (lambda y: y))(
            F.group_norm(x, groups, gamma.to(x.dtype), beta.to(x.dtype), 1e-5))
        pair["kernels_ms"] += n * time_ms(ours)
        lib_ms = time_ms(ref)
        pair["library_ms"] += n * lib_ms
        if math.prod(shape[1:]) * 4 <= 6 * 2**20:
            single["library_ms"] += n * lib_ms
    print(f"[time] GroupNorm(+SiLU) per main-path run: K2+K3 {pair['kernels_ms']:.4f} ms, "
          f"F.group_norm(+silu) {pair['library_ms']:.4f} ms")
    print(f"[time] GroupNorm on single-block maps (HW*C*4 <= 6 MiB, the JAX "
          f"_gn_silu_pallas_fwd's) per main-path run: {single['launches']} calls, K2+K3 "
          f"{single['ms']:.4f} ms, bound {single['bound_ms']:.4f} ms, plain "
          f"{single['plain_ms']:.4f} ms, F.group_norm(+silu) {single['library_ms']:.4f} ms")

    del pipe, card_tiny, cpu
    train_entries, train_keys, phase10 = train_phases(card, gen, keys)
    kernels += train_entries
    checked = {name: set(keys.get(name, ())) | set(train_keys[name]) for name in registry.KERNELS}
    kernels.append(sida_phases(card, gen, checked, phase10))

    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
