#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (``sid_lsg_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It drives the port's main path, one-step SD1.5 text-to-image generation at
full width (batch 4, 512x512, init_timestep 625, random weights from a seed),
through the CUDA kernels built from ``sid_lsg_torch/csrc``:

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
}


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


def trace_generate(pipe, latents) -> None:
    """Print the device time of one ``generate`` by kernel name, from a torch.profiler
    trace: busy = union of the CUDA kernels' intervals, idle share = 1 - busy
    over the host's wall time of the call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.generate(PROMPTS, latents, init_timestep=INIT_TIMESTEP)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.time_range.end > e.time_range.start:
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    if not spans:
        print("[trace] the profiler recorded no device kernels: device busy time not measured")
        return
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    busy_ms = busy_us / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    print(f"[trace] one generate: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, "
          f"idle share {1 - busy_ms / wall_ms:.3f}, {len(spans)} kernels")
    for name, ms in top:
        print(f"[trace]   {ms:9.3f} ms  {name[:110]}")


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
    keys = {name: registry.launches_by_key(name) for name in registry.KERNELS}
    print(f"[warm-up] x0 finite, images {tuple(images.shape)} std {per_image_std.tolist()}")

    # 3. Kernel check at every shape the generation launched.
    gen = torch.Generator("cuda").manual_seed(1234)
    max_abs = {}
    for name in registry.KERNELS:
        require(keys[name], f"{name}: the warm-up generation never launched it")
        worst = 0.0
        for key in sorted(keys[name], key=str):
            kern, plain, _, tol, _ = kernel_cases(name, key, gen)
            got, ref = kern(), plain()
            torch.cuda.synchronize()
            pairs = list(zip(got, ref)) if isinstance(got, tuple) else [(got, ref)]
            for i, (g, r) in enumerate(pairs):
                t = TOL_F32 if g.dtype == torch.float32 else tol
                abs_err, rel_err, ratio, rel_l2 = close_errors(g, r, **t)
                worst = max(worst, abs_err)
                print(f"[check] {name} {key} out{i}: max abs {abs_err:.3e}, max rel {rel_err:.3e}, "
                      f"max err/tol {ratio:.3f} (atol {t['atol']}, rtol {t['rtol']}), "
                      f"rel L2 {rel_l2:.3e} (<= {REL_L2}), max |ref| {r.abs().max().item():.3e}")
                require(ratio <= 1.0 and rel_l2 <= REL_L2, f"{name} {key} output {i} out of tolerance")
        max_abs[name] = worst

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
    main_keys = {name: registry.launches_by_key(name) for name in registry.KERNELS}
    print(f"[main] launches {launches}")
    for name, n in launches.items():
        require(n > 0, f"{name} was not launched on the main path")
    require(images.shape == (BATCH, 512, 512, 3), f"images {tuple(images.shape)}")
    for _ in range(9):
        t0 = time.perf_counter()
        pipe.generate(PROMPTS, latents, init_timestep=INIT_TIMESTEP)
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t0)
    print(f"[main] per-batch seconds (batch {BATCH}, 512x512, 1 step): {batch_s}, "
          f"median {statistics.median(batch_s)} on {card}")
    trace_generate(pipe, latents)

    # 6. Timing at the main path's shapes, summed over one main-path run.
    kernels = []
    pair = {"kernels_ms": 0.0, "library_ms": 0.0}
    for name in registry.KERNELS:
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
        pair["library_ms"] += n * time_ms(ref)
    print(f"[time] GroupNorm(+SiLU) per main-path run: K2+K3 {pair['kernels_ms']:.4f} ms, "
          f"F.group_norm(+silu) {pair['library_ms']:.4f} ms")

    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
