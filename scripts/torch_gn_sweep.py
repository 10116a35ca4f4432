#!/usr/bin/env python3
"""Cluster-size sweep of the port's GroupNorm kernels on one H100.

    python3 scripts/torch_gn_sweep.py

For each GroupNorm map of the SD1.5 serving batch and train step (bf16,
batch 4, the UNet's and the VAE decoder's, plus the VAE mid block's f32 map
and two UNet maps at the CFG-doubled batch 8), on the device alone (host
launch time excluded), warm in L2 and with L2 flushed before each call
(``chip_smoke.device_ms``):

- K8 (``sid_lsg_torch/csrc/gn_fused.cu``) at every cluster size whose slice
  fits a block's shared memory;
- K2 (``csrc/gn_stats.cu``) at every cluster size, and K3 (``csrc/gn_apply.cu``);
- ``F.group_norm`` + SiLU;
- the route ``gn_plan`` picks.

Every map is normalised with SiLU over 32 groups.  The cluster rule of
``sid_lsg_torch/ops/groupnorm.py:gn_plan`` and the numbers in the note of
``csrc/gn_fused.cu`` come from this script's output.  Needs the card; exits
non-zero without one.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# (C, H = W, dtype name, batch) of the maps.
MAPS = [(c, h, "bfloat16", 4) for c, h in (
    (320, 64), (640, 64), (960, 64), (320, 32), (640, 32), (960, 32), (1280, 32), (1920, 32),
    (640, 16), (1280, 16), (1920, 16), (2560, 16), (1280, 8), (2560, 8),
    (512, 64), (512, 128), (512, 256), (256, 256), (256, 512), (128, 512))]
MAPS += [(512, 64, "float32", 4), (320, 64, "bfloat16", 8), (1280, 8, "bfloat16", 8)]
GROUPS = 32
CLUSTERS = (1, 2, 4, 8, 16)


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_gn_sweep: torch finds no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import card_line, device_ms
    from sid_lsg_torch import ops
    from sid_lsg_torch.ops import groupnorm
    from sid_lsg_torch.ops._build import check, dtype_code, library

    lib = library()
    print(f"[card] {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    gen = torch.Generator("cuda").manual_seed(0)
    stream = lambda: torch.cuda.current_stream().cuda_stream

    def fused(x, y, gamma, beta, cluster):
        n, c = x.shape[:2]
        check(lib.sidlsg_gn_fused(x.data_ptr(), y.data_ptr(), gamma.data_ptr(), beta.data_ptr(), n, c,
                                  GROUPS, x.numel() // (n * c), cluster, 1e-5, 1, dtype_code(x),
                                  stream()), "gn_fused")

    def stats(x, mean, rstd, cluster):
        check(lib.sidlsg_gn_stats_clustered(x.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                                            x.shape[0] * GROUPS, x.numel() // (x.shape[0] * GROUPS),
                                            cluster, 1e-5, dtype_code(x), stream()), "gn_stats")

    for c, h, dt, b in MAPS:
        dtype = getattr(torch, dt)
        shape = (b, c, h, h)
        x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
        gamma = torch.randn(c, generator=gen, device="cuda") + 1
        beta = torch.randn(c, generator=gen, device="cuda")
        y = torch.empty_like(x)
        mean = torch.empty(b, GROUPS, device="cuda")
        rstd = torch.empty_like(mean)
        span_kb = c // GROUPS * h * h * x.element_size() / 1024
        bound_us = 2 * x.numel() * x.element_size() / 3.35e12 * 1e6
        plan = ops.gn_plan(shape, dtype, GROUPS)
        row = [f"[sweep] {shape} {dt}: span {span_kb:.0f} KB, bound (read + write) {bound_us:.2f} us, "
               f"gn_plan {plan}"]
        ref = ops.group_norm_ref(x.float(), gamma, beta, GROUPS, 1e-5, True)
        for cl in CLUSTERS:
            if groupnorm.fused_smem_bytes(shape, dtype, GROUPS, cl) > groupnorm._SMEM_PER_BLOCK:
                continue
            fused(x, y, gamma, beta, cl)
            torch.cuda.synchronize()
            err = (y.float() - ref).abs().max().item()
            warm = device_ms(lambda: fused(x, y, gamma, beta, cl)) * 1e3
            cold = device_ms(lambda: fused(x, y, gamma, beta, cl), cold=True) * 1e3
            row.append(f"  K8 cluster {cl:2d}: warm {warm:8.2f} us, cold {cold:8.2f} us "
                       f"(max abs err {err:.2e})")
        k3 = lambda: ops.gn_apply(x, mean, rstd, gamma, beta, True)
        stats(x, mean, rstd, 1)
        k3_warm, k3_cold = device_ms(k3) * 1e3, device_ms(k3, cold=True) * 1e3
        for cl in CLUSTERS:
            warm = device_ms(lambda: stats(x, mean, rstd, cl)) * 1e3
            cold = device_ms(lambda: stats(x, mean, rstd, cl), cold=True) * 1e3
            row.append(f"  K2 cluster {cl:2d}: warm {warm:8.2f} us, cold {cold:8.2f} us; with K3 "
                       f"warm {warm + k3_warm:8.2f} us, cold {cold + k3_cold:8.2f} us")
        w16, b16 = gamma.to(dtype), beta.to(dtype)
        lib_fn = lambda: F.silu(F.group_norm(x, GROUPS, w16, b16, 1e-5))
        row.append(f"  K3 warm {k3_warm:8.2f} us, cold {k3_cold:8.2f} us; F.group_norm + SiLU warm "
                   f"{device_ms(lib_fn) * 1e3:8.2f} us, cold {device_ms(lib_fn, cold=True) * 1e3:8.2f} us")
        print("\n".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
