#!/usr/bin/env python3
"""Error of the port's bf16 flash-attention backward over seeds, on one H100.

    python3 scripts/torch_flash_bwd_seeds.py [--baseline ROOT]

At each shape below and each of 12 seeds, inputs made as ``chip_smoke.py``
makes them (unit-normal bf16 q, k and dO, v scaled by sqrt(S_k / e), out and
lse from the f32 plain forward), the largest err/tol of each output against
the f32 plain backward (``flash_attn_bwd_ref``) under the bf16 gate of
``chip_smoke.py`` (atol 2e-2, rtol 2e-2, each output scaled by the power of
two that brings the plain one to RMS about 1): dq, dk, dv of K4
(``flash_attn_bwd``), dq of K5 (``flash_attn_bwd_dq``) and dk, dv of K6
(``flash_attn_bwd_dkv``).
A value above 1 fails the gate.  With ``--baseline``, the same for the kernels
of another checkout, on the same inputs.  Needs the card.
"""

from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SHAPES = [((8, 8, 4096, 40), 77), ((4, 8, 4096, 40), 77), ((8, 8, 1024, 80), 77),
          ((8, 8, 256, 160), 77), ((4, 8, 1024, 80), 1024), ((4, 8, 4096, 40), 4096),
          ((8, 8, 4096, 40), 4096), ((8, 8, 256, 160), 256)]
SEEDS = range(12)


def err_tol(got, ref, atol=2e-2, rtol=2e-2) -> float:
    rms = ref.float().square().mean().sqrt().item()
    c = 2.0 ** round(-math.log2(max(rms, 1e-30)))
    g, r = got.float() * c, ref.float() * c
    return ((g - r).abs() / (atol + rtol * r.abs())).max().item()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--baseline", default=None, help="root of another checkout")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_flash_bwd_seeds: torch finds no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from sid_lsg_torch import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    libs = {"this tree": None}
    if args.baseline:
        libs["baseline"] = chip_smoke.load_baseline(args.baseline)
    print(f"[card] {chip_smoke.card_line()}")
    for qs, sk in SHAPES:
        b, h, sq, d = qs
        rows = {f"{tree} {name}": [] for tree in libs
                for name in ("K4 dq", "K4 dk", "K4 dv", "K5 dq", "K6 dk", "K6 dv")}
        for seed in SEEDS:
            gen = torch.Generator("cuda").manual_seed(seed)
            q = torch.randn(qs, generator=gen, device="cuda").to(torch.bfloat16)
            k = torch.randn(b, h, sk, d, generator=gen, device="cuda").to(torch.bfloat16)
            v = (torch.randn(b, h, sk, d, generator=gen, device="cuda")
                 * math.sqrt(sk / math.e)).to(torch.bfloat16)
            dout = torch.randn(qs, generator=gen, device="cuda").to(torch.bfloat16)
            out, lse = ops.attention_ref(q.float(), k.float(), v.float())
            out = out.to(torch.bfloat16)
            a = (q, k, v, out, lse, dout, d ** -0.5)
            ref = ops.flash_attn_bwd_ref(q.float(), k.float(), v.float(), out.float(), lse,
                                         dout.float(), d ** -0.5)
            for tree, lib in libs.items():
                ctx = chip_smoke.attention_library(lib) if lib else chip_smoke.contextlib.nullcontext()
                with ctx:
                    fused = ops.flash_attn_bwd(*a)
                    # K5 and K6 apart: an older library has no two-pass entry.
                    twopass = (ops.flash_attn_bwd_dq(*a),) + ops.flash_attn_bwd_dkv(*a)
                torch.cuda.synchronize()
                for name, got, r in zip(("K4 dq", "K4 dk", "K4 dv", "K5 dq", "K6 dk", "K6 dv"),
                                        fused + twopass, ref + ref):
                    rows[f"{tree} {name}"].append(err_tol(got, r))
        for name, vals in rows.items():
            print(f"[seeds] {qs} x S_k {sk} {name}: max err/tol per seed "
                  + " ".join(f"{x:.3f}" for x in vals) + f"; largest {max(vals):.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
