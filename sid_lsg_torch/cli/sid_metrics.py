"""Metric evaluation CLI of the port: score a generator on registered metrics.

An argparse copy of ``sid_lsg_tpu/cli/sid_metrics.py`` (the same flags and
defaults) plus ``--device`` (``cuda`` unless asked for ``cpu``): load the
base checkpoint and a generator file, run each metric against a prepared
COCO eval folder or zip (image + txt pairs), append ``metric-<name>.jsonl``
and ``<key>.txt`` lines under ``--outdir``.

    python -m sid_lsg_torch.cli.sid_metrics --metrics fid_clip_test --data coco_eval \\
        --repo_id <checkpoint dir> --network network-snapshot-1-000100.safetensors
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import torch

from . import int_range, parse_bool


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Metric evaluation of a generator (PyTorch port).")
    a = p.add_argument
    a("--metrics", default="fid_clip_test", help="Comma-separated metric names")
    a("--network", dest="network_path", default=None, help="Generator checkpoint")
    a("--data", dest="dataset_path", required=True,
      help="Prepared COCO eval folder or zip (img+txt pairs)")
    a("--repo_id", default="sd15", help="Base SD checkpoint dir or preset")
    a("--outdir", dest="run_dir", default=".", help="Where to write metric jsonl/txt")
    a("--num", dest="num_gen", type=int, default=30000)
    a("--batch", dest="batch_size", type=int, default=16)
    a("--init_timestep", type=int_range(0, 999), default=625)
    a("--num_steps_eval", type=int_range(1), default=1)
    a("--resolution", type=int, default=256, help="Eval resolution (GigaGAN protocol: 256)")
    a("--use_bf16", type=parse_bool, default=True)
    a("--inception_weights", default=None)
    a("--clip_weights", default=None)
    a("--hpsv2_prompts", default=None, help="{style: [prompts]} json for the hpsv2 metric")
    a("--list", dest="list_only", action="store_true", help="List registered metrics and exit")
    a("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def main(argv: Optional[Sequence[str]] = None) -> None:
    from ..metrics import MetricOptions, calc_metric, list_valid_metrics, report_metric

    args = build_parser().parse_args(argv)
    if args.list_only:
        for name in list_valid_metrics():
            print(name)
        return
    from ..metrics.detectors import clip_scorer, inception_detector
    from ..pipeline import SDPipeline

    metrics = [m.strip() for m in args.metrics.split(",")]
    pipe = SDPipeline.from_pretrained(args.repo_id,
                                      dtype=torch.bfloat16 if args.use_bf16 else torch.float32,
                                      device=args.device)
    if args.network_path:
        pipe.load_generator(args.network_path)
    wants_clip = any("clip" in m or m == "hpsv2" for m in metrics)
    opts = MetricOptions(
        pipe=pipe, dataset_path=args.dataset_path,
        detector=inception_detector(args.inception_weights, device=args.device),
        clip=clip_scorer(args.clip_weights, device=args.device) if wants_clip else None,
        batch_size=args.batch_size, num_gen=args.num_gen, init_timestep=args.init_timestep,
        num_steps_eval=args.num_steps_eval, resolution=args.resolution, device=args.device)
    opts.hpsv2_prompts = args.hpsv2_prompts
    os.makedirs(args.run_dir, exist_ok=True)
    for metric in metrics:
        result = calc_metric(metric, opts=opts)
        report_metric(result, run_dir=args.run_dir, snapshot_pkl=args.network_path)
        for key, value in result.results.items():
            with open(os.path.join(args.run_dir, f"{key}.txt"), "at") as f:
                f.write(f"{key}: {value}\n")


if __name__ == "__main__":
    main()
