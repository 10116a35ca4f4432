"""Distillation training CLI of the port.

An argparse copy of ``sid_lsg_tpu/cli/sid_train.py``: the same flag names
and defaults, plus ``--device`` (``cuda`` unless asked for ``cpu``).  Run
dirs are numbered ``{id:05d}-{desc}`` with ``training_options.json`` and
``log.txt`` inside; ``--dump`` writes training-state dumps under
``checkpoints/``, which ``--resume <run dir>`` (or ``--resume latest`` with
``--nosubdir`` in the same run dir) continues.

    python -m sid_lsg_torch.cli.sid_train --outdir runs --sd_model tiny --device cpu \\
        --batch 4 --batch-micro 2 --tick 0 --max-ticks 2 --bf16 0 --snap 1

On N cards, one process each (NCCL; with ``--device cpu``, N CPU processes
on gloo); ``--batch-micro`` stays the global microbatch, ``--fsdp F`` shards
the trainable state over groups of F ranks:

    torchrun --standalone --nproc_per_node=N -m sid_lsg_torch.cli.sid_train \\
        --outdir runs --sd_model <checkpoint dir> --fsdp 1 ...

Rank 0 makes the numbered run dir and writes ``log.txt``; the other ranks
find the same directory after a barrier.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from . import int_range, parse_bool
from ..parallel import runtime
from ..training.loop import TrainConfig, training_loop
from ..training.state import SiDState
from ..utils.util import Logger, make_run_dir

REMAT_CHOICES = ["full", "dots", "dots_no_batch", "attn", "attn_offload", "flash"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="SiD-LSG distillation (PyTorch port).")
    a = p.add_argument
    a("--outdir", required=True, help="Where to save the results")
    a("--data", default="", help="Prompt corpus file/dir (Aesthetics6+ txt)")
    a("--sd_model", default="sd15",
      help="Teacher: HF-layout checkpoint dir, or preset (sd15/sd21base/tiny) / random:<preset>")
    a("--prediction_type", choices=["epsilon", "v_prediction"], default=None)
    a("--duration", type=int, default=200000, help="Training duration (kimg)")
    a("--batch", type=int, default=512, help="Global batch size")
    a("--batch-micro", dest="batch_micro", type=int, default=8,
      help="Global batch per accumulation round")
    a("--glr", type=float, default=1e-6, help="Generator learning rate")
    a("--lr", type=float, default=1e-6, help="Fake-score learning rate")
    a("--optimizer", choices=["adam", "adamw"], default="adam")
    a("--weight_decay", type=float, default=0.01, help="AdamW decoupled decay (with --optimizer adamw)")
    a("--nosubdir", action="store_true", help="Run directly in --outdir")
    a("--ema", dest="ema_halflife_kimg", type=float, default=500, help="EMA half-life (kimg)")
    a("--tick", dest="kimg_per_tick", type=int, default=50, help="Progress interval (kimg)")
    a("--snap", dest="snapshot_ticks", type=int, default=50, help="Snapshot interval (ticks)")
    a("--dump", dest="state_dump_ticks", type=int, default=500, help="State dump interval (ticks)")
    a("--seed", type=int, default=0)
    a("--ls", dest="loss_scaling", type=float, default=1.0)
    a("--lsg", dest="loss_scaling_g", type=float, default=1.0)
    a("--cfg_train_fake", type=float, default=1.0, help="kappa1")
    a("--cfg_eval_fake", type=float, default=1.0, help="kappa2=kappa3")
    a("--cfg_eval_real", type=float, default=1.0, help="kappa4")
    a("--init_timestep", type=int_range(0, 999), default=625)
    a("--tmin", type=int, default=20)
    a("--tmax", type=int, default=980)
    a("--alpha", type=float, default=1.0)
    a("--num_steps", type=int, default=1)
    a("--bf16", dest="use_bf16", type=parse_bool, default=True)
    a("--grad-ckpt", dest="gradient_checkpointing", type=parse_bool, default=False)
    a("--teacher-bf16", dest="teacher_bf16", type=parse_bool, default=False,
      help="Store the frozen teacher in bf16")
    a("--lowmem-opt", dest="low_mem_opt", type=parse_bool, default=False,
      help="Low-memory Adam state (no mu at b1=0, bf16 nu)")
    a("--fake_score_use_lora", type=parse_bool, default=False)
    a("--adv_weight_d", type=float, default=0.0, help="SiDA discriminator loss weight")
    a("--adv_weight_g", type=float, default=0.0, help="SiDA generator loss weight")
    a("--gan_loss", choices=["ns", "hinge"], default="ns")
    a("--adv_data", default=None, help="Real-latent corpus (.npz from encode_latents)")
    a("--adv_tower", choices=["encoder", "dino"], default="encoder",
      help="SiDA judge: psi's encoder or the projected DINO pixel discriminator")
    a("--adv_dino", default=None, help="timm DINO ViT state dict (torch.save) for --adv_tower dino")
    a("--adv_vit", choices=["s16", "tiny"], default="s16", help="DINO backbone: ViT-S/16 or tiny")
    a("--remat-policy", dest="remat_policy", choices=REMAT_CHOICES, default="full",
      help="With --grad-ckpt 1, what the UNet blocks keep for the backward: 'full' (their "
           "inputs only), 'dots' (every matmul/conv output), 'dots_no_batch' (the dense "
           "layers' outputs), 'attn' (the attention outputs), 'attn_offload' (the same, "
           "in pinned host memory) or 'flash' (the flash-attention op's out and lse)")
    a("--lora_rank", type=int, default=4)
    a("--fsdp", type=int, default=1,
      help="FSDP axis size: the state sharded over groups of this many ranks")
    a("--resolution", type=int, default=512)
    a("--metrics", default=None, help="Comma-separated metric names")
    a("--metric_data", default=None)
    a("--resume", default=None,
      help="'latest', a run directory with training-state dumps, or a generator snapshot "
           "file that G, the EMA and psi start from")
    a("--resume_kimg", type=int, default=0)
    a("--desc", default=None, help="Run-dir description suffix")
    a("--max-ticks", dest="max_ticks", type=int, default=None, help="Stop after N ticks")
    a("--profile-dir", dest="profile_dir", default=None,
      help="Capture a torch.profiler trace of a few steps here")
    a("--dry-run", dest="dry_run", action="store_true", help="Print options and exit")
    a("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def run_description(opts: argparse.Namespace) -> str:
    """The run dir's name after its number, as the JAX CLI builds it."""
    dataset_name = os.path.splitext(os.path.basename(opts.data))[0] if opts.data else "synthetic"
    desc = (f"{dataset_name}-{opts.sd_model.split('/')[-1].replace(':', '_')}"
            f"-glr{opts.glr:g}-lr{opts.lr:g}-kappa{opts.cfg_eval_real:g}-alpha{opts.alpha:g}"
            f"-batch{opts.batch:d}")
    return desc + (f"-{opts.desc}" if opts.desc else "")


def config_from_args(opts: argparse.Namespace) -> TrainConfig:
    """The ``TrainConfig`` of parsed flags (``run_dir`` left empty)."""
    return TrainConfig(
        run_dir="", data=opts.data, model=opts.sd_model, prediction_type=opts.prediction_type,
        resolution=opts.resolution, batch_size=opts.batch, microbatch=opts.batch_micro,
        glr=opts.glr, lr=opts.lr, optimizer=opts.optimizer, weight_decay=opts.weight_decay,
        cfg_train_fake=opts.cfg_train_fake, cfg_eval_fake=opts.cfg_eval_fake,
        cfg_eval_real=opts.cfg_eval_real, init_timestep=opts.init_timestep, tmin=opts.tmin,
        tmax=opts.tmax, alpha=opts.alpha, loss_scaling=opts.loss_scaling,
        loss_scaling_G=opts.loss_scaling_g, num_steps=opts.num_steps,
        ema_halflife_kimg=opts.ema_halflife_kimg, total_kimg=opts.duration,
        kimg_per_tick=opts.kimg_per_tick, snapshot_ticks=opts.snapshot_ticks,
        state_dump_ticks=opts.state_dump_ticks, seed=opts.seed, use_bf16=opts.use_bf16,
        gradient_checkpointing=opts.gradient_checkpointing, remat_policy=opts.remat_policy,
        adv_weight_D=opts.adv_weight_d, adv_weight_G=opts.adv_weight_g, gan_loss=opts.gan_loss,
        adv_data=opts.adv_data, adv_tower=opts.adv_tower, adv_dino=opts.adv_dino,
        adv_vit=opts.adv_vit, low_mem_opt=opts.low_mem_opt, teacher_bf16=opts.teacher_bf16,
        fake_score_use_lora=opts.fake_score_use_lora, lora_rank=opts.lora_rank, fsdp=opts.fsdp,
        metrics=opts.metrics.split(",") if opts.metrics else None, metric_data=opts.metric_data,
        resume=opts.resume, resume_kimg=opts.resume_kimg, max_ticks=opts.max_ticks,
        profile_dir=opts.profile_dir, device=opts.device,
    )


def main(argv: Optional[Sequence[str]] = None) -> Optional[SiDState]:
    """Parse, make the run dir, train; returns the final state (None on a dry run)."""
    opts = build_parser().parse_args(argv)
    desc = run_description(opts)
    cfg = config_from_args(opts)
    if opts.dry_run:
        print("Training options:")
        print(cfg.as_json())
        print(f"Output directory would be: {opts.outdir}/<id>-{desc}")
        print("Dry run; exiting.")
        return None
    runtime.init_distributed(opts.device)
    rank = runtime.get_process_index()
    if opts.nosubdir:
        cfg.run_dir = opts.outdir
        if rank == 0:
            os.makedirs(cfg.run_dir, exist_ok=True)
        runtime.sync_hosts("run-dir")
    else:
        if rank == 0:
            cfg.run_dir = make_run_dir(opts.outdir, desc)
        runtime.sync_hosts("run-dir")
        if rank != 0:
            cfg.run_dir = sorted(os.path.join(opts.outdir, d) for d in os.listdir(opts.outdir)
                                 if d.endswith(f"-{desc}"))[-1]
    logger = Logger(os.path.join(cfg.run_dir, "log.txt") if rank == 0 else None, "a")
    try:
        runtime.print0(f"Output directory: {cfg.run_dir}")
        runtime.print0("Training options:")
        runtime.print0(cfg.as_json())
        return training_loop(cfg)
    finally:
        logger.close()


if __name__ == "__main__":
    main()
