"""Training orchestration: run dir, ticks, grids, snapshots, stats.

Port of ``sid_lsg_tpu/training/loop.py`` for one process on one device
(the card unless ``TrainConfig.device`` says ``cpu``).  The host side is the
JAX package's: ``training_options.json``, the prompt stream, text encoding
once per batch (frozen tower), tick-cadenced console / ``log.txt`` /
``stats_{alpha}.jsonl`` reporting, fixed-seed sample grids
``fakes_{alpha:03f}_{kimg:06d}_{steps}.png`` and safetensors EMA snapshots.

Weights: ``model`` names an HF-layout checkpoint directory, or a preset /
``random:<preset>`` for random weights from ``seed``
(``pipeline.load_pretrained``); the teacher, G and psi start from its UNet.
``resume`` names a generator file (``runtime.checkpoint.load_generator_params``):
G, the EMA and a full-UNet psi each start from their own copy of it, a LoRA
psi keeps its factors and the pixel judge its heads.  What is not ported yet
is refused when the ``Trainer`` is built, each with the ROADMAP item that
brings it: resuming a training state (``latest`` or a run directory),
metrics, ``fsdp > 1``, orbax state dumps (which would also carry the
spectral ``u`` vectors of the SiDA pixel judge) and profiler traces.

SiDA (``adv_weight_D`` / ``adv_weight_G`` > 0): the ``encoder`` tower judges
with psi's encoder; the ``dino`` tower builds a ``ProjectedDiscriminator``
(TINY_VIT or ViT-S/16, random backbone unless ``adv_dino`` names a timm
state dict) whose trainable heads join ``params_fake`` as ``disc.*`` and
whose ``u`` vectors advance after every step (``refresh_spectral_u``).
Real latents come from ``adv_data`` or, without it, from a synthetic
normal stream (``RandomState(seed + 2)``, the JAX package's).
"""

from __future__ import annotations

import dataclasses
import json
import os
import resource
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..cli.pngio import write_png
from ..data.latents import InfiniteLatentIterator, LatentDataset
from ..data.prompts import InfinitePromptIterator, PromptDataset
from ..device import resolve_device
from ..diffusion.rng import StackedRandomGenerator
from ..diffusion.sampling import sid_sampler
from ..models.stylegan_discriminator import (
    DINO_VIT_S16,
    TINY_VIT,
    ProjectedDiscriminator,
    convert_dino,
    head_params,
    init_disc_weights_,
    refresh_spectral_u,
    spectral_buffers,
)
from ..models.unet import unet_apply_fn
from ..pipeline import SDPipeline, load_pretrained
from ..runtime.checkpoint import export_generator, load_generator_params
from ..utils import training_stats
from ..utils.util import EasyDict, format_time
from .adversarial import make_pixel_disc
from .distill import DISC_PREFIX, DistillConfig, make_train_step
from .lora import apply_lora, init_lora
from .state import SiDState, init_state, make_optimizer

# Early ticks that get sample grids regardless of the uniform cadence.
EARLY_SAMPLE_TICKS = (2, 4, 10, 20, 30, 40, 50, 60, 70, 80, 90, 100)


@dataclasses.dataclass
class TrainConfig:
    """The JAX package's ``TrainConfig`` (same fields and defaults) plus
    ``device``."""

    run_dir: str = "."
    data: str = ""  # prompt corpus path (file or dir)
    model: str = "sd15"  # checkpoint directory, preset or random:<preset>
    prediction_type: Optional[str] = None
    resolution: int = 512
    batch_size: int = 512
    microbatch: int = 8  # global batch per accumulation round
    glr: float = 1e-6
    lr: float = 1e-6
    adam_eps: float = 1e-8
    optimizer: str = "adam"  # 'adam' | 'adamw'
    weight_decay: float = 0.01  # applied only when optimizer == 'adamw'
    cfg_train_fake: float = 1.0
    cfg_eval_fake: float = 1.0
    cfg_eval_real: float = 1.0
    init_timestep: int = 625
    tmin: int = 20
    tmax: int = 980
    alpha: float = 1.0
    loss_scaling: float = 1.0
    loss_scaling_G: float = 1.0
    num_steps: int = 1
    ema_halflife_kimg: float = 500.0
    ema_rampup_ratio: Optional[float] = 0.05
    total_kimg: int = 200000
    kimg_per_tick: int = 50
    snapshot_ticks: int = 50
    state_dump_ticks: int = 500
    sample_ticks: int = 50
    seed: int = 0
    adv_weight_D: float = 0.0
    adv_weight_G: float = 0.0
    gan_loss: str = "ns"
    adv_data: Optional[str] = None
    adv_tower: str = "encoder"
    adv_dino: Optional[str] = None
    adv_vit: str = "s16"
    use_bf16: bool = True
    gradient_checkpointing: bool = False
    remat_policy: str = "full"
    low_mem_opt: bool = False
    teacher_bf16: bool = False
    fake_score_use_lora: bool = False
    lora_rank: int = 4
    fsdp: int = 1
    metrics: Optional[List[str]] = None
    metric_data: Optional[str] = None
    metric_ticks: int = 50
    metric_num_gen: int = 30000
    profile_dir: Optional[str] = None
    profile_start_step: int = 2
    profile_steps: int = 3
    resume: Optional[str] = None
    resume_kimg: int = 0
    max_ticks: Optional[int] = None
    device: str = "cuda"

    def as_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)


def last_tick(cfg: TrainConfig) -> int:
    """Index of the run's last tick under the loop below: tick 0 after the
    first step, then one tick per ``kimg_per_tick`` (each step when 0), the
    last one cut short by ``total_kimg`` or ``max_ticks``."""
    steps = max(1, -(-cfg.total_kimg * 1000 // cfg.batch_size))
    per_tick = max(1, -(-cfg.kimg_per_tick * 1000 // cfg.batch_size))
    ticks = -(-(steps - 1) // per_tick)
    return ticks if cfg.max_ticks is None else min(ticks, cfg.max_ticks)


def refuse_unported(cfg: TrainConfig) -> None:
    """Raise ``ValueError`` for an option whose feature is not ported yet."""
    resume_state = cfg.resume == "latest" or (
        cfg.resume is not None and os.path.isdir(os.path.join(cfg.resume, "checkpoints")))
    checks = [
        (resume_state,
         f"resume {cfg.resume!r}: resuming a training state is not ported yet (ROADMAP Queue 1 "
         f"item 5); pass a generator snapshot file"),
        (bool(cfg.metrics), "metrics during training are not ported yet (ROADMAP Queue 1 item 7)"),
        (cfg.fsdp > 1, "fsdp > 1 (torch.distributed) is not ported yet (ROADMAP Queue 1 item 5)"),
        (cfg.state_dump_ticks > 0 and last_tick(cfg) >= cfg.state_dump_ticks,
         f"this schedule reaches a state dump at tick {cfg.state_dump_ticks} (last tick "
         f"{last_tick(cfg)}); state dumps are not ported yet (ROADMAP Queue 1 item 5): pass "
         f"--dump 0 or fewer ticks"),
        (cfg.profile_dir is not None,
         "profiler traces of the loop are not ported yet (ROADMAP Queue 1 item 5)"),
    ]
    for bad, msg in checks:
        if bad:
            raise ValueError(msg)
    if cfg.batch_size % cfg.microbatch:
        raise ValueError(f"batch_size {cfg.batch_size} is not a multiple of microbatch "
                         f"{cfg.microbatch}")
    if cfg.remat_policy != "full" and not cfg.gradient_checkpointing:
        raise ValueError(f"remat_policy={cfg.remat_policy!r} has no effect without "
                         "gradient_checkpointing: pass --grad-ckpt 1")


def save_image_grid(images: np.ndarray, path: str, grid_wh=None) -> None:
    """uint8 (N, H, W, 3) -> one PNG grid."""
    n, h, w, _ = images.shape
    gw = grid_wh[0] if grid_wh else int(np.ceil(np.sqrt(n)))
    gh = grid_wh[1] if grid_wh else int(np.ceil(n / gw))
    canvas = np.zeros((gh * h, gw * w, 3), np.uint8)
    for i in range(n):
        r, c = divmod(i, gw)
        canvas[r * h:(r + 1) * h, c * w:(c + 1) * w] = images[i]
    write_png(path, canvas)


class Trainer:
    """Owns the pipeline (text tower, VAE, scheduler), the state, the step
    and the tick loop."""

    def __init__(self, cfg: TrainConfig):
        refuse_unported(cfg)
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        dtype = torch.bfloat16 if cfg.use_bf16 else torch.float32
        # What SDPipeline.from_pretrained builds, keeping the f32 UNet.
        sd_cfg, sds, tokenizer = load_pretrained(cfg.model, self.device, cfg.seed)
        self.pipe = SDPipeline(sd_cfg, sds, tokenizer=tokenizer, dtype=dtype, device=self.device,
                               prediction_type=cfg.prediction_type)
        unet_f32 = {k: v.to(self.device) for k, v in sds.pop("unet").items()}
        del sds
        # G's (and the EMA's and a full psi's) starting weights.
        g_init = unet_f32
        if cfg.resume is not None:
            g_init = {k: v.to(self.device)
                      for k, v in load_generator_params(cfg.resume, sd_cfg.unet).items()}
        self.a_rounds = cfg.batch_size // cfg.microbatch
        self.dcfg = DistillConfig(
            latent_size=sd_cfg.unet.sample_size, latent_channels=sd_cfg.unet.in_channels,
            init_timestep=cfg.init_timestep, tmin=cfg.tmin, tmax=cfg.tmax,
            cfg_train_fake=cfg.cfg_train_fake, cfg_eval_fake=cfg.cfg_eval_fake,
            cfg_eval_real=cfg.cfg_eval_real, alpha=cfg.alpha, loss_scaling=cfg.loss_scaling,
            loss_scaling_G=cfg.loss_scaling_G, num_steps=cfg.num_steps,
            batch_size=cfg.batch_size, ema_halflife_kimg=cfg.ema_halflife_kimg,
            ema_rampup_ratio=cfg.ema_rampup_ratio, dtype=dtype, adv_weight_D=cfg.adv_weight_D,
            adv_weight_G=cfg.adv_weight_G, gan_loss=cfg.gan_loss, adv_tower=cfg.adv_tower,
        )
        remat = cfg.remat_policy if cfg.gradient_checkpointing else None
        self.unet_apply = unet_apply_fn(sd_cfg.unet, dtype, remat_policy=remat)
        unet_encode = (unet_apply_fn(sd_cfg.unet, dtype, remat_policy=remat, encoder_only=True)
                       if self.dcfg.adversarial and cfg.adv_tower == "encoder" else None)
        wd = cfg.weight_decay if cfg.optimizer == "adamw" else 0.0
        self.opt_g = make_optimizer(lr=cfg.glr, eps=cfg.adam_eps, low_mem_state=cfg.low_mem_opt,
                                    weight_decay=wd)
        self.opt_fake = make_optimizer(lr=cfg.lr, eps=cfg.adam_eps,
                                       low_mem_state=cfg.low_mem_opt and not cfg.fake_score_use_lora,
                                       weight_decay=wd)
        fake_transform, params_fake_init = None, None
        if cfg.fake_score_use_lora:
            lora_gen = torch.Generator(self.device).manual_seed(cfg.seed + 1)
            params_fake_init = init_lora(lora_gen, unet_f32, rank=cfg.lora_rank)
            fake_transform = lambda pf, teacher: apply_lora(teacher, pf)
        self.disc: Optional[ProjectedDiscriminator] = None
        pixel_disc = None
        if self.dcfg.adversarial and cfg.adv_tower == "dino":
            self.disc = self._build_disc(sd_cfg.unet.cross_attention_dim)
            pixel_disc = make_pixel_disc(self.pipe.vae, self.disc, sd_cfg.vae.scaling_factor)
            # psi and the judge's heads share psi's optimizer.
            params_fake_init = {**(g_init if params_fake_init is None else params_fake_init),
                                **{DISC_PREFIX + k: v for k, v in head_params(self.disc).items()}}
        # The state holds the three trainables (f32 masters); the teacher
        # stays a separate frozen dict.
        self.state: SiDState = init_state(g_init, self.opt_g, self.opt_fake,
                                          resume_nimg=cfg.resume_kimg * 1000,
                                          params_fake=params_fake_init)
        del g_init
        if cfg.teacher_bf16 and not cfg.use_bf16:
            print("WARNING: --teacher-bf16 with f32 compute (--bf16 0) quantizes the frozen "
                  "teacher and DOES change numerics; it is numerically free only under bf16 "
                  "compute.")
        self.teacher: Dict[str, torch.Tensor] = (
            {k: v.to(torch.bfloat16) for k, v in unet_f32.items()} if cfg.teacher_bf16 else unet_f32)
        self.train_step = make_train_step(self.unet_apply, self.pipe.scheduler, self.dcfg,
                                          self.opt_g, self.opt_fake, fake_transform=fake_transform,
                                          unet_encode=unet_encode, pixel_disc=pixel_disc)
        dataset = (PromptDataset(cfg.data) if cfg.data
                   else PromptDataset([f"prompt {i}" for i in range(1024)], name="synthetic"))
        self.prompts = InfinitePromptIterator(dataset, cfg.microbatch, seed=cfg.seed)
        # All draws of the step (see the training.distill docstring), on the host.
        self.generator = torch.Generator().manual_seed(cfg.seed)
        self._init_real_latents()

    def _build_disc(self, text_dim: int) -> ProjectedDiscriminator:
        """The pixel judge: random weights from ``seed + 3``, the backbone
        from ``adv_dino`` when given; frozen as a module (its heads train as
        ``disc.*`` entries of ``params_fake``)."""
        cfg = self.cfg
        vit_cfg = TINY_VIT if cfg.adv_vit == "tiny" else DINO_VIT_S16
        # power_iters=3 sweeps per call from the persistent u refreshed
        # after every step (Trainer.step).
        disc = ProjectedDiscriminator(c_dim=text_dim, vit=vit_cfg, power_iters=3).to(self.device)
        init_disc_weights_(disc, torch.Generator(self.device).manual_seed(cfg.seed + 3))
        if cfg.adv_dino:
            state = torch.load(cfg.adv_dino, map_location="cpu", weights_only=True)
            disc.dino.load_state_dict(convert_dino(state, vit_cfg), strict=True)
        else:
            print("WARNING: --adv_tower dino without --adv_dino uses a RANDOM DINO backbone - "
                  "smoke/testing only.")
        if self.dcfg.adv_weight_D == 0.0:
            print("WARNING: --adv_tower dino with adv_weight_d == 0 - the spectral heads receive "
                  "no gradients (only the D loss trains them), so the G term judges with random "
                  "heads.")
        return disc.eval().requires_grad_(False)

    def _init_real_latents(self) -> None:
        """The real-latent stream: only the D loss reads it."""
        cfg = self.cfg
        self.latents: Optional[InfiniteLatentIterator] = None
        if cfg.adv_data and self.dcfg.adv_weight_D == 0.0:
            print("WARNING: --adv_data is set but adv_weight_d == 0 - the real-latent corpus will "
                  "NOT be read (only the discriminator loss consumes real latents).")
        if self.dcfg.adv_weight_D <= 0.0:
            return
        if cfg.adv_data:
            lat_ds = LatentDataset(cfg.adv_data)
            h = lat_ds.latents.shape[1]
            if h != self.dcfg.latent_size:
                raise ValueError(f"{cfg.adv_data}: latent resolution {h} != model latent size "
                                 f"{self.dcfg.latent_size}")
            self.latents = InfiniteLatentIterator(lat_ds, cfg.microbatch, seed=cfg.seed + 2)
        else:
            print("WARNING: adversarial training without --adv_data uses SYNTHETIC random "
                  "latents - smoke/testing only.")
            self._adv_rng = np.random.RandomState(cfg.seed + 2)

    # ------------------------------------------------------------------ io
    def _encode_rounds(self) -> torch.Tensor:
        """(A, mb, L, D) embeddings for one phase: A fresh prompt microbatches."""
        prompts: List[str] = []
        for _ in range(self.a_rounds):
            prompts.extend(next(self.prompts))
        emb = self.pipe.encode_prompts(prompts)
        return emb.reshape(self.a_rounds, self.cfg.microbatch, *emb.shape[1:])

    def _adv_rounds(self):
        """(A, mb, 4, h, w) real latents and (A, mb, L, D) caption embeddings."""
        mb, rounds = self.cfg.microbatch, self.a_rounds
        if self.latents is not None:
            lats, caps = [], []
            for _ in range(rounds):
                lat, cap = next(self.latents)
                lats.append(lat)
                caps.extend(cap)
            lat = np.stack(lats)
        else:
            s, c = self.dcfg.latent_size, self.dcfg.latent_channels
            lat = self._adv_rng.randn(rounds, mb, s, s, c).astype(np.float32)
            caps = [p for _ in range(rounds) for p in next(self.prompts)]
        emb = self.pipe.encode_prompts(caps)
        lat = torch.from_numpy(lat).permute(0, 1, 4, 2, 3).contiguous().to(self.device)
        return lat, emb.reshape(rounds, mb, *emb.shape[1:])

    def next_batch(self) -> Dict[str, torch.Tensor]:
        batch = {"emb_fake": self._encode_rounds(), "emb_g": self._encode_rounds(),
                 "uncond_emb": self.pipe.uncond_embedding()}
        if self.dcfg.adv_weight_D > 0.0:
            batch["lat_real"], batch["emb_real"] = self._adv_rounds()
        return batch

    def step(self) -> Dict[str, torch.Tensor]:
        """One train step on the next batch, then (pixel judge) the spectral
        ``u`` vectors advanced against the heads it just updated; returns the
        step's metrics."""
        self.state, metrics = self.train_step(self.state, self.teacher, self.next_batch(),
                                              self.generator)
        if self.disc is not None:
            heads = {k[len(DISC_PREFIX):]: v for k, v in self.state.params_fake.items()
                     if k.startswith(DISC_PREFIX)}
            buffers = spectral_buffers(self.disc)
            with torch.no_grad():
                for k, u in refresh_spectral_u(heads, buffers).items():
                    buffers[k].copy_(u)
        return metrics

    def save_snapshot(self, kimg: int) -> str:
        tag = f"{self.cfg.alpha:g}".replace(".", "_")
        path = os.path.join(self.cfg.run_dir, f"network-snapshot-{tag}-{kimg:06d}.safetensors")
        export_generator(self.state.ema, path)
        return path

    @torch.no_grad()
    def _eval_images(self, prompts: List[str], lat: torch.Tensor, num_steps_eval: int) -> np.ndarray:
        """EMA generator samples (latents NCHW) -> uint8 images (N, H, W, 3)."""
        emb = self.pipe.encode_prompts(prompts)
        init_t = torch.full((lat.shape[0],), self.cfg.init_timestep, dtype=torch.long,
                            device=self.device)
        apply = lambda x, t, c: self.unet_apply(self.state.ema, x, t, c)
        x0 = sid_sampler(apply, lat, emb, init_t, self.pipe.scheduler, num_steps=num_steps_eval,
                         generator=torch.Generator().manual_seed(2024), dtype=self.dcfg.dtype)
        return self.pipe.decode(x0.permute(0, 2, 3, 1)).cpu().numpy()

    def sample_grid(self, kimg: int, num_steps_eval: int = 1, n: int = 16) -> str:
        """Deterministic sample grid: prompts and latents from fixed seeds."""
        idx = np.random.RandomState(2024).randint(len(self.prompts.dataset), size=n)
        prompts = [self.prompts.dataset[i] for i in idx]
        s, c = self.dcfg.latent_size, self.dcfg.latent_channels
        lat = StackedRandomGenerator(range(n), self.device).randn((n, c, s, s))
        path = os.path.join(self.cfg.run_dir,
                            f"fakes_{self.cfg.alpha:03f}_{kimg:06d}_{num_steps_eval:d}.png")
        save_image_grid(self._eval_images(prompts, lat, num_steps_eval), path)
        return path

    @staticmethod
    def _flush_metrics(pending: list) -> None:
        """Queued per-step metric tensors into training_stats (one host sync
        per tick instead of per step)."""
        for m in pending:
            training_stats.report("fake_score_Loss/loss", float(m["fake_score_loss"]))
            training_stats.report("G_Loss/loss", float(m["g_loss"]))
            if "adv_d_loss" in m:
                training_stats.report("Adv/d_loss", float(m["adv_d_loss"]))
                training_stats.report("Adv/d_logit_real", float(m["d_logit_real"]))
                training_stats.report("Adv/d_logit_fake", float(m["d_logit_fake"]))
            if "adv_g_loss" in m:
                training_stats.report("Adv/g_loss", float(m["adv_g_loss"]))
        pending.clear()

    # ---------------------------------------------------------------- loop
    def run(self) -> SiDState:
        cfg = self.cfg
        cur_nimg = int(self.state.nimg)
        tick_start_nimg, cur_tick = cur_nimg, 0
        start_time = tick_start_time = time.time()
        maintenance_time = 0.0
        stats_jsonl = None
        collector = training_stats.Collector(regex=".*")
        print(f"Training for {cfg.total_kimg} kimg (batch {cfg.batch_size}, "
              f"{self.a_rounds} accumulation rounds) on {self.device}...", flush=True)
        pending: list = []
        while True:
            pending.append(self.step())
            cur_nimg += cfg.batch_size
            if len(pending) >= 256:
                self._flush_metrics(pending)
            done = cur_nimg >= cfg.total_kimg * 1000
            if cfg.max_ticks is not None and cur_tick >= cfg.max_ticks:
                done = True
            if (not done and cur_tick != 0
                    and cur_nimg < tick_start_nimg + cfg.kimg_per_tick * 1000):
                continue

            # ---- tick ----
            self._flush_metrics(pending)
            tick_end_time = time.time()
            collector.update()
            fields = EasyDict()
            fields.tick = cur_tick
            fields.kimg = cur_nimg / 1000.0
            fields.time = format_time(tick_end_time - start_time)
            fields.sec_per_tick = tick_end_time - tick_start_time
            fields.sec_per_kimg = fields.sec_per_tick / max((cur_nimg - tick_start_nimg) / 1000.0,
                                                            1e-8)
            fields.maintenance = maintenance_time
            fields.fake_loss = collector.mean("fake_score_Loss/loss")
            fields.g_loss = collector.mean("G_Loss/loss")
            fields.cpumem_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
            fields.devmem_gb = (torch.cuda.max_memory_allocated(self.device) / 2**30
                                if self.device.type == "cuda" else 0.0)
            print(f"tick {fields.tick:<5d} kimg {fields.kimg:<9.1f} "
                  f"time {fields.time:<12s} sec/tick {fields.sec_per_tick:<8.1f} "
                  f"sec/kimg {fields.sec_per_kimg:<8.2f} "
                  f"fake_loss {fields.fake_loss:<10.4f} g_loss {fields.g_loss:<10.4f} "
                  f"cpumem {fields.cpumem_gb:<6.2f} devmem {fields.devmem_gb:<6.2f}", flush=True)
            maintenance_start = time.time()
            have_dir = os.path.isdir(cfg.run_dir)
            if have_dir:
                if stats_jsonl is None:
                    stats_jsonl = open(os.path.join(cfg.run_dir, f"stats_{cfg.alpha:g}.jsonl"), "at")
                stats_jsonl.write(json.dumps(
                    {**{k: float(v) if isinstance(v, (int, float)) else v for k, v in fields.items()},
                     "timestamp": time.time()}) + "\n")
                stats_jsonl.flush()
            if cfg.sample_ticks and have_dir and (
                    done or cur_tick % cfg.sample_ticks == 0 or cur_tick in EARLY_SAMPLE_TICKS):
                for nse in (1, 2, 4):
                    self.sample_grid(cur_nimg // 1000, num_steps_eval=nse)
            if cfg.snapshot_ticks and cur_tick and cur_tick % cfg.snapshot_ticks == 0 and have_dir:
                self.save_snapshot(cur_nimg // 1000)
            maintenance_time = time.time() - maintenance_start
            cur_tick += 1
            tick_start_nimg = cur_nimg
            tick_start_time = time.time()
            if done:
                break
        if stats_jsonl is not None:
            stats_jsonl.close()
        print("Exiting...", flush=True)
        return self.state


def training_loop(cfg: TrainConfig) -> SiDState:
    """Write ``training_options.json`` into the run dir, build, run."""
    if cfg.run_dir and cfg.run_dir != ".":
        os.makedirs(cfg.run_dir, exist_ok=True)
        with open(os.path.join(cfg.run_dir, "training_options.json"), "w") as f:
            f.write(cfg.as_json())
    return Trainer(cfg).run()
