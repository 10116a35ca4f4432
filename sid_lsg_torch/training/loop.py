"""Training orchestration: run dir, ticks, grids, snapshots, stats.

Port of ``sid_lsg_tpu/training/loop.py``, on the card unless
``TrainConfig.device`` says ``cpu``: one process, or one process per card
under torchrun (``parallel``).  The host side is the JAX package's:
``training_options.json``, the prompt stream, text encoding once per batch
(frozen tower), tick-cadenced console / ``log.txt`` / ``stats_{alpha}.jsonl``
reporting, fixed-seed sample grids ``fakes_{alpha:03f}_{kimg:06d}_{steps}.png``
and safetensors EMA snapshots.

Weights: ``model`` names an HF-layout checkpoint directory, or a preset /
``random:<preset>`` for random weights from ``seed``
(``pipeline.load_pretrained``); the teacher, G and psi start from its UNet.
``resume`` names a generator file (``runtime.checkpoint.load_generator_params``):
G, the EMA and a full-UNet psi each start from their own copy of it, a LoRA
psi keeps its factors and the pixel judge its heads.  ``resume='latest'``
(this run dir) or a run directory restores a training-state dump instead
(``training_loop``).

State dumps (``state_dump_ticks``) go to ``<run_dir>/checkpoints/<step>``
through ``runtime.checkpoint.CheckpointManager``.  The JAX step folds the step
number into a fixed key, so its state alone resumes it; this port draws every
step from one advancing CPU generator and from the prompt (and real-latent)
iterators, so a dump also carries their states and, with the pixel judge,
the spectral ``u`` vectors.  A run resumed from a dump takes the same next
step as the run that was never stopped.  A JAX run's orbax dump, converted
by ``scripts/jax_dump_to_torch.py``, carries the state alone and says so
(``converted_from``): the generator and the iterators start from their
seeds; an orbax dump itself is refused, naming the script.  ``profile_dir`` traces steps
``[profile_start_step, profile_start_step + profile_steps)`` with
``torch.profiler``; ``metrics`` run on the EMA generator at the snapshot
ticks that are also metric ticks (``eval_metrics``).  After each tick the run
leaves when ``parallel.runtime.should_stop`` (the ``$SIDLSG_STOP_FILE``
graceful stop, agreed across ranks) says so.

Across processes each rank feeds ``microbatch / W`` rows a round from its
stride of the prompt (and real-latent) streams; the step draws for the whole
microbatch and keeps its rows (``training.distill``).  With ``fsdp > 1`` the
state's G, psi, EMA and Adam moments are flat shards (``parallel.mesh``); the
frozen teacher stays whole on every rank.  Rank 0 writes every file (logs,
stats, grids, snapshots, dumps, metric reports); the others join the
collectives the writes need (the EMA gathered for a grid or snapshot, the
state gathered a part at a time and every rank's stream states for a dump)
and meet rank 0 at a barrier after each.  A dump has one layout at every world size: whole
tensors, the step generator's state, and the stream states (a list, one a
rank, above one process); it resumes at any world size and ``fsdp``, its
streams only at the world size that wrote it (elsewhere they restart from
their seeds, with a warning).

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
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..cli.pngio import write_png
from ..data.latents import InfiniteLatentIterator, LatentDataset
from ..data.prompts import (InfinitePromptIterator, PromptDataset, random_state_dict,
                            set_random_state)
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
from ..ops import registry
from ..parallel import mesh as pmesh
from ..parallel import runtime
from ..pipeline import SDPipeline, load_pretrained
from ..runtime.checkpoint import (CheckpointManager, check_like, export_generator, fill_like,
                                  load_generator_params, refuse_orbax)
from ..utils import training_stats
from ..utils.misc import cpu_memory_gb, peak_device_memory_gb, start_profiler_trace
from ..utils.util import EasyDict, format_time
from .adversarial import make_pixel_disc
from .distill import DISC_PREFIX, FLAT, DistillConfig, make_train_step
from .lora import apply_lora, init_lora
from .state import SiDState, init_state, make_optimizer

STREAMS = ("prompts", "latents", "adv_rng")  # per-rank entries of a dump

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
    microbatch: int = 8  # global batch per accumulation round (all ranks)
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


def resumes_state(cfg: TrainConfig) -> bool:
    """Whether ``resume`` names a training state (``latest`` or a run
    directory with dumps) rather than a generator file."""
    return cfg.resume == "latest" or (
        cfg.resume is not None and os.path.isdir(os.path.join(cfg.resume, "checkpoints")))


def refuse_unported(cfg: TrainConfig) -> None:
    """Raise ``ValueError`` for an option whose feature is not ported yet,
    or that contradicts another."""
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
        # Under torchrun: the process group (a no-op without one) and this
        # rank's card; ``mesh`` stays None for one process without torchrun.
        self.device = runtime.init_distributed(cfg.device)
        mesh = pmesh.make_mesh(fsdp=cfg.fsdp)
        self.mesh = mesh if runtime.is_distributed() else None
        self.rank, self.world = runtime.get_process_index(), runtime.get_process_count()
        self.mb_local = pmesh.process_local_rows(cfg.microbatch)
        if (cfg.adv_tower == "dino" and (cfg.adv_weight_D > 0.0 or cfg.adv_weight_G > 0.0)
                and self.world > 1 and self.mb_local % 8):
            raise ValueError(
                f"--adv_tower dino on {self.world} processes needs a multiple of 8 rows a rank "
                f"(microbatch {cfg.microbatch} gives {self.mb_local}): the pixel judge's "
                "BatchNormLocal normalises groups of 8 rows of the global microbatch, and a "
                "rank sees only its own rows")
        dtype = torch.bfloat16 if cfg.use_bf16 else torch.float32
        # What SDPipeline.from_pretrained builds, keeping the f32 UNet.
        sd_cfg, sds, tokenizer = load_pretrained(cfg.model, self.device, cfg.seed)
        self.pipe = SDPipeline(sd_cfg, sds, tokenizer=tokenizer, dtype=dtype, device=self.device,
                               prediction_type=cfg.prediction_type)
        unet_f32 = {k: v.to(self.device) for k, v in sds.pop("unet").items()}
        del sds
        # G's (and the EMA's and a full psi's) starting weights.
        g_init = unet_f32
        if cfg.resume is not None and not resumes_state(cfg):
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
        self.shards: Optional[Dict[str, pmesh.FlatShard]] = None
        if mesh.sharded:
            self.state = self._sharded_state(g_init, params_fake_init)
        else:
            self.state: SiDState = init_state(g_init, self.opt_g, self.opt_fake,
                                              resume_nimg=cfg.resume_kimg * 1000,
                                              params_fake=params_fake_init)
        del g_init, params_fake_init
        if cfg.teacher_bf16 and not cfg.use_bf16:
            print("WARNING: --teacher-bf16 with f32 compute (--bf16 0) quantizes the frozen "
                  "teacher and DOES change numerics; it is numerically free only under bf16 "
                  "compute.")
        self.teacher: Dict[str, torch.Tensor] = (
            {k: v.to(torch.bfloat16) for k, v in unet_f32.items()} if cfg.teacher_bf16 else unet_f32)
        self.train_step = make_train_step(self.unet_apply, self.pipe.scheduler, self.dcfg,
                                          self.opt_g, self.opt_fake, fake_transform=fake_transform,
                                          unet_encode=unet_encode, pixel_disc=pixel_disc,
                                          mesh=self.mesh, shards=self.shards)
        dataset = (PromptDataset(cfg.data) if cfg.data
                   else PromptDataset([f"prompt {i}" for i in range(1024)], name="synthetic"))
        self.prompts = InfinitePromptIterator(dataset, self.mb_local, seed=cfg.seed,
                                              process_index=self.rank, process_count=self.world)
        # All draws of the step (see the training.distill docstring), on the host.
        self.generator = torch.Generator().manual_seed(cfg.seed)
        self._init_real_latents()
        self.ckpt_mgr: Optional[CheckpointManager] = None

    def _sharded_state(self, g_init, fake_init) -> SiDState:
        """The state as flat shards (``fsdp > 1``): G, the EMA and psi each
        ``{FLAT: shard}``, and the moments made on the shards."""
        fake_init = g_init if fake_init is None else fake_init
        self.shards = {"params_G": pmesh.FlatShard(g_init, self.mesh),
                       "params_fake": pmesh.FlatShard(fake_init, self.mesh)}
        g = {FLAT: self.shards["params_G"].shard(g_init)}
        fake = {FLAT: self.shards["params_fake"].shard(fake_init)}
        ema = {FLAT: g[FLAT].clone()}
        return SiDState(step=0, nimg=float(self.cfg.resume_kimg * 1000), params_G=g,
                        params_fake=fake, ema=ema, opt_G=self.opt_g.init(g),
                        opt_fake=self.opt_fake.init(fake))

    def _shard_of(self, part: str) -> pmesh.FlatShard:
        return self.shards["params_fake" if "fake" in part else "params_G"]

    def whole(self, part: str, params=None, prefix: str = "") -> Dict[str, torch.Tensor]:
        """A state part (``params_G``, ``params_fake``, ``ema``, or a moment
        dict of ``opt_G`` / ``opt_fake`` passed as ``params``) as whole
        tensors, its entries whose keys start with ``prefix``: the live dict,
        or under FSDP gathered from the shards (a collective: every rank calls
        it; with a ``prefix``, only the flat range of those entries moves)."""
        params = getattr(self.state, part) if params is None else params
        if self.shards is None:
            return {k: v for k, v in params.items() if k.startswith(prefix)}
        shard = self._shard_of(part)
        if not prefix:
            return shard.full(params[FLAT])
        return shard.some(params[FLAT], [k for k in shard.keys if k.startswith(prefix)])

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
        self._adv_rng: Optional[np.random.RandomState] = None
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
            self.latents = InfiniteLatentIterator(lat_ds, self.mb_local, seed=cfg.seed + 2,
                                                  process_index=self.rank,
                                                  process_count=self.world)
        else:
            print("WARNING: adversarial training without --adv_data uses SYNTHETIC random "
                  "latents - smoke/testing only.")
            # Per rank: the ranks' slabs must differ (the real iterators stride).
            self._adv_rng = np.random.RandomState(cfg.seed + 2 + 1000 * self.rank)

    # ------------------------------------------------------------------ io
    def _encode_rounds(self) -> torch.Tensor:
        """(A, mb, L, D) embeddings for one phase: A fresh prompt microbatches."""
        prompts: List[str] = []
        for _ in range(self.a_rounds):
            prompts.extend(next(self.prompts))
        emb = self.pipe.encode_prompts(prompts)
        return emb.reshape(self.a_rounds, self.mb_local, *emb.shape[1:])

    def _adv_rounds(self):
        """(A, mb, 4, h, w) real latents and (A, mb, L, D) caption embeddings."""
        mb, rounds = self.mb_local, self.a_rounds
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
            heads = {k[len(DISC_PREFIX):]: v
                     for k, v in self.whole("params_fake", prefix=DISC_PREFIX).items()}
            buffers = spectral_buffers(self.disc)
            with torch.no_grad():
                for k, u in refresh_spectral_u(heads, buffers).items():
                    buffers[k].copy_(u)
        return metrics

    def save_snapshot(self, kimg: int) -> Optional[str]:
        """The EMA as a safetensors file, written by rank 0 (every rank calls
        it: under FSDP the EMA is gathered first); its path, on every rank."""
        tag = f"{self.cfg.alpha:g}".replace(".", "_")
        path = os.path.join(self.cfg.run_dir, f"network-snapshot-{tag}-{kimg:06d}.safetensors")
        ema = self.whole("ema")
        if self.rank == 0:
            export_generator(ema, path)
        runtime.sync_hosts("snapshot")
        return path

    def _state_tree(self) -> dict:
        """The dump's ``state``: the live tensors, or under FSDP shape-only
        stand-ins of the whole ones (to check a dump against, and to write
        it: ``_gathered_parts``)."""
        st = self.state

        def part(name, params):
            if self.shards is None or params is None:
                return params
            return self._shard_of(name).meta(params[FLAT].dtype)

        opt = lambda name, a: {"count": a.count, "mu": part(name, a.mu), "nu": part(name, a.nu)}
        return {"step": st.step, "nimg": st.nimg, "params_G": part("params_G", st.params_G),
                "params_fake": part("params_fake", st.params_fake),
                "ema": part("ema", st.ema), "opt_G": opt("opt_G", st.opt_G),
                "opt_fake": opt("opt_fake", st.opt_fake)}

    def _sharded_parts(self):
        """Under FSDP: (key path in the dump, name, live ``{FLAT: shard}``) of
        each sharded part of the state."""
        st = self.state
        for keys, name, params in ((("params_G",), "params_G", st.params_G),
                                   (("params_fake",), "params_fake", st.params_fake),
                                   (("ema",), "ema", st.ema),
                                   (("opt_G", "mu"), "opt_G", st.opt_G.mu),
                                   (("opt_G", "nu"), "opt_G", st.opt_G.nu),
                                   (("opt_fake", "mu"), "opt_fake", st.opt_fake.mu),
                                   (("opt_fake", "nu"), "opt_fake", st.opt_fake.nu)):
            if params is not None:
                yield ("state",) + keys, name, params

    def _gathered_parts(self):
        """Under FSDP, each sharded part gathered whole, one at a time (a
        collective: every rank walks it to its end)."""
        for keys, name, params in self._sharded_parts():
            yield keys, self.whole(name, params)

    def _streams(self) -> dict:
        out = {"prompts": self.prompts.state_dict()}
        if self.latents is not None:
            out["latents"] = self.latents.state_dict()
        if self._adv_rng is not None:
            out["adv_rng"] = random_state_dict(self._adv_rng)
        return out

    def _ckpt_tree(self, spectral: bool = True) -> dict:
        """A dump's payload: the state (its tensors are the live ones in one
        process), the step generator's state, the iterators' states and, with
        the pixel judge, its spectral ``u`` vectors (the JAX layout without
        them is the pre-spectral one, ``spectral=False``).  Under FSDP the
        state's sharded parts are shape-only stand-ins (``save_state`` writes
        them a part at a time).  Above one process every rank calls it: each
        stream entry is the list of every rank's state."""
        tree = {"state": self._state_tree(), "rng": self.generator.get_state()}
        streams = self._streams()
        if self.world > 1:
            gathered = [None] * self.world
            torch.distributed.all_gather_object(gathered, streams)
            streams = {k: [g[k] for g in gathered] for k in streams}
        tree.update(streams)
        if self.disc is not None and spectral:
            tree["spectral"] = spectral_buffers(self.disc)
        return tree

    def _accept_streams(self, streams: dict) -> None:
        """This rank's stream states from a dump's entries; the streams of a
        dump written by another number of processes restart from their seeds."""
        mine = {"prompts": self.prompts}
        if self.latents is not None:
            mine["latents"] = self.latents
        if self._adv_rng is not None:
            mine["adv_rng"] = self._adv_rng
        missing = sorted(set(mine) - set(streams))
        if missing:
            raise KeyError(f"the dump has no stream state for {missing}")
        per_rank = {k: [v] if isinstance(v, dict) else list(v) for k, v in streams.items()}
        dumped = len(per_rank["prompts"])
        if dumped != self.world:
            runtime.print0(f"WARNING: the dump was written by {dumped} process(es) and this run has "
                           f"{self.world}: the state is restored, the data streams restart from "
                           "their seeds.", flush=True)
            return
        for k, it in mine.items():
            state = per_rank[k][self.rank]
            if k == "adv_rng":
                set_random_state(it, state)
            else:
                it.load_state_dict(state)

    def restore_from(self, mgr: CheckpointManager, step: Optional[int] = None) -> None:
        """Restore a dump (every rank reads the file memory-mapped and takes
        what it holds: the whole tensors, or its shards), falling back to the
        pre-spectral layout for a dump without the judge's ``u`` vectors.
        Only a key or shape mismatch falls back (read failures propagate),
        and the fallback warns: the ``u`` vectors stay at their start, so
        sigma is under-estimated until power iteration converges again."""
        loaded = mgr.restore(step)
        converted = loaded.pop("converted_from", None)
        streams = {k: loaded.pop(k) for k in STREAMS if k in loaded}
        template = {"state": self._state_tree(), "rng": self.generator.get_state()}
        if converted is not None:  # scripts/jax_dump_to_torch.py's: no generator or streams
            del template["rng"]
        if self.disc is not None:
            template["spectral"] = spectral_buffers(self.disc)
        try:
            check_like(loaded, template)
        except (KeyError, ValueError):
            if self.disc is None:
                raise
            del template["spectral"]
            check_like(loaded, template)
            print("WARNING: checkpoint restored with the pre-spectral layout; spectral-norm u "
                  "vectors reset to init (sigma will be under-estimated until power iteration "
                  "re-converges).", flush=True)
        st, dumped = self.state, loaded["state"]
        if self.shards is None:
            fill_like(dumped, template["state"])
        else:
            with torch.no_grad():
                for keys, name, live in self._sharded_parts():
                    saved = loaded
                    for k in keys:
                        saved = saved[k]
                    live[FLAT].copy_(self._shard_of(name).shard(saved, live[FLAT].dtype))
        if "spectral" in template:
            fill_like(loaded["spectral"], template["spectral"])
        st.step, st.nimg = int(dumped["step"]), float(dumped["nimg"])
        st.opt_G.count = int(dumped["opt_G"]["count"])
        st.opt_fake.count = int(dumped["opt_fake"]["count"])
        if converted is not None:
            runtime.print0(f"Resumed a dump converted from {converted}.", flush=True)
            return
        self.generator.set_state(loaded["rng"])
        self._accept_streams(streams)

    def save_state(self, step: int) -> Optional[str]:
        """Dump the state; every rank calls it, rank 0 writes (and returns
        the file's path).  Under FSDP the sharded parts are gathered and
        written one at a time."""
        tree = self._ckpt_tree()
        parts = self._gathered_parts() if self.shards is not None else None
        path = None
        if self.rank == 0:
            if self.ckpt_mgr is None:
                self.ckpt_mgr = CheckpointManager(os.path.join(self.cfg.run_dir, "checkpoints"))
            path = self.ckpt_mgr.save(step, tree, parts)
            self.ckpt_mgr.wait()
        elif parts is not None:
            for _, tensors in parts:  # join each gather
                del tensors
        del tree
        runtime.sync_hosts("state-dump")
        return path

    def restore_state(self) -> bool:
        """Restore the newest dump of this run dir; False when it has none."""
        ckdir = os.path.join(self.cfg.run_dir, "checkpoints")
        if not os.path.isdir(ckdir):
            return False
        mgr = CheckpointManager(ckdir)
        step = mgr.latest_step()
        if step is None:
            refuse_orbax(ckdir)
            return False
        self.restore_from(mgr, step)
        return True

    def eval_metrics(self, snapshot_path: Optional[str]) -> None:
        """Run the configured metrics on the current EMA generator: the
        pipeline samples through the EMA for their length.  Every rank runs
        its stride of the metric loops; rank 0 reports."""
        if not self.cfg.metrics:
            return
        from ..metrics import MetricOptions, calc_metric, report_metric

        opts = MetricOptions(pipe=self.pipe, dataset_path=self.cfg.metric_data,
                             num_gen=self.cfg.metric_num_gen, init_timestep=self.cfg.init_timestep)
        ema = self.whole("ema")
        self.pipe.generator = lambda x, t, c: self.unet_apply(ema, x, t, c)
        try:
            for metric in self.cfg.metrics:
                result = calc_metric(metric, opts=opts)
                if self.rank == 0:
                    report_metric(result, run_dir=self.cfg.run_dir or None,
                                  snapshot_pkl=snapshot_path)
        finally:
            self.pipe.generator = None
        runtime.sync_hosts("metrics")

    @torch.no_grad()
    def _eval_images(self, prompts: List[str], lat: torch.Tensor, num_steps_eval: int,
                     ema=None) -> np.ndarray:
        """EMA generator samples (latents NCHW) -> uint8 images (N, H, W, 3)."""
        ema = self.state.ema if ema is None else ema
        emb = self.pipe.encode_prompts(prompts)
        init_t = torch.full((lat.shape[0],), self.cfg.init_timestep, dtype=torch.long,
                            device=self.device)
        apply = lambda x, t, c: self.unet_apply(ema, x, t, c)
        x0 = sid_sampler(apply, lat, emb, init_t, self.pipe.scheduler, num_steps=num_steps_eval,
                         generator=torch.Generator().manual_seed(2024), dtype=self.dcfg.dtype)
        return self.pipe.decode(x0.permute(0, 2, 3, 1)).cpu().numpy()

    def sample_grid(self, kimg: int, num_steps_eval: int = 1, n: int = 16,
                    ema=None) -> Optional[str]:
        """Deterministic sample grid: prompts and latents from fixed seeds;
        made and written by rank 0 (``ema``: the whole EMA, gathered by the
        caller under FSDP)."""
        if self.rank != 0:
            return None
        idx = np.random.RandomState(2024).randint(len(self.prompts.dataset), size=n)
        prompts = [self.prompts.dataset[i] for i in idx]
        s, c = self.dcfg.latent_size, self.dcfg.latent_channels
        lat = StackedRandomGenerator(range(n), self.device).randn((n, c, s, s))
        path = os.path.join(self.cfg.run_dir,
                            f"fakes_{self.cfg.alpha:03f}_{kimg:06d}_{num_steps_eval:d}.png")
        save_image_grid(self._eval_images(prompts, lat, num_steps_eval, ema), path)
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
        launches0, reduced0 = registry.counts(), pmesh.reduced_bytes
        runtime.print0(f"Training for {cfg.total_kimg} kimg (batch {cfg.batch_size}, "
                       f"{self.a_rounds} accumulation rounds, {self.world} process(es), fsdp "
                       f"{cfg.fsdp if self.mesh is not None else 1}) on {self.device}...",
                       flush=True)
        pending: list = []
        step_idx, trace = 0, None
        while True:
            if cfg.profile_dir and step_idx == cfg.profile_start_step and self.rank == 0:
                trace = start_profiler_trace(cfg.profile_dir)
            pending.append(self.step())
            if trace is not None and step_idx + 1 >= cfg.profile_start_step + cfg.profile_steps:
                print(f"profiler trace written to {trace.stop()}", flush=True)
                trace = None
            step_idx += 1
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
            launches = registry.counts()
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
            fields.cpumem_gb = cpu_memory_gb()
            fields.devmem_gb = peak_device_memory_gb()
            # This rank's kernel launches and gradient bytes handed to
            # collectives in the tick's steps.
            fields.kernel_launches = {k: v - launches0[k] for k, v in launches.items()}
            fields.reduced_bytes = pmesh.reduced_bytes - reduced0
            runtime.print0(f"tick {fields.tick:<5d} kimg {fields.kimg:<9.1f} "
                           f"time {fields.time:<12s} sec/tick {fields.sec_per_tick:<8.1f} "
                           f"sec/kimg {fields.sec_per_kimg:<8.2f} "
                           f"fake_loss {fields.fake_loss:<10.4f} g_loss {fields.g_loss:<10.4f} "
                           f"cpumem {fields.cpumem_gb:<6.2f} devmem {fields.devmem_gb:<6.2f}",
                           flush=True)
            maintenance_start = time.time()
            have_dir = os.path.isdir(cfg.run_dir)
            if have_dir and self.rank == 0:
                if stats_jsonl is None:
                    stats_jsonl = open(os.path.join(cfg.run_dir, f"stats_{cfg.alpha:g}.jsonl"), "at")
                stats_jsonl.write(json.dumps(
                    {**{k: float(v) if isinstance(v, (int, float)) else v for k, v in fields.items()},
                     "timestamp": time.time()}) + "\n")
                stats_jsonl.flush()
            if cfg.sample_ticks and have_dir and (
                    done or cur_tick % cfg.sample_ticks == 0 or cur_tick in EARLY_SAMPLE_TICKS):
                ema = self.whole("ema")
                for nse in (1, 2, 4):
                    self.sample_grid(cur_nimg // 1000, num_steps_eval=nse, ema=ema)
                del ema
                runtime.sync_hosts("grids")
            if cfg.snapshot_ticks and cur_tick and cur_tick % cfg.snapshot_ticks == 0:
                snap_path = self.save_snapshot(cur_nimg // 1000) if have_dir else None
                if cfg.metrics and cfg.metric_ticks and cur_tick % cfg.metric_ticks == 0:
                    self.eval_metrics(snap_path)
            if cfg.state_dump_ticks and cur_tick and cur_tick % cfg.state_dump_ticks == 0:
                self.save_state(self.state.step)
            maintenance_time = time.time() - maintenance_start
            cur_tick += 1
            tick_start_nimg = cur_nimg
            tick_start_time = time.time()
            launches0, reduced0 = registry.counts(), pmesh.reduced_bytes
            if done or runtime.should_stop():
                break
        if trace is not None:
            print(f"profiler trace written to {trace.stop()}", flush=True)
        if stats_jsonl is not None:
            stats_jsonl.close()
        if self.ckpt_mgr is not None:
            self.ckpt_mgr.wait()
            self.ckpt_mgr.close()
            self.ckpt_mgr = None
        runtime.print0("Exiting...", flush=True)
        return self.state


def resume_training_state(trainer: Trainer) -> None:
    """The state-resume branches of ``training_loop``: ``latest`` restores
    the newest dump of the trainer's own run dir (none: a fresh start), a run
    directory its newest dump.  A generator file was read by the
    ``Trainer`` itself."""
    cfg = trainer.cfg
    if cfg.resume == "latest":
        trainer.restore_state()
    elif resumes_state(cfg):
        trainer.restore_from(CheckpointManager(os.path.join(cfg.resume, "checkpoints")))
        runtime.print0(f"Resumed training state from {cfg.resume} (step {trainer.state.step})",
                       flush=True)


def training_loop(cfg: TrainConfig) -> SiDState:
    """Write ``training_options.json`` into the run dir (rank 0), build,
    resume, run."""
    if runtime.get_process_index() == 0 and cfg.run_dir and cfg.run_dir != ".":
        os.makedirs(cfg.run_dir, exist_ok=True)
        with open(os.path.join(cfg.run_dir, "training_options.json"), "w") as f:
            f.write(cfg.as_json())
    runtime.sync_hosts("training-options")
    trainer = Trainer(cfg)
    resume_training_state(trainer)
    return trainer.run()
