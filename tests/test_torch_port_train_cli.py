"""The port's training CLI on the CPU: run-dir artifacts, the snapshot read
back by the JAX package, the ``Trainer`` with each SiDA tower and a timm
DINO state dict, and its refusals of what is not ported yet.

The run is the CLI's ``main`` on the tiny preset (4 images per step in two
accumulation rounds, a tick per step, 3 ticks, f32, a snapshot per tick),
in this process so that its final state can be compared with the snapshot.
The artifact contract is that of the JAX CLI (``tests/test_train_cli.py``).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sid_lsg_torch.cli import sid_train
from sid_lsg_torch.training.loop import Trainer, TrainConfig

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--sd_model", "tiny", "--device", "cpu", "--batch", "4", "--batch-micro", "2",
        "--tick", "0", "--max-ticks", "2", "--bf16", "0", "--snap", "1"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("runs")
    state = sid_train.main(["--outdir", str(out)] + ARGS)
    (name,) = os.listdir(out)
    return out / name, state


def test_cli_writes_the_run_dir_artifacts(run):
    rd, state = run
    names = set(os.listdir(rd))
    assert {"training_options.json", "log.txt"} <= names, sorted(names)
    for steps in (1, 2, 4):
        assert f"fakes_1.000000_000000_{steps}.png" in names, sorted(names)
    assert any(n.startswith("network-snapshot-") and n.endswith(".safetensors") for n in names)
    opts = json.loads((rd / "training_options.json").read_text())
    assert (opts["batch_size"], opts["microbatch"], opts["device"]) == (4, 2, "cpu")
    (stats,) = [n for n in names if n.startswith("stats_") and n.endswith(".jsonl")]
    lines = [json.loads(line) for line in (rd / stats).read_text().splitlines()]
    assert [line["tick"] for line in lines] == [0, 1, 2]
    assert all(np.isfinite(line["fake_loss"]) and np.isfinite(line["g_loss"]) for line in lines)
    assert "tick 2" in (rd / "log.txt").read_text()
    assert state.step == 3 and state.nimg == 12


def test_snapshot_loads_in_jax_as_the_ema(run):
    pytest.importorskip("jax")
    from sid_lsg_tpu.models.configs import TINY as JTINY
    from sid_lsg_tpu.models.convert import export_unet
    from sid_lsg_tpu.runtime.checkpoint import load_generator_params

    rd, state = run
    (snap,) = [n for n in os.listdir(rd) if n.startswith("network-snapshot-")]
    params = load_generator_params(str(rd / snap), JTINY.unet)
    back = export_unet(params, JTINY.unet)
    assert set(back) == set(state.ema)
    for k, v in state.ema.items():
        np.testing.assert_array_equal(np.asarray(back[k]), v.numpy(), err_msg=k)
    # With the EMA ramp at nimg <= 8 its decay is below 1e-5: the EMA follows G.
    for k, v in state.ema.items():
        torch.testing.assert_close(v, state.params_G[k].detach(), msg=k)


def test_module_entry_point_dry_run():
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-m", "sid_lsg_torch.cli.sid_train", "--outdir", "unused",
                        "--dry-run"] + ARGS, env=env, cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert '"device": "cpu"' in r.stdout and "Dry run; exiting." in r.stdout


def test_training_modules_import_without_jax():
    code = ("import sys\n"
            "for name in ('jax', 'flax', 'sid_lsg_tpu'):\n"
            "    sys.modules[name] = None\n"
            "import sid_lsg_torch.cli.sid_train, sid_lsg_torch.training.loop\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'sid_lsg_tpu')\n"
            "       and sys.modules[m] is not None]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=300)


@pytest.mark.parametrize("field,value,item", [
    ("resume", "latest", "item 5"),
    ("metrics", ["fid30k_full"], "item 7"),
    ("fsdp", 4, "item 5"),
    ("state_dump_ticks", 1, "item 5"),
    ("profile_dir", "/tmp/trace", "item 5"),
])
def test_trainer_refuses_what_is_not_ported(field, value, item):
    kw = dict(model="tiny", device="cpu", batch_size=4, microbatch=2, total_kimg=1,
              kimg_per_tick=0, state_dump_ticks=0)
    kw[field] = value
    cfg = TrainConfig(**kw)
    with pytest.raises(ValueError, match=f"not ported yet \\(ROADMAP Queue 1 {item}\\)"):
        Trainer(cfg)


def test_trainer_steps_with_a_bf16_teacher():
    """``--bf16 1 --teacher-bf16 1``: the frozen teacher is held in bf16,
    its norm parameters too, and a step gives finite losses (the norms
    bring their parameters to f32 at apply time)."""
    tr = Trainer(TrainConfig(model="tiny", device="cpu", batch_size=4, microbatch=2, total_kimg=1,
                             kimg_per_tick=0, state_dump_ticks=0, use_bf16=True, teacher_bf16=True))
    assert all(v.dtype == torch.bfloat16 for v in tr.teacher.values())
    m = tr.step()
    for k in ("fake_score_loss", "g_loss"):
        assert np.isfinite(float(m[k])), k
    assert all(v.dtype == torch.bfloat16 for v in tr.teacher.values())


SIDA = dict(model="tiny", device="cpu", batch_size=2, microbatch=2, total_kimg=1, kimg_per_tick=0,
            state_dump_ticks=0, use_bf16=False, adv_weight_G=0.1, adv_vit="tiny", seed=1)


@pytest.mark.parametrize("tower,weight_d", [("encoder", 0.1), ("dino", 0.1), ("dino", 0.0)])
def test_trainer_builds_and_steps_with_each_sida_tower(tower, weight_d):
    """With adv_weight_D = 0 the judge's heads get zero gradients (as
    jax.grad gives) and only the generator term is on."""
    tr = Trainer(TrainConfig(adv_tower=tower, adv_weight_D=weight_d, **SIDA))
    fake0 = {k: v.detach().clone() for k, v in tr.state.params_fake.items()}
    u0 = {k: v.clone() for k, v in tr.disc.named_buffers() if k.endswith(".u")} if tr.disc else {}
    assert (tr.disc is not None) == (tower == "dino")
    assert any(k.startswith("disc.heads.") for k in fake0) == (tower == "dino")
    m = tr.step()
    d_keys = ("adv_d_loss", "d_logit_real", "d_logit_fake") if weight_d else ()
    assert set(d_keys) <= set(m) and (weight_d or "adv_d_loss" not in m)
    for k in ("fake_score_loss", "g_loss", "adv_g_loss") + d_keys:
        assert np.isfinite(float(m[k])), k
    changed = [k for k, v in tr.state.params_fake.items() if not torch.equal(v.detach(), fake0[k])]
    assert any(k.startswith("disc.") for k in changed) == (tower == "dino" and weight_d > 0)
    if tower == "dino":
        assert all(not p.requires_grad for p in tr.disc.parameters())
        assert all(not torch.equal(v, u0[k]) for k, v in tr.disc.named_buffers() if k in u0)


def test_adv_dino_loads_a_timm_state_dict(tmp_path):
    """A timm-keyed ViT state dict (with the final norm and head that the
    backbone does not use) saved by torch.save loads as the DINO backbone."""
    from sid_lsg_torch.models.stylegan_discriminator import TINY_VIT, DINOViT

    gen = torch.Generator().manual_seed(0)
    timm = {k: torch.randn(v.shape, generator=gen) for k, v in DINOViT(TINY_VIT).state_dict().items()}
    timm.update({"norm.weight": torch.ones(32), "norm.bias": torch.zeros(32),
                 "head.weight": torch.zeros(10, 32)})
    path = tmp_path / "dino_tiny.pth"
    torch.save(timm, path)
    tr = Trainer(TrainConfig(adv_tower="dino", adv_dino=str(path), adv_weight_D=0.1, **SIDA))
    got = tr.disc.dino.state_dict()
    assert set(got) == set(timm) - {"norm.weight", "norm.bias", "head.weight"}
    for k, v in got.items():
        torch.testing.assert_close(v, timm[k], rtol=0, atol=0, msg=k)


def test_trainer_reads_real_latents_from_adv_data(tmp_path):
    """--adv_data: the real latents (NHWC on disk, scaled) reach the step as
    NCHW rows of the corpus, with their captions; a corpus of another latent
    size is refused."""
    path = str(tmp_path / "real.npz")
    lat = np.random.RandomState(0).randn(5, 8, 8, 4).astype(np.float16)
    np.savez(path, latents=lat, captions=np.array([f"real {i}" for i in range(5)]))
    tr = Trainer(TrainConfig(adv_tower="encoder", adv_weight_D=0.1, adv_data=path, **SIDA))
    batch = tr.next_batch()
    assert batch["lat_real"].shape == (1, 2, 4, 8, 8) and batch["emb_real"].shape[:2] == (1, 2)
    rows = {tuple(np.round(x, 3).ravel()) for x in lat.astype(np.float32).transpose(0, 3, 1, 2)}
    assert all(tuple(np.round(r.numpy(), 3).ravel()) in rows for r in batch["lat_real"][0])
    assert np.isfinite(float(tr.step()["adv_d_loss"]))
    small = str(tmp_path / "small.npz")
    np.savez(small, latents=lat[:, :4, :4], captions=np.array(["x"] * 5))
    with pytest.raises(ValueError, match="latent resolution"):
        Trainer(TrainConfig(adv_tower="encoder", adv_weight_D=0.1, adv_data=small, **SIDA))
