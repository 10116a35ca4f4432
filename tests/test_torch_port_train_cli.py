"""The port's training CLI on the CPU: run-dir artifacts, the snapshot read
back by the JAX package, and the ``Trainer``'s refusals of what is not
ported yet.

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
    ("model", "/some/hf/checkpoint", "item 4"),
    ("resume", "latest", "item 5"),
    ("metrics", ["fid30k_full"], "item 7"),
    ("fsdp", 4, "item 5"),
    ("adv_weight_D", 0.1, "item 8"),
    ("adv_weight_G", 0.1, "item 8"),
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
