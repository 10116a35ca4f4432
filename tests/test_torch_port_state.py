"""Training-state dumps, resume and the profiler of the port, on the CPU.

Checked: a ``TINY`` f32 run dumped at a tick and resumed from its run dir
takes, bit for bit, the step the run that was never stopped took (with and
without SiDA's ``dino`` judge, whose spectral ``u`` vectors the dump
carries); ``--resume latest`` and ``--resume <run dir>`` through the CLI;
``CheckpointManager`` keeping five dumps, ignoring a half-written one and
refusing a dump that does not fit; the warned fallback to the pre-spectral
layout; the prompt and latent iterators' order against the generator-based
iterator they replace, and their states; a profiler trace on the CPU; the
``utils.misc`` helpers against the JAX package's.
"""

import json
import os

import numpy as np
import pytest
import torch

from sid_lsg_torch.cli import sid_train
from sid_lsg_torch.data.latents import InfiniteLatentIterator, LatentDataset, write_corpus
from sid_lsg_torch.data.prompts import InfinitePromptIterator
from sid_lsg_torch.runtime.checkpoint import CheckpointManager
from sid_lsg_torch.training.loop import Trainer, TrainConfig, resume_training_state, training_loop

torch.set_num_threads(2)

BASE = dict(model="tiny", device="cpu", batch_size=2, microbatch=2, total_kimg=1,
            kimg_per_tick=0, use_bf16=False, sample_ticks=0, snapshot_ticks=0, seed=3)
SIDA = dict(adv_weight_G=0.1, adv_weight_D=0.1, adv_tower="dino", adv_vit="tiny")
CLI = ["--sd_model", "tiny", "--device", "cpu", "--batch", "2", "--batch-micro", "2", "--tick", "0",
       "--bf16", "0", "--snap", "0", "--seed", "3"]


def _assert_trees_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
    elif torch.is_tensor(a):
        assert torch.equal(a, b), path
    else:
        assert a == b, path


def _full_state(trainer: Trainer) -> dict:
    """Everything a dump carries, as plain values (the live tensors)."""
    tree = trainer._ckpt_tree()
    tree["iter_next"] = next(trainer.prompts)  # the iterator's next batch follows its state
    return tree


@pytest.mark.parametrize("sida", [False, True], ids=["plain", "sida_dino"])
def test_resumed_run_takes_the_uninterrupted_step(tmp_path, sida):
    """Dump at tick 2 (after step 3), run on to step 4; a second run resumed
    from the first's run dir takes one step: the same bits."""
    extra = SIDA if sida else {}
    rd = str(tmp_path / "a")
    tr_a = Trainer(TrainConfig(run_dir=rd, state_dump_ticks=2, max_ticks=3, **BASE, **extra))
    os.makedirs(rd)
    tr_a.run()
    assert CheckpointManager(os.path.join(rd, "checkpoints")).all_steps() == [3]
    cfg_b = TrainConfig(run_dir=str(tmp_path / "b"), state_dump_ticks=0, max_ticks=0, resume=rd,
                        **BASE, **extra)
    tr_b = Trainer(cfg_b)
    resume_training_state(tr_b)
    assert tr_b.state.step == 3 and tr_b.state.nimg == 6.0
    tr_b.run()
    assert tr_b.state.step == tr_a.state.step == 4
    if sida:
        assert tr_b._ckpt_tree()["spectral"], "the dino judge has spectral u vectors"
    _assert_trees_equal(_full_state(tr_a), _full_state(tr_b))


def test_cli_resumes_latest_and_a_run_dir(tmp_path):
    """``--resume latest`` in the run dir itself (``--nosubdir``) and
    ``--resume <run dir>`` into a new one continue from the same dump; in a
    run dir without dumps ``latest`` starts afresh."""
    rd = str(tmp_path / "run")
    first = sid_train.main(["--outdir", rd, "--nosubdir", "--dump", "1", "--max-ticks", "1"] + CLI)
    assert first.step == 2 and CheckpointManager(os.path.join(rd, "checkpoints")).all_steps() == [2]
    latest = sid_train.main(["--outdir", rd, "--nosubdir", "--resume", "latest", "--dump", "0",
                             "--max-ticks", "0"] + CLI)
    other = sid_train.main(["--outdir", str(tmp_path / "other"), "--resume", rd, "--dump", "0",
                            "--max-ticks", "0"] + CLI)
    fresh = sid_train.main(["--outdir", str(tmp_path / "fresh"), "--nosubdir", "--resume",
                            "latest", "--dump", "0", "--max-ticks", "0"] + CLI)
    assert latest.step == other.step == 3 and fresh.step == 1
    for k, v in latest.params_G.items():
        assert torch.equal(v, other.params_G[k]), k
    assert "Resumed training state" in open(os.path.join(
        tmp_path / "other", os.listdir(tmp_path / "other")[0], "log.txt")).read()


def test_checkpoint_manager_keeps_five_and_ignores_partial_dumps(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    tree = lambda s: {"w": torch.full((3, 2), float(s)), "n": s, "opt": {"mu": None}}
    for step in range(1, 8):
        mgr.save(step, tree(step))
    assert mgr.all_steps() == [3, 4, 5, 6, 7] and mgr.latest_step() == 7
    os.makedirs(tmp_path / "ck" / "8.tmp-1")  # a dump cut while being written
    (tmp_path / "ck" / "8.tmp-1" / "state.pt").write_bytes(b"\x00" * 10)
    os.makedirs(tmp_path / "ck" / "9")  # a step directory without its file
    assert CheckpointManager(str(tmp_path / "ck")).latest_step() == 7
    template = tree(0)
    out = mgr.restore(None, template=template)
    assert out["w"] is template["w"] and torch.equal(template["w"], torch.full((3, 2), 7.0))
    assert out["n"] == 7 and out["opt"] == {"mu": None}
    with pytest.raises(KeyError, match="keys differ"):
        mgr.restore(5, template={"w": torch.zeros(3, 2), "n": 0, "opt": {"mu": None}, "x": 1})
    with pytest.raises(ValueError, match="w: \\(3, 2\\)"):
        mgr.restore(5, template={"w": torch.zeros(2, 3), "n": 0, "opt": {"mu": None}})
    with pytest.raises(ValueError, match="opt/mu"):
        mgr.restore(5, template={"w": torch.zeros(3, 2), "n": 0, "opt": {"mu": torch.zeros(1)}})
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore()


def test_restore_falls_back_to_the_pre_spectral_layout_and_warns(tmp_path, capsys):
    cfg = TrainConfig(run_dir=str(tmp_path), state_dump_ticks=0, **BASE, **SIDA)
    tr = Trainer(cfg)
    tr.step()
    mgr = CheckpointManager(str(tmp_path / "checkpoints"))
    mgr.save(1, tr._ckpt_tree(spectral=False))
    dumped = {k: v.clone() for k, v in tr.state.params_fake.items()}
    u_before = {k: v.clone() for k, v in tr._ckpt_tree()["spectral"].items()}
    tr.step()
    capsys.readouterr()
    assert tr.restore_state()
    assert "pre-spectral layout" in capsys.readouterr().out
    assert tr.state.step == 1
    for k, v in dumped.items():
        assert torch.equal(tr.state.params_fake[k], v), k
    # The u vectors keep what they held: the dump has none.
    assert any(not torch.equal(u_before[k], v) for k, v in tr._ckpt_tree()["spectral"].items())
    tr_plain = Trainer(TrainConfig(run_dir=str(tmp_path / "p"), state_dump_ticks=0, **BASE))
    tr_plain.step()
    bad = CheckpointManager(str(tmp_path / "p" / "checkpoints"))
    bad.save(1, {**tr_plain._ckpt_tree(), "spectral": {"x.u": torch.zeros(2)}})
    with pytest.raises(KeyError):
        tr_plain.restore_state()


def _generator_order(n, batch, seed, window_ratio, batches):
    """The iterator's order as the generator it replaces produced it."""
    window = int(np.rint(n * window_ratio / 2))
    order = np.arange(n)
    rnd = np.random.RandomState(seed)
    rnd.shuffle(order)
    out, idx = [], 0
    for _ in range(batches * batch):
        i = idx % n
        out.append(int(order[i]))
        if window >= 2:
            j = (i - rnd.randint(window)) % n
            order[i], order[j] = order[j], order[i]
        idx += 1
    return [out[b * batch:(b + 1) * batch] for b in range(batches)]


@pytest.mark.parametrize("n,batch,seed,ratio", [(7, 3, 0, 0.5), (50, 4, 5, 0.5), (9, 2, 1, 0.1)])
def test_prompt_iterator_keeps_its_order_and_resumes(n, batch, seed, ratio):
    names = [str(i) for i in range(n)]
    it = InfinitePromptIterator(names, batch, seed=seed, window_ratio=ratio)
    want = _generator_order(n, batch, seed, ratio, 40)
    got = [[int(p) for p in next(it)] for _ in range(25)]
    assert got == want[:25]
    state = it.state_dict()
    again = InfinitePromptIterator(names, batch, seed=seed + 1, window_ratio=ratio)
    again.load_state_dict(state)
    assert [[int(p) for p in next(again)] for _ in range(15)] == want[25:]
    assert [[int(p) for p in next(it)] for _ in range(15)] == want[25:]


def test_latent_iterator_keeps_its_order_and_resumes(tmp_path):
    lat = np.arange(5 * 2 * 2 * 4, dtype=np.float32).reshape(5, 2, 2, 4)
    write_corpus(str(tmp_path / "c.npz"), lat, [f"c{i}" for i in range(5)])
    ds = LatentDataset(str(tmp_path / "c.npz"))
    it = InfiniteLatentIterator(ds, 2, seed=4)
    order = np.concatenate([np.random.RandomState(4 + e).permutation(5) for e in range(4)])
    caps = [c for _ in range(5) for c in next(it)[1]]
    assert caps == [f"c{i}" for i in order[:10]]
    again = InfiniteLatentIterator(ds, 2, seed=4)
    again.load_state_dict(json.loads(json.dumps(it.state_dict())))
    assert [c for _ in range(3) for c in next(again)[1]] == [f"c{i}" for i in order[10:16]]


def test_profile_dir_writes_a_trace_on_the_cpu(tmp_path):
    prof = tmp_path / "prof"
    cfg = TrainConfig(run_dir="", state_dump_ticks=0, max_ticks=2, profile_dir=str(prof),
                      profile_start_step=1, profile_steps=1, **BASE)
    training_loop(cfg)
    (trace,) = os.listdir(prof)
    events = json.load(open(prof / trace))["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("aten::" in n for n in names), sorted(names)[:20]


def test_misc_helpers_match_the_jax_package():
    """``utils.misc``: the shape check raises as JAX's does, the parameter
    count of a module equals JAX's count of the same shapes, and a profiled
    function keeps its result and name."""
    jmisc = pytest.importorskip("sid_lsg_tpu.utils.misc")
    from sid_lsg_torch.utils import misc

    x = np.zeros((2, 3, 4))
    misc.assert_shape(x, [2, None, 4])
    for ref in ([2, 3], [2, 5, 4]):
        with pytest.raises(AssertionError) as got:
            misc.assert_shape(x, ref)
        with pytest.raises(AssertionError) as want:
            jmisc.assert_shape(x, ref)
        assert str(got.value) == str(want.value)
    module = torch.nn.Sequential(torch.nn.Linear(3, 5), torch.nn.Conv2d(5, 2, 3))
    shapes = {k: np.zeros(v.shape) for k, v in module.state_dict().items()}
    assert misc.count_params(module) == jmisc.count_params(shapes) == 5 * 3 + 5 + 2 * 5 * 9 + 2
    assert "Conv2d" in misc.print_module_summary(module, depth=1)
    wrapped = misc.profiled_function(lambda a: a + 1)
    assert wrapped(1) == 2 and wrapped.__name__ == "<lambda>"
    assert misc.cpu_memory_gb() > 0 and misc.device_memory_stats() == {}
