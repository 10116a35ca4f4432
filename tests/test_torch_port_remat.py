"""The UNet's six remat policies against the JAX package's, on the CPU.

Each policy of ``sid_train --remat-policy`` (``full``, ``dots``,
``dots_no_batch``, ``attn``, ``attn_offload``, ``flash``) on the tiny UNet:

- its gradients against those of the JAX ``UNet2DCondition(remat=True,
  remat_policy=p)`` on the same weights (the committed tiny checkpoint,
  carried by ``unet_params_from_jax``) and numpy inputs, f32 atol 2e-5 /
  rtol 1e-4, and its output and gradients against the port with no remat
  bit for bit;
- K1's forward launches: one per attention with no remat and under
  ``flash``, two under the other five (the backward sweep recomputes it);
- what the backward sweep recomputes, read by a dispatch mode over the
  backward call: the forward ``convolution`` and ``addmm`` run again unless
  the policy keeps them, and ``attn`` / ``attn_offload`` take each
  ``merge_heads`` output from their store;
- ``merge_heads`` runs only in the blocks of those two policies (every
  other path merges the heads with a plain reshape), at every head count,
  with the plain merge's values and gradients;
- one ``Trainer`` step under each policy the JAX package added to ``full``
  and ``flash``, with finite losses.

On CPU tensors ``attn_offload`` has no other memory to use and keeps what
``attn`` keeps.
"""

import contextlib
import os
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from sid_lsg_tpu.models import UNet2DCondition as JaxUNet  # noqa: E402
from sid_lsg_tpu.models import configs as jax_configs  # noqa: E402
from sid_lsg_tpu.models.convert import load_sd_checkpoint  # noqa: E402
from sid_lsg_torch.models import TINY  # noqa: E402
from sid_lsg_torch.models.convert import unet_params_from_jax  # noqa: E402
from sid_lsg_torch.models.layers import (  # noqa: E402
    MERGE_HEADS_OP,
    multihead_attention,
    tag_attention_outputs,
)
from sid_lsg_torch.models.unet import ATTN_POLICIES, REMAT_POLICIES, unet_apply_fn  # noqa: E402
from sid_lsg_torch.training.loop import Trainer, TrainConfig  # noqa: E402

torch.set_num_threads(2)
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "tiny_hf_ckpt")
F32 = dict(atol=2e-5, rtol=1e-4)
N_ATTN = 8  # tiny UNet: 4 transformers, self + cross attention each
NEW_POLICIES = ("dots", "dots_no_batch", "attn", "attn_offload")
_aten = torch.ops.aten


@pytest.fixture(scope="module")
def case():
    jparams = load_sd_checkpoint(FIXTURE, jax_configs.TINY)[0]
    rng = np.random.default_rng(16)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([625, 37], dtype=np.int32)
    ctx = rng.standard_normal((2, 77, 32)).astype(np.float32)
    params = unet_params_from_jax(jparams, TINY.unet)
    inputs = (torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t), torch.from_numpy(ctx))
    return {"jparams": jparams, "jinputs": (x, t, ctx), "params": params, "inputs": inputs,
            "no_remat": _port_grads(params, inputs, None)}


def _port_grads(params, inputs, policy, mode=None):
    """(output, gradients of sum(out^2)) under ``policy``, with ``mode`` (a
    dispatch mode) over the backward call alone."""
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    out = unet_apply_fn(TINY.unet, torch.float32, policy)(leaves, *inputs)
    loss = out.square().sum()
    with mode if mode is not None else contextlib.nullcontext():
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return out.detach(), dict(zip(leaves, grads))


@pytest.fixture
def k1_calls(monkeypatch):
    attn_mod = sys.modules["sid_lsg_torch.ops.attention"]
    calls = {"n": 0}
    fwd = attn_mod.flash_attn_fwd

    def counting(*args, **kwargs):
        calls["n"] += 1
        return fwd(*args, **kwargs)

    monkeypatch.setattr(attn_mod, "flash_attn_fwd", counting)
    return calls


def test_the_port_takes_every_policy_of_the_jax_cli():
    from sid_lsg_torch.cli.sid_train import REMAT_CHOICES, build_parser
    from sid_lsg_tpu.cli.sid_train import main as jax_main

    (option,) = [p for p in jax_main.params if p.name == "remat_policy"]
    assert set(REMAT_POLICIES) == set(REMAT_CHOICES) == set(option.type.choices)
    for policy in option.type.choices:
        opts = build_parser().parse_args(["--outdir", "runs", "--remat-policy", policy])
        assert opts.remat_policy == policy


@pytest.mark.parametrize("policy", REMAT_POLICIES)
def test_policy_gradients_match_jax_and_no_remat(case, policy):
    unet = JaxUNet(jax_configs.TINY.unet, remat=True, remat_policy=policy)
    x, t, ctx = case["jinputs"]
    ref = jax.jit(jax.grad(lambda p: jnp.sum(unet.apply({"params": p}, x, t, ctx) ** 2)))(
        case["jparams"])
    ref = unet_params_from_jax(jax.tree_util.tree_map(np.array, ref), TINY.unet)
    out, got = _port_grads(case["params"], case["inputs"], policy)
    out_none, no_remat = case["no_remat"]
    torch.testing.assert_close(out, out_none, atol=0, rtol=0)
    assert set(got) == set(ref) == set(no_remat)
    for k, g in got.items():
        torch.testing.assert_close(g, no_remat[k], atol=0, rtol=0, msg=k)
        np.testing.assert_allclose(g.numpy(), ref[k].numpy(), **F32, err_msg=k)


@pytest.mark.parametrize("policy", (None,) + REMAT_POLICIES)
def test_forward_attention_launches_per_policy(case, policy, k1_calls):
    _port_grads(case["params"], case["inputs"], policy)
    assert k1_calls["n"] == (N_ATTN if policy in (None, "flash") else 2 * N_ATTN)


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.seen.add(func)
        return func(*args, **(kwargs or {}))


# Which forward ops the backward sweep runs again, by policy: a product or
# merge the policy keeps is taken from its store instead (``merge_heads``
# runs only under ``attn`` and ``attn_offload``, and is kept there).
RECOMPUTED = {
    "full": {"convolution", "addmm"},
    "dots": set(),
    "dots_no_batch": {"convolution"},
    "attn": {"convolution", "addmm"},
    "attn_offload": {"convolution", "addmm"},
    "flash": {"convolution", "addmm"},
}


@pytest.mark.parametrize("policy", REMAT_POLICIES)
def test_what_the_backward_sweep_recomputes(case, policy):
    ops = _Ops()
    _port_grads(case["params"], case["inputs"], policy, ops)
    named = {"convolution": _aten.convolution.default, "addmm": _aten.addmm.default,
             "merge_heads": MERGE_HEADS_OP}
    assert {name for name, op in named.items() if op in ops.seen} == RECOMPUTED[policy]
    assert _aten.convolution_backward.default in ops.seen


@pytest.mark.parametrize("policy", (None,) + REMAT_POLICIES)
def test_merge_heads_runs_only_under_the_attention_policies(case, policy):
    apply = unet_apply_fn(TINY.unet, torch.float32, policy)
    leaves = {k: v.clone().requires_grad_() for k, v in case["params"].items()}
    ops = _Ops()
    with ops:
        apply(leaves, *case["inputs"])
    assert (MERGE_HEADS_OP in ops.seen) == (policy in ATTN_POLICIES)
    ops = _Ops()
    with torch.no_grad(), ops:  # no grad: the blocks run as they are, no remat
        apply(case["params"], *case["inputs"])
    assert MERGE_HEADS_OP not in ops.seen


@pytest.mark.parametrize("heads", (1, 4))
def test_merge_heads_copies_the_plain_merge_at_every_head_count(heads):
    gen = torch.Generator().manual_seed(heads)
    q, k, v = (torch.randn(2, 6, 16, generator=gen, requires_grad=True) for _ in range(3))
    dout = torch.randn(2, 6, 16, generator=gen)
    plain = multihead_attention(q, k, v, heads)
    ops = _Ops()
    with tag_attention_outputs(), ops:
        tagged = multihead_attention(q, k, v, heads)
    assert MERGE_HEADS_OP in ops.seen
    torch.testing.assert_close(tagged, plain, atol=0, rtol=0)
    for a, b in zip(torch.autograd.grad(plain, (q, k, v), dout),
                    torch.autograd.grad(tagged, (q, k, v), dout)):
        torch.testing.assert_close(b, a, atol=0, rtol=0)


@pytest.mark.parametrize("policy", NEW_POLICIES)
def test_trainer_steps_under_each_new_policy(policy):
    tr = Trainer(TrainConfig(model="tiny", device="cpu", batch_size=2, microbatch=2, total_kimg=1,
                             kimg_per_tick=0, state_dump_ticks=0, gradient_checkpointing=True,
                             remat_policy=policy))
    m = tr.step()
    for k in ("fake_score_loss", "g_loss"):
        assert np.isfinite(float(m[k])), k
