"""The port's ``bias_act`` and its callers in ``stylegan_shared`` against
the JAX package's, on the CPU.

Each case feeds the same numpy x and bias to the port's ``ops.bias_act`` (the
plain version on a CPU tensor), to JAX ``ops.bias_act(impl="ref")`` and to
the Pallas kernel in interpret mode (``impl="pallas"``, as
``tests/test_pallas_parity.py`` runs it): all nine activations, with the
default gain and clamp and with gain 1.3 + clamp 5, with the bias along axis
1 and along the last axis.  Forward within atol 2e-5 / rtol 1e-4 (the
Pallas parity tolerance); the gradients of a weighted sum with respect to x
and b against ``jax.grad`` within atol 5e-5 / rtol 1e-3.  ``FullyConnectedLayer``,
``MLP`` and ``normalize_2nd_moment`` on weights carried from flax, within
atol 1e-5 / rtol 1e-4.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from jax.experimental.pallas import tpu as pltpu  # noqa: E402

import torch  # noqa: E402

from sid_lsg_torch import ops  # noqa: E402
from sid_lsg_torch.models.stylegan_shared import (  # noqa: E402
    MLP,
    FullyConnectedLayer,
    ResidualBlock,
    normalize_2nd_moment,
)
from sid_lsg_tpu import ops as jops  # noqa: E402
from sid_lsg_tpu.models import stylegan_shared as jss  # noqa: E402
from sid_lsg_tpu.ops.bias_act import activation_funcs as jax_activation_funcs  # noqa: E402

torch.set_num_threads(2)
FWD = dict(atol=2e-5, rtol=1e-4)
GRAD = dict(atol=5e-5, rtol=1e-3)
TOL = dict(atol=1e-5, rtol=1e-4)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _perturb(tree, seed, scale=0.1):
    rs = np.random.RandomState(seed)

    def shift(v):
        v = np.asarray(v, np.float32)  # numpy's std: no JAX op to compile per shape
        return v + scale * (np.std(v) + 0.5) * rs.standard_normal(v.shape).astype(np.float32)

    return jax.tree_util.tree_map(shift, tree)


@pytest.mark.parametrize("dim", [1, -1])
@pytest.mark.parametrize("extra", [{}, {"gain": 1.3, "clamp": 5.0}], ids=["default", "gain_clamp"])
@pytest.mark.parametrize("act", list(ops.activation_funcs))
def test_bias_act_matches_jax_ref_and_pallas(act, extra, dim):
    assert list(ops.activation_funcs) == list(jax_activation_funcs)
    assert ops.activation_funcs[act].def_gain == pytest.approx(jax_activation_funcs[act].def_gain)
    assert ops.activation_funcs[act].def_alpha == jax_activation_funcs[act].def_alpha
    rs = np.random.RandomState(len(act) + 7 * (dim % 3))
    x = (rs.standard_normal((3, 16, 6)) * 3).astype(np.float32)
    b = rs.standard_normal(x.shape[dim]).astype(np.float32)
    w = rs.standard_normal(x.shape).astype(np.float32)
    jdim = dim % x.ndim
    ref = np.asarray(jops.bias_act(x, b, dim=jdim, act=act, impl="ref", **extra))
    with pltpu.force_tpu_interpret_mode():
        pal = np.asarray(jops.bias_act(x, b, dim=jdim, act=act, impl="pallas", **extra))

    xt = torch.from_numpy(x).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    y = ops.bias_act(xt, bt, dim=dim, act=act, **extra)
    np.testing.assert_allclose(y.detach().numpy(), ref, **FWD)
    np.testing.assert_allclose(y.detach().numpy(), pal, **FWD)

    gx, gb = torch.autograd.grad((y * torch.from_numpy(w)).sum(), (xt, bt))
    jgx, jgb = jax.grad(
        lambda x, b: (jops.bias_act(x, b, dim=jdim, act=act, impl="ref", **extra) * w).sum(),
        argnums=(0, 1))(x, b)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), **GRAD)
    np.testing.assert_allclose(gb.numpy(), np.asarray(jgb), **GRAD)


# The shapes that pick each route of K7 (csrc/bias_act.cu): the bias on the
# last axis (inner == 1: rows of C, the bias by column) and on axis 1 of an
# NCHW map (inner > 1: rows of H * W, one bias a row); C and H * W that are
# no multiple of the 16-byte vector (4 f32, 8 bf16); and a sliced x.
@pytest.mark.parametrize("shape,dim,sl", [
    ((4, 64), 1, None),
    ((5, 13), -1, None),
    ((2, 8, 4, 4), 1, None),
    ((2, 5, 3, 7), 1, None),
    ((6, 40), 1, (slice(None), slice(3, 32))),
    ((3, 12, 6, 5), 1, (slice(None), slice(None, None, 2))),
], ids=["rows_c64", "rows_c13", "nchw_hw16", "nchw_hw21", "sliced_cols", "sliced_channels"])
@pytest.mark.parametrize("act", ["linear", "swish"])
def test_bias_act_kernel_routes_match_jax_ref_and_pallas(act, shape, dim, sl):
    rs = np.random.RandomState(11)
    full = (rs.standard_normal(shape) * 3).astype(np.float32)
    x = full if sl is None else full[sl]
    b = rs.standard_normal(x.shape[dim]).astype(np.float32)
    jdim = dim % x.ndim
    extra = dict(gain=1.3, clamp=5.0)
    ref = np.asarray(jops.bias_act(x, b, dim=jdim, act=act, impl="ref", **extra))
    with pltpu.force_tpu_interpret_mode():
        pal = np.asarray(jops.bias_act(x, b, dim=jdim, act=act, impl="pallas", **extra))
    xt = torch.from_numpy(full)
    if sl is not None:
        xt = xt[sl]
        assert not xt.is_contiguous()
    y = ops.bias_act_fwd(xt, torch.from_numpy(b), dim, act, **extra)
    assert y.shape == x.shape
    np.testing.assert_allclose(y.numpy(), ref, **FWD)
    np.testing.assert_allclose(y.numpy(), pal, **FWD)


def test_bias_act_without_bias_and_with_alpha_matches_jax():
    x = np.random.RandomState(3).standard_normal((5, 8)).astype(np.float32)
    for act, alpha in (("lrelu", 0.05), ("elu", None), ("linear", None)):
        got = ops.bias_act(torch.from_numpy(x), None, dim=1, act=act, alpha=alpha)
        ref = jops.bias_act(x, None, dim=1, act=act, alpha=alpha, impl="ref")
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD)


def test_bias_act_plain_version_runs_on_cpu_without_a_launch():
    ops.registry.reset()
    x = torch.randn(2, 4, 3)
    y = ops.bias_act(x, torch.randn(4), dim=1, act="swish")
    assert y.shape == x.shape and ops.registry.counts()["bias_act"] == 0
    with pytest.raises(ValueError):
        ops.bias_act(x, torch.randn(5), dim=1)
    with pytest.raises(ValueError):
        ops.bias_act(x, None, act="gelu")


def test_fully_connected_mlp_and_normalize_match_jax():
    rs = np.random.RandomState(0)
    x = rs.standard_normal((5, 12)).astype(np.float32)
    fc = jss.FullyConnectedLayer(8, activation="lrelu", lr_multiplier=0.5, bias_init=0.3)
    p = _perturb(jax.jit(fc.init)(jax.random.PRNGKey(0), x)["params"], 1)
    port = FullyConnectedLayer(12, 8, activation="lrelu", lr_multiplier=0.5, bias_init=0.3)
    port.load_state_dict({k: _t(v) for k, v in p.items()})
    np.testing.assert_allclose(port(_t(x)).detach().numpy(), np.asarray(fc.apply({"params": p}, x)),
                               **TOL)
    x3 = rs.standard_normal((2, 3, 12)).astype(np.float32)
    mlp = jss.MLP((12, 16, 8), linear_out=True)
    p = _perturb(jax.jit(mlp.init)(jax.random.PRNGKey(1), x3)["params"], 2)
    port = MLP((12, 16, 8), linear_out=True)
    port.load_state_dict({f"{layer}.{k}": _t(v) for layer, d in p.items() for k, v in d.items()})
    np.testing.assert_allclose(port(_t(x3)).detach().numpy(),
                               np.asarray(mlp.apply({"params": p}, x3)), **TOL)
    np.testing.assert_allclose(normalize_2nd_moment(_t(x)).numpy(),
                               np.asarray(jss.normalize_2nd_moment(x)), **TOL)
    res = jss.ResidualBlock(jss.FullyConnectedLayer(12, activation="swish"))
    p = _perturb(jax.jit(res.init)(jax.random.PRNGKey(2), x)["params"], 3)
    port = ResidualBlock(FullyConnectedLayer(12, 12, activation="swish"))
    port.load_state_dict({f"fn.{k}": _t(v) for k, v in p["fn"].items()})
    np.testing.assert_allclose(port(_t(x)).detach().numpy(),
                               np.asarray(res.apply({"params": p}, x)), **TOL)
