"""Port parity of DiT training's remat policies (nn/dit.py::REMAT_POLICIES):
None, ``dots``, ``all_dots`` and ``dots_attn`` against no remat and
against lfm_tpu's same-policy gradients, on the CPU at DiT-T/2 (16x16
latents, T = 64), f32, with the attention through the port's wrappers
(their plain versions here) and through plain attention.

Tolerances: a policy only chooses what backward recomputes, and the
recompute is the same arithmetic on the same inputs, so the loss equals
no remat's bit for bit and the gradients within rtol 1e-6, atol 0 (as
tests/test_torch_train.py's grad checkpointing test); against JAX the f32
loss within 1e-5 relative and the gradients within 1e-4 of each tensor's
largest value (tests/test_torch_train.py's f32 parity).
"""

import collections

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
# lfm_tpu's attention imports pallas (CUDA_ROOT); torch.utils.checkpoint
# imports torch._dynamo (TORCHINDUCTOR_CACHE_DIR): import both with the
# module, before the state guard looks
import jax.experimental.pallas  # noqa: E402,F401
import torch  # noqa: E402
import torch._dynamo  # noqa: E402,F401
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from tests.torch_parity import leaves_process_as_found, randomize, rel_err, to_np  # noqa: E402,F401

from lfm_tpu.nn import dit as jdit  # noqa: E402
from lfm_tpu.ode.flow import interpolate as jinterpolate  # noqa: E402
from lfm_tpu_torch.kernels import flash_attention  # noqa: E402
from lfm_tpu_torch.nn import dit as tdit  # noqa: E402
from lfm_tpu_torch.nn import layers  # noqa: E402
from lfm_tpu_torch.nn.convert_dit import dit_params_from_jax  # noqa: E402
from lfm_tpu_torch.train.train import fm_train_loss  # noqa: E402

RES, N = 16, 4
POLICIES = [None, "dots", "all_dots", "dots_attn"]


def _draws(seed=1):
    rng = np.random.default_rng(seed)
    z0 = rng.standard_normal((N, RES, RES, 4)).astype(np.float32)
    z1 = rng.standard_normal((N, RES, RES, 4)).astype(np.float32)
    t = rng.uniform(size=(N,)).astype(np.float32)
    return z0, z1, t, np.zeros((N,), np.int64)


@pytest.fixture(scope="module")
def jax_params():
    jm = jdit.create_dit("DiT-T/2", img_resolution=RES)
    params = jax.jit(jm.init)({"params": jax.random.PRNGKey(0),
                               "label_dropout": jax.random.PRNGKey(1)},
                              jnp.zeros((1,)), jnp.zeros((1, RES, RES, 4)),
                              jnp.zeros((1,), jnp.int32))
    return randomize(params, 0)


def _port(params, use_flash, remat, policy):
    tm = tdit.create_dit("DiT-T/2", img_resolution=RES, use_flash=use_flash, remat=remat,
                         remat_policy=policy, device="cpu")
    tm.load_state_dict(dit_params_from_jax(params))
    return tm


def _port_value_and_grad(tm):
    z0, z1, t, y = (torch.from_numpy(a) for a in _draws())
    loss = fm_train_loss(tm, z0, y, t, z1)
    loss.backward()
    return float(loss.detach()), {k: p.grad for k, p in tm.named_parameters()}


def _jax_value_and_grad(params, use_flash, policy):
    jm = jdit.create_dit("DiT-T/2", img_resolution=RES, use_flash=use_flash, remat=True,
                         remat_policy=policy)
    z0, z1, t, y = _draws()

    def loss(p):
        z_t, u = jinterpolate(jnp.asarray(z0), jnp.asarray(z1), jnp.asarray(t))
        v = jm.apply(p, jnp.asarray(t), z_t, jnp.asarray(y), train=True)
        return jnp.mean(jnp.square(v.astype(jnp.float32) - u.astype(jnp.float32)))

    return jax.jit(jax.value_and_grad(loss))(params)


@pytest.mark.parametrize("use_flash", [True, False], ids=["kernel_wrappers", "plain_attention"])
@pytest.mark.parametrize("policy", POLICIES)
def test_policy_gives_no_remat_grads_and_jax_grads(jax_params, policy, use_flash):
    loss, grads = _port_value_and_grad(_port(jax_params, use_flash, True, policy))
    loss0, grads0 = _port_value_and_grad(_port(jax_params, use_flash, False, None))
    assert loss == loss0
    for name, g in grads.items():
        torch.testing.assert_close(g, grads0[name], rtol=1e-6, atol=0)
    jloss, jgrads = _jax_value_and_grad(jax_params, use_flash, policy)
    want = dit_params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    assert set(grads) == set(want)
    assert abs(loss - float(jloss)) <= 1e-5 * abs(float(jloss))
    for name, g in grads.items():
        assert rel_err(to_np(g), want[name].numpy()) < 1e-4, name


@pytest.mark.parametrize("remat,policy,per_block", [
    (False, None, 1), (True, None, 2), (True, "dots", 2), (True, "all_dots", 2),
    (True, "dots_attn", 1)])
@pytest.mark.parametrize("use_flash", [True, False], ids=["kernel_wrappers", "plain_attention"])
def test_attention_forward_runs_once_a_block_under_dots_attn(jax_params, monkeypatch, remat,
                                                             policy, per_block, use_flash):
    """The attention's forward (K1's wrapper, its plain version on the CPU;
    or the plain attention) runs once per block per step without remat and
    under dots_attn, and again in backward under the other policies: a
    policy cannot save what a kernel writes through ctypes."""
    calls = []
    target = (flash_attention, "_forward") if use_flash else (layers, "reference_attention")
    real = getattr(*target)

    def counting(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(*target, counting)
    tm = _port(jax_params, use_flash, remat, policy)
    _port_value_and_grad(tm)
    assert len(calls) == per_block * tm.depth


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_saves_the_products_it_names(jax_params, policy):
    """What a step dispatches, forward and backward, with plain attention:
    a product that a policy saves is not dispatched again in backward.
    None recomputes every block's products, dots saves the Linears'
    (``aten.mm``) and recomputes the attention's (``aten.bmm``), all_dots
    and dots_attn recompute neither."""

    def count(remat, pol):
        tm = _port(jax_params, False, remat, pol)
        with _OpCount() as c:
            _port_value_and_grad(tm)
        return c.counts[torch.ops.aten.mm.default], c.counts[torch.ops.aten.bmm.default]

    mm0, bmm0 = count(False, None)
    mm, bmm = count(True, policy)
    depth = tdit.DIT_CONFIGS["DiT-T/2"][0]
    # a block's forward: adaLN, qkv, proj, fc1, fc2; its attention: 2 bmm
    want = {None: (mm0 + 5 * depth, bmm0 + 2 * depth), "dots": (mm0, bmm0 + 2 * depth),
            "all_dots": (mm0, bmm0), "dots_attn": (mm0, bmm0)}[policy]
    assert (mm, bmm) == want


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="remat_policy"):
        tdit.create_dit("DiT-T/2", img_resolution=RES, remat=True, remat_policy="attn_only",
                        device="cpu")
