"""The fused training slice on the CPU: a DiT trained through
``dit_fused_apply(train_vjp=True)`` (K5's forward and hybrid backward, their
plain versions here) against JAX's jitted module path, at the sizes of
tests/test_dit_fused.py::test_fused_train_apply_grad_parity_interpret
(depth 2, hidden 128, 4 heads, 16x16 latents, batch 4, one class), with
seeded f32 masters converted from the JAX parameters and the same draws
(z0, z1, t) handed to both.

Tolerances are JAX's own for its fused path against its module path
(tests/test_dit_fused.py:180, :190): the loss within 2%, each parameter's
gradient within 8% of its largest value. The two paths round at other
points (the fused block keeps its residual in f32 and rounds its streams
once; the module rounds after each op). Measured: the loss 0.01% off, every
gradient within 1.7% except the qkv biases (7.1% and 4.4%), where XLA's CPU
bf16 reduction in the module path is itself 7.2% and 4.4% off JAX's f32
gradient; the port's are 0.4% and 0.6% off that f32 gradient, and are held
to it within 2%.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import jax.experimental.pallas  # noqa: E402,F401  (sets CUDA_ROOT when first imported)
import torch  # noqa: E402

from tests.torch_parity import leaves_process_as_found, randomize, rel_err, to_np  # noqa: E402,F401

from lfm_tpu.nn.dit import DiT as JDiT  # noqa: E402
from lfm_tpu.ode.flow import interpolate as jinterpolate  # noqa: E402
from lfm_tpu_torch.nn.convert_dit import dit_params_from_jax  # noqa: E402
from lfm_tpu_torch.nn.dit import DiT  # noqa: E402
from lfm_tpu_torch.nn.dit_fused import dit_fused_apply, dit_fused_model_apply  # noqa: E402
from lfm_tpu_torch.ode.flow import interpolate  # noqa: E402
from lfm_tpu_torch.train.state import AdamW, create_train_state  # noqa: E402
from lfm_tpu_torch.train.train import make_train_step  # noqa: E402

N, RES, HIDDEN, DEPTH, HEADS = 4, 16, 128, 2, 4
LOSS_TOL, GRAD_TOL, F32_BIAS_TOL = 0.02, 0.08, 0.02


def _jax_dit(dtype=jnp.bfloat16):
    return JDiT(img_resolution=RES, patch_size=2, in_channels=4, hidden_size=HIDDEN, depth=DEPTH,
                num_heads=HEADS, num_classes=1, dtype=dtype, scan_blocks=True)


def _models():
    jm = _jax_dit()
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1,)), jnp.zeros((1, RES, RES, 4)))
    params = randomize(params, 0)

    def port():
        tm = DiT(img_resolution=RES, patch_size=2, in_channels=4, hidden_size=HIDDEN,
                 depth=DEPTH, num_heads=HEADS, num_classes=1, dtype=torch.bfloat16)
        tm.load_state_dict(dit_params_from_jax(params))
        return tm

    return jm, params, port


def _draws(seed=1):
    rng = np.random.default_rng(seed)
    z0, z1 = (rng.standard_normal((N, RES, RES, 4)).astype(np.float32) for _ in range(2))
    return z0, z1, rng.uniform(size=(N,)).astype(np.float32)


def _jax_loss_and_grads(jm, params, z0, z1, t):
    def jloss(p):
        z_t, u = jinterpolate(jnp.asarray(z0), jnp.asarray(z1), jnp.asarray(t))
        v = jm.apply(p, jnp.asarray(t), z_t, None)
        return jnp.mean(jnp.square(v.astype(jnp.float32) - u.astype(jnp.float32)))

    loss, grads = jax.jit(jax.value_and_grad(jloss))(params)
    return loss, dit_params_from_jax(jax.tree_util.tree_map(np.asarray, grads))


def test_fused_train_loss_and_grads_match_jax_module_path():
    jm, params, port = _models()
    z0, z1, t = _draws()
    want_loss, want = _jax_loss_and_grads(jm, params, z0, z1, t)
    _, want32 = _jax_loss_and_grads(_jax_dit(jnp.float32), params, z0, z1, t)

    tm = port()
    z_t, u = interpolate(*(torch.from_numpy(a) for a in (z0, z1, t)))
    v = dit_fused_apply(tm, dict(tm.named_parameters()), torch.from_numpy(t), z_t, None,
                        train_vjp=True)
    loss = torch.mean(torch.square(v.float() - u.float()))
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= LOSS_TOL * abs(float(want_loss))
    grads = {name: p.grad for name, p in tm.named_parameters()}
    assert set(grads) == set(want)
    for name, g in grads.items():
        assert g is not None and g.dtype == torch.float32, name
        assert rel_err(to_np(g), want[name].numpy()) < GRAD_TOL, (name, rel_err(to_np(g),
                                                                                want[name].numpy()))
        if name.endswith("attn.qkv.bias"):
            assert rel_err(to_np(g), want32[name].numpy()) < F32_BIAS_TOL, name


def test_train_step_through_the_fused_apply_matches_the_module_step():
    """One ``make_train_step(model_apply=dit_fused_model_apply(model))`` step
    on latents: the loss equals the module step's on the same draws within
    2%, the parameters move, and the EMA is decay * p0 + (1 - decay) * p1."""
    _, _, port = _models()
    z0 = torch.from_numpy(_draws()[0])
    decay = 0.9
    results = []
    for fused in (False, True):
        tm = port()
        state = create_train_state(tm)
        p0 = [p.detach().clone() for p in state.params]
        step = make_train_step(tm, AdamW(lr=lambda s: 1e-3),
                               model_apply=dit_fused_model_apply(tm) if fused else None,
                               ema_decay=decay, is_latent_data=True, scale_factor=1.0, seed=3)
        loss, gnorm = step(state, {"x": z0})
        assert state.step == 1 and bool(torch.isfinite(gnorm))
        for name, a, b, e in zip(state.names, p0, state.params, state.ema):
            assert float((b - a).abs().max()) > 0, name
            torch.testing.assert_close(e, decay * a + (1 - decay) * b, rtol=0, atol=1e-6)
        results.append(float(loss))
    module_loss, fused_loss = results
    assert abs(fused_loss - module_loss) <= LOSS_TOL * abs(module_loss)


def test_fused_model_apply_refuses_label_dropout():
    _, _, port = _models()
    apply = dit_fused_model_apply(port())
    with pytest.raises(NotImplementedError, match="label dropout"):
        apply(torch.zeros(N), torch.zeros(N, RES, RES, 4), None, torch.Generator())
