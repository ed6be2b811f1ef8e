"""Data-parallel training over two gloo ranks on the CPU (train/train.py,
train/loop.py, core/rng.py's RowGenerator), held against one process at
the same global batch of 8, and through it against JAX's step.

One launch of tests/torch_dist_worker.py ``train`` runs every rank-side
check: two steps of a DiT-T/2 with label dropout and of a test-scale
DhariwalUNet (imnet_adm's network) with dropout and label dropout through
``make_train_step(mesh=...)``, two steps of ``train(...)`` through a small
VAE, and a preemption in which SIGTERM reaches rank 1 alone.

Tolerances: the loss 1e-5 relative (the global mean as the mean of two
means); the parameters, moments and EMA 2e-5 absolute (JAX's own bound
for its sharded step, tests/test_partition.py), except the parameters and
EMA of the elements whose one-process gradient is below 1e-6, 100 times
Adam's eps (such as the qkv bias's key third, whose gradient is zero in
exact arithmetic: the softmax ignores a shift of every score of a row).
Adam divides by |g| + eps, so there an f32 rounding of the gradient moves
the step by a visible share of the learning rate; each of the two steps
moves an element by at most about the learning rate, so those are held
within 5 x lr. Against JAX on the same draws: the loss 1e-5 and the
gradient norm 1e-4 relative (f32 sums in another order through the
backward, tests/test_torch_train.py's bounds).
"""

import os

import numpy as np
import pytest
import torch

try:  # lfm_tpu's attention imports pallas, which sets CUDA_ROOT: import it with
    import jax.experimental.pallas  # noqa: F401  # the module, before the state guard looks
except ImportError:  # the JAX comparison skips
    pass

from tests import torch_dist_worker as w
from tests.torch_parity import leaves_process_as_found  # noqa: F401

from lfm_tpu_torch.core import checkpoint as ckpt
from lfm_tpu_torch.core.rng import RowGenerator, draw_rows, seeded_generator
from lfm_tpu_torch.nn.factory import create_network
from lfm_tpu_torch.train import loop as loop_mod
from lfm_tpu_torch.train.state import create_train_state, make_optimizer

LR = 1e-3
PARAM_TOL = 2e-5
NOISE_GRAD = 1e-6  # 100 x Adam's eps
NOISE_TOL = 5 * LR


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return w.launch("train", 2, tmp_path_factory.mktemp("dist_train"))


def _one_process(build, dropout):
    """Two steps in one process; the state, losses, gradient norms and each
    element's smallest |gradient| over the steps."""
    model = build()
    state = create_train_state(model)
    step = w.model_step(model, dropout=dropout)
    batch = {k: torch.from_numpy(v) for k, v in w.train_batch(True).items()}
    losses, gnorms, low = [], [], None
    for _ in range(2):
        loss, gnorm = step(state, batch)
        losses.append(float(loss))
        gnorms.append(float(gnorm))
        low = _smallest_grads(state.params, low)
    return state, losses, gnorms, low


def _smallest_grads(params, low=None):
    g = [p.grad.detach().abs() for p in params]
    return g if low is None else [torch.minimum(a, b) for a, b in zip(low, g)]


def _assert_state_close(got, state, low, what):
    assert (got["step"], got["count"]) == (state.step, state.count)
    for key in ("params", "mu", "nu", "ema"):
        for name, a, b, g in zip(state.names, got[key], getattr(state, key), low):
            tol = torch.full_like(b, PARAM_TOL)
            if key in ("params", "ema"):
                tol = torch.where(g < NOISE_GRAD, torch.full_like(b, NOISE_TOL), tol)
            err = (a.detach() - b.detach()).abs()
            assert bool((err <= tol).all()), (what, key, name, float(err.max()))


BUILDS = {"dit": (lambda: w.dit_train_model(), False),
          "unet": (lambda: w.unet_train_model()[0], True)}


@pytest.mark.parametrize("name", ["dit", "unet"])
def test_two_rank_steps_match_one_process(ranks, name):
    """Two data-parallel steps with label dropout (and the UNet's dropout):
    the same draws, loss and state as one process at the same global
    batch, on both ranks."""
    build, dropout = BUILDS[name]
    state, losses, _, grads = _one_process(build, dropout)
    for r in ranks:
        got = r[name]
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        _assert_state_close(got, state, grads, name)


def test_two_rank_dit_step_matches_jax(ranks):
    """Step 1 of the two ranks against JAX's loss and gradient norm on the
    draws one process makes for the global batch: t, z1, then the label
    dropout mask, from seeded_generator(seed 3, step 0)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from lfm_tpu.nn import dit as jdit
    from lfm_tpu.nn.convert_dit import convert_dit_state_dict
    from lfm_tpu.ode.flow import interpolate as jinterpolate

    model = w.dit_train_model()
    batch = w.train_batch(True)
    gen = seeded_generator("cpu", 3, 0)
    t = torch.rand((w.TRAIN_BATCH,), generator=gen).numpy()
    z1 = torch.randn(batch["x"].shape, generator=gen).numpy()
    drop = (torch.rand((w.TRAIN_BATCH,), generator=gen) < 0.5).numpy()
    y = np.where(drop, 4, batch["y"])
    jm = jdit.create_dit("DiT-T/2", img_resolution=8, num_classes=4, label_dropout=0.5,
                         use_flash=True)
    params = convert_dit_state_dict({k: v.numpy() for k, v in model.state_dict().items()},
                                    depth=model.depth)

    def loss(p):
        z_t, u = jinterpolate(jnp.asarray(batch["x"] * 0.5), jnp.asarray(z1), jnp.asarray(t))
        v = jm.apply(p, jnp.asarray(t), z_t, jnp.asarray(y), train=False)
        return jnp.mean(jnp.square(v.astype(jnp.float32) - u.astype(jnp.float32)))

    jloss, jgrads = jax.jit(jax.value_and_grad(loss))(params)
    jnorm = float(jnp.sqrt(sum(jnp.sum(jnp.square(g))
                               for g in jax.tree_util.tree_leaves(jgrads))))
    _, _, gnorms, _ = _one_process(w.dit_train_model, False)
    for r in ranks:
        assert abs(r["dit"]["losses"][0] - float(jloss)) <= 1e-5 * abs(float(jloss))
        assert abs(r["dit"]["gnorms"][0] - jnorm) <= 1e-4 * jnorm
    assert abs(gnorms[0] - jnorm) <= 1e-4 * jnorm


def test_two_rank_loop_matches_one_process(ranks, tmp_path):
    """train(...) through the VAE (the encoder's eps drawn for the global
    batch) for two steps."""
    dataset, vae = w.loop_data()
    state, low = _train_recording(w.loop_config(str(tmp_path), "loop"), dataset, vae, 2)
    for r in ranks:
        _assert_state_close(r["loop"], state, low, "loop")


def _train_recording(cfg, dataset, vae, max_steps):
    """train(...) in one process; the state and each element's smallest
    |gradient| over its steps."""
    low = []
    real = loop_mod.make_train_step

    def recording(*a, **k):
        step = real(*a, **k)

        def wrapped(state, batch):
            out = step(state, batch)
            low[:] = [_smallest_grads(state.params, low[0] if low else None)]
            return out

        return wrapped

    loop_mod.make_train_step = recording
    try:
        state = loop_mod.train(cfg, dataset=dataset, vae=vae, device="cpu",
                               max_steps=max_steps, log_fn=lambda *a: None)
    finally:
        loop_mod.make_train_step = real
    return state, low[0]


def test_sigterm_on_one_rank_saves_once_at_the_same_step(ranks, tmp_path):
    """SIGTERM after rank 1's step 1: both ranks save at the check of step
    2 and return; rank 0 alone writes, so the directory holds one
    content.pth, in the one-device format."""
    for r in ranks:
        assert r["preempt"]["step"] == w.PREEMPT_EVERY
        assert r["preempt"]["files"] == ["config.json", ckpt.CONTENT]
    content = ranks[0]["preempt"]["content"]
    assert (content["epoch"], content["global_step"]) == (0, w.PREEMPT_EVERY)
    # what one process writes for the same network
    cfg = w.loop_config(str(tmp_path), "single")
    model = create_network(cfg.model, device="cpu")
    ckpt.save_content(cfg.exp_path, model, create_train_state(model),
                      make_optimizer(cfg.train, 4), 0, cfg)
    single = ckpt.load_content(cfg.exp_path)
    assert set(content) == set(single)
    assert {k: v.shape for k, v in content["model_dict"].items()} == {
        k: v.shape for k, v in single["model_dict"].items()}
    assert set(content["optimizer"]["state"]) == set(single["optimizer"]["state"])


def test_preempted_content_resumes_on_one_or_two_ranks(ranks, tmp_path):
    """The saved content.pth resumes on the two ranks and in one process to
    the same state one step on."""
    cfg = w.loop_config(str(tmp_path), "preempt", num_epoch=5)
    os.makedirs(cfg.exp_path)
    src = os.path.join(ranks[0]["dir"], "preempt_content.pth")
    with open(src, "rb") as f, open(os.path.join(cfg.exp_path, ckpt.CONTENT), "wb") as g:
        g.write(f.read())
    dataset, vae = w.loop_data()
    state, low = _train_recording(cfg, dataset, vae, w.PREEMPT_EVERY + 1)
    assert state.step == w.PREEMPT_EVERY + 1
    for r in ranks:
        _assert_state_close(r["resumed"], state, low, "resumed")


def test_row_generator_draws_the_global_batch():
    """A rank's draws are its rows of one process's draws for the whole
    batch, in the same order; a draw whose leading dimension is not the
    rank's rows raises."""
    full = seeded_generator("cpu", 5, 2)
    want_t, want_z = torch.rand((8,), generator=full), torch.randn((8, 3), generator=full)
    for start in (0, 4):
        g = seeded_generator("cpu", 5, 2, rows=(start, start + 4, 8))
        assert isinstance(g, RowGenerator)
        assert torch.equal(draw_rows(torch.rand, (4,), g, "cpu"), want_t[start:start + 4])
        assert torch.equal(draw_rows(torch.randn, (4, 3), g, "cpu"),
                           want_z[start:start + 4])
    with pytest.raises(ValueError, match="leading dimension"):
        draw_rows(torch.rand, (8,), seeded_generator("cpu", 1, rows=(0, 4, 8)), "cpu")
    plain = seeded_generator("cpu", 5, 2)
    assert torch.equal(draw_rows(torch.rand, (8,), plain, "cpu"), want_t)
