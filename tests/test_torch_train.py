"""Port parity of the training slice on the CPU: the train step's loss and
gradients, grad checkpointing, the VAE encoder, one AdamW + EMA step, the
schedule, and the loop with its content.pth resume, against lfm_tpu at
test scale (DiT-T/2 at 16x16 latents, T = 64; DiT-S/8 at 32x32, T = 16;
a VAE with block_out (32, 32)). Weights, data and every random draw (t,
z1, the encoder's eps, the label-dropout mask) come from numpy seeds and
are handed to both packages: JAX's threefry bits cannot be matched.

Tolerances: the f32 loss 1e-5 relative and the f32 gradients 1e-4 of the
largest value of each tensor (same arithmetic, other reduction order,
through two backward passes); bf16 5e-2 (tests/test_dit_fused.py); the
f32 encoder 1e-5; the optimizer 1e-6 of the largest value of each tensor;
resume exact (the same draws in the same order on one thread). The port
rounds where flax does around Dense (input and f32 kernel cast, product
rounded, bias added in bf16) and LayerNorm (f32 statistics, output
rounded): bit for bit on the CPU, held by its own test. The bf16 loss and
gradients are held to the JAX package's bf16 ones, except the qkv bias's
gradient: XLA's CPU bf16 reduction of it is 5.4-6.0% off its own f32 value
at DiT-T/2, while the port's is 0.6% off that f32 value, so it is held to
the f32 gradient. The bf16 loss lies nearer JAX's bf16 loss than JAX's f32
loss does (0.10 of that gap at DiT-T/2, 0.19 at DiT-S/8), and at DiT-T/2
so do the gradients (summed squares 0.27 of JAX's f32-to-bf16 distance); a
port that computes in f32 reads about 1 on both. The gradients at DiT-S/8
are not held so: silu, GELU and modulate round once in the port, as a
fused kernel does, and after each operation in XLA's CPU code, and on the
CPU JAX differentiates its plain attention while the port runs K3's plain
version; through twelve blocks these differences reach the size of the
bf16-f32 gap (summed squares 0.90 of it).
"""

import dataclasses
import os
import signal

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
# both set an environment variable when first imported: lfm_tpu's attention
# imports pallas (CUDA_ROOT), torch.utils.checkpoint imports torch._dynamo
# (TORCHINDUCTOR_CACHE_DIR); import them with the module, before the state
# guard looks
import jax.experimental.pallas  # noqa: E402,F401
import torch  # noqa: E402
import torch._dynamo  # noqa: E402,F401

from tests.torch_parity import leaves_process_as_found, randomize, rel_err, to_np  # noqa: E402,F401

from lfm_tpu.core import config as jconfig  # noqa: E402
from lfm_tpu.core.convert_optimizer import load_reference_content  # noqa: E402
from lfm_tpu.nn import dit as jdit  # noqa: E402
from lfm_tpu.ode.flow import interpolate as jinterpolate  # noqa: E402
from lfm_tpu.train import state as jstate  # noqa: E402
from lfm_tpu.vae.autoencoder_kl import AutoencoderKL as JVAE  # noqa: E402
from lfm_tpu_torch.core import checkpoint as ckpt  # noqa: E402
from lfm_tpu_torch.core.config import Config, ModelConfig, TrainConfig  # noqa: E402
from lfm_tpu_torch.data import SyntheticLatentDataset  # noqa: E402
from lfm_tpu_torch.nn import dit as tdit  # noqa: E402
from lfm_tpu_torch.nn.convert_dit import dit_params_from_jax  # noqa: E402
from lfm_tpu_torch.train import state as tstate  # noqa: E402
from lfm_tpu_torch.train.loop import train  # noqa: E402
from lfm_tpu_torch.train.train import fm_train_loss  # noqa: E402
from lfm_tpu_torch.vae.autoencoder_kl import create_vae  # noqa: E402
from lfm_tpu_torch.vae.convert import vae_params_from_jax  # noqa: E402

# model type -> latent size
SCALES = {"DiT-T/2": 16, "DiT-S/8": 32}


def _pair(model_type, dtype_j, dtype_t, *, num_classes=1, label_dropout=0.0, seed=0,
          remat=False):
    res = SCALES[model_type]
    jm = jdit.create_dit(model_type, img_resolution=res, num_classes=num_classes,
                         label_dropout=label_dropout, dtype=dtype_j, use_flash=True)
    x = jnp.zeros((1, res, res, 4))
    params = jax.jit(jm.init)({"params": jax.random.PRNGKey(0),
                               "label_dropout": jax.random.PRNGKey(1)},
                              jnp.zeros((1,)), x, jnp.zeros((1,), jnp.int32))
    params = randomize(params, seed)
    tm = tdit.create_dit(model_type, img_resolution=res, num_classes=num_classes,
                         label_dropout=label_dropout, dtype=dtype_t, use_flash=True,
                         remat=remat, device="cpu")
    tm.load_state_dict(dit_params_from_jax(params))
    return jm, params, tm


def _draws(n, res, num_classes, seed=1):
    rng = np.random.default_rng(seed)
    z0 = rng.standard_normal((n, res, res, 4)).astype(np.float32)
    z1 = rng.standard_normal((n, res, res, 4)).astype(np.float32)
    t = rng.uniform(size=(n,)).astype(np.float32)
    y = rng.integers(num_classes, size=(n,))
    drop = (rng.uniform(size=(n,)) < 0.5).astype(np.int64)
    return z0, z1, t, y, drop


def _jax_value_and_grad(jm, params, z0, z1, t, y, train):
    def loss(p):
        z_t, u = jinterpolate(jnp.asarray(z0), jnp.asarray(z1), jnp.asarray(t))
        v = jm.apply(p, jnp.asarray(t), z_t, jnp.asarray(y), train=train)
        return jnp.mean(jnp.square(v.astype(jnp.float32) - u.astype(jnp.float32)))

    return jax.jit(jax.value_and_grad(loss))(params)


def _port_value_and_grad(tm, z0, z1, t, y, drop=None):
    for p in tm.parameters():
        p.grad = None
    loss = fm_train_loss(tm, torch.from_numpy(z0), torch.from_numpy(y), torch.from_numpy(t),
                         torch.from_numpy(z1),
                         force_drop_ids=None if drop is None else torch.from_numpy(drop))
    loss.backward()
    return float(loss), {k: p.grad for k, p in tm.named_parameters()}


@pytest.mark.parametrize("model_type", ["DiT-T/2", "DiT-S/8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_loss_and_grads_match_jax(model_type, dtype):
    """celeb-like: one class, no label dropout, train mode on both sides."""
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    jm, params, tm = _pair(model_type, jdt, tdt, remat=True)
    z0, z1, t, y, _ = _draws(4, SCALES[model_type], 1)
    jloss, jgrads = _jax_value_and_grad(jm, params, z0, z1, t, y, train=True)
    loss, grads = _port_value_and_grad(tm, z0, z1, t, y)
    want = dit_params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    assert set(grads) == set(want)
    loss_tol, grad_tol = (1e-5, 1e-4) if dtype == "float32" else (5e-2, 5e-2)
    assert abs(loss - float(jloss)) <= loss_tol * abs(float(jloss))
    if dtype == "float32":
        for name, g in grads.items():
            assert rel_err(to_np(g), want[name].numpy()) < grad_tol, name
        return
    jm32 = jdit.create_dit(model_type, img_resolution=SCALES[model_type], use_flash=True)
    jloss32, jgrads32 = _jax_value_and_grad(jm32, params, z0, z1, t, y, train=True)
    want32 = dit_params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads32))
    for name, g in grads.items():
        ref = want32 if name.endswith("attn.qkv.bias") else want
        assert rel_err(to_np(g), ref[name].numpy()) < grad_tol, name
    # bf16 rounding, not f32 arithmetic: nearer JAX's bf16 result than its f32 one is
    assert abs(loss - float(jloss)) <= 0.5 * abs(float(jloss32) - float(jloss))
    if model_type == "DiT-T/2":
        def sumsq(pairs):
            return sum(float(np.sum((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
                       for a, b in pairs)

        near = sumsq((to_np(g), want[name].numpy()) for name, g in grads.items())
        spread = sumsq((want32[name].numpy(), want[name].numpy()) for name in grads)
        assert near <= 0.5 * spread, (near, spread)


def test_bf16_dense_and_layernorm_round_where_flax_does():
    """flax ``Dense(dtype=bf16)`` on f32 params: input and kernel cast to
    bf16, the product rounded to bf16, then the bias added in bf16;
    ``LayerNorm(dtype=bf16)``: f32 statistics, the output rounded. The port
    gives the same bits (a few in ten thousand may differ by the order of
    the f32 sums); a bias fused into the product (one rounding) matches
    about 73%, an unrounded f32 kernel about 50%."""
    import flax.linen as fnn

    from lfm_tpu_torch.nn.layers import layer_norm, linear

    rng = np.random.default_rng(9)
    x = rng.standard_normal((4, 64, 256)).astype(np.float32)
    kernel = (0.05 * rng.standard_normal((256, 192))).astype(np.float32)
    bias = (0.05 * rng.standard_normal(192)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = fnn.Dense(192, dtype=jnp.bfloat16).apply({"params": {"kernel": kernel, "bias": bias}},
                                                    xb)
    layer = torch.nn.Linear(256, 192)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(kernel.T.copy()))
        layer.bias.copy_(torch.from_numpy(bias))
        got = linear(torch.from_numpy(x).to(torch.bfloat16), layer, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert np.mean(to_np(got) == np.asarray(want.astype(jnp.float32))) >= 0.999
    want_ln = fnn.LayerNorm(use_bias=False, use_scale=False, epsilon=1e-6,
                            dtype=jnp.bfloat16).apply({}, xb)
    got_ln = layer_norm(torch.from_numpy(x).to(torch.bfloat16)).to(torch.bfloat16)
    assert np.mean(to_np(got_ln) == np.asarray(want_ln.astype(jnp.float32))) >= 0.999


def test_label_dropout_mask_matches_jax():
    """force_drop_ids in train mode against the JAX module applied to the
    labels that mask drops to the null class; and the JAX LabelEmbedder's
    own force_drop_ids."""
    jm, params, tm = _pair("DiT-T/2", jnp.float32, torch.float32, num_classes=10,
                           label_dropout=0.1)
    z0, z1, t, y, drop = _draws(6, 16, 10)
    y_dropped = np.where(drop == 1, 10, y)
    jloss, jgrads = _jax_value_and_grad(jm, params, z0, z1, t, y_dropped, train=False)
    loss, grads = _port_value_and_grad(tm, z0, z1, t, y, drop)
    want = dit_params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    assert abs(loss - float(jloss)) <= 1e-5 * abs(float(jloss))
    for name, g in grads.items():
        assert rel_err(to_np(g), want[name].numpy()) < 1e-4, name
    from lfm_tpu.nn.layers import LabelEmbedder as JLabel

    jl = JLabel(10, 8, 0.1)
    lp = jl.init(jax.random.PRNGKey(0), jnp.zeros((6,), jnp.int32))
    jout = jl.apply(lp, jnp.asarray(y), train=False, force_drop_ids=jnp.asarray(drop))
    table = torch.from_numpy(np.asarray(lp["params"]["embedding"]))
    tl = tm.y_embedder.__class__(10, 8, 0.1)
    tl.embedding_table.weight.data.copy_(table)
    tout = tl(torch.from_numpy(y), torch.float32, force_drop_ids=torch.from_numpy(drop))
    assert np.array_equal(to_np(tout), np.asarray(jout))
    # train mode draws from the generator: the same generator, the same mask
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    a = tl(torch.from_numpy(y), torch.float32, train=True, generator=g1)
    b = tl(torch.from_numpy(y), torch.float32, train=True, generator=g2)
    assert torch.equal(a, b)


def test_dit_init_follows_the_jax_initializers():
    """The same tensors start at zero (adaLN-Zero, the final layer, biases)
    and the others have the JAX initializers' scale (the draws differ)."""
    from lfm_tpu_torch.nn.init import dit_init_

    jm = jdit.create_dit("DiT-S/8", img_resolution=32, num_classes=10, label_dropout=0.1)
    jp = jax.jit(jm.init)({"params": jax.random.PRNGKey(0), "label_dropout": jax.random.PRNGKey(1)},
                          jnp.zeros((1,)), jnp.zeros((1, 32, 32, 4)), jnp.zeros((1,), jnp.int32))
    want = dit_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    tm = dit_init_(tdit.create_dit("DiT-S/8", img_resolution=32, num_classes=10,
                                   label_dropout=0.1, device="cpu"), 0)
    for name, p in tm.named_parameters():
        w = want[name]
        assert bool((p == 0).all()) == bool((w == 0).all()), name
        if w.numel() > 1000 and not bool((w == 0).all()):
            assert abs(float(p.std()) / float(w.std()) - 1.0) < 0.1, name


def test_grad_checkpointing_gives_the_same_grads():
    _, _, on = _pair("DiT-T/2", jnp.float32, torch.float32, remat=True)
    _, _, off = _pair("DiT-T/2", jnp.float32, torch.float32, remat=False)
    z0, z1, t, y, _ = _draws(4, 16, 1)
    loss_on, g_on = _port_value_and_grad(on, z0, z1, t, y)
    loss_off, g_off = _port_value_and_grad(off, z0, z1, t, y)
    assert loss_on == loss_off
    for name in g_on:
        torch.testing.assert_close(g_on[name], g_off[name], rtol=1e-6, atol=0)
    with pytest.raises(NotImplementedError, match="remat_policy"):
        tdit.create_dit("DiT-T/2", img_resolution=16, remat=True, remat_policy="dots",
                        device="cpu")


def test_vae_encoder_matches_jax():
    jv = JVAE(block_out=(32, 32))
    params = jax.jit(jv.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)),
                              jax.random.PRNGKey(1))
    params = randomize(params, 6)
    tv = create_vae((32, 32), device="cpu")
    tv.load_state_dict(vae_params_from_jax(params))
    x = np.random.default_rng(7).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    jmean, jlogvar = jax.jit(lambda p, x_: jv.apply(p, x_, method=JVAE.encode_moments))(
        params, jnp.asarray(x))
    with torch.no_grad():
        mean, logvar = tv.encode_moments(torch.from_numpy(x))
        mode = tv.encode_mode(torch.from_numpy(x))
        eps = torch.from_numpy(np.random.default_rng(8).standard_normal(mean.shape)
                               .astype(np.float32))
        sample = tv.encode_sample(torch.from_numpy(x), eps=eps)
    assert mean.shape == (2, 8, 8, 4) and logvar.dtype == torch.float32
    assert rel_err(mean, jmean) < 1e-5 and rel_err(logvar, jlogvar) < 1e-5
    assert torch.equal(mode, mean)
    want = np.asarray(jmean) + np.exp(0.5 * np.asarray(jlogvar)) * eps.numpy()
    assert rel_err(sample, want) < 1e-5


def _jax_train_config(**kw):
    return jconfig.TrainConfig(**kw)


def test_train_configs_match_lfm_tpu():
    """Every DiT preset's TrainConfig, field for field (celeb256_dit: batch
    32, lr 2e-4, no_lr_decay, EMA 0.9999, grad checkpointing, bf16), and the
    test-scale DiT configs."""
    from lfm_tpu_torch.core.config import PRESETS

    for name, cfg in PRESETS.items():
        assert dataclasses.asdict(cfg.train) == dataclasses.asdict(jconfig.PRESETS[name].train)
    tc = PRESETS["celeb256_dit"].train
    assert (tc.batch_size, tc.lr, tc.no_lr_decay, tc.use_ema, tc.ema_decay,
            tc.use_grad_checkpointing, tc.precision) == (32, 2e-4, True, True, 0.9999, True,
                                                         "bf16")
    for name in ("DiT-T/2", "DiT-T4/2"):
        assert tdit.DIT_CONFIGS[name] == jdit.DIT_CONFIGS[name]


@pytest.mark.parametrize("wd", [0.0, 0.05])
def test_adamw_ema_steps_match_optax_chain_and_fused(wd):
    cfg = dict(lr=1e-3, weight_decay=wd, no_lr_decay=False, num_epoch=10, lr_min=1e-5,
               ema_decay=0.9)
    spe = 2
    _, params, tm = _pair("DiT-T/2", jnp.float32, torch.float32)
    jtc = _jax_train_config(**cfg)
    tx = jstate.make_optimizer(jtc, spe)
    chain = jstate.create_train_state(params, jtc, spe)
    fused = jstate.create_train_state(params, jtc, spe)
    jfused = jax.jit(jstate.make_fused_adamw_ema(jtc, spe, ema_decay=0.9))

    @jax.jit
    def chain_step(st, grads):
        ups, opt = tx.update(grads, st.opt_state, st.params)
        cp = jax.tree_util.tree_map(lambda p, u: p + u, st.params, ups)
        return jstate.TrainState(st.step + 1, cp, opt, jstate.ema_update(st.ema_params, cp, 0.9))

    state = tstate.create_train_state(tm)
    update = tstate.make_fused_adamw_ema(tstate.make_optimizer(TrainConfig(**cfg), spe),
                                         ema_decay=0.9)
    for step in range(3):
        grads = randomize(params, 100 + step, scale=0.1)
        chain = chain_step(chain, grads)
        fp, fopt, fema, jnorm = jfused(fused.opt_state, fused.params, grads, fused.ema_params)
        fused = jstate.TrainState(fused.step + 1, fp, fopt, fema)
        tgrads = dit_params_from_jax(grads)
        gnorm = update(state, [tgrads[n] for n in state.names])
        assert abs(float(gnorm) - float(jnorm)) <= 1e-6 * float(jnorm)
        for jst in (chain, fused):
            adam = jst.opt_state[0]
            trees = {"params": jst.params, "mu": adam.mu, "nu": adam.nu, "ema": jst.ema_params}
            for key, tree in trees.items():
                want = dit_params_from_jax(jax.tree_util.tree_map(np.asarray, tree))
                for name, got in zip(state.names, getattr(state, key)):
                    assert rel_err(to_np(got), want[name].numpy()) < 1e-6, (step, key, name)
    assert (state.step, state.count) == (3, 3)


def test_schedule_and_decay_mask_match_jax():
    for no_decay in (False, True):
        kw = dict(lr=2e-4, lr_min=1e-5, num_epoch=10, no_lr_decay=no_decay)
        jsched = jstate.cosine_epoch_schedule(_jax_train_config(**kw), 3)
        tsched = tstate.cosine_epoch_schedule(TrainConfig(**kw), 3)
        for step in range(0, 40, 3):
            want = float(jsched(jnp.asarray(step, jnp.int32)))
            assert abs(tsched(step) - want) <= 1e-6 * want, step
    tree = {"fourier": {"W": np.zeros(2), "b": np.zeros(2)}, "out": {"kernel": np.zeros(2)}}
    names = ["fourier.W", "fourier.b", "out.kernel"]
    want = jax.tree_util.tree_leaves(jstate.decay_mask(tree))
    assert tstate.decay_mask(names) == [bool(w) for w in want] == [False, True, True]


def _loop_config(tmp_path, name, **train_kw):
    kw = dict(batch_size=4, num_epoch=1, lr=1e-3, no_lr_decay=True, use_ema=True,
              ema_decay=0.9, save_content=True, save_content_every=1, save_ckpt_every=1, seed=3)
    kw.update(train_kw)
    return Config(exp=name, dataset="synthetic_latent", output_dir=str(tmp_path),
                  model=ModelConfig(model_type="DiT-T/2", image_size=128, num_classes=1),
                  train=TrainConfig(**kw))


def _dataset():
    return SyntheticLatentDataset(n=8, latent_size=16, seed=4)


def _assert_same_state(a, b):
    assert (a.step, a.count) == (b.step, b.count)
    for key in ("params", "mu", "nu", "ema"):
        for x, y in zip(getattr(a, key), getattr(b, key)):
            assert torch.equal(x, y), key


def test_train_loop_resumes_from_content_to_the_identical_state(tmp_path):
    logs = []
    # one epoch (2 steps), content.pth saved at its end; then epoch 1 resumes
    first = _loop_config(tmp_path, "resumed", num_epoch=0)
    train(first, dataset=_dataset(), device="cpu", log_fn=logs.append)
    exp = first.exp_path
    assert ckpt.has_content(exp) and os.path.isfile(os.path.join(exp, "model_0.pth"))
    resumed = train(_loop_config(tmp_path, "resumed"), dataset=_dataset(), device="cpu",
                    log_fn=logs.append)
    assert any("resume checkpoint (epoch 1)" in line for line in logs)
    straight = train(_loop_config(tmp_path, "straight"), dataset=_dataset(), device="cpu",
                     log_fn=lambda *a: None)
    assert resumed.step == 4
    _assert_same_state(resumed, straight)
    # model_{E}.pth holds the EMA weights under the reference's names
    sd = torch.load(os.path.join(exp, "model_1.pth"), weights_only=True)
    assert list(sd)[0] == "pos_embed"
    for name, e in zip(resumed.names, resumed.ema):
        assert torch.equal(sd[name], e)


def test_port_content_pth_loads_into_lfm_tpu(tmp_path):
    cfg = _loop_config(tmp_path, "bridge", no_lr_decay=False, weight_decay=0.01)
    state = train(cfg, dataset=_dataset(), device="cpu", log_fn=lambda *a: None)
    path = os.path.join(cfg.exp_path, ckpt.CONTENT)
    jcfg = jconfig.Config(model=jconfig.ModelConfig(model_type="DiT-T/2", image_size=128,
                                                    num_classes=1),
                          train=_jax_train_config(**{f.name: getattr(cfg.train, f.name)
                                                     for f in dataclasses.fields(cfg.train)}))
    jm = jdit.create_dit("DiT-T/2", img_resolution=16, num_classes=1)
    tx = jstate.make_optimizer(jcfg.train, 2)
    jst, epoch, gstep = load_reference_content(path, jcfg, jm, tx)
    assert (epoch, gstep, int(jst.step)) == (2, state.step, state.step)
    adam, sched = jst.opt_state[0], jst.opt_state[2]
    assert int(adam.count) == state.count and int(sched.count) == state.step
    for key, tree in (("params", jst.params), ("mu", adam.mu), ("nu", adam.nu),
                      ("ema", jst.ema_params)):
        want = dit_params_from_jax(jax.tree_util.tree_map(np.asarray, tree))
        assert set(want) == set(state.names)
        for name, got in zip(state.names, getattr(state, key)):
            assert np.array_equal(to_np(got), want[name].numpy()), (key, name)


def test_sigterm_saves_content_at_the_current_epoch(tmp_path):
    cfg = _loop_config(tmp_path, "preempted", num_epoch=3)
    handler = signal.getsignal(signal.SIGTERM)

    def log_fn(line):
        if "Loss" in line:
            os.kill(os.getpid(), signal.SIGTERM)

    state = train(cfg, dataset=_dataset(), device="cpu", log_fn=log_fn)
    assert signal.getsignal(signal.SIGTERM) == handler
    assert state.step == 1
    content = ckpt.load_content(cfg.exp_path)
    assert (content["epoch"], content["global_step"]) == (0, 1)
