"""The downstream tasks' model side through the port on the CPU, against
lfm_tpu at test scale: the SpatialRescaler, one conditional train step of
each task (inpainting: a 9-channel origin ADM; semantic synthesis: 8
channels and the rescaler trained with it), the conditional sampler, the
inpainting composite, the semantic sampler, ``to_rgb`` and the weight
converters. The ADM is narrow (nf 32, ch_mult (1, 2), attention at ds 2;
the port's through ``use_flash``, K1's and K3's plain versions here, the
JAX package's plain, as its downstream loops and samplers build it), the
VAE has four blocks of 32 channels (f = 8), the images are 64^2.

JAX's threefry bits cannot be matched, so both sides get the same draws:
the VAE posterior eps (the image's, then the masked image's), t and the
noise, answered in call order in place of ``jax.random.normal`` /
``uniform`` and of the port's ``torch.randn`` / ``rand`` in the modules
that draw them.

Tolerances: f32 throughout. The rescaler 1e-6 relative (the same bilinear
weights and one product); loss and gradient norm 1e-5 relative, each
gradient 1e-4 of its tensor's largest value (floored at 1e-3 of the
step's largest gradient), the parameters and EMA after the step as
tests/test_torch_adm_train.py holds them (Adam's first step moves a
parameter by about lr times the sign of its gradient); the sampled latents
1e-5 relative for euler, and for dopri5 at 1e-5 tolerances (the same NFE,
the same accepted steps); images after the VAE decode 1e-4; the
composite equals the input image bit for bit outside the hole.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import jax.experimental.pallas  # noqa: E402,F401  (sets CUDA_ROOT once, before the guard)
import torch  # noqa: E402
import torch._dynamo  # noqa: E402,F401

from tests.torch_parity import leaves_process_as_found, randomize, rel_err, to_np  # noqa: E402,F401

from lfm_tpu.core import config as jconfig  # noqa: E402
from lfm_tpu.nn import adm_unet as jadm  # noqa: E402
from lfm_tpu.nn.convert_adm import convert_adm_state_dict  # noqa: E402
from lfm_tpu.nn.encoders import SpatialRescaler as JRescaler  # noqa: E402
from lfm_tpu.sample import downstream as jds  # noqa: E402
from lfm_tpu.train import conditional as jcond  # noqa: E402
from lfm_tpu.train import state as jstate  # noqa: E402
from lfm_tpu.vae.autoencoder_kl import AutoencoderKL as JVAE  # noqa: E402
from lfm_tpu_torch.core import config as tconfig  # noqa: E402
from lfm_tpu_torch.nn import adm_unet as tadm  # noqa: E402
from lfm_tpu_torch.nn.convert_adm import adm_params_from_jax  # noqa: E402
from lfm_tpu_torch.nn.encoders import SpatialRescaler, rescaler_params_from_jax  # noqa: E402
from lfm_tpu_torch.sample import downstream as tds  # noqa: E402
from lfm_tpu_torch.train import conditional as tcond  # noqa: E402
from lfm_tpu_torch.train import state as tstate  # noqa: E402
from lfm_tpu_torch.vae import autoencoder_kl as tvae  # noqa: E402
from lfm_tpu_torch.vae.convert import vae_params_from_jax  # noqa: E402

N, RES, LAT, CLASSES = 2, 64, 8, 5
SCALE = 0.18215
BLOCKS = (32, 32, 32, 32)
OPT = dict(lr=1e-3, num_epoch=10, no_lr_decay=True, ema_decay=0.9, use_ema=True)


def _adm(in_ch):
    return dict(image_size=LAT, in_channels=in_ch, model_channels=32, out_channels=4,
                num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2), num_heads=2)


@pytest.fixture(scope="module")
def vae():
    """The JAX VAE, its seeded params, and the port's VAE on them."""
    jv = JVAE(block_out=BLOCKS)
    params = randomize(jax.jit(jv.init)(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)),
                                        jax.random.PRNGKey(1)), 6)
    tv = tvae.AutoencoderKL(BLOCKS)
    tv.load_state_dict(vae_params_from_jax(params))
    return jv, params, tv.eval().requires_grad_(False)


def _unet(in_ch, seed=5):
    jm = jadm.UNetModel(**_adm(in_ch))
    params = randomize(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1,)),
                                        jnp.zeros((1, LAT, LAT, in_ch))), seed, scale=0.2)
    tm = tadm.UNetModel(**_adm(in_ch), use_flash=True)
    tm.load_state_dict(adm_params_from_jax(params, tm.plan))
    return jm, params, tm


def _rescaler(seed=7):
    jr = JRescaler(n_stages=3, multiplier=0.5, out_channels=4)
    params = randomize(jr.init(jax.random.PRNGKey(0), jnp.zeros((1, RES, RES, CLASSES))), seed,
                       scale=0.5)
    tr = SpatialRescaler(n_stages=3, multiplier=0.5, in_channels=CLASSES, out_channels=4)
    tr.load_state_dict(rescaler_params_from_jax(params))
    return jr, params, tr


def _batch(task, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (N, RES, RES, 3)).astype(np.float32)
    if task == "inpaint":
        mask = np.zeros((N, RES, RES, 1), np.float32)
        mask[0, 8:40, 16:56] = 1.0
        mask[1, 30:60, 2:20] = 1.0
        return {"x": x, "mask": mask, "masked": x * (1 - mask)}
    return {"x": x, "seg": rng.integers(0, CLASSES, (N, RES, RES)).astype(np.int32)}


def _draws(task, seed=4):
    """[eps of x, (eps of masked,)] t, z1: in the order both steps draw."""
    rng = np.random.default_rng(seed)
    shape = (N, LAT, LAT, 4)
    eps = [rng.standard_normal(shape).astype(np.float32)
           for _ in range(2 if task == "inpaint" else 1)]
    return eps, rng.uniform(size=(N,)).astype(np.float32), rng.standard_normal(shape).astype(
        np.float32)


def _queue_jax(monkeypatch, normals, uniforms):
    """jax.random.normal / uniform answer the given arrays in call order."""
    normals, uniforms = list(normals), list(uniforms)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=(), dtype=jnp.float32: jnp.asarray(normals.pop(0), dtype))
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape=(), dtype=jnp.float32, *a, **k:
                        jnp.asarray(uniforms.pop(0), dtype))
    return normals, uniforms


class _QueuedTorch:
    """``torch`` for a module of the port, with ``rand`` / ``randn``
    answering the given arrays in call order."""

    def __init__(self, normals, uniforms):
        self.normals, self.uniforms = list(normals), list(uniforms)

    def __getattr__(self, name):
        return getattr(torch, name)

    def randn(self, shape, generator=None, device=None, **_):
        return torch.from_numpy(self.normals.pop(0)).to(device)

    def rand(self, shape, generator=None, device=None, **_):
        return torch.from_numpy(self.uniforms.pop(0)).to(device)


def test_spatial_rescaler_matches_flax():
    """3 stages of x0.5 non-antialiased bilinear and the channel map against
    flax, on a one-hot map and on a smooth one; a reference (out, in, 1, 1)
    1x1-conv weight loads as it is."""
    jr, params, tr = _rescaler()
    rng = np.random.default_rng(0)
    onehot = np.eye(CLASSES, dtype=np.float32)[rng.integers(0, CLASSES, (N, RES, RES))]
    smooth = rng.standard_normal((N, 48, 40, CLASSES)).astype(np.float32)
    for x in (onehot, smooth):
        want = np.asarray(jax.jit(jr.apply)(params, jnp.asarray(x)))
        with torch.no_grad():
            got = tr(torch.from_numpy(x))
        assert got.shape == want.shape and rel_err(got, want) < 1e-6
    conv = {"channel_mapper.weight": tr.channel_mapper.weight.detach()[:, :, None, None] + 1.0}
    tr2 = SpatialRescaler(n_stages=3, multiplier=0.5, in_channels=CLASSES, out_channels=4)
    tr2.load_state_dict(conv)
    assert torch.equal(tr2.channel_mapper.weight, conv["channel_mapper.weight"][:, :, 0, 0])
    # no channel map: the resize alone
    bare = np.asarray(JRescaler(n_stages=2).apply({}, jnp.asarray(smooth)))
    assert rel_err(SpatialRescaler(n_stages=2)(torch.from_numpy(smooth)), bare) < 1e-6


def _jax_cond(task, jv, vparams, jr):
    if task == "inpaint":
        return jcond.inpainting_condition(jv, vparams, SCALE)
    return jcond.semantic_condition(jv, vparams, jr, SCALE, CLASSES)


def _port_cond(task, tv):
    if task == "inpaint":
        return tcond.inpainting_condition(tv, SCALE)
    return tcond.semantic_condition(tv, SCALE, CLASSES)


@pytest.mark.parametrize("task", ["inpaint", "semantic"])
def test_cond_train_step_matches_jax(task, vae, monkeypatch):
    """cond_fm_loss, and one make_cond_train_step step (AdamW, EMA, the
    gradient norm over the network and the rescaler), against JAX's jitted
    step on the same batch and draws: the loss, the norm, every gradient
    (the rescaler's too), the parameters and the EMA after the step."""
    jv, vparams, tv = vae
    in_ch = 9 if task == "inpaint" else 8
    jm, mparams, tm = _unet(in_ch)
    jr, rparams, tr = _rescaler()
    cond = None if task == "inpaint" else tr
    params = {"model": mparams, "cond": {} if cond is None else rparams["params"]}
    batch = _batch(task)
    eps, t, z1 = _draws(task)

    def model_apply(p, t_, x_):
        return jm.apply(p, t_, x_)

    jcond_fn = _jax_cond(task, jv, vparams, jr)
    jtc = jconfig.TrainConfig(**OPT)
    tx = jstate.make_optimizer(jtc, 2)
    state = jstate.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                              opt_state=tx.init(params),
                              ema_params=jax.tree_util.tree_map(jnp.copy, params))
    step = jcond.make_cond_train_step(model_apply, jcond_fn, tx, ema_decay=OPT["ema_decay"])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    _queue_jax(monkeypatch, eps + [z1], [t])
    new_state, metrics = jax.jit(step)(state, jbatch, jax.random.PRNGKey(0))

    def loss(p):  # the step's loss on the same draws, for its gradients
        z0, c = jcond_fn(p.get("cond"), jbatch, jax.random.PRNGKey(0))
        z_t, u = jcond.interpolate(z0, jnp.asarray(z1), jnp.asarray(t))
        v = model_apply(p["model"], jnp.asarray(t), jnp.concatenate([z_t, c], axis=-1))
        return jnp.mean(jnp.square(v - u))

    _queue_jax(monkeypatch, eps, [])
    jloss, jgrads = jax.jit(jax.value_and_grad(loss))(params)
    monkeypatch.undo()
    assert abs(float(jloss) - float(metrics.loss)) <= 1e-6 * abs(float(jloss))

    # the port: the loss with the draws given, then the step with them queued
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tcond_fn = _port_cond(task, tv)
    got = tcond.cond_fm_loss(tm, tcond_fn, cond, tbatch, torch.from_numpy(t),
                             torch.from_numpy(z1), eps=[torch.from_numpy(e) for e in eps])
    assert abs(float(got.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))
    mods = tcond.cond_modules(tm, cond)
    tstate_ = tstate.create_train_state(mods)
    tstep = tcond.make_cond_train_step(tm, cond, tcond_fn, tstate.make_optimizer(
        tconfig.TrainConfig(**OPT), 2), ema_decay=OPT["ema_decay"], seed=0)
    queued = _QueuedTorch(eps + [z1], [t])
    monkeypatch.setattr(tcond, "torch", queued)
    monkeypatch.setattr(tvae, "torch", queued)
    params0 = [p.detach().clone() for p in tstate_.params]
    tloss, gnorm = tstep(tstate_, tbatch)
    monkeypatch.undo()
    assert not queued.normals and not queued.uniforms  # every draw taken, in order
    assert abs(float(tloss) - float(metrics.loss)) <= 1e-5 * abs(float(metrics.loss))
    assert abs(float(gnorm) - float(metrics.grad_norm)) <= 1e-5 * float(metrics.grad_norm)

    def convert(tree):
        tree = jax.tree_util.tree_map(np.asarray, tree)
        sd = {f"model.{k}": v for k, v in adm_params_from_jax(tree["model"], tm.plan).items()}
        if cond is not None:
            sd.update({f"cond.{k}": v for k, v in rescaler_params_from_jax(tree["cond"]).items()})
        return sd

    want_g, want_p, want_e = (convert(t_) for t_ in (jgrads, new_state.params,
                                                     new_state.ema_params))
    assert set(tstate_.names) <= set(want_g)
    if cond is not None:
        assert "cond.channel_mapper.weight" in tstate_.names
    lr, decay = OPT["lr"], OPT["ema_decay"]
    floor = 1e-3 * max(float(w.abs().max()) for w in want_g.values())
    for i, name in enumerate(tstate_.names):
        g = to_np(tstate_.params[i].grad).astype(np.float64)
        wg = want_g[name].numpy().astype(np.float64)
        scale = max(float(np.abs(wg).max()), floor)
        assert float(np.abs(g - wg).max()) < 1e-4 * scale, name
        clear = ((np.sign(g) == np.sign(wg)) & (np.abs(g) > 1e-4 * scale)
                 & (np.abs(wg) > 1e-4 * scale))
        p0 = to_np(params0[i])
        for got_, want, stp in ((to_np(tstate_.params[i]), want_p[name].numpy(), lr),
                                (to_np(tstate_.ema[i]), want_e[name].numpy(), (1 - decay) * lr)):
            big = float(np.abs(want).max())
            diff = np.abs(got_.astype(np.float64) - want)
            assert diff[clear].max(initial=0.0) <= 1e-6 * big + 1e-3 * stp, name
            assert diff.max() <= 2 * stp + 1e-6 * big, name
            assert not np.array_equal(got_, p0), name  # every tensor moved


@pytest.mark.parametrize("method", ["euler", "dopri5"])
def test_sample_conditional_matches_jax(method):
    """The conditional ODE (v(t, [x ++ c])) from the same numpy noise and
    condition: the latents and the NFE."""
    jm, mparams, tm = _unet(9)
    rng = np.random.default_rng(9)
    c = rng.standard_normal((N, LAT, LAT, 5)).astype(np.float32)
    noise = rng.standard_normal((N, LAT, LAT, 4)).astype(np.float32)
    kw = dict(method=method, atol=1e-5, rtol=1e-5, num_steps=4)

    def model_apply(p, t_, x_):
        return jm.apply(p, t_, x_)

    want, jnfe = jax.jit(lambda p, c_, n_: jcond.sample_conditional(model_apply, p, c_, n_, **kw))(
        mparams, jnp.asarray(c), jnp.asarray(noise))
    got, nfe = tcond.sample_conditional(tm, torch.from_numpy(c), torch.from_numpy(noise), **kw)
    assert nfe == float(jnfe) and (nfe == 4 if method == "euler" else nfe > 6)
    assert rel_err(got, want) < 1e-5


def test_mask_to_latent_is_jax_nearest():
    """The mask's downsample equals jax.image.resize(..., "nearest") bit for
    bit (torch's nearest-exact; its "nearest" differs)."""
    rng = np.random.default_rng(1)
    for h, w, oh, ow in ((256, 256, 32, 32), (64, 64, 8, 8), (37, 50, 5, 7)):
        m = (rng.uniform(size=(2, h, w, 1)) < 0.5).astype(np.float32)
        want = np.asarray(jax.image.resize(jnp.asarray(m), (2, oh, ow, 1), method="nearest"))
        got = tcond.mask_to_latent(torch.from_numpy(m), (oh, ow)).numpy()
        assert np.array_equal(got, want)


def test_inpainting_and_semantic_samplers_match_jax(vae, monkeypatch):
    """make_inpainting_sampler and make_semantic_sampler (euler, 3 steps)
    against JAX's on the same weights, posterior eps and noise: the images
    within 1e-4; outside the hole the composite is the input image, bit for
    bit; to_rgb given the same projection."""
    jv, vparams, tv = vae
    cfg_j = jconfig.Config(sample=jconfig.SampleConfig(method="euler", num_steps=3))
    cfg_t = tconfig.Config(sample=tconfig.SampleConfig(method="euler", num_steps=3))
    rng = np.random.default_rng(12)
    shape = (N, LAT, LAT, 4)
    eps, noise = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))

    def fake_randn(self, indices, sample_shape, dtype=torch.float32, device=None, stream=None):
        assert list(indices) == [5, 6] and tuple(sample_shape) == shape[1:]
        return torch.from_numpy(eps if stream == tds.ENCODE_STREAM else noise)

    # inpainting
    jm, mparams, tm = _unet(9)
    b = _batch("inpaint")
    _queue_jax(monkeypatch, [eps, noise], [])
    want = np.asarray(jds.make_inpainting_sampler(cfg_j, jm, mparams, jv, vparams)(
        b["x"], b["mask"], b["masked"], jax.random.PRNGKey(0)))
    monkeypatch.undo()
    monkeypatch.setattr(tds.SampleRNG, "randn", fake_randn)
    out = tds.make_inpainting_sampler(cfg_t, tm, None, tv, None, device="cpu")(
        b["x"], b["mask"], b["masked"], [5, 6])
    monkeypatch.undo()
    assert out.nfe == 3.0 and rel_err(out.images, want) < 1e-4
    keep = np.broadcast_to(b["mask"] == 0, want.shape)
    assert np.array_equal(out.images.numpy()[keep], ((b["x"] + 1) / 2)[keep])
    assert 0 < keep.mean() < 1

    # semantic synthesis
    jm, mparams, tm = _unet(8)
    jr, rparams, tr = _rescaler()
    seg = _batch("semantic")["seg"]
    _queue_jax(monkeypatch, [noise], [])
    want = np.asarray(jds.make_semantic_sampler(cfg_j, jm, mparams, jr, rparams["params"], jv,
                                                vparams, CLASSES)(seg, jax.random.PRNGKey(0)))
    monkeypatch.undo()
    monkeypatch.setattr(tds.SampleRNG, "randn", fake_randn)
    out = tds.make_semantic_sampler(cfg_t, tm, None, tr, None, tv, None, CLASSES,
                                    device="cpu")(seg, [5, 6])
    monkeypatch.undo()
    assert out.images.shape == (N, RES, RES, 3) and rel_err(out.images, want) < 1e-4

    onehot = np.eye(CLASSES, dtype=np.float32)[seg]
    w = jax.random.normal(jax.random.PRNGKey(3), (CLASSES, 3))
    want = np.asarray(jds.to_rgb(jnp.asarray(onehot), jax.random.PRNGKey(3)))
    got = tds.to_rgb(torch.from_numpy(onehot), weight=torch.from_numpy(np.asarray(w)))
    assert rel_err(got, want) < 1e-6 and float(got.min()) == -1.0


@pytest.mark.parametrize("in_ch", [9, 8])
def test_weight_converters_carry_the_downstream_adm(in_ch):
    """The 9- and 8-channel ADM's weights go both ways: JAX's params through
    adm_params_from_jax load strictly into the port, and the port's
    state dict (a reference model_{E}.pth's layout) through
    lfm_tpu.nn.convert_adm gives JAX's params back; both models give the
    same velocity. The rescaler's converter likewise."""
    jm, mparams, tm = _unet(in_ch, seed=11)
    back = convert_adm_state_dict({k: v.numpy() for k, v in tm.state_dict().items()}, jm)
    flat_a = jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, mparams))
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        assert np.array_equal(flat_b[path], leaf), path
    rng = np.random.default_rng(2)
    t = rng.uniform(size=(N,)).astype(np.float32)
    x = rng.standard_normal((N, LAT, LAT, in_ch)).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply)(mparams, jnp.asarray(t), jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(t), torch.from_numpy(x))
    assert rel_err(got, want) < 1e-5
    assert tm.input_blocks[0][0].weight.shape[1] == in_ch
    _, rparams, tr = _rescaler(seed=in_ch)
    assert np.array_equal(tr.channel_mapper.weight.detach().numpy().T,
                          np.asarray(rparams["params"]["channel_mapper"]["kernel"]))
