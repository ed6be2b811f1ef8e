"""ADM and EDM training through the port on the CPU, against lfm_tpu at test
scale: one train step (``train/train.py::make_train_step``) of a small
origin ADM (attention through ``use_flash``: K1's and K3's plain versions)
and of a small EDM DhariwalUNet with labels and label dropout, in f32 and
bf16, from the same converted weights, against JAX's ``make_train_step``
(fused AdamW + EMA) on the same latents: the loss, the gradient norm, every
gradient, the updated parameters and the EMA. JAX's threefry bits cannot
be matched, so both steps get the same draws: t, z1 and the label-dropout
uniforms, answered by shape in place of ``jax.random.uniform`` / ``normal``
and of the port's ``torch.rand`` / ``randn`` where those modules call them.
Also: ``unet_init_`` against the JAX initializers, dropout with the step's
generator, ``cli train`` on an ADM preset at test scale reading an NVAE
LMDB, and the loop on EDM with labels.

Tolerances: f32 loss and gradient norm 1e-5 relative, gradients 1e-4 of the
largest value of each tensor (tests/test_torch_train.py's); bf16 5e-2 for
the loss and the norm (tests/test_torch_adm.py's forward tolerance) and
8e-2 for the gradients, the JAX package's own bound between two bf16
gradient paths (tests/test_dit_fused.py:190): through the UNet's bf16
convolutions both packages' bf16 gradients lie 4-6% of a tensor's largest
value from JAX's f32 ones. A tensor's largest value is floored at 1e-3 (f32) or 1e-2
(bf16, a few bf16 ulps) of the model's largest gradient: a convolution's
bias ahead of a GroupNorm has a gradient that is zero but for rounding,
which no two packages share. In bf16 the gradients of the 1-D parameters
(biases, norm scales and shifts: sums over the batch and every pixel) are
held to JAX's f32 ones: XLA's CPU bf16 reduction of such a sum is up to 52%
off its own f32 value at these sizes, the port's at most 4% (as
tests/test_torch_train.py finds for the DiT's qkv bias). Adam's first step moves a parameter by lr g / (|g| + eps), lr times
the sign of its gradient where |g| >> eps, so the updated parameters are
held to 1e-6 of the largest value of each tensor plus 1e-3 lr where the
port's gradient and the one JAX's step took agree in sign and both exceed
the gradient tolerance (of the floored largest value), and to the step's
bound, 2 lr, elsewhere; the EMA as the parameters, scaled by 1 - decay.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
# lfm_tpu's attention imports pallas (CUDA_ROOT), a module built on the meta
# device imports torch._dynamo (TORCHINDUCTOR_CACHE_DIR): both set an
# environment variable when first imported, so import them before the guard
import jax.experimental.pallas  # noqa: E402,F401
import torch  # noqa: E402
import torch._dynamo  # noqa: E402,F401

from tests.torch_parity import leaves_process_as_found, randomize, rel_err, to_np  # noqa: E402,F401

from lfm_tpu.core import config as jconfig  # noqa: E402
from lfm_tpu.nn import adm_unet as jadm  # noqa: E402
from lfm_tpu.nn import edm_unet as jedm  # noqa: E402
from lfm_tpu.ode.flow import interpolate as jinterpolate  # noqa: E402
from lfm_tpu.train import state as jstate  # noqa: E402
from lfm_tpu.train.train import make_train_step as jmake_train_step  # noqa: E402
from lfm_tpu_torch.core import config as tconfig  # noqa: E402
from lfm_tpu_torch.nn import adm_unet as tadm  # noqa: E402
from lfm_tpu_torch.nn import edm_unet as tedm  # noqa: E402
from lfm_tpu_torch.nn.convert_adm import adm_params_from_jax  # noqa: E402
from lfm_tpu_torch.nn.convert_edm import edm_params_from_jax  # noqa: E402
from lfm_tpu_torch.nn.init import unet_init_  # noqa: E402
from lfm_tpu_torch.nn.layers import dropout  # noqa: E402
from lfm_tpu_torch.train import state as tstate  # noqa: E402
from lfm_tpu_torch.train import train as ttrain  # noqa: E402

N, RES, CLASSES = 4, 16, 10
SCALE_FACTOR = 0.18215
OPT = dict(lr=1e-3, num_epoch=10, no_lr_decay=True, ema_decay=0.9, use_ema=True)
ADM = dict(image_size=RES, in_channels=4, model_channels=32, out_channels=4, num_res_blocks=1,
           attention_resolutions=(2,), channel_mult=(1, 2), use_flash=True)
EDM = dict(img_resolution=RES, model_channels=32, channel_mult=(1, 2), num_blocks=1,
           attn_resolutions=(8,), dropout=0.0, label_dim=CLASSES, label_dropout=0.5)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _models(kind, dtype):
    """The JAX model, its seeded params, the port's model on them, the
    converter of a param tree to the port's names, and the labels."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(3)
    t = rng.uniform(size=(N,)).astype(np.float32)
    x = rng.standard_normal((N, RES, RES, 4)).astype(np.float32)
    if kind == "adm":
        jm, y = jadm.UNetModel(**ADM, dtype=jdt), None
        params = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(t), jnp.asarray(x)), 5,
                           scale=0.2)
        tm = tadm.UNetModel(**ADM, dtype=tdt)

        def convert(tree):
            return adm_params_from_jax(tree, tm.plan)
    else:
        jm = jedm.DhariwalUNet(**EDM, dtype=jdt)
        y = rng.integers(CLASSES, size=(N,)).astype(np.int32)
        params = randomize(jm.init({"params": jax.random.PRNGKey(0),
                                    "label_dropout": jax.random.PRNGKey(1)}, jnp.asarray(t),
                                   jnp.asarray(x), jnp.asarray(y)), 5, scale=0.2)
        tm = tedm.DhariwalUNet(**EDM, dtype=tdt)
        convert = edm_params_from_jax
    tm.load_state_dict(convert(params))
    return jm, params, tm, convert, y


def _draws(seed=1):
    """{shape: values}: t (N,), the label-dropout uniforms (N, 1), some
    below EDM's 0.5 and some above, and z1."""
    rng = np.random.default_rng(seed)
    return {(N,): rng.uniform(size=(N,)).astype(np.float32),
            (N, 1): np.array([[0.2], [0.7], [0.4], [0.9]], np.float32),
            (N, RES, RES, 4): rng.standard_normal((N, RES, RES, 4)).astype(np.float32)}


class _TorchDraws:
    """``torch`` for a module of the port, with ``rand`` and ``randn``
    answering the test's draws by shape."""

    def __init__(self, draws):
        self._draws = draws

    def __getattr__(self, name):
        return getattr(torch, name)

    def rand(self, shape, generator=None, device=None):
        return torch.from_numpy(self._draws[tuple(shape)]).to(device)

    randn = rand


def _jax_step(jm, params, z, y, draws, label_dropout, monkeypatch):
    spe = 2
    jtc = jconfig.TrainConfig(**OPT)
    state = jstate.create_train_state(params, jtc, spe)
    fused = jstate.make_fused_adamw_ema(jtc, spe, ema_decay=OPT["ema_decay"])

    def model_apply(p, t, z_t, y_, rngs=None):
        return jm.apply(p, t, z_t, y_, train=True, rngs=rngs)

    step = jmake_train_step(model_apply, jstate.make_optimizer(jtc, spe),
                            ema_decay=OPT["ema_decay"], scale_factor=SCALE_FACTOR,
                            is_latent_data=True, label_dropout=label_dropout,
                            fused_update=fused)
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape=(), dtype=jnp.float32, *a, **k:
                        jnp.asarray(draws[tuple(shape)], dtype))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=(), dtype=jnp.float32:
                        jnp.asarray(draws[tuple(shape)], dtype))
    batch = {"x": jnp.asarray(z)} if y is None else {"x": jnp.asarray(z), "y": jnp.asarray(y)}
    new_state, metrics = jax.jit(step)(state, batch, jax.random.PRNGKey(0))

    def loss(p):  # the step's loss on the same draws, for its gradients
        z0 = jnp.asarray(z) * SCALE_FACTOR
        t = jnp.asarray(draws[(N,)])
        z1 = jnp.asarray(draws[(N, RES, RES, 4)])
        z_t, u = jinterpolate(z0, z1, t)
        rngs = {"label_dropout": jax.random.PRNGKey(0)} if label_dropout else None
        v = model_apply(p, t, z_t, None if y is None else jnp.asarray(y), rngs=rngs)
        return jnp.mean(jnp.square(v.astype(jnp.float32) - u.astype(jnp.float32)))

    jloss, grads = jax.jit(jax.value_and_grad(loss))(params)
    monkeypatch.undo()
    assert abs(float(jloss) - float(metrics.loss)) <= 1e-6 * abs(float(jloss))
    return new_state, metrics, grads


def _port_step(tm, z, y, draws, label_dropout, monkeypatch):
    spe = 2
    tc = tconfig.TrainConfig(**OPT)
    state = tstate.create_train_state(tm)
    step = ttrain.make_train_step(tm, tstate.make_optimizer(tc, spe), ema_decay=OPT["ema_decay"],
                                  scale_factor=SCALE_FACTOR, is_latent_data=True,
                                  label_dropout=label_dropout, seed=0)
    proxy = _TorchDraws(draws)
    monkeypatch.setattr(ttrain, "torch", proxy)
    monkeypatch.setattr(tedm, "torch", proxy)
    batch = {"x": torch.from_numpy(z)}
    if y is not None:
        batch["y"] = torch.from_numpy(y).long()
    params0 = [p.detach().clone() for p in state.params]
    loss, gnorm = step(state, batch)
    monkeypatch.undo()
    grads = {name: p.grad for name, p in zip(state.names, state.params)}
    return state, params0, float(loss), float(gnorm), grads


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["adm", "edm"])
def test_train_step_matches_jax(kind, dtype, monkeypatch):
    jm, params, tm, convert, y = _models(kind, dtype)
    z = np.random.default_rng(2).standard_normal((N, RES, RES, 4)).astype(np.float32)
    draws = _draws()
    label_dropout = kind == "edm"
    jstate_new, metrics, jgrads = _jax_step(jm, params, z, y, draws, label_dropout,
                                            monkeypatch)
    state, params0, loss, gnorm, grads = _port_step(tm, z, y, draws, label_dropout,
                                                    monkeypatch)
    f32 = dtype == "float32"
    tol, grad_tol, floor_share = (1e-5, 1e-4, 1e-3) if f32 else (5e-2, 8e-2, 1e-2)
    jgrads32 = jgrads if f32 else _jax_step(_models(kind, "float32")[0], params, z, y, draws,
                                            label_dropout, monkeypatch)[2]
    jloss = float(metrics.loss)
    assert np.isfinite(loss) and abs(loss - jloss) <= tol * abs(jloss)
    assert abs(gnorm - float(metrics.grad_norm)) <= tol * float(metrics.grad_norm)
    want_g = convert(jax.tree_util.tree_map(np.asarray, jgrads))
    want_g32 = convert(jax.tree_util.tree_map(np.asarray, jgrads32))
    want_p = convert(jax.tree_util.tree_map(np.asarray, jstate_new.params))
    want_e = convert(jax.tree_util.tree_map(np.asarray, jstate_new.ema_params))
    assert set(grads) <= set(want_g)  # the converters also give buffers
    lr, decay = OPT["lr"], OPT["ema_decay"]
    floor = floor_share * max(float(w.abs().max()) for w in want_g.values())
    for i, name in enumerate(state.names):
        g = to_np(grads[name]).astype(np.float64)
        wg = want_g[name].numpy().astype(np.float64)  # the gradient JAX's step took
        ref = want_g32[name].numpy() if g.ndim == 1 else wg
        scale = max(float(np.abs(ref).max()), floor)
        assert float(np.abs(g - ref).max()) < grad_tol * scale, name
        clear = ((np.sign(g) == np.sign(wg)) & (np.abs(g) > grad_tol * scale)
                 & (np.abs(wg) > grad_tol * scale))
        p0 = to_np(params0[i])
        for got, want, step in ((to_np(state.params[i]), want_p[name].numpy(), lr),
                                (to_np(state.ema[i]), want_e[name].numpy(),
                                 (1 - decay) * lr)):
            big = float(np.abs(want).max())
            diff = np.abs(got.astype(np.float64) - want)
            assert diff[clear].max(initial=0.0) <= 1e-6 * big + 1e-3 * step, name
            assert diff.max() <= 2 * step + 1e-6 * big, name
            assert not np.array_equal(got, p0), name  # every tensor moved


def test_unet_init_follows_the_jax_initializers():
    """The same tensors start at zero (biases, the ResBlock and attention
    output projections, the final conv; EDM's conv1, proj and out_conv),
    norm scales at one, and the others at the JAX initializers' scale (the
    draws differ)."""
    for kind in ("adm", "edm"):
        jm, _, tm, convert, y = _models(kind, "float32")
        t, x = jnp.zeros((2,)), jnp.zeros((2, RES, RES, 4))
        if kind == "adm":
            jp = jax.jit(jm.init)(jax.random.PRNGKey(0), t, x)
        else:
            jp = jax.jit(jm.init)({"params": jax.random.PRNGKey(0),
                                   "label_dropout": jax.random.PRNGKey(1)}, t, x,
                                  jnp.zeros((2,), jnp.int32))
        want = convert(jax.tree_util.tree_map(np.asarray, jp))
        unet_init_(tm, 0)
        for name, p in tm.named_parameters():
            w = want[name]
            assert bool((p == 0).all()) == bool((w == 0).all()), name
            if bool((w == 1).all()):
                assert bool((p == 1).all()), name
            elif w.numel() > 1000 and not bool((w == 0).all()):
                assert abs(float(p.detach().std()) / float(w.std()) - 1.0) < 0.15, name


def test_dropout_draws_from_the_generator():
    """flax nn.Dropout's rule: kept with probability 1 - rate, kept values
    over 1 - rate, the rest zero; the same generator gives the same mask,
    and the UNets' train forward is deterministic given it."""
    x = torch.randn(64, 64, generator=torch.Generator().manual_seed(0)) + 3.0
    a = dropout(x, 0.25, torch.Generator().manual_seed(4))
    b = dropout(x, 0.25, torch.Generator().manual_seed(4))
    assert torch.equal(a, b)
    kept = a != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.03
    assert torch.equal(a[kept], x[kept] / 0.75)
    assert dropout(x, 0.0) is x
    tm = tadm.UNetModel(**{**ADM, "dropout": 0.3})
    unet_init_(tm, 0)
    with torch.no_grad():  # a non-zero output conv, so that dropout shows
        for p in tm.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(1)))
    t, z = torch.rand(2), torch.randn(2, RES, RES, 4)
    outs = [tm(t, z, train=True, generator=torch.Generator().manual_seed(9)) for _ in range(2)]
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], tm(t, z))


def test_cli_trains_an_adm_preset_on_an_nvae_lmdb(tmp_path, monkeypatch, capsys):
    """``cli.main train --preset celeb256_adm`` at test scale on the CPU,
    reading a raw-RGB NVAE LMDB written with the port's write_db (records
    at the image size: no Pillow), 2 steps: finite losses, every parameter
    finite and moved, the experiment directory written."""
    from lfm_tpu_torch.cli import main as cli
    from lfm_tpu_torch.data import minilmdb

    rng = np.random.default_rng(0)
    minilmdb.write_db(str(tmp_path / "celeba" / "train.lmdb"),
                      {str(i).encode(): rng.integers(0, 256, (16, 16, 3), np.uint8).tobytes()
                       for i in range(8)})
    monkeypatch.chdir(tmp_path)
    state = cli.main(["train", "--preset", "celeb256_adm", "--device", "cpu",
                      "--datadir", str(tmp_path / "celeba"), "--image_size", "16", "--nf", "32",
                      "--ch_mult", "1", "2", "--attn_resolutions", "1", "--num_res_blocks", "1",
                      "--batch_size", "4", "--max_steps", "2", "--precision", "f32"])
    assert state.step == 2 and all(bool(torch.isfinite(p).all()) for p in state.params)
    out = capsys.readouterr().out
    assert "epoch 0 iteration0, Loss: " in out
    loss = float(out.split("Loss: ")[1].split(",")[0])
    assert np.isfinite(loss)
    exp = tmp_path / "saved_info" / "latent_flow" / "celeba_256" / "celeb256_f8_adm"
    assert (exp / "config.json").exists()


def test_loop_trains_edm_with_labels(tmp_path):
    """train(...) on imnet_adm's DhariwalUNet at test scale on labelled
    latents ("imagenet" in the dataset's name: labels on), two steps from
    the JAX initializers: the labels reach every step and map_label moves."""
    import dataclasses

    from lfm_tpu_torch.data import SyntheticLatentDataset
    from lfm_tpu_torch.train.loop import train

    cfg = tconfig.get_preset("imnet_adm")
    cfg = dataclasses.replace(
        cfg, output_dir=str(tmp_path), dataset="latent_imagenet_256",
        model=dataclasses.replace(cfg.model, image_size=64, nf=32, ch_mult=(1, 2),
                                  attn_resolutions=(4,), num_res_blocks=1, num_classes=CLASSES,
                                  label_dim=CLASSES, label_dropout=0.5),
        train=dataclasses.replace(cfg.train, batch_size=2, precision="f32"))
    ds = SyntheticLatentDataset(n=6, latent_size=8, num_classes=CLASSES, seed=0)
    seen = []
    real = ttrain.make_train_step

    def spy(*a, **k):
        step = real(*a, **k)
        return lambda state, b: seen.append(b.get("y")) or step(state, b)

    import lfm_tpu_torch.train.loop as loop_module
    loop_module.make_train_step = spy
    try:
        state = train(cfg, dataset=ds, device="cpu", max_steps=2, log_fn=lambda *_: None)
    finally:
        loop_module.make_train_step = real
    assert state.step == 2 and all(y is not None and y.shape == (2,) for y in seen)
    i = state.names.index("map_label.weight")
    assert float(state.params[i].abs().max()) > 0
    assert os.path.exists(os.path.join(cfg.exp_path, "config.json"))
