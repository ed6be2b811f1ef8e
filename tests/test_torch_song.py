"""Port parity: EDM's SongUNet (NCSN++, DDPM++, and the ``skip`` encoder and
decoder) and the context DhariwalUNet (``adm_context``) of lfm_tpu_torch
against lfm_tpu's on the CPU at a small size (latents 16x16,
model_channels 32, ch_mult (1, 2), one block per level, attention at
resolution 8), one set of seeded non-zero weights carried across by
``edm_params_from_jax``; the round trip of each ``state_dict`` through
JAX's ``convert_edm_state_dict``; the CFG sampler of ``adm_context`` with
its null label -1; one NCSN++ train step (one level) against JAX's, its Fourier
``freqs`` trained as JAX trains them; the full-width parameter counts.

Tolerances: max abs error / max |JAX| within 1e-4 in f32 (the same
arithmetic; GroupNorm statistics two-pass against flax's E[x^2] - mean^2,
other reduction orders) and 5e-2 in bf16 (bf16 roundings that fall the
other way, compounded over the UNet's depth), as tests/test_torch_edm.py;
the train step as tests/test_torch_adm_train.py in f32.
"""

import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
optax = pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402
# lfm_tpu's make_sampler imports pallas lazily, and that import sets CUDA_ROOT
# in os.environ; a module built on the meta device imports torch._dynamo,
# which sets another: import both before the state guard looks
import jax.experimental.pallas  # noqa: E402,F401
import torch  # noqa: E402
import torch._dynamo  # noqa: E402,F401

from tests.torch_parity import leaves_process_as_found, randomize, rel_err, to_np  # noqa: E402,F401

from lfm_tpu.core import config as jconfig  # noqa: E402
from lfm_tpu.nn import edm_unet as jedm  # noqa: E402
from lfm_tpu.nn.convert_edm import convert_edm_state_dict  # noqa: E402
from lfm_tpu.nn.factory import create_network as jcreate_network  # noqa: E402
from lfm_tpu.sample.sample import make_sampler as jmake_sampler  # noqa: E402
from lfm_tpu.train import state as jstate  # noqa: E402
from lfm_tpu.train.train import make_train_step as jmake_train_step  # noqa: E402
from lfm_tpu.vae.autoencoder_kl import AutoencoderKL as JVAE  # noqa: E402
from lfm_tpu_torch.core import config as tconfig  # noqa: E402
from lfm_tpu_torch.nn import edm_unet as tedm  # noqa: E402
from lfm_tpu_torch.nn.convert_edm import edm_params_from_jax  # noqa: E402
from lfm_tpu_torch.nn.factory import create_network  # noqa: E402
from lfm_tpu_torch.nn.init import unet_init_  # noqa: E402
from lfm_tpu_torch.sample.sample import make_sampler  # noqa: E402
from lfm_tpu_torch.train import state as tstate  # noqa: E402
from lfm_tpu_torch.train import train as ttrain  # noqa: E402
from lfm_tpu_torch.vae.autoencoder_kl import create_vae  # noqa: E402
from lfm_tpu_torch.vae.convert import vae_params_from_jax  # noqa: E402

N, RES, CLASSES = 2, 16, 10
SMALL = dict(img_resolution=RES, model_channels=32, channel_mult=(1, 2), num_blocks=1,
             attn_resolutions=(8,), dropout=0.0)
NCSN = dict(embedding_type="fourier", channel_mult_noise=2, encoder_type="residual",
            resample_filter=(1.0, 3.0, 3.0, 1.0))
DDPM = dict(embedding_type="positional", channel_mult_noise=1, encoder_type="standard")
# SongUNet's settings by name, and the filter its converter takes
SONG = {"ncsn++": NCSN, "ddpm++": DDPM,
        "skip_encoder": dict(NCSN, encoder_type="skip"),
        "skip_decoder": dict(DDPM, decoder_type="skip"),
        "ncsn++_labels": dict(NCSN, label_dim=CLASSES)}
# one level, attention at the latents' size: the train step's and the init
# test's model (half the JAX program to compile)
ONE_LEVEL = dict(SMALL, model_channels=64, channel_mult=(1,), attn_resolutions=(RES,))
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, labels):
    rng = np.random.default_rng(seed)
    t = rng.uniform(0.0, 1.0, (N,)).astype(np.float32)
    x = rng.standard_normal((N, RES, RES, 4)).astype(np.float32)
    # the second label is CFG's null label
    y = np.array([3, -1], np.int32) if labels else None
    return t, x, y


def _random_tree(jm, seed, *args, scale=0.2):
    """jm's param tree with seeded non-zero leaves, its shapes from
    jax.eval_shape (no initialiser runs)."""
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *args)
    return randomize(jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), shapes),
                     seed, scale=scale)


@functools.lru_cache(maxsize=None)
def _song_pair(kind, dtype="float32", seed=3):
    """The JAX SongUNet, its seeded params and the port's on them (built
    once for the tests that read them)."""
    jdt, tdt = DTYPES[dtype]
    kw = SONG[kind]
    jm = jedm.SongUNet(**SMALL, **kw, dtype=jdt)
    t, x, y = _inputs(0, "label_dim" in kw)
    params = _random_tree(jm, seed, jnp.asarray(t), jnp.asarray(x),
                          None if y is None else jnp.asarray(y))
    tm = tedm.SongUNet(**SMALL, **kw, dtype=tdt).eval()
    tm.load_state_dict(edm_params_from_jax(params, kw.get("resample_filter", (1.0, 1.0))))
    return jm, params, tm


@functools.lru_cache(maxsize=None)
def _context_pair(label_dim=CLASSES, dtype="float32", seed=3):
    jdt, tdt = DTYPES[dtype]
    jm = jedm.DhariwalUNet(**SMALL, label_dim=label_dim, use_context=True, dtype=jdt)
    t, x, y = _inputs(0, label_dim)
    params = _random_tree(jm, seed, jnp.asarray(t), jnp.asarray(x),
                          None if y is None else jnp.asarray(y))
    tm = tedm.DhariwalUNet(**SMALL, label_dim=label_dim, use_context=True, dtype=tdt).eval()
    tm.load_state_dict(edm_params_from_jax(params))
    return jm, params, tm


def _forward_both(jm, params, tm, labels, seed=1):
    t, x, y = _inputs(seed, labels)
    want = jax.jit(jm.apply)(params, jnp.asarray(t), jnp.asarray(x),
                             None if y is None else jnp.asarray(y))
    with torch.no_grad():
        got = tm(torch.from_numpy(t), torch.from_numpy(x),
                 None if y is None else torch.from_numpy(y).long())
    assert got.dtype == torch.float32 and tuple(got.shape) == (N, RES, RES, 4)
    return to_np(got), np.asarray(want)


@pytest.mark.parametrize("kind", sorted(SONG))
def test_song_unet_matches_jax_f32(kind):
    jm, params, tm = _song_pair(kind)
    got, want = _forward_both(jm, params, tm, "label_dim" in SONG[kind])
    assert rel_err(got, want) < 1e-4


@pytest.mark.parametrize("kind", ["ncsn++", "ddpm++"])
def test_song_unet_matches_jax_bf16(kind):
    jm, params, tm = _song_pair(kind, "bfloat16")
    got, want = _forward_both(jm, params, tm, False)
    assert rel_err(got, want) < 5e-2


@pytest.mark.parametrize("label_dim", [CLASSES, 0])
def test_context_unet_matches_jax_f32(label_dim):
    """adm_context with a label (its one-row context, -1 gathering the last
    row as JAX's does) and without one (the cross-attention attends to the
    block's own tokens)."""
    jm, params, tm = _context_pair(label_dim)
    got, want = _forward_both(jm, params, tm, label_dim)
    assert rel_err(got, want) < 1e-4


def test_context_unet_null_label_is_the_last_row():
    """-1 reaches the table through a gather that wraps to the last row (a
    class's row when label_dropout is 0), in both packages: the velocity at
    y = -1 equals the velocity at y = label_dim - 1."""
    _, _, tm = _context_pair()
    t, x, _ = _inputs(2, True)
    with torch.no_grad():
        a = tm(torch.from_numpy(t), torch.from_numpy(x), torch.tensor([-1, -1]))
        b = tm(torch.from_numpy(t), torch.from_numpy(x), torch.tensor([CLASSES - 1] * 2))
    assert torch.equal(a, b)


def test_context_cfg_sampler_matches_jax():
    """noise -> CFG 1.25 velocity (one doubled batch, null label -1) ->
    euler at 3 steps -> VAE decode -> [0, 1] images, f32: the port's
    make_sampler on adm_context against lfm_tpu's on the same weights,
    numpy noise and labels, within 1e-4."""
    jm, params, tm = _context_pair(seed=6)
    cfgs = []
    for mod in (jconfig, tconfig):
        c = mod.get_preset("imnet_adm")
        model = dataclasses.replace(c.model, model_type="adm_context", image_size=32, f=2,
                                    nf=32, ch_mult=(1, 2), num_res_blocks=1,
                                    attn_resolutions=(8,), num_classes=CLASSES,
                                    label_dim=CLASSES)
        cfgs.append(dataclasses.replace(c, model=model, sample=dataclasses.replace(
            c.sample, method="euler", num_steps=3)))
    assert cfgs[1].sample.cfg_scale == 1.25
    jv = JVAE(block_out=(32, 32))
    vparams = _random_tree(jv, 4, jnp.zeros((1, 8, 8, 3)), jax.random.PRNGKey(1), scale=0.05)
    tv = create_vae((32, 32), device="cpu")
    tv.load_state_dict(vae_params_from_jax(vparams))
    rng = np.random.default_rng(8)
    noise = rng.standard_normal((N, RES, RES, 4)).astype(np.float32)
    y = np.array([2, 9], np.int32)
    jout = jmake_sampler(cfgs[0], jm, params, jv, vparams, jit=True)(jnp.asarray(noise),
                                                                     jnp.asarray(y))
    tout = make_sampler(cfgs[1], tm, None, tv, None, device="cpu")(
        torch.from_numpy(noise), torch.from_numpy(y).long())
    assert tout.images.shape == (N, 32, 32, 3) and tout.nfe == float(jout.nfe) == 3.0
    assert rel_err(tout.latents, jout.latents) < 1e-4
    assert rel_err(tout.images, jout.images) < 1e-4


def _round_trip(params, sd):
    """JAX's convert_edm_state_dict takes the port's state_dict onto JAX's
    tree: the same leaves, bit for bit."""
    back = convert_edm_state_dict({k: v.numpy() for k, v in sd.items()})
    want = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back["params"])[0])
    assert len(got) == len(want)
    for path, leaf in want:
        assert np.array_equal(np.asarray(got[path]), np.asarray(leaf)), path


@pytest.mark.parametrize("kind", ["ncsn++", "skip_encoder", "skip_decoder", "ncsn++_labels"])
def test_song_state_dict_round_trips_through_jax_converter(kind):
    _, params, tm = _song_pair(kind)
    _round_trip(params, tm.state_dict())
    filt = SONG[kind].get("resample_filter", (1.0, 1.0))
    buffers = dict(tm.named_buffers())
    assert buffers and all(torch.equal(b, tedm.resample_kernel(filt)) for b in buffers.values())


def test_context_state_dict_round_trips_but_the_label_table():
    """JAX's converter has no branch for a LabelEmbedder table (it takes
    every rank-2 weight for a Dense kernel), so ``map_label`` is held apart:
    every other leaf round-trips bit for bit, and the port's converter puts
    JAX's table at ``map_label.embedding_table.weight``."""
    _, params, tm = _context_pair()
    sd = tm.state_dict()
    table = sd.pop("map_label.embedding_table.weight")
    assert np.array_equal(table.numpy(), params["params"]["map_label"]["embedding"])
    rest = {"params": {k: v for k, v in params["params"].items() if k != "map_label"}}
    _round_trip(rest, sd)


# --- one NCSN++ train step against JAX's ------------------------------------

OPT = dict(lr=1e-3, num_epoch=10, no_lr_decay=True, ema_decay=0.9, use_ema=True)
SCALE_FACTOR = 0.18215
TN = 4


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


def test_ncsn_train_step_matches_jax(monkeypatch):
    """One make_train_step of a labelled NCSN++ with label dropout, from the
    same weights, draws (t, z1, the label uniforms) and latents as JAX's:
    the loss and gradient norm within 1e-5, every gradient within 1e-4 of
    its tensor's largest, Fourier ``freqs`` among them, and the updated
    parameters as tests/test_torch_adm_train.py holds them."""
    kw = dict(SONG["ncsn++_labels"], label_dropout=0.5)
    rng = np.random.default_rng(5)
    z = rng.standard_normal((TN, RES, RES, 4)).astype(np.float32)
    y = rng.integers(CLASSES, size=(TN,)).astype(np.int32)
    draws = {(TN,): rng.uniform(size=(TN,)).astype(np.float32),
             (TN, 1): np.array([[0.2], [0.7], [0.4], [0.9]], np.float32),
             (TN, RES, RES, 4): rng.standard_normal((TN, RES, RES, 4)).astype(np.float32)}
    jm = jedm.SongUNet(**ONE_LEVEL, **kw)
    params = _random_tree(jm, 5, jnp.zeros((TN,)), jnp.asarray(z), jnp.asarray(y))
    tm = tedm.SongUNet(**ONE_LEVEL, **kw)
    tm.load_state_dict(edm_params_from_jax(params, NCSN["resample_filter"]))

    spe = 2
    jtc = jconfig.TrainConfig(**OPT)

    def model_apply(p, t, z_t, y_, rngs=None):
        return jm.apply(p, t, z_t, y_, train=True, rngs=rngs)

    step = jmake_train_step(model_apply, jstate.make_optimizer(jtc, spe),
                            ema_decay=OPT["ema_decay"], scale_factor=SCALE_FACTOR,
                            is_latent_data=True, label_dropout=True,
                            fused_update=jstate.make_fused_adamw_ema(
                                jtc, spe, ema_decay=OPT["ema_decay"]))
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape=(), dtype=jnp.float32, *a, **k:
                        jnp.asarray(draws[tuple(shape)], dtype))
    monkeypatch.setattr(jax.random, "normal", lambda key, shape=(), dtype=jnp.float32:
                        jnp.asarray(draws[tuple(shape)], dtype))
    jnew, metrics = jax.jit(step)(jstate.create_train_state(params, jtc, spe),
                                  {"x": jnp.asarray(z), "y": jnp.asarray(y)},
                                  jax.random.PRNGKey(0))

    monkeypatch.undo()
    # the gradient JAX's step took: Adam's first moment after one step is
    # (1 - b1) g
    adam = [n for n in jax.tree_util.tree_leaves(
        jnew.opt_state, is_leaf=lambda n: isinstance(n, optax.ScaleByAdamState))
        if isinstance(n, optax.ScaleByAdamState)][0]
    jgrads = jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1, adam.mu)

    state = tstate.create_train_state(tm)
    tstep = ttrain.make_train_step(tm, tstate.make_optimizer(tconfig.TrainConfig(**OPT), spe),
                                   ema_decay=OPT["ema_decay"], scale_factor=SCALE_FACTOR,
                                   is_latent_data=True, label_dropout=True, seed=0)
    proxy = _TorchDraws(draws)
    monkeypatch.setattr(ttrain, "torch", proxy)
    monkeypatch.setattr(tedm, "torch", proxy)
    params0 = [p.detach().clone() for p in state.params]
    tloss, gnorm = tstep(state, {"x": torch.from_numpy(z), "y": torch.from_numpy(y).long()})
    monkeypatch.undo()

    jloss = float(metrics.loss)
    assert abs(float(tloss) - jloss) <= 1e-5 * abs(jloss)
    assert abs(float(gnorm) - float(metrics.grad_norm)) <= 1e-5 * float(metrics.grad_norm)
    want_g = edm_params_from_jax(jgrads)
    want_p = edm_params_from_jax(jax.tree_util.tree_map(np.asarray, jnew.params))
    assert "map_noise.freqs" in state.names
    floor = 1e-3 * max(float(w.abs().max()) for w in want_g.values())
    lr = OPT["lr"]
    for name, p, g, p0 in zip(state.names, state.params, (q.grad for q in state.params),
                              params0):
        wg = want_g[name].numpy().astype(np.float64)
        scale = max(float(np.abs(wg).max()), floor)
        assert float(np.abs(to_np(g) - wg).max()) < 1e-4 * scale, name
        diff = np.abs(to_np(p).astype(np.float64) - want_p[name].numpy())
        assert diff.max() <= 2 * lr + 1e-6 * float(np.abs(want_p[name].numpy()).max()), name
        assert not np.array_equal(to_np(p), to_np(p0)), name  # every tensor moved
    # the Fourier frequencies get a gradient and move, as in JAX
    assert float(np.abs(want_g["map_noise.freqs"].numpy()).max()) > 0


def test_unet_init_gives_song_and_context_the_jax_initializers():
    """The same tensors start at zero (biases, conv1, proj, aux_conv, the
    cross-attention proj), norm scales at one, the Fourier frequencies at
    N(0, 16^2) and the label table at N(0, 0.02^2), as JAX's init."""
    for tm, jm, y in ((tedm.SongUNet(**ONE_LEVEL, **NCSN), jedm.SongUNet(**ONE_LEVEL, **NCSN),
                       None),
                      (tedm.DhariwalUNet(**ONE_LEVEL, label_dim=CLASSES, use_context=True),
                       jedm.DhariwalUNet(**ONE_LEVEL, label_dim=CLASSES, use_context=True),
                       jnp.zeros((2,), jnp.int32))):
        jp = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((2,)), jnp.zeros((2, RES, RES, 4)),
                              y)
        want = edm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                   NCSN["resample_filter"])
        unet_init_(tm, 0)
        for name, p in tm.named_parameters():
            w = want[name]
            assert bool((p == 0).all()) == bool((w == 0).all()), name
            if bool((w == 1).all()):
                assert bool((p == 1).all()), name
            elif w.numel() >= 256 and not bool((w == 0).all()):
                assert abs(float(p.detach().std()) / float(w.std()) - 1.0) < 0.2, name


FULL = {"ncsn++": 161_240_324, "ddpm++": 157_428_484, "adm_context": 538_786_564}


@pytest.mark.parametrize("model_type", sorted(FULL))
def test_parameter_count_at_full_width_matches_jax(model_type):
    """ncsn++ and ddpm++ at ModelConfig()'s widths, adm_context at
    imnet_adm's, built on the meta device, against jax.eval_shape."""
    if model_type == "adm_context":
        jm = dataclasses.replace(jconfig.get_preset("imnet_adm").model, model_type=model_type)
        tm = dataclasses.replace(tconfig.get_preset("imnet_adm").model, model_type=model_type)
    else:
        jm = jconfig.ModelConfig(model_type=model_type)
        tm = tconfig.ModelConfig(model_type=model_type)
    s = jm.latent_size
    y = jnp.zeros((1,), jnp.int32) if jm.label_dim else None
    shapes = jax.eval_shape(jcreate_network(jm).init, jax.random.PRNGKey(0), jnp.zeros((1,)),
                            jnp.zeros((1, s, s, 4)), y)
    want = sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes))
    model = create_network(tm, device="meta")
    assert sum(p.numel() for p in model.parameters()) == want == FULL[model_type]
