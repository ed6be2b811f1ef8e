"""Port parity: EDM's DhariwalUNet of lfm_tpu_torch against lfm_tpu's on
the CPU at a small size (latents 16x16, model_channels 32, ch_mult (1, 2),
one block per level, attention at resolution 8: T = 64, one head of 64),
one set of seeded non-zero weights carried across by
``edm_params_from_jax``; its converter, reference names, factory, presets,
CFG sampler and parameter count.

Tolerances: max abs error / max |JAX| within 1e-4 in f32 (same
arithmetic; GroupNorm statistics two-pass against flax's E[x^2] - mean^2,
other reduction orders) and 5e-2 in bf16 (bf16 roundings that fall the
other way, compounded over the UNet's depth; 2-4% over four seeds); the
CFG sampler's latents and images within 1e-4 in f32 (the ODE carries the
evaluation's differences).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
# lfm_tpu's make_sampler imports pallas lazily, and that import sets CUDA_ROOT
# in os.environ; import it with the module, before the state guard looks
import jax.experimental.pallas  # noqa: E402,F401
import torch  # noqa: E402
# a module built on the meta device imports torch._dynamo, which sets an
# environment variable when first imported; import it before the guard looks
import torch._dynamo  # noqa: E402,F401

from tests.torch_parity import leaves_process_as_found, randomize, rel_err  # noqa: E402,F401

from lfm_tpu.core import config as jconfig  # noqa: E402
from lfm_tpu.nn import edm_unet as jedm  # noqa: E402
from lfm_tpu.nn.convert_edm import convert_edm_state_dict  # noqa: E402
from lfm_tpu.nn.factory import create_network as jcreate_network  # noqa: E402
from lfm_tpu.sample.sample import make_sampler as jmake_sampler  # noqa: E402
from lfm_tpu.vae.autoencoder_kl import AutoencoderKL as JVAE  # noqa: E402
from lfm_tpu_torch.core import config as tconfig  # noqa: E402
from lfm_tpu_torch.core.checkpoint import reference_state_dict  # noqa: E402
from lfm_tpu_torch.nn import edm_unet as tedm  # noqa: E402
from lfm_tpu_torch.nn.convert_edm import edm_params_from_jax  # noqa: E402
from lfm_tpu_torch.nn.factory import create_network  # noqa: E402
from lfm_tpu_torch.nn.init import seeded_init_  # noqa: E402
from lfm_tpu_torch.sample.sample import build_velocity, make_sampler  # noqa: E402
from lfm_tpu_torch.vae.autoencoder_kl import create_vae  # noqa: E402
from lfm_tpu_torch.vae.convert import vae_params_from_jax  # noqa: E402

SMALL = dict(img_resolution=16, model_channels=32, channel_mult=(1, 2), num_blocks=1,
             attn_resolutions=(8,), dropout=0.0)
N = 2
EDM_PRESETS = ("ffhq_adm", "bed_adm", "imnet_adm")


def _inputs(seed, label_dim):
    rng = np.random.default_rng(seed)
    t = rng.uniform(0.0, 1.0, (N,)).astype(np.float32)
    x = rng.standard_normal((N, 16, 16, 4)).astype(np.float32)
    # the second label is CFG's null label: the zero one-hot row
    y = np.array([3, -1], np.int32) if label_dim else None
    return t, x, y


def _pair(label_dim, seed=3, dtype="float32"):
    """The JAX model, its seeded params and the port's model on them."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jm = jedm.DhariwalUNet(**SMALL, label_dim=label_dim, dtype=jdt)
    t, x, y = _inputs(0, label_dim)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(t), jnp.asarray(x),
                     None if y is None else jnp.asarray(y))
    params = randomize(params, seed, scale=0.2)
    tm = tedm.DhariwalUNet(**SMALL, label_dim=label_dim, dtype=tdt).eval()
    tm.load_state_dict(edm_params_from_jax(params))
    return jm, params, tm


def _forward_both(jm, params, tm, seed=1):
    t, x, y = _inputs(seed, tm.label_dim)
    want = jax.jit(jm.apply)(params, jnp.asarray(t), jnp.asarray(x),
                             None if y is None else jnp.asarray(y))
    with torch.no_grad():
        got = tm(torch.from_numpy(t), torch.from_numpy(x),
                 None if y is None else torch.from_numpy(y).long())
    return got, np.asarray(want)


@pytest.mark.parametrize("label_dim", [0, 10])
def test_dhariwal_unet_f32_matches_jax(label_dim):
    jm, params, tm = _pair(label_dim)
    got, want = _forward_both(jm, params, tm)
    assert got.shape == (N, 16, 16, 4) and got.dtype == torch.float32
    assert np.abs(want).max() > 1e-2  # the zero-initialised output conv is seeded
    assert rel_err(got, want) < 1e-4


@pytest.mark.parametrize("label_dim", [0, 10])
def test_dhariwal_unet_bf16_matches_jax(label_dim):
    jm, params, tm = _pair(label_dim, dtype="bfloat16")
    got, want = _forward_both(jm, params, tm)
    assert rel_err(got, want) < 5e-2


def test_null_label_is_the_zero_embedding_and_cfg_matches_jax():
    """Label -1 embeds the zero row (the label's one-hot is all zeros), so it
    equals drop_half_label's zeroing; forward_with_cfg equals JAX's, and
    the sampler's CFG velocity (doubled batch, null label -1) equals
    uncond + s (cond - uncond) from two separate calls."""
    jm, params, tm = _pair(10)
    _, x, _ = _inputs(5, 10)
    x2 = np.concatenate([x, x])
    t2 = np.full((2 * N,), 0.5, np.float32)
    y2 = np.array([3, 7, 3, 7], np.int32)
    tt, xx = torch.from_numpy(t2), torch.from_numpy(x2)
    xt, half = torch.from_numpy(x), tt[:N]
    with torch.no_grad():
        dropped = tm(tt, xx, torch.from_numpy(y2).long(), drop_half_label=True)
        null = tm(tt, xx, torch.tensor([3, 7, -1, -1]))
        got = tm.forward_with_cfg(tt, xx, torch.from_numpy(y2).long(), cfg_scale=1.5)
        v = build_velocity(tm, torch.tensor([3, 7]), 1.5)(0.5, xt)
        cond = tm(half, xt, torch.tensor([3, 7]))
        uncond = tm(half, xt, torch.tensor([-1, -1]))
    assert torch.equal(dropped, null)
    want = jax.jit(lambda p, t, x, y: jm.forward_with_cfg(p, t, x, y, cfg_scale=1.5))(
        params, jnp.asarray(t2), jnp.asarray(x2), jnp.asarray(y2))
    assert rel_err(got, want) < 1e-4
    assert rel_err(v, uncond + 1.5 * (cond - uncond)) < 1e-5
    assert rel_err(v, got[:N]) < 1e-5


def test_edm_params_round_trip_through_the_jax_converter():
    """edm_params_from_jax is the inverse of JAX's convert_edm_state_dict:
    the JAX tree comes back unchanged, and the dict holds exactly the
    port's keys (the resample_filter buffers included)."""
    _, params, tm = _pair(10)
    sd = edm_params_from_jax(params)
    assert set(sd) == set(tm.state_dict())
    back = convert_edm_state_dict(sd)
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    flat_want = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    assert set(flat_back) == set(flat_want)
    for key, want in flat_want.items():
        np.testing.assert_array_equal(np.asarray(flat_back[key]), np.asarray(want))


@pytest.mark.parametrize("prefix", ["", "module."])
def test_reference_named_dict_loads(tmp_path, prefix):
    """The reference's EDM.py names and shapes (1x1-conv qkv and proj, the
    bias-free map_label, the resample_filter buffers of up and down blocks,
    a bare resampling skip without weights) load strictly through the
    checkpoint reader, with and without DDP's ``module.`` prefix."""
    tm = seeded_init_(tedm.DhariwalUNet(**SMALL, label_dim=10), 5)
    sd = {f"{prefix}{k}": v.clone() for k, v in tm.state_dict().items()}
    shapes = {"map_layer0.weight": (128, 32), "map_layer1.bias": (128,),
              "map_label.weight": (128, 10), "enc.16x16_conv.weight": (32, 4, 3, 3),
              "enc.16x16_block0.norm0.weight": (32,), "enc.16x16_block0.affine.weight": (64, 128),
              "enc.8x8_down.conv0.resample_filter": (1, 1, 2, 2),
              "enc.8x8_down.skip.resample_filter": (1, 1, 2, 2),
              "enc.8x8_block0.skip.weight": (64, 32, 1, 1),
              "enc.8x8_block0.qkv.weight": (192, 64, 1, 1),
              "enc.8x8_block0.proj.weight": (64, 64, 1, 1), "dec.8x8_in0.norm2.weight": (64,),
              "dec.8x8_in1.conv1.weight": (64, 64, 3, 3),
              "dec.16x16_up.conv0.weight": (64, 64, 3, 3),
              "dec.16x16_block1.conv0.weight": (32, 64, 3, 3), "out_norm.bias": (32,),
              "out_conv.weight": (4, 32, 3, 3)}
    for key, shape in shapes.items():
        assert tuple(sd[prefix + key].shape) == shape, key
    assert prefix + "map_label.bias" not in sd
    assert prefix + "enc.8x8_down.skip.weight" not in sd
    path = tmp_path / "model_1125.pth"
    torch.save(sd, path)
    fresh = tedm.DhariwalUNet(**SMALL, label_dim=10)
    fresh.load_state_dict(reference_state_dict(str(path)))
    for (name, a), b in zip(fresh.state_dict().items(), tm.state_dict().values()):
        assert torch.equal(a, b), name


def test_factory_dispatches_and_names_what_is_missing():
    cfg = dataclasses.replace(tconfig.get_preset("imnet_adm").model, image_size=64, nf=32,
                              ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(4,))
    model = create_network(cfg, dtype=torch.bfloat16, use_flash=True, device="cpu")
    assert isinstance(model, tedm.DhariwalUNet)
    assert model.null_label == -1 and model.dtype == torch.bfloat16 and model.label_dim == 1000
    # EDM's other networks build too: SongUNet (NCSN++ with its Fourier
    # embedding and residual encoder, DDPM++) and the context DhariwalUNet
    built = {t: create_network(dataclasses.replace(cfg, model_type=t), device="cpu")
             for t in ("ncsn++", "ddpm++", "adm_context")}
    assert all(m.null_label == -1 for m in built.values())
    assert isinstance(built["ncsn++"].map_noise, tedm.FourierEmbedding)
    assert isinstance(built["ddpm++"], tedm.SongUNet) and built["ddpm++"].map_noise is None
    assert isinstance(built["adm_context"], tedm.DhariwalUNet) and built["adm_context"].use_context
    with pytest.raises(ValueError, match="unknown EDM model_type"):
        create_network(dataclasses.replace(cfg, model_type="unet"), device="cpu")


@pytest.mark.parametrize("name", EDM_PRESETS)
def test_edm_presets_and_argfiles_match_lfm_tpu(name):
    """The preset and its released argfile equal the JAX package's, and
    neither is an origin ADM."""
    import os

    assert dataclasses.asdict(tconfig.get_preset(name)) == dataclasses.asdict(
        jconfig.get_preset(name))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(repo, "test_args", f"{name}.txt")
    assert dataclasses.asdict(tconfig.load_argfile(path)) == dataclasses.asdict(
        jconfig.load_argfile(path))
    assert not tconfig.load_argfile(path).model.use_origin_adm


@pytest.mark.parametrize("name", EDM_PRESETS)
def test_parameter_count_at_full_width_matches_jax(name):
    """The preset's network at full width (built on the meta device) has
    the JAX network's parameter count: 407,420,420 for imnet_adm,
    406,396,420 for ffhq_adm and bed_adm."""
    m = jconfig.get_preset(name).model
    s = m.latent_size
    y = jnp.zeros((1,), jnp.int32) if m.label_dim else None
    shapes = jax.eval_shape(jcreate_network(m).init, jax.random.PRNGKey(0), jnp.zeros((1,)),
                            jnp.zeros((1, s, s, 4)), y)
    want = sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes))
    tm = create_network(tconfig.get_preset(name).model, device="meta")
    assert sum(p.numel() for p in tm.parameters()) == want
    assert want == (407_420_420 if name == "imnet_adm" else 406_396_420)


def test_seeded_init_leaves_no_tensor_zero():
    """The zero-initialised conv1, proj and out_conv would hide their
    layers; the seeded weights give every tensor signal, and the fixed
    resampling filters stay the reference's."""
    tm = seeded_init_(tedm.DhariwalUNet(**SMALL, label_dim=10), 0)
    for name, p in tm.named_parameters():
        assert int(torch.count_nonzero(p)) == p.numel(), name
    filters = [b for name, b in tm.named_buffers() if name.endswith("resample_filter")]
    assert len(filters) == 4 and all(torch.equal(f, torch.full((1, 1, 2, 2), 0.25))
                                     for f in filters)


def _sampler_configs(method):
    out = []
    for mod in (jconfig, tconfig):
        c = mod.get_preset("imnet_adm")
        model = dataclasses.replace(c.model, image_size=32, f=2, nf=32, ch_mult=(1, 2),
                                    num_res_blocks=1, attn_resolutions=(8,), num_classes=10,
                                    label_dim=10)
        sample = dataclasses.replace(c.sample, method=method, num_steps=3)
        out.append(dataclasses.replace(c, model=model, sample=sample))
    return out


@pytest.mark.parametrize("method", ["euler", "dopri5"])
def test_cfg_sampler_matches_jax(method):
    """noise -> CFG 1.25 velocity (null label -1) -> ODE -> VAE decode ->
    [0, 1] images, f32: the port's make_sampler against lfm_tpu's on the
    same weights, numpy noise and labels."""
    cfg_j, cfg_t = _sampler_configs(method)
    assert cfg_t.sample.cfg_scale == 1.25
    jm, params, tm = _pair(10, seed=6)
    jv = JVAE(block_out=(32, 32))
    vparams = randomize(jv.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)),
                                jax.random.PRNGKey(1)), 4)
    tv = create_vae((32, 32), device="cpu")
    tv.load_state_dict(vae_params_from_jax(vparams))
    rng = np.random.default_rng(8)
    noise = rng.standard_normal((N, 16, 16, 4)).astype(np.float32)
    y = np.array([2, 9], np.int32)
    jout = jmake_sampler(cfg_j, jm, params, jv, vparams, jit=True)(jnp.asarray(noise),
                                                                   jnp.asarray(y))
    tout = make_sampler(cfg_t, tm, None, tv, None, device="cpu")(torch.from_numpy(noise),
                                                                 torch.from_numpy(y).long())
    assert tout.images.shape == (N, 32, 32, 3)
    assert tout.nfe == float(jout.nfe)
    if method == "euler":
        assert tout.nfe == 3.0
    assert rel_err(tout.latents, jout.latents) < 1e-4
    assert rel_err(tout.images, jout.images) < 1e-4
