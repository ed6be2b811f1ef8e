"""Port parity: the model zoo's variants (nn/variants.py) of lfm_tpu_torch
against lfm_tpu's on the CPU at test scale, seeded non-zero weights carried
across by ``upsampler_params_from_jax``, ``encoder_unet_params_from_jax``
and ``resnet_params_from_jax``: ``SuperResModel``, ``EncoderUNetModel``
with each pool, ``UNetUpsamplerModel`` (its three outputs), the CIFAR
ResNets in eval mode and ResNet-18 in train mode (the batch statistics,
and the running ones after the step), ``GaussianFourierProjection``'s
frozen ``W``, and ``resize_bilinear`` against ``jax.image.resize``.

Tolerances: max abs error / max |JAX| within 1e-4 in f32 (other sum
orders; norm statistics), as tests/test_torch_adm.py; the running
statistics within 1e-5.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tests.torch_parity import leaves_process_as_found, randomize, rel_err, to_np  # noqa: E402,F401

from lfm_tpu.nn import variants as jvar  # noqa: E402
from lfm_tpu_torch.nn import variants as tvar  # noqa: E402

N = 2
UNET = dict(model_channels=32, num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
            num_heads=2)


def _random_tree(module, seed, *args, scale=0.2, **kw):
    shapes = jax.eval_shape(lambda *a: module.init(jax.random.PRNGKey(0), *a, **kw), *args)
    return randomize(jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), shapes),
                     seed, scale=scale)


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def test_resize_bilinear_matches_jax_image_resize():
    """Up and down, integer and other factors, on both axes at once."""
    x, = _inputs(0, (2, 9, 12, 3))
    for h, w in ((18, 24), (16, 17), (4, 5), (9, 30), (3, 12)):
        want = jax.image.resize(jnp.asarray(x), (2, h, w, 3), method="bilinear")
        assert rel_err(tvar.resize_bilinear(torch.from_numpy(x), h, w), want) < 1e-6


def test_super_res_model_matches_jax():
    kw = dict(UNET, image_size=16, in_channels=8, out_channels=4, num_classes=5)
    jm, tm = jvar.SuperResModel(**kw), tvar.SuperResModel(**kw).eval()
    x, low = _inputs(1, (N, 16, 16, 4), (N, 8, 8, 4))
    t, y = np.array([0.2, 0.9], np.float32), np.array([1, 4], np.int32)
    params = _random_tree(jm, 2, jnp.asarray(t), jnp.asarray(x), jnp.asarray(y),
                          jnp.asarray(low))
    tm.load_state_dict(tvar.upsampler_params_from_jax(params, tm.plan))
    want = jax.jit(jm.apply)(params, jnp.asarray(t), jnp.asarray(x), jnp.asarray(y),
                             jnp.asarray(low))
    with torch.no_grad():
        got = tm(torch.from_numpy(t), torch.from_numpy(x), torch.from_numpy(y).long(),
                 low_res=torch.from_numpy(low))
    assert rel_err(got, want) < 1e-4


@pytest.mark.parametrize("pool", ["adaptive", "attention", "spatial", "spatial_v2"])
def test_encoder_unet_model_matches_jax(pool):
    kw = dict(UNET, image_size=16, in_channels=4, out_channels=7, num_head_channels=16,
              use_scale_shift_norm=pool == "spatial", resblock_updown=pool == "attention",
              pool=pool)
    jm, tm = jvar.EncoderUNetModel(**kw), tvar.EncoderUNetModel(**kw).eval()
    x, = _inputs(3, (N, 16, 16, 4))
    t = np.array([0.4, 0.7], np.float32)
    params = _random_tree(jm, 4, jnp.asarray(t), jnp.asarray(x))
    tm.load_state_dict(tvar.encoder_unet_params_from_jax(params, tm))
    want = jax.jit(jm.apply)(params, jnp.asarray(t), jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(t), torch.from_numpy(x))
    assert got.shape == (N, 7) and rel_err(got, want) < 1e-4


def test_unet_upsampler_matches_jax_and_freezes_w():
    kw = dict(UNET, image_size=16, in_channels=7, out_channels=3)
    jm, tm = jvar.UNetUpsamplerModel(**kw), tvar.UNetUpsamplerModel(**kw).eval()
    x, cond = _inputs(5, (N, 16, 16, 3), (N, 8, 8, 4))
    t, aug = np.array([0.3, 0.6], np.float32), np.array([0.05, 0.2], np.float32)
    params = _random_tree(jm, 6, jnp.asarray(t), jnp.asarray(x), None,
                          (jnp.asarray(cond), jnp.asarray(aug)))
    tm.load_state_dict(tvar.upsampler_params_from_jax(params, tm.plan))
    want = jax.jit(jm.apply)(params, jnp.asarray(t), jnp.asarray(x), None,
                             (jnp.asarray(cond), jnp.asarray(aug)))
    with torch.no_grad():
        got = tm(torch.from_numpy(t), torch.from_numpy(x),
                 context=(torch.from_numpy(cond), torch.from_numpy(aug)))
    for g, w in zip(got, want):
        assert rel_err(g, w) < 1e-4
    frozen = [name for name, p in tm.named_parameters() if not p.requires_grad]
    assert sorted(frozen) == ["aug_gfp.W", "time_gfp.W"]
    gfp = tvar.GaussianFourierProjection(8)
    out = gfp(torch.rand(3))
    assert out.shape == (3, 16) and not gfp.W.requires_grad


def _resnet_variables(jm, seed, x):
    """Seeded weights that keep a deep ResNet's activations finite: kernels
    N(0, 1 / fan_in), norm scales 1 + N(0, 0.1^2), biases and running means
    N(0, 0.1^2), running variances 1 + |N(0, 0.1^2)|."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda a: jm.init(jax.random.PRNGKey(0), a), x)

    def leaf(path, a):
        name = str(getattr(path[-1], "key", path[-1]))
        v = rng.standard_normal(a.shape).astype(np.float32)
        if name == "kernel":
            return v / np.sqrt(np.prod(a.shape[:-1]))
        if name == "scale":
            return 1.0 + 0.1 * v
        return 1.0 + 0.1 * np.abs(v) if name == "var" else 0.1 * v

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.mark.parametrize("depth", ["resnet18", "resnet34", "resnet50", "resnet101"])
def test_resnet_matches_jax_in_eval_mode(depth):
    """Softmax probabilities with the running statistics on 32^2 images."""
    jm, tm = getattr(jvar, depth)(num_classes=10), getattr(tvar, depth)(num_classes=10).eval()
    x, = _inputs(7, (N, 32, 32, 3))
    variables = _resnet_variables(jm, 8, jnp.asarray(x))
    tm.load_state_dict(tvar.resnet_params_from_jax(variables))
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == (N, 10) and rel_err(got, want) < 1e-4


def test_resnet18_train_mode_matches_jax_and_moves_running_stats():
    """One train-mode forward: the batch statistics' output and the
    running statistics after it (flax's momentum 0.99, biased variance)."""
    jm, tm = jvar.resnet18(num_classes=10), tvar.resnet18(num_classes=10).train()
    x, = _inputs(9, (4, 32, 32, 3))
    variables = _resnet_variables(jm, 10, jnp.asarray(x))
    tm.load_state_dict(tvar.resnet_params_from_jax(variables))
    want, updates = jax.jit(lambda v, a: jm.apply(v, a, train=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert rel_err(got, want) < 1e-4
    moved = tvar.resnet_params_from_jax({"params": variables["params"], **updates})
    sd = tm.state_dict()
    for key, value in moved.items():
        if key.endswith(("running_mean", "running_var")):
            assert rel_err(to_np(sd[key]), value.numpy()) < 1e-5, key
            assert not torch.equal(sd[key], tvar.resnet_params_from_jax(variables)[key]), key
