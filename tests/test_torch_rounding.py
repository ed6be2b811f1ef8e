"""The port rounds where flax does around a bf16 Dense and a bf16 Conv: the
product rounded to bf16, then the bf16 bias added (a second rounding). A
bias fused into the product rounds once, and then about a third of the
outputs differ from JAX's by one bf16 ulp. Held here for the fused DiT's
``_dense`` (against lfm_tpu/nn/dit_fused.py::_dense) and the VAE's conv and
linear (against flax ``nn.Conv`` / ``nn.Dense`` with ``dtype=bf16``, as the
JAX VAE runs them at the CLI), on seeded numpy inputs: the share of bf16
outputs that differ at all must stay under 0.1% (products summed in another
order still round the other way now and then, a few in 10^5).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import flax.linen as fnn  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch import nn  # noqa: E402

from tests.torch_parity import leaves_process_as_found  # noqa: E402,F401

from lfm_tpu.nn import dit_fused as jfused  # noqa: E402
from lfm_tpu_torch.nn import dit_fused as tfused  # noqa: E402
from lfm_tpu_torch.vae import autoencoder_kl as tvae  # noqa: E402

MAX_SHARE = 1e-3


def _share_differing(got: torch.Tensor, want) -> float:
    g = got.detach().float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    assert g.shape == w.shape
    return float(np.mean(g != w))


def _normal(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("params", ["bf16_copy", "f32_masters"])
def test_fused_dense_rounds_product_then_bias(params):
    """The sampler passes a bf16 copy (``cast_params_bf16``), the fused
    train path the f32 masters, which ``_dense`` casts per use."""
    rng = np.random.default_rng(0)
    x = _normal(rng, (64, 1024))
    kernel = _normal(rng, (1024, 1024), 1024 ** -0.5)
    bias = _normal(rng, (1024,), 0.5)
    want = jfused._dense(jnp.asarray(x), {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)})
    p = {"fc.weight": torch.from_numpy(np.ascontiguousarray(kernel.T)),
         "fc.bias": torch.from_numpy(bias)}
    if params == "bf16_copy":
        p = tfused.cast_params_bf16(p)
    got = tfused._dense(torch.from_numpy(x), p, "fc")
    assert got.dtype == torch.bfloat16
    assert _share_differing(got, want) < MAX_SHARE


def test_vae_conv_rounds_like_flax_conv():
    rng = np.random.default_rng(1)
    x = _normal(rng, (2, 16, 16, 128))
    w = _normal(rng, (128, 128, 3, 3), (9 * 128) ** -0.5)  # (O, I, kh, kw)
    b = _normal(rng, (128,), 0.5)
    conv = nn.Conv2d(128, 128, 3, padding=1)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w))
        conv.bias.copy_(torch.from_numpy(b))
    got = tvae._conv(torch.from_numpy(x).permute(0, 3, 1, 2), conv, torch.bfloat16)
    fconv = fnn.Conv(128, (3, 3), padding=1, dtype=jnp.bfloat16)
    want = fconv.apply({"params": {"kernel": jnp.asarray(w.transpose(2, 3, 1, 0)),
                                   "bias": jnp.asarray(b)}}, jnp.asarray(x))
    assert got.dtype == torch.bfloat16
    assert _share_differing(got.permute(0, 2, 3, 1), want) < MAX_SHARE


def test_vae_linear_rounds_like_flax_dense():
    rng = np.random.default_rng(2)
    x = _normal(rng, (2, 256, 512))
    w = _normal(rng, (512, 512), 512 ** -0.5)  # (out, in)
    b = _normal(rng, (512,), 0.5)
    lin = nn.Linear(512, 512)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w))
        lin.bias.copy_(torch.from_numpy(b))
    got = tvae._linear(torch.from_numpy(x), lin, torch.bfloat16)
    want = fnn.Dense(512, dtype=jnp.bfloat16).apply(
        {"params": {"kernel": jnp.asarray(w.T), "bias": jnp.asarray(b)}}, jnp.asarray(x))
    assert _share_differing(got, want) < MAX_SHARE


def test_vae_f32_conv_is_unchanged_by_the_separate_bias():
    """In f32 the product and the bias add round alike either way."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(_normal(rng, (2, 32, 8, 8)))
    conv = nn.Conv2d(32, 32, 3, padding=1)
    with torch.no_grad():
        conv.bias.copy_(torch.from_numpy(_normal(rng, (32,), 0.5)))
    want = torch.nn.functional.conv2d(x, conv.weight, conv.bias, padding=1)
    assert torch.allclose(tvae._conv(x, conv, torch.float32), want, rtol=0, atol=1e-6)
