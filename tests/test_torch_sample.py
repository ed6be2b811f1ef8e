"""Port parity: the VAE decoder and the whole sampler (noise -> ODE -> VAE
decode) of lfm_tpu_torch against lfm_tpu, on the CPU at a small size: a
DiT with 16x16 latents, hidden 128, depth 2, and a VAE with block_out
(32, 32) (f = 2). Weights come from a numpy seed, every tensor non-zero.

Tolerances: the f32 decode agrees to 1e-5 relative (same arithmetic, other
reduction order); the f32 samplers to 1e-4 (the ODE compounds the
per-evaluation differences), with identical NFE.
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

from tests.torch_parity import leaves_process_as_found, randomize, rel_err  # noqa: E402,F401

from lfm_tpu.core.config import get_preset as jget_preset  # noqa: E402
from lfm_tpu.nn import dit as jdit  # noqa: E402
from lfm_tpu.sample.sample import make_sampler as jmake_sampler  # noqa: E402
from lfm_tpu.vae.autoencoder_kl import AutoencoderKL as JVAE  # noqa: E402
from lfm_tpu_torch.core.config import get_preset  # noqa: E402
from lfm_tpu_torch.nn import dit as tdit  # noqa: E402
from lfm_tpu_torch.nn.convert_dit import dit_params_from_jax  # noqa: E402
from lfm_tpu_torch.sample.sample import make_sampler  # noqa: E402
from lfm_tpu_torch.vae.autoencoder_kl import AutoencoderKL, create_vae  # noqa: E402
from lfm_tpu_torch.vae.convert import vae_params_from_jax  # noqa: E402

BLOCK_OUT = (32, 32)


def _vae_pair(seed=4):
    jv = JVAE(block_out=BLOCK_OUT)
    params = jv.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)), jax.random.PRNGKey(1))
    params = randomize(params, seed)
    tv = create_vae(BLOCK_OUT, device="cpu")
    tv.load_state_dict(vae_params_from_jax(params))
    return jv, params, tv.eval()


def test_vae_decode_parity_f32():
    jv, params, tv = _vae_pair()
    z = np.random.default_rng(5).standard_normal((2, 4, 4, 4)).astype(np.float32)
    want = jv.apply(params, jnp.asarray(z), method=JVAE.decode)
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    with torch.no_grad():
        got = tv.decode(torch.from_numpy(z))
    assert got.shape == (2, 8, 8, 3) and got.dtype == torch.float32
    assert rel_err(got, want) < 1e-5
    # decode turns TF32 off only for its own duration
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == tf32


def test_vae_decode_parity_bf16():
    jv, params, tv = _vae_pair()
    jvb = JVAE(block_out=BLOCK_OUT, dtype=jnp.bfloat16)
    tvb = AutoencoderKL(BLOCK_OUT, dtype=torch.bfloat16)
    tvb.load_state_dict(tv.state_dict())
    z = np.random.default_rng(6).standard_normal((2, 4, 4, 4)).astype(np.float32)
    want = jvb.apply(params, jnp.asarray(z), method=JVAE.decode)
    with torch.no_grad():
        got = tvb.decode(torch.from_numpy(z))
    assert rel_err(got, want) < 5e-2


def _config(method, num_steps=4):
    cfg_j, cfg_t = jget_preset("celeb256_dit"), get_preset("celeb256_dit")
    out = []
    for c in (cfg_j, cfg_t):
        model = dataclasses.replace(c.model, image_size=32, f=2)
        sample = dataclasses.replace(c.sample, method=method, num_steps=num_steps)
        out.append(dataclasses.replace(c, model=model, sample=sample))
    return out


@pytest.mark.parametrize("method", ["euler", "dopri5"])
def test_make_sampler_end_to_end_parity(method):
    """noise -> ODE -> VAE decode -> [0, 1] images, f32: the port's
    make_sampler against lfm_tpu's on the same weights and noise."""
    cfg_j, cfg_t = _config(method)
    jm = jdit.DiT(img_resolution=16, patch_size=2, hidden_size=128, depth=2, num_heads=4,
                  num_classes=1, scan_blocks=True)
    params = randomize(jm.init(jax.random.PRNGKey(0), jnp.zeros((1,)), jnp.zeros((1, 16, 16, 4))),
                       seed=7)
    jv, vparams, tv = _vae_pair()
    tm = tdit.DiT(img_resolution=16, patch_size=2, hidden_size=128, depth=2, num_heads=4,
                  num_classes=1)
    noise = np.random.default_rng(8).standard_normal((2, 16, 16, 4)).astype(np.float32)

    jout = jmake_sampler(cfg_j, jm, params, jv, vparams, jit=True)(jnp.asarray(noise), None)
    tout = make_sampler(cfg_t, tm, dit_params_from_jax(params), tv, None,
                        device="cpu")(torch.from_numpy(noise))
    assert tout.images.shape == (2, 32, 32, 3)
    assert float(tout.images.min()) >= 0.0 and float(tout.images.max()) <= 1.0
    assert tout.nfe == float(jout.nfe)
    if method == "euler":
        assert tout.nfe == 4.0
    assert rel_err(tout.latents, jout.latents) < 1e-4
    assert rel_err(tout.images, jout.images) < 1e-4


def test_fused_sampler_bf16_runs_the_fused_path_on_cpu(monkeypatch):
    """A bf16 DiT under use_fused_dit: the sampler takes dit_fused_apply
    (the block's plain version on the CPU) once per evaluation and agrees
    with the module path to bf16 accuracy."""
    from lfm_tpu_torch.nn import dit_fused

    calls = []
    real = dit_fused.dit_fused_apply
    monkeypatch.setattr(dit_fused, "dit_fused_apply",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _, cfg = _config("euler")
    tm = tdit.DiT(img_resolution=16, patch_size=2, hidden_size=128, depth=2, num_heads=4,
                  num_classes=1, dtype=torch.bfloat16, use_flash=True)
    jm = jdit.DiT(img_resolution=16, patch_size=2, hidden_size=128, depth=2, num_heads=4,
                  num_classes=1, scan_blocks=True)
    params = randomize(jm.init(jax.random.PRNGKey(0), jnp.zeros((1,)), jnp.zeros((1, 16, 16, 4))),
                       seed=9)
    sd = dit_params_from_jax(params)
    noise = torch.from_numpy(np.random.default_rng(10).standard_normal((2, 16, 16, 4)).astype(np.float32))
    fused = make_sampler(cfg, tm, sd, device="cpu")(noise)
    module_cfg = dataclasses.replace(cfg, sample=dataclasses.replace(cfg.sample, use_fused_dit=False))
    module = make_sampler(module_cfg, tm, sd, device="cpu")(noise)
    assert fused.nfe == module.nfe == 4.0 and len(calls) == 4
    assert rel_err(fused.latents, module.latents) < 5e-2
