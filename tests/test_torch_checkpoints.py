"""The port loads the reference's checkpoint files (ROADMAP Queue 3 items
1-2), on the CPU with synthetic state dicts:

* a diffusers AutoencoderKL dict, in the current ``to_q/to_k/to_v/to_out.0``
  naming and the 2022 ``query/key/value/proj_attn`` naming with 4-D 1x1
  attention weights, as ``.pth`` and ``.safetensors``;
* a reference ``model_{E}.pth`` with the DDP ``module.`` prefix and the
  fixed ``pos_embed``.

Each loads strictly into the port's module, and the module then computes
what lfm_tpu computes after its own converter read the same dict (f32,
1e-5 relative to the largest output: same arithmetic, other reduction
order).
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
# lfm_tpu's DiT attention imports pallas, which sets CUDA_ROOT; import it
# with the module, before the state guard looks
import jax.experimental.pallas  # noqa: E402,F401
import torch  # noqa: E402

from tests.torch_parity import leaves_process_as_found, randomize, rel_err  # noqa: E402,F401

from lfm_tpu.nn import dit as jdit  # noqa: E402
from lfm_tpu.nn.convert_dit import convert_dit_state_dict  # noqa: E402
from lfm_tpu.vae.autoencoder_kl import AutoencoderKL as JVAE  # noqa: E402
from lfm_tpu.vae.convert import convert_vae_state_dict  # noqa: E402
from lfm_tpu_torch.core.checkpoint import reference_state_dict  # noqa: E402
from lfm_tpu_torch.core.config import Config, ModelConfig, TrainConfig  # noqa: E402
from lfm_tpu_torch.data import SyntheticLatentDataset  # noqa: E402
from lfm_tpu_torch.nn import dit as tdit  # noqa: E402
from lfm_tpu_torch.nn.convert_dit import dit_params_from_jax  # noqa: E402
from lfm_tpu_torch.train.loop import train  # noqa: E402
from lfm_tpu_torch.vae.autoencoder_kl import create_vae  # noqa: E402
from lfm_tpu_torch.vae.convert import (load_vae_state_dict, read_safetensors,  # noqa: E402
                                       vae_params_from_jax)

BLOCK_OUT = (32, 32)
_LEGACY = {"to_q": "query", "to_k": "key", "to_v": "value", "to_out.0": "proj_attn"}
_JV = JVAE(block_out=BLOCK_OUT)
_jv_init = jax.jit(_JV.init)
_jv_encode = jax.jit(lambda p, a: _JV.apply(p, a, method=JVAE.encode_moments))
_jv_decode = jax.jit(lambda p, a: _JV.apply(p, a, method=JVAE.decode))


def _diffusers_vae_dict(naming: str):
    """A full diffusers-style VAE dict (encoder, decoder, quant convs) of
    seeded non-zero weights."""
    params = _jv_init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)), jax.random.PRNGKey(1))
    sd = vae_params_from_jax(randomize(params, 11))
    if naming == "current":
        return sd
    out = {}
    for key, v in sd.items():
        for new, old in _LEGACY.items():
            if f".attentions.0.{new}." in key:
                key = key.replace(f".{new}.", f".{old}.")
                if key.endswith(".weight"):
                    v = v[:, :, None, None]  # the 1x1-conv attention of 2022 checkpoints
        out[key] = v
    return out


@pytest.mark.parametrize("fmt", ["pth", "safetensors"])
@pytest.mark.parametrize("naming", ["current", "legacy"])
def test_diffusers_vae_checkpoint_loads(tmp_path, naming, fmt):
    sd = _diffusers_vae_dict(naming)
    path = str(tmp_path / f"vae.{fmt}")
    if fmt == "pth":
        torch.save(sd, path)
    else:
        from safetensors.torch import save_file

        save_file({k: v.contiguous() for k, v in sd.items()}, path)
    tv = create_vae(BLOCK_OUT, device="cpu")
    tv.load_state_dict(load_vae_state_dict(path))  # strict
    jparams = convert_vae_state_dict({k: v.numpy() for k, v in sd.items()},
                                     num_blocks=len(BLOCK_OUT))
    rng = np.random.default_rng(12)
    x = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    z = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    jmean, _ = _jv_encode(jparams, x)
    jimg = _jv_decode(jparams, z)
    with torch.no_grad():
        mean, _ = tv.encode_moments(torch.from_numpy(x))
        img = tv.decode(torch.from_numpy(z))
    assert rel_err(mean, jmean) < 1e-5 and rel_err(img, jimg) < 1e-5


def test_safetensors_reader_matches_the_library(tmp_path):
    from safetensors.torch import save_file

    rng = np.random.default_rng(13)
    tensors = {"f32": torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32)),
               "bf16": torch.from_numpy(rng.standard_normal(7).astype(np.float32)).bfloat16(),
               "f16": torch.from_numpy(rng.standard_normal((2, 2, 2)).astype(np.float16))}
    path = str(tmp_path / "t.safetensors")
    save_file(tensors, path)
    got = read_safetensors(path)
    assert set(got) == set(tensors)
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v)


def _reference_dit_pth(tmp_path, prefix: str):
    """A reference-style model_{E}.pth: the reference DiT's state_dict
    (pos_embed first) under the DDP prefix, of seeded non-zero weights."""
    jm = jdit.create_dit("DiT-T/2", img_resolution=16, num_classes=1)
    params = randomize(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1,)),
                                        jnp.zeros((1, 16, 16, 4))), 14)
    tm = tdit.create_dit("DiT-T/2", img_resolution=16, num_classes=1, device="cpu")
    sd = {"pos_embed": tm.pos_embed.clone(), **dit_params_from_jax(params)}
    path = str(tmp_path / "model_475.pth")
    torch.save({prefix + k: v for k, v in sd.items()}, path)
    return path


@pytest.mark.parametrize("prefix", ["module.", ""])
def test_reference_model_pth_loads(tmp_path, prefix):
    path = _reference_dit_pth(tmp_path, prefix)
    tm = tdit.create_dit("DiT-T/2", img_resolution=16, num_classes=1, device="cpu")
    tm.load_state_dict(reference_state_dict(path))  # strict
    raw = torch.load(path, weights_only=True)
    jparams = convert_dit_state_dict({k: v.numpy() for k, v in raw.items()}, depth=2)
    jm = jdit.create_dit("DiT-T/2", img_resolution=16, num_classes=1)
    rng = np.random.default_rng(15)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.array([0.3, 0.8], np.float32)
    want = jax.jit(jm.apply)(jparams, t, x)
    with torch.no_grad():
        got = tm(torch.from_numpy(t), torch.from_numpy(x))
    assert rel_err(got, want) < 1e-5


def test_train_model_ckpt_starts_from_a_reference_model_pth(tmp_path):
    """``--model_ckpt`` with a model_{E}.pth: the loop starts from its
    weights (lr 0 keeps them through one step)."""
    path = _reference_dit_pth(tmp_path, "module.")
    cfg = Config(exp="from_pth", dataset="synthetic_latent", output_dir=str(tmp_path),
                 model=ModelConfig(model_type="DiT-T/2", image_size=128, num_classes=1),
                 train=TrainConfig(batch_size=4, lr=0.0, no_lr_decay=True, model_ckpt=path))
    logs = []
    state = train(cfg, dataset=SyntheticLatentDataset(n=8, latent_size=16), device="cpu",
                  max_steps=1, log_fn=logs.append)
    assert any(line.startswith("=> initialised from") for line in logs)
    want = reference_state_dict(path)
    for name, p in zip(state.names, state.params):
        assert torch.equal(p.detach(), want[name]), name
    assert os.path.isfile(os.path.join(cfg.exp_path, "config.json"))
