"""Sharded FID generation over two gloo ranks on the CPU (sample/sharded.py):
celeb256_dit's network at test scale (DiT-T/2 on 16x16 latents of 32 px
images, f32), a small VAE (block_out (32, 32)) and seeded Inception weights,
5 samples at batch 4 (2 rows a rank, the last batch padded).

Held against lfm_tpu.sample.sharded.generate_fid_activations on one JAX
device, which JAX pins as mesh-invariant
(tests/test_sharded_fid.py::test_sharded_generation_mesh_invariant), and
against the port in one process. JAX's threefry bits cannot be matched,
so JAX's SampleRNG is handed the port's per-index noise as a table.

Tolerances: the pool3 activations 1e-4 of the largest against JAX (f32
convolutions summed in another order over the ODE, the VAE and 95
Inception layers; tests/test_torch_cli_eval.py's bound) and 1e-5 against
the port in one process (the same operations on 2 rows instead of 4);
the ranks' sets equal bit for bit. dopri5 (atol = rtol = 1e-3, step
control shared over the ranks): the same NFE, and the latents within 1e-5
of one process's and 1e-4 of JAX's.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
# lfm_tpu's attention imports pallas, which sets CUDA_ROOT; import it with
# the module, before the state guard looks
import jax.experimental.pallas  # noqa: E402,F401
import torch  # noqa: E402

from tests import torch_dist_worker as w  # noqa: E402
from tests.torch_parity import leaves_process_as_found, randomize, rel_err  # noqa: E402,F401

from lfm_tpu.core import config as jconfig  # noqa: E402
from lfm_tpu.core import rng as jrng  # noqa: E402
from lfm_tpu.core.sharding import make_mesh as jmake_mesh  # noqa: E402
from lfm_tpu.eval.inception import convert_inception_state_dict  # noqa: E402
from lfm_tpu.nn.factory import create_network as jcreate_network  # noqa: E402
from lfm_tpu.sample import sharded as jsharded  # noqa: E402
from lfm_tpu.vae.autoencoder_kl import AutoencoderKL as JVAE  # noqa: E402
from lfm_tpu_torch.core.rng import SampleRNG  # noqa: E402
from lfm_tpu_torch.eval.inception import seeded_inception_state_dict  # noqa: E402
from lfm_tpu_torch.nn.convert_dit import dit_params_from_jax  # noqa: E402
from lfm_tpu_torch.sample import sharded  # noqa: E402
from lfm_tpu_torch.vae.convert import vae_params_from_jax  # noqa: E402

N_SAMPLE = 5


def _jax_config(method, batch_size=4):
    c = w.fid_config(method, batch_size)
    return jconfig.Config(
        model=jconfig.ModelConfig(model_type="DiT-T/2", image_size=32, f=2, num_classes=1),
        sample=jconfig.SampleConfig(method=method, num_steps=2, n_sample=N_SAMPLE,
                                    batch_size=batch_size, atol=c.sample.atol,
                                    rtol=c.sample.rtol, use_fused_dit=False))


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """JAX's weights, and the port's copies saved for the ranks."""
    jm = jcreate_network(_jax_config("euler").model)
    s = w.fid_config("euler").model.latent_size
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1,)),
                            jnp.zeros((1, s, s, 4)), None)
    params = randomize(shapes, 1)
    jv = JVAE(block_out=(32, 32))
    vparams = randomize(jax.eval_shape(jv.init, jax.random.PRNGKey(0),
                                       jnp.zeros((1, 8, 8, 3)), jax.random.PRNGKey(1)), 4)
    inception = seeded_inception_state_dict(3)
    path = tmp_path_factory.mktemp("fid_weights") / "weights.pt"
    torch.save({"dit": dit_params_from_jax(params), "vae": vae_params_from_jax(vparams),
                "inception": inception}, path)
    return {"path": str(path), "model": jm, "params": params, "vae": jv, "vparams": vparams,
            "inception": convert_inception_state_dict(inception)}


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    return w.launch("fid", 2, tmp_path_factory.mktemp("fid_ranks"), args=(jax_side["path"],))


def _port_noise_rng(config):
    """JAX's SampleRNG answering with the port's noise of each index."""
    s = config.model.latent_size
    table = jnp.asarray(SampleRNG(seed=config.sample.seed).randn(
        range(N_SAMPLE), (s, s, 4), device="cpu").numpy())

    class TableRNG(jrng.SampleRNG):
        def randn(self, indices, sample_shape, dtype=jnp.float32):
            return table[jnp.asarray(indices, jnp.int32)].astype(dtype)

    return TableRNG


def test_two_rank_activations_match_jax_on_one_device(ranks, jax_side, monkeypatch):
    cfg = _jax_config("euler")
    monkeypatch.setattr(jsharded, "SampleRNG", _port_noise_rng(w.fid_config("euler")))
    want = jsharded.generate_fid_activations(
        cfg, jax_side["model"], jax_side["params"], jax_side["vae"], jax_side["vparams"],
        jax_side["inception"], mesh=jmake_mesh(dp=1, devices=jax.devices()[:1]))
    for r in ranks:
        assert r["acts"].shape == (N_SAMPLE, 2048)
        assert rel_err(r["acts"], want) < 1e-4


def test_two_rank_activations_match_one_process(ranks, jax_side):
    """Every rank scores the identical set, one process's."""
    model, vae, inception = w.fid_models(jax_side["path"])
    want = sharded.generate_fid_activations(w.fid_config("euler"), model, None, vae, None,
                                            inception, device="cpu")
    assert np.array_equal(ranks[0]["acts"], ranks[1]["acts"])
    assert rel_err(ranks[0]["acts"], want) < 1e-5


def test_rank0_alone_writes_the_images(ranks):
    assert ranks[0]["saved"] == sorted(f"{i}.jpg" for i in range(N_SAMPLE))
    assert ranks[1]["saved"] is None


def test_batch_arithmetic_is_jax(ranks, jax_side):
    """batch_size 5 over 2 ranks: 2 rows a rank, a global batch of 4, 2
    steps, as JAX's arithmetic gives on 2 devices."""
    _, n_steps, gb = jsharded.make_sharded_generator(
        _jax_config("euler", batch_size=5), jax_side["model"], jax_side["params"],
        mesh=jmake_mesh(dp=2, devices=jax.devices()[:2]))
    for r in ranks:
        assert r["arith"] == (n_steps, gb) == (2, 4)


def test_dopri5_steps_alike_over_ranks(ranks, jax_side, monkeypatch):
    """The adaptive controller's norms are the global batch's, so the two
    ranks take one process's steps and JAX's."""
    config = w.fid_config("dopri5")
    model, _, _ = w.fid_models(jax_side["path"])
    step_fn, n_steps, _ = sharded.make_sharded_generator(config, model, None, device="cpu")
    want = [step_fn(s) for s in range(n_steps)]
    monkeypatch.setattr(jsharded, "SampleRNG", _port_noise_rng(config))
    jstep, jn, _ = jsharded.make_sharded_generator(
        _jax_config("dopri5"), jax_side["model"], jax_side["params"],
        mesh=jmake_mesh(dp=1, devices=jax.devices()[:1]))
    jwant = [jstep(s) for s in range(jn)]
    assert jn == n_steps == len(ranks[0]["dopri5"]) == 2
    for r in ranks:
        for (img, _, nfe, idx), (img1, _, nfe1, idx1), (jimg, _, jnfe, _) in zip(
                r["dopri5"], want, jwant):
            assert nfe == nfe1 == jnfe and nfe > 6
            assert np.array_equal(idx, idx1)
            assert rel_err(img, img1) < 1e-5
            assert rel_err(img, jimg) < 1e-4
