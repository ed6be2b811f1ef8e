"""Port parity of the FID stage (eval/inception.py, eval/fid.py) against
lfm_tpu, on the CPU.

The weights are a synthetic state dict in pytorch-fid's names
(``seeded_inception_state_dict``: seeded values drawn as
tests/test_inception_parity.py draws them, under the port module's own
names and shapes). It loads into the port directly, and into JAX through
``convert_inception_state_dict``, so a name the port got wrong fails the
JAX side. Tolerances: pool3 and the fc logits within 1e-4 (relative and
absolute, as tests/test_inception_parity.py: f32 convolutions summed in
another order over 95 layers); the Fréchet distance within 1e-9 relative
(the same scipy arithmetic on the same statistics).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tests.torch_parity import leaves_process_as_found  # noqa: E402,F401

from lfm_tpu.eval import fid as jfid  # noqa: E402
from lfm_tpu.eval.inception import FIDInceptionV3 as JInception  # noqa: E402
from lfm_tpu.eval.inception import convert_inception_state_dict  # noqa: E402
from lfm_tpu_torch.eval import fid as tfid  # noqa: E402
from lfm_tpu_torch.eval.inception import (FIDInceptionV3, load_inception_params,  # noqa: E402
                                          seeded_inception_state_dict)

TOL = 1e-4


@pytest.fixture(scope="module")
def weights():
    return seeded_inception_state_dict(1)


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(2).uniform(0, 1, (2, 128, 128, 3)).astype(np.float32)


@pytest.mark.parametrize("include_head", [False, True])
def test_inception_matches_jax(weights, images, include_head, tmp_path):
    """pool3 (N, 2048) and the 1008 fc logits through the 128 -> 299 resize,
    against JAX's FIDInceptionV3 on the same weights; the checkpoint loads
    through load_inception_params."""
    path = tmp_path / "pt_inception.pth"
    torch.save(weights, path)
    model = FIDInceptionV3(include_head=include_head)
    model.load_state_dict(load_inception_params(str(path)))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(images)).numpy()
    params = convert_inception_state_dict(weights)
    want = np.asarray(jax.jit(JInception(include_head=include_head).apply)(
        params, jnp.asarray(images)))
    assert got.shape == (2, 1008 if include_head else 2048)
    assert np.abs(want).mean() > 1e-3  # the comparison is not vacuous
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_frechet_distance_matches_jax():
    """The same statistics give the same distance; rank-deficient
    covariances (fewer samples than features) take the eps fallback alike."""
    rng = np.random.default_rng(3)
    for n, d in ((400, 64), (32, 64)):
        a = rng.standard_normal((n, d))
        b = 0.9 * a + 0.3 * rng.standard_normal((n, d)) + 0.1
        sa, sb = tfid.activation_statistics(a), tfid.activation_statistics(b)
        want = jfid.calculate_frechet_distance(*jfid.activation_statistics(a),
                                               *jfid.activation_statistics(b))
        got = tfid.calculate_frechet_distance(*sa, *sb)
        assert np.isfinite(got) and got > 0
        assert abs(got - want) <= 1e-9 * abs(want)


def test_statistics_files_cross_read(tmp_path):
    """The port writes what JAX reads and reads what JAX writes, in the
    .npy dict format and the .npz format; fid_from_activations reads a
    stats file."""
    rng = np.random.default_rng(4)
    mu, sigma = rng.standard_normal(8), np.cov(rng.standard_normal((20, 8)), rowvar=False)
    tfid.save_statistics(str(tmp_path / "t.npy"), mu, sigma)
    jfid.save_statistics(str(tmp_path / "j.npy"), mu, sigma)
    np.savez(tmp_path / "r.npz", mu=mu, sigma=sigma)
    for got in (jfid.load_statistics(str(tmp_path / "t.npy")),
                tfid.load_statistics(str(tmp_path / "j.npy")),
                tfid.load_statistics(str(tmp_path / "r.npz"))):
        np.testing.assert_array_equal(got[0], mu)
        np.testing.assert_array_equal(got[1], sigma)
    acts = rng.standard_normal((30, 8))
    assert tfid.fid_from_activations(acts, str(tmp_path / "t.npy")) == pytest.approx(
        jfid.fid_from_activations(acts, str(tmp_path / "j.npy")), rel=1e-12)


def test_fid_given_paths_on_the_cpu(weights, tmp_path):
    """An image folder through ActivationExtractor (device="cpu") gives the
    statistics of its images' activations; calculate_fid_given_paths takes
    stats files and refuses a path that is not there."""
    from PIL import Image

    rng = np.random.default_rng(5)
    folder = tmp_path / "imgs"
    folder.mkdir()
    pixels = rng.integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    for i, img in enumerate(pixels):
        Image.fromarray(img).save(folder / f"{i}.png")
    extractor = tfid.ActivationExtractor(weights, device="cpu")
    mu, sigma = tfid.statistics_of_path(str(folder), extractor, batch_size=2)
    want_mu, want_sigma = tfid.activation_statistics(extractor(pixels / np.float32(255.0)))
    assert mu.shape == (2048,) and sigma.shape == (2048, 2048)
    np.testing.assert_allclose(mu, want_mu, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sigma, want_sigma, rtol=1e-4, atol=1e-6)

    stats = []
    for name, shift in (("a.npy", 0.0), ("b.npy", 0.5)):
        acts = rng.standard_normal((40, 8)) + shift
        tfid.save_statistics(str(tmp_path / name), *tfid.activation_statistics(acts))
        stats.append(tfid.load_statistics(str(tmp_path / name)))
    fid = tfid.calculate_fid_given_paths([str(tmp_path / "a.npy"), str(tmp_path / "b.npy")],
                                         weights, device="cpu")
    assert fid == tfid.calculate_frechet_distance(*stats[0], *stats[1]) > 0
    with pytest.raises(RuntimeError, match="Invalid path"):
        tfid.calculate_fid_given_paths([str(folder), str(tmp_path / "none.npy")], weights,
                                       device="cpu")
