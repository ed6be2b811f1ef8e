"""The downstream evaluation through the port on the CPU, against lfm_tpu:
P-IDS / U-IDS with the port's own linear SVM in place of scikit-learn's
``LinearSVC(dual=False)``, FID of the same activations, the folder metrics,
SSIM, LPIPS and its converter, the online evaluator and the Inception
Score. The Inception weights are seeded (``seeded_inception_state_dict``),
the LPIPS weights too, in torchvision's and lpips' names.

Tolerances: the SVM's decision values within 1e-6 of the largest, against
scikit-learn solving the same problem to a gradient of 1e-8 (at its
default 1e-4, liblinear stops up to a third of the largest decision value
short of the optimum on activations that a hyperplane separates), and
P-IDS and U-IDS equal to the JAX package's (scikit-learn's defaults);
the folder metrics and the evaluator's FID / P-IDS / U-IDS equal, with
both packages' activation extractors replaced by one seeded projection of
the pixels (the Inception is held against JAX's in tests/test_torch_fid.py,
and here in the Inception Score, 1e-4 relative); SSIM 1e-5 and LPIPS 1e-4
relative (f32 convolutions).

scikit-learn is imported once, with the environment kept as it was (its
import sets KMP_* variables); nothing here changes its or cv2's thread
settings or seeds a global generator.
"""

import os
from unittest import mock

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tests.torch_parity import leaves_process_as_found, rel_err  # noqa: E402,F401

from lfm_tpu.eval import evaluator as jevaluator  # noqa: E402
from lfm_tpu.eval import inception_score as jis  # noqa: E402
from lfm_tpu.eval import inpainting_metrics as jmetrics  # noqa: E402
from lfm_tpu.eval import perceptual as jperc  # noqa: E402
from lfm_tpu.eval.inception import convert_inception_state_dict  # noqa: E402
from lfm_tpu_torch.eval import evaluator as tevaluator  # noqa: E402
from lfm_tpu_torch.eval import inception_score as tis  # noqa: E402
from lfm_tpu_torch.eval import inpainting_metrics as tmetrics  # noqa: E402
from lfm_tpu_torch.eval import perceptual as tperc  # noqa: E402
from lfm_tpu_torch.eval.inception import seeded_inception_state_dict  # noqa: E402

Image = pytest.importorskip("PIL.Image")


@pytest.fixture(scope="module", autouse=True)
def sk_svm():
    """scikit-learn, imported before any test here reaches the JAX
    package's pids_uids (which imports it)."""
    with mock.patch.dict(os.environ):
        from sklearn import svm
    return svm


@pytest.fixture(scope="module")
def inception():
    sd = seeded_inception_state_dict(2)
    return sd, convert_inception_state_dict(sd)


def _activations(n, d, shift, seed):
    rng = np.random.default_rng(seed)
    real = rng.standard_normal((n, d)).astype(np.float32)
    fake = (rng.standard_normal((n, d)) + shift).astype(np.float32)
    return fake, real


CASES = [(120, 64, 0.2, 0), (60, 32, 0.15, 1), (50, 2048, 0.05, 2), (25, 2048, 0.0, 3)]


@pytest.mark.parametrize("n,d,shift,seed", CASES)
def test_pids_uids_match_jax(n, d, shift, seed, sk_svm):
    """The port's SVM is liblinear's optimum: its decision values against
    scikit-learn's at a tight tolerance; P-IDS and U-IDS equal JAX's."""
    fake, real = _activations(n, d, shift, seed)
    x = np.concatenate([real, fake])
    y = np.array([1] * n + [0] * n)
    w, b = tmetrics.fit_linear_svc(x, y)
    clf = sk_svm.LinearSVC(dual=False, tol=1e-8, max_iter=100_000).fit(x, y)
    want = clf.decision_function(x)
    assert np.abs(x @ w + b - want).max() <= 1e-6 * np.abs(want).max()
    got = tmetrics.pids_uids(fake, real)
    assert got == jmetrics.pids_uids(fake, real)
    if d == 64:  # the classes overlap: neither score is trivial
        assert 0 < got[0] < 0.5 and 0 < got[1] < 0.5


def test_metrics_from_activations_match_jax():
    fake, real = _activations(80, 48, 0.2, 4)
    got, want = tmetrics.metrics_from_activations(fake, real), jmetrics.metrics_from_activations(
        fake, real)
    assert abs(got[0] - want[0]) <= 1e-9 * abs(want[0]) and got[1:] == want[1:]


def _images(n, seed, size=32):
    return np.random.default_rng(seed).uniform(0, 1, (n, size, size, 3)).astype(np.float32)


class _Projection:
    """A stand-in for both packages' ActivationExtractor: a fixed seeded
    projection of the pixels to 64 features (the Inception itself is held
    against JAX's in tests/test_torch_fid.py)."""

    def __init__(self, *args, **kwargs):
        self.w = np.random.default_rng(20).standard_normal((32 * 32 * 3, 64)).astype(np.float32)

    def __call__(self, images):
        return np.asarray(images, np.float32).reshape(len(images), -1) @ self.w


def test_calculate_metrics_matches_jax(tmp_path, monkeypatch):
    """calculate_metrics over two folders of PNG / JPEG files (FID, P-IDS,
    U-IDS), both packages' extractors the same projection; a folder of
    another length raises."""
    monkeypatch.setattr(jmetrics, "ActivationExtractor", _Projection)
    monkeypatch.setattr(tmetrics, "ActivationExtractor", _Projection)
    for name, seed in (("fake", 5), ("real", 6)):
        os.makedirs(tmp_path / name)
        for i, img in enumerate(_images(6, seed)):
            Image.fromarray((img * 255).astype(np.uint8)).save(
                tmp_path / name / f"{i}.{'png' if i % 2 else 'jpg'}")
    want = jmetrics.calculate_metrics(str(tmp_path / "fake"), str(tmp_path / "real"), None,
                                      batch_size=4)
    got = tmetrics.calculate_metrics(str(tmp_path / "fake"), str(tmp_path / "real"), None,
                                     batch_size=4, device="cpu")
    assert got == want and np.isfinite(got[0])
    with pytest.raises(ValueError):
        tmetrics.calculate_metrics(str(tmp_path / "fake"), str(tmp_path / "real"), None,
                                   limit=5, device="cpu")


def _lpips_weights(seed=0):
    """torchvision vgg16 ``features.*`` and lpips ``lin{i}.model.1.weight``,
    seeded (weights N(0, 2 / fan_in), so the features stay of order one)."""
    rng = np.random.default_rng(seed)
    vgg, ti, ch = {}, 0, 3
    for v in jperc._VGG16_CFG:
        if v == "M":
            ti += 1
            continue
        vgg[f"features.{ti}.weight"] = (rng.standard_normal((v, ch, 3, 3))
                                        * np.sqrt(2.0 / (9 * ch))).astype(np.float32)
        vgg[f"features.{ti}.bias"] = (0.1 * rng.standard_normal(v)).astype(np.float32)
        ti, ch = ti + 2, v
    lin = {f"lin{i}.model.1.weight": rng.uniform(0, 0.2, (1, c, 1, 1)).astype(np.float32)
           for i, c in enumerate((64, 128, 256, 512, 512))}
    return vgg, lin


def test_ssim_and_lpips_match_jax():
    """SSIM (Gaussian window) and LPIPS on the same seeded weights, through
    both converters from one torchvision / lpips state dict."""
    a, b = _images(3, 7), _images(3, 8)
    b[0] = a[0]
    want = np.asarray(jax.jit(jperc.ssim)(jnp.asarray(a), jnp.asarray(b)))
    got = tperc.ssim(torch.from_numpy(a), torch.from_numpy(b))
    assert rel_err(got, want) < 1e-5 and abs(float(got[0]) - 1.0) < 1e-5
    vgg, lin = _lpips_weights()
    jp = jperc.convert_lpips_state_dict(vgg, lin)
    net = tperc.LPIPS()
    net.load_state_dict(tperc.convert_lpips_state_dict(vgg, lin))
    x, y = a * 2 - 1, b * 2 - 1
    want = np.asarray(jax.jit(jperc.LPIPS().apply)(jp, jnp.asarray(x), jnp.asarray(y)))
    with torch.no_grad():
        got = net(torch.from_numpy(x), torch.from_numpy(y))
    assert rel_err(got, want) < 1e-4 and float(got[0]) == 0.0 and float(got[1]) > 0


def test_evaluator_matches_jax(monkeypatch):
    """InpaintingEvaluator over two batches: SSIM, LPIPS, FID, P-IDS, U-IDS
    (both extractors the same projection) and SSIM by hole area."""
    from lfm_tpu.eval import fid as jfid
    from lfm_tpu_torch.eval import fid as tfid

    monkeypatch.setattr(jfid, "ActivationExtractor", _Projection)
    monkeypatch.setattr(tfid, "ActivationExtractor", _Projection)
    sd = jparams = "unused: the projection stands in"
    vgg, lin = _lpips_weights(1)
    jev = jevaluator.InpaintingEvaluator(jparams, jperc.convert_lpips_state_dict(vgg, lin))
    tev = tevaluator.InpaintingEvaluator(sd, tperc.convert_lpips_state_dict(vgg, lin),
                                         device="cpu")
    rng = np.random.default_rng(9)
    for seed in (10, 11):
        real, fake = _images(3, seed), _images(3, seed + 20)
        mask = (rng.uniform(size=(3, 32, 32, 1)) < rng.uniform(0, 0.6, (3, 1, 1, 1))).astype(
            np.float32)
        for ev in (jev, tev):
            ev.process_batch(real, fake, mask)
    want, got = jev.evaluation_end(), tev.evaluation_end()
    assert set(got) == set(want) and got["ssim_by_area"].keys() == want["ssim_by_area"].keys()
    for key in ("ssim", "lpips"):
        assert abs(got[key] - want[key]) <= 1e-4 * abs(want[key]), key
    assert (got["fid"], got["pids"], got["uids"]) == (want["fid"], want["pids"], want["uids"])
    for k, v in want["ssim_by_area"].items():
        assert abs(got["ssim_by_area"][k] - v) <= 1e-5


def test_inception_score_matches_jax(inception):
    sd, jparams = inception
    batches = [_images(3, 12), _images(3, 13)]
    want = jis.get_inception_score(batches, jparams, splits=2)
    got = tis.get_inception_score(batches, sd, splits=2, device="cpu")
    assert np.allclose(got, want, rtol=1e-4, atol=1e-6) and got[0] > 1.0
    probs = np.random.default_rng(14).dirichlet(np.ones(10), 20)
    assert tis.inception_score_from_probs(probs, 4) == jis.inception_score_from_probs(probs, 4)
