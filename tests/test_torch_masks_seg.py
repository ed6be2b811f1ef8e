"""The downstream tasks' host data through the port on the CPU, against
lfm_tpu: the LaMa mask generators, the inpainting train and evaluation
datasets, the segmentation readers (COCO-stuff, ADE20k, CelebAMask-HQ) with
``smallest_max_size`` and ``square_crop``, and
``rasterize_celebamask_parts``. Fixtures are PNG / JPEG files written in
``tmp_path``.

The port never imports cv2: it rasterises an irregular mask's strokes as
``cv2.line`` does, so the generators that draw them (LINE strokes) are held
bit for bit against the JAX package with cv2 present, which draws them
with ``cv2.line``; the others with cv2 hidden from it
(``monkeypatch.setitem(sys.modules, "cv2", None)``), as they never call
it. The JAX segmentation readers resize with
cv2: the label maps (nearest) are equal bit for bit, the images (bicubic,
rounded to uint8) within one level, 1 / 127.5 in [-1, 1].

Nothing here seeds a global generator or changes cv2's settings: every
draw comes from a seeded ``np.random.Generator``.
"""

import os
import sys
from unittest import mock

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402,F401

from tests.torch_parity import leaves_process_as_found  # noqa: E402,F401

from lfm_tpu import data as jdata  # noqa: E402
from lfm_tpu.core import config as jconfig  # noqa: E402
from lfm_tpu.data import masks as jmasks  # noqa: E402
from lfm_tpu.data import segmentation as jseg  # noqa: E402
from lfm_tpu.data.inpainting import InpaintingTrainDataset as JInpaint  # noqa: E402
from lfm_tpu.sample.downstream import InpaintingEvalDataset as JEval  # noqa: E402
from lfm_tpu_torch import data as tdata  # noqa: E402
from lfm_tpu_torch.core import config as tconfig  # noqa: E402
from lfm_tpu_torch.data import masks as tmasks  # noqa: E402
from lfm_tpu_torch.data import segmentation as tseg  # noqa: E402
from lfm_tpu_torch.data.inpainting import InpaintingTrainDataset as TInpaint  # noqa: E402
from lfm_tpu_torch.sample.downstream import InpaintingEvalDataset as TEval  # noqa: E402

Image = pytest.importorskip("PIL.Image")
LEVEL = 1.0 / 127.5  # one uint8 level in [-1, 1]


@pytest.fixture
def no_cv2(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)


@pytest.fixture(scope="module")
def cv2():
    """cv2 for the JAX package's readers, imported with the environment
    kept as it was: importing it sets Qt's variables and LD_LIBRARY_PATH,
    which nothing in this process reads afterwards."""
    with mock.patch.dict(os.environ):
        import cv2
    return cv2


GENERATORS = {
    "irregular_line": lambda m, s: m.RandomIrregularMaskGenerator(seed=s),
    "irregular_square": lambda m, s: m.RandomIrregularMaskGenerator(
        seed=s, draw_method=m.DrawMethod.SQUARE, max_width=30),
    "irregular_ramp": lambda m, s: m.RandomIrregularMaskGenerator(
        seed=s, ramp_kwargs=dict(start_iter=2, end_iter=8)),
    "rectangle": lambda m, s: m.RandomRectangleMaskGenerator(seed=s),
    "rectangle_ramp": lambda m, s: m.RandomRectangleMaskGenerator(
        seed=s, ramp_kwargs=dict(start_iter=0, end_iter=5)),
    "superres": lambda m, s: m.RandomSuperresMaskGenerator(seed=s),
    "mixed": lambda m, s: m.get_mask_generator(seed=s),
    "mixed_all": lambda m, s: m.MixedMaskGenerator(
        irregular_proba=1, box_proba=1, superres_proba=1, invert_proba=0.5, seed=s),
}


# the generators that draw LINE strokes, which the JAX package draws with
# cv2.line where cv2 is present
LINE_STROKES = ("irregular_line", "irregular_ramp", "mixed", "mixed_all")


@pytest.mark.parametrize("kind", sorted(GENERATORS))
def test_mask_generators_match_jax_bit_for_bit(kind, request):
    """Each generator against JAX's, 12 masks of two shapes from three
    seeds, with the curriculum's iter_i where it has one: with cv2 present
    where JAX draws LINE strokes with it, else with cv2 hidden."""
    request.getfixturevalue("cv2" if kind in LINE_STROKES else "no_cv2")
    for seed in (0, 1, 7):
        jg, tg = GENERATORS[kind](jmasks, seed), GENERATORS[kind](tmasks, seed)
        for i in range(4):
            shape = (256, 256) if i % 2 == 0 else (96, 128)
            want, got = jg(shape, iter_i=i), tg(shape, iter_i=i)
            assert got.dtype == np.float32 and np.array_equal(got, want), (seed, i)


def test_linear_ramp_matches_jax():
    for kw in (dict(), dict(start_value=0.2, end_value=1.5, start_iter=3, end_iter=10)):
        jr, tr = jmasks.LinearRamp(**kw), tmasks.LinearRamp(**kw)
        assert [tr(i) for i in range(-2, 14)] == [jr(i) for i in range(-2, 14)]
    with pytest.raises(NotImplementedError):
        tmasks.get_mask_generator("box")


def test_irregular_masks_against_cv2_line(cv2):
    """The port's strokes against JAX's drawn by cv2.line, over seeds 0-99
    at 256^2 and at 96 x 128: bit for bit; and the raster alone against
    cv2.line on segments that leave the image on every side, at every
    stroke width the masks draw (5-24) and wider."""
    for seed in range(100):
        for shape in ((256, 256), (96, 128)):
            want = jmasks.RandomIrregularMaskGenerator(seed=seed)(shape)
            got = tmasks.RandomIrregularMaskGenerator(seed=seed)(shape)
            assert np.array_equal(got, want), (seed, shape)
    rng = np.random.default_rng(0)
    for i in range(400):
        h, w = ((96, 128), (40, 50), (7, 300))[i % 3]
        p0 = (int(rng.integers(-40, w + 40)), int(rng.integers(-40, h + 40)))
        length, angle = int(rng.integers(0, 120)), rng.uniform(0, 2 * np.pi)
        p1 = (int(p0[0] + length * np.cos(angle)), int(p0[1] + length * np.sin(angle)))
        width = int(rng.integers(2, 40))
        want = np.zeros((h, w), np.float32)
        cv2.line(want, p0, p1, 1.0, width)
        got = np.zeros((h, w), np.float32)
        tmasks._line(got, p0, p1, width)
        assert np.array_equal(got, want), (p0, p1, width, (h, w))


def _write_images(folder, n, size, rng, ext=".png", fmt="{i:03d}"):
    os.makedirs(folder, exist_ok=True)
    for i in range(n):
        arr = rng.integers(0, 256, size + (3,), dtype=np.uint8)
        Image.fromarray(arr).save(os.path.join(folder, fmt.format(i=i) + ext))


def test_inpainting_train_dataset_matches_jax(tmp_path, cv2):
    """InpaintingTrainDataset and get_inpainting_dataset on a folder of PNGs
    of other sizes (resized and cropped by Pillow): the image, the flip, the
    mask and the masked image bit for bit."""
    rng = np.random.default_rng(0)
    _write_images(tmp_path / "a", 3, (80, 72), rng)
    _write_images(tmp_path / "a" / "sub", 2, (64, 64), rng, ext=".jpg")
    jds = JInpaint(str(tmp_path / "a"), jmasks.get_mask_generator(seed=3), image_size=64, seed=5)
    tds = TInpaint(str(tmp_path / "a"), tmasks.get_mask_generator(seed=3), image_size=64, seed=5)
    assert len(tds) == len(jds) == 5 and tds.files == jds.files
    for i in (0, 3, 4, 1, 0, 2):
        for got, want in zip(tds[i], jds[i]):
            assert got.dtype == want.dtype and np.array_equal(got, want)
    jcfg = jconfig.get_preset("celeb256_adm")
    jcfg = jcfg.replace(data=jconfig.DataConfig(datadir=str(tmp_path / "a")),
                        model=jconfig.ModelConfig(image_size=64))
    tcfg = tconfig.get_preset("celeb256_adm")
    tcfg = tcfg.replace(data=tconfig.DataConfig(datadir=str(tmp_path / "a")),
                        model=tconfig.ModelConfig(image_size=64))
    jds, tds = jdata.get_inpainting_dataset(jcfg, seed=2), tdata.get_inpainting_dataset(tcfg, 2)
    for i in range(5):
        for got, want in zip(tds[i], jds[i]):
            assert got.shape[:2] == (64, 64) and np.array_equal(got, want)


def test_inpainting_eval_dataset_matches_jax(tmp_path):
    """{i:06d}.jpg images with {i:06d}.png masks (255 = keep; one RGB mask),
    as the reference's evaluation set: (img, mask, masked) bit for bit."""
    rng = np.random.default_rng(1)
    _write_images(tmp_path / "img", 3, (32, 32), rng, ext=".jpg", fmt="{i:06d}")
    os.makedirs(tmp_path / "mask")
    for i in range(3):
        m = np.where(rng.uniform(size=(32, 32)) < 0.3, 0, 255).astype(np.uint8)
        Image.fromarray(np.stack([m] * 3, -1) if i == 1 else m).save(
            tmp_path / "mask" / f"{i:06d}.png")
    jds, tds = JEval(str(tmp_path / "img"), str(tmp_path / "mask")), TEval(
        str(tmp_path / "img"), str(tmp_path / "mask"))
    assert len(tds) == len(jds) == 3 and len(TEval(str(tmp_path / "img"), "", n=2)) == 2
    for i in range(3):
        for got, want in zip(tds[i], jds[i]):
            assert got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("shape", [(300, 400, 3), (300, 400), (97, 131, 3), (64, 80)])
def test_smallest_max_size_against_cv2(shape, cv2):
    """Nearest (label maps) equals cv2's INTER_NEAREST bit for bit; bicubic
    (images) is within one level of cv2's INTER_CUBIC."""
    rng = np.random.default_rng(sum(shape))
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    for size in (64, 256, 512):
        want, got = jseg.smallest_max_size(img, size, True), tseg.smallest_max_size(img, size, True)
        assert got.dtype == np.uint8 and np.array_equal(got, want)
        want, got = jseg.smallest_max_size(img, size), tseg.smallest_max_size(img, size)
        assert got.shape == want.shape and min(got.shape[:2]) == size
        assert np.abs(got.astype(int) - want).max() <= 1


def _assert_items_match(tds, jds, items):
    for i in items:
        (gi, gs), (wi, ws) = tds[i], jds[i]
        assert gi.dtype == wi.dtype == np.float32 and gs.dtype == ws.dtype == np.int32
        assert gi.shape == wi.shape and np.array_equal(gs, ws), i
        assert np.abs(gi - wi).max() <= LEVEL + 1e-6, i


def _write_seg_tree(root, image_dir, seg_dir, rng, labels):
    rels = ["a/x1.jpg", "b/x2.jpg", "x3.jpg"]
    for j, rel in enumerate(rels):
        size = ((70, 90), (90, 64), (64, 64))[j]
        for folder, ext, arr in (
                (image_dir, ".jpg", rng.integers(0, 256, size + (3,), dtype=np.uint8)),
                (seg_dir, ".png", rng.integers(0, labels, size, dtype=np.uint8))):
            path = os.path.join(root, folder, rel.replace(".jpg", ext))
            os.makedirs(os.path.dirname(path), exist_ok=True)
            Image.fromarray(arr).save(path)
    for split in ("train", "val"):
        with open(os.path.join(root, f"{split}.txt"), "w") as f:
            f.write("\n".join(rels))


@pytest.mark.parametrize("name", ["coco", "ade20k", "celebamask"])
def test_segmentation_readers_match_jax(name, tmp_path, cv2):
    """Each reader through get_segmentation_dataset on handmade fixtures, in
    both splits (train crops at random from the same seed): the label map
    bit for bit, the image within one level; COCO's labels shifted by one
    with 255 wrapping to 0."""
    rng = np.random.default_rng(4)
    root = str(tmp_path)
    if name == "celebamask":
        for folder, ext in (("CelebA-HQ-img", ".jpg"), ("mask", ".png")):
            os.makedirs(os.path.join(root, folder))
        for idx in (0, 1, 27000):
            Image.fromarray(rng.integers(0, 256, (80, 80, 3), dtype=np.uint8)).save(
                os.path.join(root, "CelebA-HQ-img", f"{idx}.jpg"))
            Image.fromarray(rng.integers(0, 19, (80, 80), dtype=np.uint8)).save(
                os.path.join(root, "mask", f"{idx}.png"))
        items = {"train": (0, 1, 27001), "val": (0, 3000)}
    else:
        image_dir, seg_dir = "images", "segmentations" if name == "coco" else "annotations"
        labels = 256 if name == "coco" else 151
        _write_seg_tree(root, image_dir, seg_dir, rng, labels)
        items = {"train": (0, 1, 2, 1), "val": (2, 0)}
    for split, idx in items.items():
        jds = jseg.get_segmentation_dataset(name, root, size=48, split=split, seed=3)
        tds = tseg.get_segmentation_dataset(name, root, size=48, split=split, seed=3)
        assert len(tds) == len(jds) and tds.num_classes == jds.num_classes
        _assert_items_match(tds, jds, idx)
    with pytest.raises(KeyError):
        tseg.get_segmentation_dataset("cityscapes", root)


def test_rasterize_celebamask_parts_matches_jax(tmp_path):
    """Per-part binary masks -> one label map per image, the same PNGs."""
    rng = np.random.default_rng(6)
    anno = tmp_path / "anno" / "0"
    os.makedirs(anno)
    for idx in range(2):
        for part in tseg.CelebAMask.CLASSES[1:][::3]:
            m = np.where(rng.uniform(size=(32, 32)) < 0.2, 255, 0).astype(np.uint8)
            Image.fromarray(m).save(anno / f"{idx:05d}_{part}.png")
    for mod, out in ((jseg, "jax"), (tseg, "port")):
        mod.rasterize_celebamask_parts(str(tmp_path / "anno"), str(tmp_path / out),
                                       image_size=32, num_images=2)
    for idx in range(2):
        got = np.asarray(Image.open(tmp_path / "port" / f"{idx}.png"))
        want = np.asarray(Image.open(tmp_path / "jax" / f"{idx}.png"))
        assert np.array_equal(got, want) and got.max() > 0
