"""The layout data of lfm_tpu_torch against lfm_tpu's, bit for bit on the
CPU: the conditional builders (centre points, bounding boxes; crops, flips,
group and additional flags, more objects than allowed) and their inverses,
the bbox helpers, COUNTLESS on numpy arrays and torch tensors (which the
JAX package takes as jnp arrays), and ``AnnotatedObjectsCoco`` over a
COCO-style JSON and PNG files written in ``tmp_path``. Every draw comes
from a seeded ``random.Random`` or ``np.random.Generator``.
"""

import json
import random
import warnings

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tests.torch_parity import leaves_process_as_found  # noqa: E402,F401

from lfm_tpu.data import countless as jcl  # noqa: E402
from lfm_tpu.data import layout as jlayout  # noqa: E402
from lfm_tpu.data.annotated_objects import AnnotatedObjectsCoco as JCoco  # noqa: E402
from lfm_tpu_torch.data import countless as tcl  # noqa: E402
from lfm_tpu_torch.data import layout as tlayout  # noqa: E402
from lfm_tpu_torch.data.annotated_objects import AnnotatedObjectsCoco as TCoco  # noqa: E402


def _annotations(mod, rng, n):
    out = []
    for i in range(n):
        x0, y0 = rng.uniform(-0.1, 0.9, 2)
        w, h = rng.uniform(0.02, 0.5, 2)
        out.append(mod.Annotation(bbox=(float(x0), float(y0), float(w), float(h)),
                                  category_no=int(rng.integers(12)), area=float(w * h),
                                  is_group_of=bool(rng.integers(2)),
                                  is_occluded=bool(rng.integers(2)),
                                  is_depiction=bool(rng.integers(2)),
                                  is_inside=bool(rng.integers(2))))
    return out


@pytest.mark.parametrize("kind", ["ObjectsCenterPointsConditionalBuilder",
                                  "ObjectsBoundingBoxConditionalBuilder"])
def test_conditional_builders_match_jax(kind):
    rng = np.random.default_rng(0)
    for trial in range(40):
        encode_crop, group, extra = trial % 2 == 0, trial % 3 == 0, trial % 5 == 0
        args = (12, 6, 1024, encode_crop, group, extra)
        jb, tb = getattr(jlayout, kind)(*args), getattr(tlayout, kind)(*args)
        n = int(rng.integers(1, 9))  # past no_max_objects sometimes
        seed = int(rng.integers(1 << 30))
        crop = None if trial % 4 == 0 else tuple(float(v) for v in (*rng.uniform(0, 0.3, 2),
                                                                    *rng.uniform(0.5, 0.7, 2)))
        flip = bool(trial % 3)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # more annotations than allowed
            want = jb.build(_annotations(jlayout, np.random.default_rng(seed), n), crop, flip,
                            rng=random.Random(seed))
            got = tb.build(_annotations(tlayout, np.random.default_rng(seed), n), crop, flip,
                           rng=random.Random(seed))
        assert got.dtype == want.dtype and np.array_equal(got, want), trial
        assert tb.inverse_build(got) == jb.inverse_build(want)
        for r in range(0, 12 * 16, 7):
            assert vars(tb.representation_to_annotation(r)) == vars(
                jb.representation_to_annotation(r))


def test_bbox_helpers_match_jax():
    rng = np.random.default_rng(1)
    anns_j = _annotations(jlayout, np.random.default_rng(2), 10)
    anns_t = _annotations(tlayout, np.random.default_rng(2), 10)
    for _ in range(20):
        crop = tuple(float(v) for v in (*rng.uniform(0, 0.4, 2), *rng.uniform(0.3, 0.6, 2)))
        assert ([vars(a) for a in tlayout.filter_annotations(anns_t, crop)]
                == [vars(a) for a in jlayout.filter_annotations(anns_j, crop)])
        for flip in (False, True):
            assert ([vars(a) for a in tlayout.rescale_annotations(anns_t, crop, flip)]
                    == [vars(a) for a in jlayout.rescale_annotations(anns_j, crop, flip)])
        assert tlayout.intersection_area(crop, anns_t[0].bbox) == jlayout.intersection_area(
            crop, anns_j[0].bbox)
        assert tlayout.horizontally_flip_bbox(crop) == jlayout.horizontally_flip_bbox(crop)
        assert tlayout.absolute_bbox(crop, 640, 480) == jlayout.absolute_bbox(crop, 640, 480)


@pytest.mark.parametrize("dtype", [np.uint8, np.int8, np.int32, np.int64])
def test_countless_matches_jax_on_numpy_and_torch(dtype):
    """countless2d / 3d and downsample_segmentation: numpy in the port
    against numpy in JAX's, torch tensors against the same (and against
    jnp arrays where JAX holds the dtype: int64 needs its x64 mode), with
    ties, zeros and a uint8 map's largest label."""
    rng = np.random.default_rng(3)
    top = min(np.iinfo(dtype).max, 255)
    seg2 = rng.integers(0, 4, (3, 16, 16)).astype(dtype)
    seg2[0, :2, :2] = [[0, top], [top, 0]]  # a tie between 0 and the largest label
    seg3 = rng.integers(0, 3, (2, 8, 8, 8)).astype(dtype)
    for fn, seg in ((lambda m, a: m.countless2d(a), seg2),
                    (lambda m, a: m.countless3d(a), seg3),
                    (lambda m, a: m.downsample_segmentation(a, 4), seg2)):
        want = fn(jcl, seg)
        got = fn(tcl, seg)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        got_t = fn(tcl, torch.from_numpy(seg))
        assert got_t.dtype == torch.from_numpy(seg).dtype and np.array_equal(got_t.numpy(), want)
        if dtype != np.int64:
            assert np.array_equal(np.asarray(fn(jcl, jnp.asarray(seg))), want)
    with pytest.raises(ValueError):
        tcl.countless2d(np.zeros((3, 5), dtype))
    with pytest.raises(TypeError):
        tcl.countless2d(torch.zeros(4, 4))


def test_annotated_objects_coco_matches_jax(tmp_path):
    """A COCO instances JSON (an allow list, a crowd object, a tiny one
    dropped, an image without objects) over PNGs of other sizes: the
    categories, the images kept, and every item (image, both token
    sequences, crop, flip) equal to JAX's over two passes, center and
    random crops."""
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(4)
    sizes = [(80, 64), (64, 96), (72, 72), (90, 70)]
    images = []
    for i, (w, h) in enumerate(sizes):
        name = f"{i:012d}." + ("png" if i else "jpg")  # image 0 by its default name
        Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(tmp_path / name)
        images.append({"id": i, "width": w, "height": h, **({"file_name": name} if i else {})})
    cats = [{"id": 3 * k + 1, "name": f"c{k}"} for k in range(6)]
    anns = []
    for j in range(14):
        im = images[j % 3]
        bw, bh = rng.uniform(2, im["width"] / 2), rng.uniform(2, im["height"] / 2)
        anns.append({"id": j, "image_id": im["id"], "category_id": cats[j % 6]["id"],
                     "bbox": [float(rng.uniform(0, im["width"] - bw)),
                              float(rng.uniform(0, im["height"] - bh)), float(bw), float(bh)],
                     "iscrowd": int(j == 4)})
    anns.append({"id": 99, "image_id": 0, "category_id": 1, "bbox": [1, 1, 0.01, 0.01]})
    path = tmp_path / "instances.json"
    path.write_text(json.dumps({"images": images, "categories": cats, "annotations": anns}))
    for kw in (dict(crop_method="center", category_allow_list=["c0", "c1", "c3", "c4", "c5"]),
               dict(crop_method="random-1d", encode_crop=True, seed=7)):
        jds = JCoco(str(tmp_path), str(path), target_image_size=48, max_objects_per_image=5,
                    no_tokens=256, **kw)
        tds = TCoco(str(tmp_path), str(path), target_image_size=48, max_objects_per_image=5,
                    no_tokens=256, **kw)
        assert len(tds) == len(jds) > 0 and tds.categories == jds.categories
        assert [d["id"] for d in tds.image_descriptions] == [d["id"] for d in
                                                            jds.image_descriptions]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for i in [*range(len(jds)), *range(len(jds))]:
                want, got = jds[i], tds[i]
                assert set(got) == set(want)
                for key in want:
                    assert np.array_equal(np.asarray(got[key]), np.asarray(want[key])), key
