"""The port's host data readers against lfm_tpu's on fixtures built in the
test: an image folder (flat and with class folders, each transform),
NVAE raw and encoded LMDBs written by both packages' ``write_db``, an
LSUN-style and an ``ImageLMDB`` database, CIFAR-10 pickle batches, the
hand-assembled database of tools/make_lmdb_fixture.py, every dataset name
through ``get_dataset`` (the folder fallback too), the Pillow-free read of
a raw record at the image size, ``tools/prepare_latent_dataset.py`` against
the port's ``lfm_tpu_torch.tools.prepare_latent_dataset``, and the ``cli
sample`` file name and grid pixels against JAX's ``save_image_grid``.

The pipeline is uint8 up to ``to_neg1_1`` and the flips draw from the same
numpy generator, so every reader's arrays and labels equal JAX's bit for
bit, item by item in order. The latents of the two tools (bf16 VAE
encoders, XLA's and torch's convolutions) are held to 5e-2 of their
largest value (tests/test_torch_adm.py's bf16 tolerance), with the VAE's
noise set to zero on both sides; their labels and file layout exactly.
"""

import dataclasses
import importlib.util
import io
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import jax.experimental.pallas  # noqa: E402,F401
import torch  # noqa: E402
import torch._dynamo  # noqa: E402,F401
from PIL import Image  # noqa: E402

from tests.torch_parity import leaves_process_as_found, randomize  # noqa: E402,F401

from lfm_tpu.core import config as jconfig  # noqa: E402
from lfm_tpu import data as jdata  # noqa: E402
from lfm_tpu.data import datasets as jdatasets  # noqa: E402
from lfm_tpu.data import lmdb_datasets as jlmdb_datasets  # noqa: E402
from lfm_tpu.data import minilmdb as jminilmdb  # noqa: E402
from lfm_tpu_torch.core import config as tconfig  # noqa: E402
from lfm_tpu_torch import data as tdata  # noqa: E402
from lfm_tpu_torch.data import datasets as tdatasets  # noqa: E402
from lfm_tpu_torch.data import lmdb_datasets as tlmdb_datasets  # noqa: E402
from lfm_tpu_torch.data import minilmdb as tminilmdb  # noqa: E402
from lfm_tpu_torch.data import transforms as ttransforms  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def _rgb(rng, h, w):
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


def _png(arr) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _same(jds, tds, count=None):
    """Both datasets give the same arrays and labels, item by item in
    order (their flips draw from the same generator)."""
    assert len(jds) == len(tds) and type(jds).__name__ == type(tds).__name__
    for i in range(len(jds) if count is None else count):
        (ja, jy), (ta, ty) = jds[i], tds[i]
        assert ta.dtype == np.float32 and np.array_equal(ja, ta), i
        assert int(jy) == int(ty), i


def _folder(root, rng, sizes, classes=None):
    for c in classes or [None]:
        d = root if c is None else root / c
        d.mkdir(parents=True, exist_ok=True)
        for i, (h, w) in enumerate(sizes):
            Image.fromarray(_rgb(rng, h, w)).save(d / f"{i:03d}.png")
        (d / "notes.txt").write_text("not an image")


@pytest.mark.parametrize("kind", ["resize", "resize_crop", "adm_center_crop"])
@pytest.mark.parametrize("classes", [None, ["a", "b"]])
def test_image_folder_matches_jax(tmp_path, kind, classes):
    rng = np.random.default_rng(0)
    _folder(tmp_path, rng, [(40, 30), (24, 50), (37, 37), (80, 64)], classes)
    kw = dict(image_size=16, transform_kind=kind, seed=3)
    jds = jdatasets.ImageFolderDataset(str(tmp_path), **kw)
    tds = tdatasets.ImageFolderDataset(str(tmp_path), **kw)
    assert (tds.num_classes, tds.labels) == (jds.num_classes, jds.labels)
    _same(jds, tds)


def _nvae_items(rng, n, size, encoded):
    return {str(i).encode(): (_png(_rgb(rng, size, size)) if encoded
                              else _rgb(rng, size, size).tobytes()) for i in range(n)}


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("encoded", [False, True])
@pytest.mark.parametrize("record_size", [16, 24])  # at the image size, and resampled
def test_nvae_lmdb_matches_jax(tmp_path, writer, encoded, record_size):
    """Raw-RGB and encoded NVAE records (past the in-page maximum: overflow
    pages), written by either write_db, read by both readers."""
    items = _nvae_items(np.random.default_rng(1), 5, record_size, encoded)
    write = tminilmdb.write_db if writer == "port" else jminilmdb.write_db
    write(str(tmp_path / "train.lmdb"), items)
    for crop in (False, True):
        kw = dict(root=str(tmp_path), name="celeba", image_size=16, is_encoded=encoded,
                  crop=crop, seed=4)
        _same(jlmdb_datasets.LMDBDataset(**kw), tlmdb_datasets.LMDBDataset(**kw))


def test_write_db_files_are_the_same_bytes(tmp_path):
    """The port's write_db writes JAX's file byte for byte (one leaf, several
    leaves under a branch, overflow runs), and its reader reads both."""
    rng = np.random.default_rng(2)
    for n, size in ((3, 8), (300, 4), (7, 48)):
        items = {f"k{i:04d}".encode(): _rgb(rng, size, size).tobytes() for i in range(n)}
        a, b = tmp_path / f"j{n}", tmp_path / f"t{n}"
        jminilmdb.write_db(str(a), items)
        tminilmdb.write_db(str(b), items)
        assert (a / "data.mdb").read_bytes() == (b / "data.mdb").read_bytes()
        env = tminilmdb.open(str(a))
        with env.begin() as txn:
            assert txn.stat()["entries"] == n
            assert dict(txn.cursor().iternext()) == items
            assert all(txn.get(k) == v for k, v in items.items())
            assert txn.get(b"missing") is None
        env.close()


def test_handmade_lmdb_reads_as_in_jax():
    """tools/make_lmdb_fixture.py's database (scrambled node order, a stale
    meta page, an overflow run), which no write_db made."""
    path = str(REPO / "tests" / "fixtures" / "lmdb_handmade")
    jenv, tenv = jminilmdb.open(path), tminilmdb.open(path)
    with jenv.begin() as jt, tenv.begin() as tt:
        assert tt.stat() == jt.stat()
        jitems = list(jt.cursor().iternext())
        assert list(tt.cursor().iternext()) == jitems and len(jitems) == 5
        assert list(tt.cursor().iternext(keys=True, values=False)) == [k for k, _ in jitems]
        for k, v in jitems:
            assert tt.get(k) == v == jt.get(k)
        assert tt.get(b"absent") is None
    jenv.close()
    tenv.close()


def _lsun(root, rng):
    for cls in ("church_outdoor_train", "bedroom_train"):
        items = {f"{cls[:3]}-{i:x}-{rng.integers(1e6)}".encode():
                 _png(_rgb(rng, 20 + i, 28)) for i in range(4)}
        tminilmdb.write_db(str(root / f"{cls}_lmdb"), items)


def test_lsun_and_image_lmdb_match_jax(tmp_path, monkeypatch):
    """Multi-class LSUN (its key cache goes to the working directory) and the
    torchtoolbox ImageLMDB (keys '{db_name}_{i}', '__len__')."""
    rng = np.random.default_rng(5)
    _lsun(tmp_path, rng)
    classes = ["church_outdoor_train", "bedroom_train"]
    readers = []
    for mod, cwd in ((tlmdb_datasets, "port"), (jlmdb_datasets, "jax")):
        (tmp_path / cwd).mkdir()
        monkeypatch.chdir(tmp_path / cwd)  # each lists its own keys into its cache
        readers.append(mod.LSUN(str(tmp_path), classes, image_size=16, seed=6))
    tds, jds = readers
    _same(jds, tds)
    items = {f"celeba_512_{i}".encode(): _png(_rgb(rng, 30, 26)) for i in range(3)}
    items[b"__len__"] = b"3"
    tminilmdb.write_db(str(tmp_path / "img"), items)
    kw = dict(db_path=str(tmp_path / "img"), db_name="celeba_512", image_size=16, seed=7)
    _same(jlmdb_datasets.ImageLMDB(**kw), tlmdb_datasets.ImageLMDB(**kw))


def _cifar(root, rng):
    base = root / "cifar-10-batches-py"
    base.mkdir(parents=True)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        batch = {b"data": rng.integers(0, 256, (3, 3072), dtype=np.uint8),
                 b"labels": [int(v) for v in rng.integers(10, size=3)]}
        with open(base / name, "wb") as f:
            pickle.dump(batch, f)


def test_cifar10_matches_jax(tmp_path):
    _cifar(tmp_path, np.random.default_rng(8))
    for train in (True, False):
        _same(jdatasets.CIFAR10Dataset(str(tmp_path), train=train, seed=1),
              tdatasets.CIFAR10Dataset(str(tmp_path), train=train, seed=1))


def _configs(name, datadir, size=16):
    jcfg = jconfig.Config(dataset=name, model=jconfig.ModelConfig(model_type="DiT-T/2",
                                                                  image_size=size),
                          data=jconfig.DataConfig(dataset=name, datadir=str(datadir)))
    tcfg = tconfig.Config(dataset=name, model=tconfig.ModelConfig(model_type="DiT-T/2",
                                                                  image_size=size),
                          data=tconfig.DataConfig(dataset=name, datadir=str(datadir)))
    return jcfg, tcfg


def test_get_dataset_dispatches_every_name_as_jax(tmp_path, monkeypatch):
    """Every dataset name, LMDB-backed ones both on their database and on a
    plain image folder (``_folder_fallback``): the same reader, length and
    first items; an unknown name raises KeyError in both."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(9)
    folder = tmp_path / "folder"
    _folder(folder, rng, [(20, 18), (22, 30)])
    _cifar(tmp_path / "cifar", rng)
    _folder(tmp_path / "imnet" / "train", rng, [(20, 24), (30, 20)], ["n01", "n02"])
    _lsun(tmp_path / "lsun", rng)
    tminilmdb.write_db(str(tmp_path / "nvae" / "train.lmdb"), _nvae_items(rng, 3, 16, False))
    items = {f"celeba_1024_{i}".encode(): _png(_rgb(rng, 20, 20)) for i in range(2)}
    tminilmdb.write_db(str(tmp_path / "img"), items)
    latent = tmp_path / "latent"
    latent.mkdir()
    np.save(latent / "latents.npy", rng.standard_normal((3, 2, 2, 4)).astype(np.float16))
    np.save(latent / "labels.npy", np.array([0, 2, 1], np.int32))
    cases = [("cifar10", tmp_path / "cifar"), ("imagenet_256", tmp_path / "imnet"),
             ("lsun_church", tmp_path / "lsun"), ("lsun_bedroom", tmp_path / "lsun"),
             ("lsun_church", folder), ("celeba_256", tmp_path / "nvae"),
             ("ffhq_256", folder), ("celeba_1024", tmp_path / "img"), ("celeba_512", folder),
             ("latent_celeba_256", latent), ("synthetic", folder),
             ("synthetic_latent", folder)]
    for name, datadir in cases:
        jcfg, tcfg = _configs(name, datadir)
        jds, tds = jdata.get_dataset(jcfg, seed=2), tdata.get_dataset(tcfg, seed=2)
        _same(jds, tds, count=min(2, len(jds)))
        if isinstance(jds, jdatasets.Subset):
            assert type(tds.dataset).__name__ == type(jds.dataset).__name__
    for mod, cfg in zip((jdata, tdata), _configs("mnist", folder)):
        with pytest.raises(KeyError, match="mnist"):
            mod.get_dataset(cfg)


def test_raw_record_at_the_image_size_needs_no_pillow(tmp_path, monkeypatch):
    """Without Pillow a raw NVAE record already at the image size reads (the
    same bits as JAX's reader with Pillow); one that needs resampling, and
    an image folder, raise an ImportError that names Pillow."""
    items = _nvae_items(np.random.default_rng(10), 4, 16, False)
    tminilmdb.write_db(str(tmp_path / "train.lmdb"), items)
    want = jlmdb_datasets.LMDBDataset(str(tmp_path), image_size=16, seed=1)
    want_items = [want[i] for i in range(len(want))]
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError):
        import PIL.Image  # noqa: F401
    got = tlmdb_datasets.LMDBDataset(str(tmp_path), image_size=16, seed=1)
    for i, (wa, wy) in enumerate(want_items):
        ga, gy = got[i]
        assert np.array_equal(ga, wa) and gy == wy
    with pytest.raises(ImportError, match="Pillow"):
        tlmdb_datasets.LMDBDataset(str(tmp_path), image_size=8, seed=1)[0]
    with pytest.raises(ImportError, match="Pillow"):
        ttransforms.require_pil("an image folder")


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_prepare_latent_dataset", REPO / "tools" / "prepare_latent_dataset.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_prepare_latent_dataset_matches_the_jax_tool(tmp_path, monkeypatch):
    """Both tools over the same NVAE LMDB (5 records, batches of 2: a ragged
    last batch) with the same VAE checkpoint, cut to two blocks (block_out
    (32, 32)) on both sides, the encoder's noise at zero on both sides: the
    same files, labels and shapes, latents within 5e-2."""
    from lfm_tpu.vae import autoencoder_kl as jvae
    from lfm_tpu.vae import convert as jconvert
    from lfm_tpu_torch.tools import prepare_latent_dataset as ttool
    from lfm_tpu_torch.vae import autoencoder_kl as tvae
    from lfm_tpu_torch.vae.convert import vae_params_from_jax

    rng = np.random.default_rng(11)
    tminilmdb.write_db(str(tmp_path / "db" / "train.lmdb"), _nvae_items(rng, 5, 16, False))
    blocks = (32, 32)
    jv = jvae.AutoencoderKL(block_out=blocks)
    params = randomize(jax.jit(jv.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)),
                                        jax.random.PRNGKey(1)), 6)
    ckpt = str(tmp_path / "vae.pth")
    torch.save(vae_params_from_jax(params), ckpt)

    class SmallVAE(jvae.AutoencoderKL):
        block_out: tuple = blocks

    monkeypatch.setattr(sys, "path", list(sys.path))  # the JAX tool inserts "."
    monkeypatch.setattr(jvae, "AutoencoderKL", SmallVAE)
    monkeypatch.setattr(jconvert, "load_vae_params", lambda p: jconvert.convert_vae_state_dict(
        torch.load(p, map_location="cpu", weights_only=True), num_blocks=len(blocks)))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.zeros(shape, dtype))
    real_create = tvae.create_vae
    monkeypatch.setattr(tvae, "create_vae", lambda *a, **k: real_create(blocks, **k))
    monkeypatch.setattr(tvae.AutoencoderKL, "encode_sample",
                        lambda self, x, generator=None, eps=None: self.encode_mode(x))
    args = ["--dataset", "celeba_256", "--datadir", str(tmp_path / "db"), "--image_size", "16",
            "--vae_ckpt", ckpt, "--batch_size", "2"]
    monkeypatch.setattr(sys, "argv", ["prepare_latent_dataset.py", *args, "--out",
                                      str(tmp_path / "jax")])
    _jax_tool().main()
    assert ttool.main([*args, "--out", str(tmp_path / "port"), "--device", "cpu"]) == 5
    for name in ("latents.npy", "labels.npy"):
        want, got = np.load(tmp_path / "jax" / name), np.load(tmp_path / "port" / name)
        assert got.dtype == want.dtype and got.shape == want.shape
        if name == "labels.npy":
            assert np.array_equal(got, want)
        else:
            err = np.abs(got.astype(np.float64) - want).max() / np.abs(want).max()
            assert got.shape == (5, 8, 8, 4) and err < 5e-2


def test_cli_sample_writes_the_jax_file_and_grid(tmp_path, monkeypatch):
    """``cli.main sample`` without --out writes JAX's
    samples_{dataset}_{method}_{atol}_{rtol}[_cfg{scale}].jpg (its name
    from the same config fields, lfm_tpu/cli/main.py:505-512) with the grid
    JAX's save_image_grid writes of the same images (the same Pillow
    encoder: the same bytes); the grid's pixels equal JAX's through a PNG;
    --out keeps the .npy."""
    from lfm_tpu.train.loop import save_image_grid as jsave
    from lfm_tpu_torch.cli import main as cli
    from lfm_tpu_torch.train.loop import save_image_grid as tsave

    monkeypatch.chdir(tmp_path)
    flags = ["sample", "--preset", "celeb256_dit", "--device", "cpu", "--model_type", "DiT-T/2",
             "--image_size", "32", "--method", "euler", "--steps", "2", "--batch_size", "3"]
    npy = cli.main([*flags, "--out", str(tmp_path / "s.npy")])
    assert npy == str(tmp_path / "s.npy")
    path = cli.main(flags)
    jc = jconfig.get_preset("celeb256_dit")
    sc = dataclasses.replace(jc.sample, method="euler")
    assert path == f"./samples_{jc.dataset}_{sc.method}_{sc.atol}_{sc.rtol}.jpg"
    images = np.load(npy)
    jsave(images, str(tmp_path / "want.jpg"))
    assert (tmp_path / path).read_bytes() == (tmp_path / "want.jpg").read_bytes()
    jsave(images, str(tmp_path / "want.png"))
    tsave(images, str(tmp_path / "got.png"))  # the port's own PNG encoder
    assert np.array_equal(np.asarray(Image.open(tmp_path / "got.png")),
                          np.asarray(Image.open(tmp_path / "want.png")))
    imnet = tconfig.get_preset("imnet_dit")
    jimnet = jconfig.get_preset("imnet_dit")
    assert cli.sample_grid_path(imnet) == (
        f"./samples_{jimnet.dataset}_{jimnet.sample.method}_{jimnet.sample.atol}_"
        f"{jimnet.sample.rtol}_cfg{jimnet.sample.cfg_scale}.jpg")
