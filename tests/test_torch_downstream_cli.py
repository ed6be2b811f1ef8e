"""The four downstream subcommands end to end on the CPU: ``python -m
lfm_tpu_torch.cli.main train-inpainting | train-semantic | test-inpainting
| test-semantic`` against ``lfm_tpu.cli.main``'s, on the same fixtures and
weights, at test scale (celeb256_adm with ``--image_size 64 --nf 32
--ch_mult 1 2 --attn_resolutions 2 --num_res_blocks 1``; a VAE of four
32-channel blocks on both sides, from one checkpoint).

Every Gaussian draw is zero on both sides (the VAE posterior eps and the
noise: JAX's threefry bits cannot be matched), so the outputs are
deterministic functions of the weights and the data:
- ``train-*``: the ADM's output convolution starts at zero in both
  packages, so step 1's loss is mean((z1 - z0)^2) = mean(z0^2) with z0 the
  VAE latent of the first batch (the same shuffled order, flips and masks,
  whose strokes the port draws as JAX's cv2.line). Held within 5e-2 relative:
  bf16 VAEs (tests/test_torch_data.py's latent tolerance), and for ADE20k
  images whose bicubic resize is within one level of cv2's.
- ``test-*``: the images written, from one checkpoint: a reference
  ``model_{E}.pth`` (the bare network) for ``test-inpainting``; for
  ``test-semantic`` the port's own ``model_{E}.pth`` (network and
  rescaler) against the same weights as JAX's orbax checkpoint. Both CLIs
  build their network and VAE in bf16; here both are built in f32 (the
  factories wrapped on both sides), because at test scale a random bf16
  network and decoder move a pixel by up to 50 levels between any two
  bf16 implementations (the bf16 models are held elsewhere:
  tests/test_torch_adm.py). The decoded JPEG files agree within
  JPEG_LEVELS.
"""

import os
import sys
from unittest import mock

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
import torch._dynamo  # noqa: E402,F401

from tests.torch_parity import leaves_process_as_found, randomize  # noqa: E402,F401

from lfm_tpu.cli import main as jcli  # noqa: E402
from lfm_tpu.nn import adm_unet as jadm  # noqa: E402
from lfm_tpu.nn.convert_adm import convert_adm_state_dict  # noqa: E402
from lfm_tpu.vae import autoencoder_kl as jvae  # noqa: E402
from lfm_tpu_torch.cli import main as cli  # noqa: E402
from lfm_tpu_torch.core.config import get_preset  # noqa: E402
from lfm_tpu_torch.core.rng import SampleRNG  # noqa: E402
from lfm_tpu_torch.nn.encoders import SpatialRescaler  # noqa: E402
from lfm_tpu_torch.nn.factory import create_network  # noqa: E402
from lfm_tpu_torch.nn.init import seeded_init_  # noqa: E402
from lfm_tpu_torch.train import conditional as tcond  # noqa: E402
from lfm_tpu_torch.vae import autoencoder_kl as tvae  # noqa: E402
from lfm_tpu_torch.vae.convert import vae_params_from_jax  # noqa: E402

Image = pytest.importorskip("PIL.Image")
BLOCKS = (32, 32, 32, 32)
SMALL = ["--preset", "celeb256_adm", "--image_size", "64", "--nf", "32", "--ch_mult", "1", "2",
         "--attn_resolutions", "2", "--num_res_blocks", "1", "--batch_size", "2"]
ADE_CLASSES = 151
# the written JPEGs of f32 pipelines: the largest and the mean difference in
# levels (a value on a level's edge truncates the other way, and JPEG's
# blocks spread it; measured 4 and 0.052 at most)
JPEG_LEVELS = (6, 0.1)


@pytest.fixture(scope="module")
def cv2():
    """cv2 for the JAX package's segmentation readers, imported with the
    environment kept as it was (importing it sets Qt's variables)."""
    with mock.patch.dict(os.environ):
        import cv2
    return cv2


@pytest.fixture
def fixtures(tmp_path, monkeypatch):
    """The VAE checkpoint, the small VAE on both sides, every Gaussian draw
    zero, and a directory per package to run in."""
    jv = jvae.AutoencoderKL(block_out=BLOCKS)
    params = randomize(jax.jit(jv.init)(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)),
                                        jax.random.PRNGKey(1)), 6)
    vae_ckpt = str(tmp_path / "vae.pth")
    torch.save(vae_params_from_jax(params), vae_ckpt)

    class SmallVAE(jvae.AutoencoderKL):
        block_out: tuple = BLOCKS

    monkeypatch.setattr(jvae, "AutoencoderKL", SmallVAE)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=(), dtype=jnp.float32: jnp.zeros(shape, dtype))
    real_create = tvae.create_vae
    monkeypatch.setattr(cli, "create_vae", lambda *a, **k: real_create(BLOCKS, **k))

    class ZeroNormal:  # the port's train step and VAE: zero Gaussian draws
        def __getattr__(self, name):
            return getattr(torch, name)

        def randn(self, shape, generator=None, device=None, **_):
            return torch.zeros(tuple(shape), device=device)

    monkeypatch.setattr(tcond, "torch", ZeroNormal())
    monkeypatch.setattr(tvae, "torch", ZeroNormal())
    monkeypatch.setattr(SampleRNG, "randn",
                        lambda self, idx, shape, dtype=torch.float32, device=None, stream=None:
                        torch.zeros((len(list(idx)),) + tuple(shape), dtype=dtype))
    for side in ("jax", "port"):
        os.makedirs(tmp_path / side)
    return tmp_path, vae_ckpt


def _write_rgb(path, rng, size):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(rng.integers(0, 256, size + (3,), dtype=np.uint8)).save(path)


def _ade20k(root, rng, n=4):
    """ADE20k's layout: {split}.txt of relative .jpg paths, images/ and
    annotations/ (.png label maps)."""
    rels = [f"x{i}.jpg" for i in range(n)]
    for rel in rels:
        _write_rgb(os.path.join(root, "images", rel), rng, (70, 64))
        os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
        Image.fromarray(rng.integers(0, ADE_CLASSES, (70, 64), dtype=np.uint8)).save(
            os.path.join(root, "annotations", rel.replace(".jpg", ".png")))
    for split in ("train", "val"):
        with open(os.path.join(root, f"{split}.txt"), "w") as f:
            f.write("\n".join(rels))


def _first_loss(out):
    line = next(ln for ln in out.splitlines() if ln.startswith("epoch 0 iteration0, Loss: "))
    return float(line.split("Loss: ")[1].split(",")[0])


def _run_both(tmp_path, monkeypatch, capsys, argv, port_flags=("--device", "cpu")):
    results = {}
    for side in ("jax", "port"):
        monkeypatch.chdir(tmp_path / side)
        capsys.readouterr()
        ret = (jcli.main(argv) if side == "jax" else cli.main(argv + list(port_flags)))
        results[side] = (ret, capsys.readouterr().out)
    monkeypatch.chdir(tmp_path)
    return results


@pytest.mark.parametrize("task", ["inpainting", "semantic"])
def test_train_subcommands_match_jax(task, fixtures, monkeypatch, capsys, request):
    """train-inpainting (a folder of PNGs) and train-semantic (ADE20k's
    layout) for one step: step 1's loss against JAX's, and the run's
    config.json where JAX writes it."""
    tmp_path, vae_ckpt = fixtures
    rng = np.random.default_rng(0)
    # JAX draws the masks' strokes and resizes the label maps with cv2
    request.getfixturevalue("cv2")
    if task == "inpainting":
        for i in range(8):
            _write_rgb(str(tmp_path / "data" / f"{i}.png"), rng, (64, 64))
        extra = []
    else:
        _ade20k(str(tmp_path / "data"), rng, n=8)
        extra = ["--seg_dataset", "ade20k"]
    # a batch of 8: the JAX loop shards it over the 8 CPU devices of the
    # test process's JAX
    argv = [f"train-{task}", *SMALL, "--datadir", str(tmp_path / "data"), "--vae_ckpt", vae_ckpt,
            "--max_steps", "1", "--exp", "e", "--batch_size", "8", *extra]
    res = _run_both(tmp_path, monkeypatch, capsys, argv)
    want, got = _first_loss(res["jax"][1]), _first_loss(res["port"][1])
    assert np.isfinite(got) and got > 0 and abs(got - want) <= 5e-2 * want
    state = res["port"][0]
    assert state.step == 1
    assert any(n.startswith("cond.") for n in state.names) == (task == "semantic")
    out = "inpaint" if task == "inpainting" else "mask2image"
    dataset = "celeba_256"
    for side in ("jax", "port"):
        assert (tmp_path / side / f"saved_info/latent_flow_{out}" / dataset / "e"
                / "config.json").is_file()


def _decoded(folder):
    return {f: np.asarray(Image.open(os.path.join(folder, f)), np.int32)
            for f in sorted(os.listdir(folder))}


def _assert_images_close(got_dir, want_dir, n):
    got, want = _decoded(got_dir), _decoded(want_dir)
    assert sorted(got) == sorted(want) == sorted(f"{i}.jpg" for i in range(n))
    for name in got:
        diff = np.abs(got[name] - want[name])
        assert diff.max() <= JPEG_LEVELS[0] and diff.mean() <= JPEG_LEVELS[1], (
            name, diff.max(), diff.mean())


@pytest.fixture
def f32_pipelines(monkeypatch):
    """Both CLIs' networks and VAEs built in f32."""
    from lfm_tpu.nn import factory as jfactory

    real_j, real_t = jfactory.create_network, cli.create_network
    small = jvae.AutoencoderKL  # the fixture's small VAE
    monkeypatch.setattr(jfactory, "create_network",
                        lambda cfg, dtype=None, **k: real_j(cfg, dtype=jnp.float32, **k))
    monkeypatch.setattr(jvae, "AutoencoderKL", lambda dtype=None, **k: small(dtype=jnp.float32,
                                                                             **k))
    monkeypatch.setattr(cli, "create_network",
                        lambda cfg, dtype=None, **k: real_t(cfg, dtype=torch.float32, **k))
    real_vae = cli.create_vae
    monkeypatch.setattr(cli, "create_vae", lambda *a, dtype=None, **k: real_vae(
        *a, dtype=torch.float32, **k))


def _small_config(in_ch):
    import dataclasses

    c = get_preset("celeb256_adm")
    return dataclasses.replace(c.model, image_size=64, nf=32, ch_mult=(1, 2),
                               attn_resolutions=(2,), num_res_blocks=1, num_in_channels=in_ch)


def test_test_inpainting_matches_jax(fixtures, f32_pipelines, monkeypatch, capsys):
    """test-inpainting from a reference model_{E}.pth (the bare network, the
    DDP prefix on) over {i:06d}.jpg / .png pairs, 3 images in batches of 2,
    euler at 2 steps: the same composites written as {i}.jpg."""
    tmp_path, vae_ckpt = fixtures
    rng = np.random.default_rng(1)
    for i in range(3):
        _write_rgb(str(tmp_path / "img" / f"{i:06d}.jpg"), rng, (64, 64))
        os.makedirs(tmp_path / "mask", exist_ok=True)
        m = np.full((64, 64), 255, np.uint8)
        m[8 + 8 * i: 40, 16: 48 - 4 * i] = 0
        Image.fromarray(m).save(tmp_path / "mask" / f"{i:06d}.png")
    model = seeded_init_(create_network(_small_config(9), device="cpu"), 3)
    ckpt = str(tmp_path / "model_7.pth")
    torch.save({f"module.{k}": v for k, v in model.state_dict().items()}, ckpt)
    argv = ["test-inpainting", *SMALL, "--ckpt", ckpt, "--vae_ckpt", vae_ckpt, "--indir",
            str(tmp_path / "img"), "--maskdir", str(tmp_path / "mask"), "--method", "euler",
            "--steps", "2", "--save_dir", "out"]
    res = _run_both(tmp_path, monkeypatch, capsys, argv)
    assert res["port"][0] == os.path.join("out", "celeba_256")
    _assert_images_close(tmp_path / "port" / "out" / "celeba_256",
                         tmp_path / "jax" / "out" / "celeba_256", 3)
    assert "composited samples saved to" in res["port"][1]


def test_test_semantic_matches_jax(fixtures, f32_pipelines, monkeypatch, capsys, cv2):
    """test-semantic on ADE20k's val split from the port's own
    model_{E}.pth (network and rescaler), against JAX's CLI from an orbax
    checkpoint of the same weights: the same images written."""
    import orbax.checkpoint as ocp

    tmp_path, vae_ckpt = fixtures
    rng = np.random.default_rng(2)
    _ade20k(str(tmp_path / "data"), rng, n=3)
    model = seeded_init_(create_network(_small_config(8), device="cpu"), 4)
    rescaler = SpatialRescaler(3, multiplier=0.5, in_channels=ADE_CLASSES, out_channels=4)
    rescaler.reset_parameters(torch.Generator().manual_seed(5))
    mods = tcond.cond_modules(model, rescaler)
    ckpt = str(tmp_path / "model_3.pth")
    torch.save(mods.state_dict(), ckpt)
    jm = jadm.UNetModel(image_size=8, in_channels=8, model_channels=32, out_channels=4,
                        num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2))
    tree = {"model": convert_adm_state_dict({k: v.numpy() for k, v in model.state_dict().items()},
                                            jm),
            "cond": {"channel_mapper": {"kernel": rescaler.channel_mapper.weight.detach()
                                        .numpy().T.copy()}}}
    with ocp.PyTreeCheckpointer() as c:
        c.save(str(tmp_path / "model_3"), tree)
    common = ["test-semantic", *SMALL, "--vae_ckpt", vae_ckpt, "--datadir",
              str(tmp_path / "data"), "--seg_dataset", "ade20k", "--method", "euler", "--steps",
              "2", "--n_sample", "3", "--save_dir", "out"]
    results = {}
    for side, path in (("jax", str(tmp_path / "model_3")), ("port", ckpt)):
        monkeypatch.chdir(tmp_path / side)
        argv = common + ["--ckpt", path]
        results[side] = jcli.main(argv) if side == "jax" else cli.main(argv + ["--device", "cpu"])
    monkeypatch.chdir(tmp_path)
    assert results["port"] == "out"
    _assert_images_close(tmp_path / "port" / "out", tmp_path / "jax" / "out", 3)


def test_downstream_flags_raise_where_not_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        cli.main(["train-inpainting", "--preset", "celeb256_adm", "--num_procs", "2",
                  "--device", "cpu"])
    cfg = cli._resolve_downstream_config(cli._build_parser().parse_args(
        ["test-semantic", "--preset", "celeb256_adm", "--steps", "7", "--batch_size", "3"]))
    assert (cfg.model.num_in_channels, cfg.sample.num_steps, cfg.sample.batch_size) == (8, 7, 3)
    cfg = cli._resolve_downstream_config(cli._build_parser().parse_args(
        ["train-inpainting", "--preset", "celeb256_adm", "--lr", "0.5", "--use_ema"]))
    assert (cfg.model.num_in_channels, cfg.train.lr, cfg.train.use_ema) == (9, 0.5, True)
