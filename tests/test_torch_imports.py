"""lfm_tpu_torch stands alone: no module of it and not chip_smoke.py imports
jax, jaxlib, flax, optax or lfm_tpu, nor cv2, scikit-learn, transformers or
Pillow, which the card's machine lacks (a reader imports Pillow when it
decodes a file);
every entry point runs on the card
unless the caller passes device="cpu" (sampling and training alike); the
kernel wrappers take no device other than the CPU and CUDA; chip_smoke.py
fails without CUDA or without the package beside it, printing no result."""

import json
import os
from dataclasses import replace
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch
# meta tensors' torch.cat imports torch._dynamo, which sets an environment
# variable when first imported; import it with the module, before the state
# guard looks
import torch._dynamo  # noqa: F401

from tests.torch_parity import leaves_process_as_found  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_ISOLATED = textwrap.dedent("""
    import importlib, importlib.abc, json, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "flax", "optax", "lfm_tpu", "cv2", "sklearn", "transformers",
               "PIL")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    import lfm_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(lfm_tpu_torch.__path__, "lfm_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    with open("chip_smoke.py") as f:
        compile(f.read(), "chip_smoke.py", "exec")
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    print(json.dumps({"modules": names, "leaked": leaked}))
""")


def test_port_imports_nothing_of_jax_or_lfm_tpu():
    res = subprocess.run([sys.executable, "-c", _ISOLATED], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["leaked"] == []
    for mod in ("lfm_tpu_torch.sample.sample", "lfm_tpu_torch.kernels.dit_block",
                "lfm_tpu_torch.kernels.flash_attention", "lfm_tpu_torch.cli.main",
                "lfm_tpu_torch.vae.autoencoder_kl", "lfm_tpu_torch.vae.convert",
                "lfm_tpu_torch.ode.solvers", "lfm_tpu_torch.train.loop",
                "lfm_tpu_torch.train.train", "lfm_tpu_torch.train.state",
                "lfm_tpu_torch.core.checkpoint", "lfm_tpu_torch.core.preemption",
                "lfm_tpu_torch.data.datasets", "lfm_tpu_torch.data.loader",
                "lfm_tpu_torch.data.transforms", "lfm_tpu_torch.data.minilmdb",
                "lfm_tpu_torch.data.lmdb_datasets", "lfm_tpu_torch.tools.prepare_latent_dataset",
                "lfm_tpu_torch.nn.adm_unet", "lfm_tpu_torch.nn.convert_adm",
                "lfm_tpu_torch.nn.edm_unet", "lfm_tpu_torch.nn.convert_edm",
                "lfm_tpu_torch.sample.sharded",
                "lfm_tpu_torch.kernels.groupnorm_silu", "lfm_tpu_torch.kernels.dit_block_train",
                "lfm_tpu_torch.kernels.int8_matmul", "lfm_tpu_torch.nn.dit_int8",
                "lfm_tpu_torch.eval.inception", "lfm_tpu_torch.eval.fid",
                "lfm_tpu_torch.tools.microbench_int8", "lfm_tpu_torch.nn.encoders",
                "lfm_tpu_torch.train.conditional", "lfm_tpu_torch.train.downstream_loops",
                "lfm_tpu_torch.sample.downstream", "lfm_tpu_torch.data.masks",
                "lfm_tpu_torch.data.inpainting", "lfm_tpu_torch.data.segmentation",
                "lfm_tpu_torch.eval.inpainting_metrics", "lfm_tpu_torch.eval.perceptual",
                "lfm_tpu_torch.eval.evaluator", "lfm_tpu_torch.eval.inception_score",
                "lfm_tpu_torch.nn.attention", "lfm_tpu_torch.nn.text_encoder",
                "lfm_tpu_torch.nn.variants", "lfm_tpu_torch.data.layout",
                "lfm_tpu_torch.data.countless", "lfm_tpu_torch.data.annotated_objects"):
        assert mod in out["modules"]


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_refuse_the_cpu_unless_asked(no_cuda):
    from lfm_tpu_torch.cli import main as cli
    from lfm_tpu_torch.core.config import get_preset
    from lfm_tpu_torch.core.rng import SampleRNG
    from lfm_tpu_torch.eval.evaluator import InpaintingEvaluator
    from lfm_tpu_torch.eval.inception_score import get_inception_score
    from lfm_tpu_torch.nn.dit import DiT, create_dit
    from lfm_tpu_torch.sample.downstream import make_inpainting_sampler, make_semantic_sampler
    from lfm_tpu_torch.nn.factory import create_network
    from lfm_tpu_torch.nn.text_encoder import BERTEmbedder
    from lfm_tpu_torch.sample.sample import make_sampler, noise_and_labels
    from lfm_tpu_torch.vae.autoencoder_kl import create_vae

    cfg = get_preset("celeb256_dit")
    tiny = DiT(img_resolution=8, patch_size=2, hidden_size=32, depth=1, num_heads=2)
    calls = [
        lambda: create_dit("DiT-S/8", img_resolution=32),
        lambda: create_network(cfg.model),
        lambda: create_network(get_preset("celeb256_adm").model),
        lambda: create_network(get_preset("imnet_adm").model),
        lambda: create_network(replace(get_preset("celeb256_adm").model, layout=True)),
        lambda: create_network(replace(get_preset("imnet_adm").model, model_type="adm_context")),
        lambda: create_network(replace(get_preset("imnet_adm").model, model_type="ncsn++")),
        lambda: BERTEmbedder(n_layer=1),
        lambda: create_vae((32, 32)),
        lambda: make_sampler(cfg, tiny),
        lambda: noise_and_labels(cfg, SampleRNG(0), [0]),
        lambda: SampleRNG(0).randn([0], (2,)),
        lambda: SampleRNG(0).randint([0], 0, 2),
        lambda: cli.main(["sample", "--preset", "celeb256_dit"]),
        lambda: cli.main(["sample", "--preset", "celeb256_adm"]),
        lambda: cli.main(["nfe", "--preset", "imnet_adm"]),
        lambda: cli.main(["time", "--preset", "ffhq_adm"]),
        lambda: cli.main(["fid", "--preset", "celeb256_dit", "--real_img_dir", "stats.npz"]),
        lambda: make_inpainting_sampler(cfg, tiny, None, None, None),
        lambda: make_semantic_sampler(cfg, tiny, None, None, None, None, None, 2),
        lambda: InpaintingEvaluator(),
        lambda: get_inception_score([], {}),
        lambda: cli.main(["test-inpainting", "--preset", "celeb256_adm"]),
        lambda: cli.main(["test-semantic", "--preset", "celeb256_adm"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    # asked for, the CPU is used
    assert create_vae((32, 32), device="cpu").decoder.conv_in.weight.device.type == "cpu"
    assert SampleRNG(0).randn([0], (2,), device="cpu").shape == (1, 2)


def test_train_refuses_the_cpu_unless_asked(no_cuda, tmp_path):
    from lfm_tpu_torch.cli import main as cli
    from lfm_tpu_torch.core.config import get_preset
    from lfm_tpu_torch.tools import prepare_latent_dataset
    from lfm_tpu_torch.train.downstream_loops import train_inpainting, train_semantic
    from lfm_tpu_torch.train.loop import train

    cfg = get_preset("celeb256_dit").replace(output_dir=str(tmp_path))
    for call in (lambda: train(cfg),
                 lambda: train(get_preset("celeb256_adm").replace(output_dir=str(tmp_path))),
                 lambda: cli.main(["train", "--preset", "celeb256_dit", "--dataset",
                                   "synthetic_latent", "--max_steps", "1"]),
                 lambda: cli.main(["train", "--preset", "celeb256_adm", "--dataset",
                                   "synthetic", "--max_steps", "1"]),
                 lambda: train_inpainting(cfg, [], None),
                 lambda: train_semantic(cfg, [], None, None, num_classes=2),
                 lambda: cli.main(["train-inpainting", "--preset", "celeb256_adm",
                                   "--max_steps", "1"]),
                 lambda: prepare_latent_dataset.main(
                     ["--dataset", "synthetic", "--datadir", str(tmp_path), "--vae_ckpt",
                      "vae.bin", "--out", str(tmp_path / "latents")])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert not os.listdir(tmp_path)


def test_kernel_wrappers_take_no_other_device():
    """A wrapper computes the plain version only for a CPU tensor; for any
    other device it launches its kernel or raises (here: a meta tensor)."""
    from lfm_tpu_torch.kernels.dit_block import fused_dit_block
    from lfm_tpu_torch.kernels.dit_block_train import attn_bwd, block_train_fwd, mlp_bwd
    from lfm_tpu_torch.kernels.flash_attention import (attention_small, attention_small_bwd,
                                                       flash_attention, fused_attention)
    from lfm_tpu_torch.kernels.groupnorm_silu import groupnorm_silu
    from lfm_tpu_torch.kernels.int8_matmul import bf16_mlp, int8_dense, int8_mlp, quant_rows

    q = torch.empty(1, 16, 2, 32, dtype=torch.bfloat16, device="meta")
    x = torch.empty(1, 4, 4, 64, dtype=torch.bfloat16, device="meta")
    for call in (lambda: attention_small(q, q, q), lambda: attention_small_bwd(q, q, q, q),
                 lambda: fused_attention(q, q, q), lambda: flash_attention(q, q, q),
                 lambda: groupnorm_silu(x, x[0, 0, 0], x[0, 0, 0])):
        with pytest.raises(ValueError, match="unsupported device"):
            call()
    x = torch.empty(1, 16, 128, dtype=torch.bfloat16, device="meta")
    for call in (lambda: fused_dit_block(x, *([x] * 9), num_heads=4),
                 lambda: block_train_fwd(x, *([x] * 9), num_heads=4),
                 lambda: mlp_bwd(*([x] * 7)),
                 lambda: attn_bwd(*([x] * 8), num_heads=4)):
        with pytest.raises(ValueError, match="unsupported device"):
            call()
    a = torch.empty(16, 128, dtype=torch.bfloat16, device="meta")
    q = torch.empty(128, 128, dtype=torch.int8, device="meta")
    s = torch.empty(128, dtype=torch.float32, device="meta")
    for call in (lambda: quant_rows(a), lambda: int8_dense(a, q, s),
                 lambda: int8_mlp(a, q, s, None, q, s, None),
                 lambda: bf16_mlp(a, a.new_empty(256, 128), a.new_empty(128, 256))):
        with pytest.raises(ValueError, match="unsupported device"):
            call()


def test_chip_smoke_fails_without_cuda_or_the_package(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    res = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and '"ok"' not in res.stdout
    # alone in a directory: no package beside it
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    res = subprocess.run([sys.executable, str(tmp_path / "chip_smoke.py")], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and '"ok"' not in res.stdout
