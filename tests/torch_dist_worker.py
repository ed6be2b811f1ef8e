"""Ranks of the port's distributed CPU tests (tests/test_torch_multihost.py,
test_torch_sharded_fid_dist.py, test_torch_partition.py,
test_torch_dist_train.py), as tests/multihost_worker.py is JAX's.

    python tests/torch_dist_worker.py MODE STORE WORLD RANK OUT

Each rank joins the job over gloo through a ``file://`` store (no fixed
port: the suite runs several files at once), runs MODE's checks and writes
its results to ``OUT/rank{RANK}.pt``. ``launch`` starts the ranks from a
test, without touching the test process's environment; a rank that fails
fails the launch. The builders below are shared with the tests, so that
the ranks and the one-process runs they are held against build the same
models and batches from the same seeds.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

# DiT-T/2-like test model of the partition checks (tests/test_partition.py)
PART_DIT = dict(img_resolution=8, patch_size=2, in_channels=4, hidden_size=128, depth=2,
                num_heads=4, num_classes=1)
# the partition layouts over 4 ranks: JAX's three (tests/test_partition.py:53-57)
# at half the ranks
LAYOUTS = {"fsdp": dict(dp=2, fsdp=2, tp=1, tp_rules="none"),
           "tp": dict(dp=2, fsdp=1, tp=2, tp_rules="dit"),
           "fsdp_tp": dict(dp=1, fsdp=2, tp=2, tp_rules="dit")}
TRAIN_BATCH = 8  # the global batch of the train checks
PREEMPT_EVERY = 2  # preempt_check_every of the preemption check
PREEMPT_RANK, PREEMPT_AT = 1, 1  # the rank that gets SIGTERM, after its step PREEMPT_AT


def launch(mode: str, world: int, out_dir, timeout: float = 300.0, args=()) -> list:
    """Run MODE on ``world`` ranks; returns each rank's results. The ranks'
    environment is a copy of this process's, one thread each."""
    out_dir = str(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    store = os.path.join(out_dir, "store")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    if world == 1:
        args = (*args, free_port())
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), mode, store,
                               str(world), str(r), out_dir, *map(str, args)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    deadline = time.time() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs) or time.time() > deadline:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        logs = [p.communicate() for p in procs]
    for r, (p, (_, err)) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"{mode}: rank {r} exited with {p.returncode}:\n{err[-6000:]}")
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def free_port() -> int:
    """A free TCP port on this machine's loopback address."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------- builders

def fid_config(method: str, batch_size: int = 4, n_sample: int = 5):
    """celeb256_dit's network at test scale: DiT-T/2 on 16x16 latents of 32 px
    images, f32, the module path."""
    from lfm_tpu_torch.core.config import Config, ModelConfig, SampleConfig

    return Config(model=ModelConfig(model_type="DiT-T/2", image_size=32, f=2, num_classes=1),
                  sample=SampleConfig(method=method, num_steps=2, n_sample=n_sample,
                                      batch_size=batch_size, atol=1e-3, rtol=1e-3,
                                      use_fused_dit=False))


def fid_models(weights: str):
    """The DiT, the VAE (block_out (32, 32)) and the Inception state dict
    saved by the test at ``weights``."""
    from lfm_tpu_torch.nn.factory import create_network
    from lfm_tpu_torch.vae.autoencoder_kl import create_vae

    w = torch.load(weights, weights_only=False)
    model = create_network(fid_config("euler").model, use_flash=True, device="cpu")
    model.load_state_dict(w["dit"])
    vae = create_vae((32, 32), device="cpu")
    vae.load_state_dict(w["vae"])
    return model, vae, w["inception"]


def part_model():
    from lfm_tpu_torch.nn.dit import DiT
    from lfm_tpu_torch.nn.init import seeded_init_

    with torch.device("cpu"):
        return seeded_init_(DiT(**PART_DIT), 5)


def part_batch():
    return {"x": np.random.default_rng(1).standard_normal((8, 8, 8, 4)).astype(np.float32)}


def part_step(model, mesh=None):
    """JAX's partition test step: lr 1e-3, no decay, no EMA, scale 1."""
    from lfm_tpu_torch.core.config import TrainConfig
    from lfm_tpu_torch.train.state import make_optimizer
    from lfm_tpu_torch.train.train import make_train_step

    tx = make_optimizer(TrainConfig(lr=1e-3, no_lr_decay=True), 10)
    return make_train_step(model, tx, use_ema=False, scale_factor=1.0, seed=0, mesh=mesh)


def dit_train_model():
    """DiT-T/2 on 8x8 latents, 4 classes with label dropout 0.5, f32."""
    from lfm_tpu_torch.nn.dit import create_dit
    from lfm_tpu_torch.nn.init import seeded_init_

    return seeded_init_(create_dit("DiT-T/2", img_resolution=8, num_classes=4,
                                   label_dropout=0.5, use_flash=True, device="cpu"), 7)


def unet_train_model():
    """imnet_adm's DhariwalUNet at test scale with dropout 0.3 and label
    dropout 0.5, f32, on 8x8 latents."""
    import dataclasses

    from lfm_tpu_torch.core.config import get_preset
    from lfm_tpu_torch.nn.factory import create_network
    from lfm_tpu_torch.nn.init import seeded_init_

    m = dataclasses.replace(get_preset("imnet_adm").model, image_size=64, nf=32,
                            ch_mult=(1, 2), attn_resolutions=(4,), num_res_blocks=1,
                            num_classes=4, label_dim=4, dropout=0.3, label_dropout=0.5)
    return seeded_init_(create_network(m, device="cpu"), 8), m


def train_batch(labels: bool):
    rng = np.random.default_rng(11)
    b = {"x": rng.standard_normal((TRAIN_BATCH, 8, 8, 4)).astype(np.float32)}
    if labels:
        b["y"] = rng.integers(4, size=(TRAIN_BATCH,)).astype(np.int64)
    return b


def model_step(model, mesh=None, *, dropout: bool = False):
    from lfm_tpu_torch.core.config import TrainConfig
    from lfm_tpu_torch.train.state import make_optimizer
    from lfm_tpu_torch.train.train import make_train_step

    tx = make_optimizer(TrainConfig(lr=1e-3, no_lr_decay=True, weight_decay=0.01), 10)
    return make_train_step(model, tx, ema_decay=0.9, is_latent_data=True, scale_factor=0.5,
                           label_dropout=True, dropout=dropout, seed=3, mesh=mesh)


def loop_config(out_dir: str, name: str, **train_kw):
    """The loop checks: DiT-T/2 on 32 px synthetic images through a small
    VAE (16x16 latents), global batch 8."""
    from lfm_tpu_torch.core.config import Config, ModelConfig, TrainConfig

    kw = dict(batch_size=TRAIN_BATCH, num_epoch=0, lr=1e-3, no_lr_decay=True, use_ema=True,
              ema_decay=0.9, save_content=False, seed=3, preempt_check_every=PREEMPT_EVERY)
    kw.update(train_kw)
    return Config(exp=name, dataset="synthetic", output_dir=out_dir,
                  model=ModelConfig(model_type="DiT-T/2", image_size=32, f=2, num_classes=1),
                  train=TrainConfig(**kw))


def loop_data():
    from lfm_tpu_torch.data import SyntheticImageDataset
    from lfm_tpu_torch.nn.init import seeded_init_
    from lfm_tpu_torch.vae.autoencoder_kl import create_vae

    vae = seeded_init_(create_vae((32, 32), device="cpu"), 9)
    return SyntheticImageDataset(n=4 * TRAIN_BATCH, image_size=32, seed=4), vae


def state_arrays(state):
    return {k: [t.detach().clone() for t in getattr(state, k)]
            for k in ("params", "mu", "nu", "ema")} | {"step": state.step,
                                                        "count": state.count}


# ------------------------------------------------------------------- modes

def run_helpers(rank, world, out):
    from lfm_tpu_torch.core import multihost
    from lfm_tpu_torch.core.sharding import make_mesh, shard_batch

    res = {"index": multihost.process_index(), "count": multihost.process_count(),
           "main": multihost.is_main_process(), "shard": multihost.data_shard(),
           "sync": multihost.sync_hosts(),
           "any_one": multihost.any_process_flag(rank == world - 1),
           "any_none": multihost.any_process_flag(False),
           "any_all": multihost.any_process_flag(True)}
    multihost.initialize("file:///nowhere", world, rank)  # joined already: a no-op
    mesh = make_mesh(dp=-1)
    res["mesh_coords"] = mesh.coords
    res["data_group"] = mesh.group("data") is not None
    res["rows"] = shard_batch(mesh, {"x": np.arange(2 * world)})["x"].tolist()
    if world % 2 == 0:
        m2 = make_mesh(dp=-1, tp=2)
        res["tp_mesh"] = (m2.shape, m2.coords)
        res["tp_data_group"] = m2.group("data") is not None
        res["tp_rows"] = shard_batch(m2, np.arange(world)).tolist()
    out.update(res)


def run_fid(rank, world, out, weights):
    from lfm_tpu_torch.core.sharding import make_mesh
    from lfm_tpu_torch.sample import sharded

    model, vae, inception = fid_models(weights)
    save_dir = os.path.join(os.path.dirname(weights), f"jpg_rank{rank}")
    out["acts"] = sharded.generate_fid_activations(
        fid_config("euler"), model, None, vae, None, inception, save_dir=save_dir,
        device="cpu")
    out["saved"] = sorted(os.listdir(save_dir)) if os.path.isdir(save_dir) else None
    step_fn, n_steps, gb = sharded.make_sharded_generator(
        fid_config("euler", batch_size=5), model, None, device="cpu")
    out["arith"] = (n_steps, gb)
    # dopri5 without the VAE: the latents, and the shared step control's NFE
    step_fn, n_steps, gb = sharded.make_sharded_generator(fid_config("dopri5"), model, None,
                                                          mesh=make_mesh(), device="cpu")
    out["dopri5"] = [step_fn(s) for s in range(n_steps)]


def run_partition(rank, world, out):
    import copy

    from lfm_tpu_torch.core.partition import combined_shardings, shard_params
    from lfm_tpu_torch.core.sharding import TENSOR_AXIS, make_mesh, shard_batch
    from lfm_tpu_torch.nn.layers import linear
    from lfm_tpu_torch.train.state import create_train_state

    for name, layout in LAYOUTS.items():
        layout = dict(layout)
        tp_rules = layout.pop("tp_rules")
        mesh = make_mesh(**layout)
        model = part_model()
        full = copy.deepcopy(model)
        part = shard_params(model, combined_shardings(model, mesh, tp_rules=tp_rules,
                                                      fsdp_min_size=1024), mesh)
        res = {"coords": mesh.coords, "heads": [b.attn.num_heads for b in model.blocks]}
        if mesh.shape[TENSOR_AXIS] > 1:
            # the rank's qkv product holds whole heads of q, k and v
            x = torch.from_numpy(np.random.default_rng(2).standard_normal(
                (1, 16, PART_DIT["hidden_size"])).astype(np.float32))
            with torch.no_grad():
                local = linear(x, model.blocks[0].attn.qkv, torch.float32)
                whole = linear(x, full.blocks[0].attn.qkv, torch.float32)
            c, h, t = PART_DIT["hidden_size"], PART_DIT["num_heads"], mesh.shape[TENSOR_AXIS]
            d, r = c // h, mesh.coords[TENSOR_AXIS]
            want = torch.cat([third.reshape(1, 16, h, d)[:, :, r * h // t:(r + 1) * h // t]
                              .reshape(1, 16, -1) for third in whole.split(c, dim=-1)], dim=-1)
            res["qkv_heads_err"] = float((local - want).abs().max())
            res["qkv_width"] = local.shape[-1]
        state = create_train_state(model, part)
        batch = {"x": torch.from_numpy(shard_batch(mesh, part_batch())["x"])}
        loss, gnorm = part_step(model, mesh)(state, batch)
        res.update(loss=float(loss), gnorm=float(gnorm), params=part.full(state.params),
                   master_shapes=[tuple(p.shape) for p in state.params])
        out[name] = res


def run_train(rank, world, out):
    import shutil

    from lfm_tpu_torch.core import checkpoint as ckpt
    from lfm_tpu_torch.core.sharding import make_mesh, shard_batch
    from lfm_tpu_torch.train import loop as loop_mod
    from lfm_tpu_torch.train.state import create_train_state

    mesh = make_mesh()
    # the module steps: a DiT with label dropout, a UNet with dropout too
    for name, build, dropout in (("dit", lambda: (dit_train_model(), None), False),
                                 ("unet", unet_train_model, True)):
        model, _ = build()
        state = create_train_state(model)
        step = model_step(model, mesh, dropout=dropout)
        batch = {k: torch.from_numpy(v) for k, v in
                 shard_batch(mesh, train_batch(True)).items()}
        steps = [step(state, batch) for _ in range(2)]
        out[name] = {"losses": [float(s[0]) for s in steps],
                     "gnorms": [float(s[1]) for s in steps], **state_arrays(state)}

    # the loop through the VAE, two steps
    work = out["dir"]
    dataset, vae = loop_data()
    state = loop_mod.train(loop_config(work, "loop"), dataset=dataset, vae=vae,
                           device="cpu", max_steps=2)
    out["loop"] = state_arrays(state)

    # preemption: SIGTERM on one rank, every rank saves at the next check
    real = loop_mod.make_train_step

    def signalling(*a, **k):
        step = real(*a, **k)

        def wrapped(state, batch):
            res = step(state, batch)
            if rank == PREEMPT_RANK and state.step == PREEMPT_AT:
                os.kill(os.getpid(), signal.SIGTERM)
            return res

        return wrapped

    loop_mod.make_train_step = signalling
    cfg = loop_config(work, "preempt", num_epoch=5)
    try:
        pre = loop_mod.train(cfg, dataset=dataset, vae=vae, device="cpu")
    finally:
        loop_mod.make_train_step = real
    out["preempt"] = {"step": pre.step, "files": sorted(os.listdir(cfg.exp_path)),
                      "content": ckpt.load_content(cfg.exp_path) if rank == 0 else None}
    if rank == 0:  # a copy for the one-process resume in the test
        shutil.copy(os.path.join(cfg.exp_path, ckpt.CONTENT),
                    os.path.join(work, "preempt_content.pth"))
    # resume on every rank, one step on
    res = loop_mod.train(cfg, dataset=dataset, vae=vae, device="cpu", max_steps=pre.step + 1)
    out["resumed"] = state_arrays(res)


# --------------------------------------------- sequence / pipeline parallel
# (tests/test_torch_ring.py, test_torch_pp.py, test_torch_sp_unet.py: the
# test writes the inputs and the JAX-converted state dicts to INPUTS, and
# holds what the ranks return against JAX)

# the CLI's sample at test scale (tests/test_torch_cli_eval.py's DiT flags)
CLI_SAMPLE_FLAGS = ["--preset", "celeb256_dit", "--model_type", "DiT-T/2", "--image_size", "32",
                    "--method", "euler", "--steps", "2", "--batch_size", "4", "--device", "cpu"]
CLI_MESH_FLAGS = {"cli_sp": ["--sp", "2"], "cli_pp": ["--pp", "2", "--pp_chunks", "1"]}


# the pp train step's seed: its t and z1 come from seeded_generator(seed, 0)
PP_STEP_SEED = 7


def tiny_pp_dit(depth=4, **kw):
    """tests/test_pp.py's tiny_dit as the port's module."""
    from lfm_tpu_torch.nn.dit import DiT

    kw = {**dict(img_resolution=8, patch_size=2, in_channels=4, hidden_size=64, num_heads=4,
                 num_classes=1), **kw}
    with torch.device("cpu"):
        return DiT(depth=depth, **kw).eval()


def run_ring(rank, world, out, inputs):
    from lfm_tpu_torch.core.config import Config, ModelConfig, SampleConfig
    from lfm_tpu_torch.core.ring import ring_attention
    from lfm_tpu_torch.core.sharding import SEQ_AXIS, make_mesh
    from lfm_tpu_torch.nn.dit import create_dit
    from lfm_tpu_torch.sample.sample import make_sampler
    from lfm_tpu_torch.sample.sp import make_sp_apply, sp_block, sp_gather

    inp = torch.load(inputs, weights_only=False)
    for dp, sp in ((1, 4), (2, 2)):
        mesh = make_mesh(dp=dp, sp=sp)
        q, k, v = (sp_block(mesh, inp["qkv"][i]) for i in range(3))
        out[f"ring_{dp}x{sp}"] = sp_gather(mesh, ring_attention(q, k, v, mesh.group(SEQ_AXIS)))
    mesh = make_mesh(dp=1, sp=4)
    q, k, v = (sp_block(mesh, inp["grad_qkv"][i]).requires_grad_() for i in range(3))
    co = sp_block(mesh, inp["grad_co"])
    (ring_attention(q, k, v, mesh.group(SEQ_AXIS)) * co).sum().backward()
    out["ring_grads"] = [sp_gather(mesh, a.grad) for a in (q, k, v)]

    mesh = make_mesh(dp=2, sp=2)
    model = create_dit("DiT-T/2", img_resolution=16, num_classes=10, device="cpu").eval()
    model.load_state_dict(inp["dit"])
    start, stop = mesh.coords["data"] * 4, (mesh.coords["data"] + 1) * 4
    with torch.no_grad():
        got = make_sp_apply(model, mesh)(inp["t"][start:stop], sp_block(mesh, inp["x"]),
                                         inp["y"][start:stop])
    out["sp_dit"] = sp_gather(mesh, got)
    from lfm_tpu_torch.nn.layers import row_shard

    out["row_shard_after"] = row_shard()

    model = create_dit("DiT-T/2", img_resolution=16, num_classes=10, label_dropout=0.1,
                       device="cpu")
    config = Config(model=ModelConfig(model_type="DiT-T/2", image_size=128, num_classes=10),
                    sample=SampleConfig(method="euler", num_steps=4, cfg_scale=1.5,
                                        use_fused_dit=False))
    sampler = make_sampler(config, model, inp["dit_cfg"], device="cpu", sp_mesh=mesh)
    out["sp_sampler"] = sampler(inp["noise"], inp["labels"]).latents

    # the CLI's sample over the ranks: --sp 2 (dp 2) and --pp 2 (dp 2), rank 0 writes
    from lfm_tpu_torch.cli import main as cli

    for name, flags in CLI_MESH_FLAGS.items():
        path = os.path.join(out["dir"], f"{name}.npy")
        got = cli.main(["sample", *CLI_SAMPLE_FLAGS, *flags, "--out", path,
                        "--coordinator", "file:///unused", "--num_procs", str(world),
                        "--process_id", str(rank)])
        out[name] = (got, os.path.isfile(path) if rank == 0 else None)


def run_pp(rank, world, out, inputs):
    import dataclasses

    from lfm_tpu_torch.core import checkpoint as ckpt
    from lfm_tpu_torch.core.config import (Config, MeshConfig, ModelConfig, SampleConfig,
                                           TrainConfig)
    from lfm_tpu_torch.core.sharding import make_mesh
    from lfm_tpu_torch.sample import pp as tpp
    from lfm_tpu_torch.sample.sample import make_sampler
    from lfm_tpu_torch.train import loop as loop_mod
    from lfm_tpu_torch.train.state import create_train_state, make_optimizer
    from lfm_tpu_torch.train.train import make_train_step

    inp = torch.load(inputs, weights_only=False)
    # GPipe forward (S = 4) and with labels and two microbatches (dp 2 x S 2)
    for name, (dp, pp), kw, mb in (("gpipe", (1, 4), {}, None),
                                   ("labels_mb", (2, 2), dict(num_classes=10), 2)):
        mesh = make_mesh(dp=dp, pp=pp)
        model = tiny_pp_dit(**kw)
        model.load_state_dict(inp[f"{name}_sd"])
        tpp.place_stage_blocks_(model, mesh)
        rows = slice(mesh.coords["data"] * 8 // dp, (mesh.coords["data"] + 1) * 8 // dp)
        y = None if "num_classes" not in kw else inp[f"{name}_y"][rows]
        with torch.no_grad():
            out[name] = tpp.make_pp_apply(model, mesh, num_microbatches=mb)(
                inp[f"{name}_t"][rows], inp[f"{name}_x"][rows], y)
        out[f"{name}_rows"] = (rows.start, rows.stop)
        out[f"{name}_blocks"] = model.pp_blocks[0]

    # gradients: GPipe at S = 4, and interleaved at S = 2 x 2 chunks (dp 2)
    for name, (dp, pp), chunks, depth in (("grads", (1, 4), 1, 4),
                                          ("il", (2, 2), 2, 8)):
        mesh = make_mesh(dp=dp, pp=pp)
        model = tiny_pp_dit(depth=depth, hidden_size=32, num_heads=2)
        model.load_state_dict(inp[f"{name}_sd"])
        tpp.place_stage_blocks_(model, mesh, chunks)
        n = inp[f"{name}_x"].shape[0] // dp
        rows = slice(mesh.coords["data"] * n, (mesh.coords["data"] + 1) * n)
        apply = tpp.make_pp_apply(model, mesh, has_labels=False, num_chunks=chunks)
        v = apply(inp[f"{name}_t"][rows], inp[f"{name}_x"][rows])
        (v * inp[f"{name}_co"][rows]).sum().backward()
        names = [nm for nm, _ in model.named_parameters()]
        grads = [p.grad for _, p in model.named_parameters()]
        out[name] = {"out": v.detach(), "rows": (rows.start, rows.stop),
                     "grads": tpp.gather_canonical(model, mesh, names, grads)}

    # one train step through the pipeline (dp 2 x S 2) against one process
    mesh = make_mesh(dp=2, pp=2)
    tc = TrainConfig(lr=1e-3, no_lr_decay=True, use_ema=True)
    steps = {}
    for name in ("plain", "pp"):
        model = tiny_pp_dit(hidden_size=32, num_heads=2, remat=True)
        model.load_state_dict(inp["step_sd"])
        model.train()
        batch = {"x": inp["step_x"]}
        kw = {}
        if name == "pp":
            tpp.place_stage_blocks_(model, mesh)
            kw = dict(model_apply=tpp.make_pp_apply(model, mesh, train=True), mesh=mesh)
            batch = {"x": inp["step_x"][mesh.coords["data"] * 4:(mesh.coords["data"] + 1) * 4]}
        state = create_train_state(model)
        if name == "pp":
            state.norm_groups = tpp.pipe_norm_groups(state.names, mesh)
        step = make_train_step(model, make_optimizer(tc, 10), use_ema=True, scale_factor=1.0,
                               is_latent_data=True, seed=PP_STEP_SEED, **kw)
        loss, gnorm = step(state, batch)
        params = (tpp.gather_canonical(model, mesh, state.names, state.params) if name == "pp"
                  else dict(zip(state.names, state.params)))
        steps[name] = {"loss": float(loss), "gnorm": float(gnorm),
                       "params": {k: v.detach().clone() for k, v in params.items()}}
    out["step"] = steps

    # the sampler: GPipe with CFG (dp 2 x S 2), interleaved at 2 chunks
    config = Config(model=ModelConfig(model_type="DiT-T/2", image_size=64, num_classes=10),
                    sample=SampleConfig(method="euler", num_steps=4, cfg_scale=1.5,
                                        use_fused_dit=False))
    model = tiny_pp_dit(hidden_size=32, num_heads=2, num_classes=10, label_dropout=0.1)
    out["sampler"] = make_sampler(config, model, inp["sampler_sd"], device="cpu",
                                  pp_mesh=mesh)(inp["sampler_x"], inp["sampler_y"]).latents
    il_config = dataclasses.replace(config, mesh=MeshConfig(pp=2, pp_chunks=2),
                                    model=dataclasses.replace(config.model, num_classes=1))
    model = tiny_pp_dit(depth=8, hidden_size=32, num_heads=2)
    out["sampler_il"] = make_sampler(il_config, model, inp["sampler_il_sd"], device="cpu",
                                     pp_mesh=mesh)(inp["sampler_il_x"]).latents

    # the loop: pp=2 x 2 chunks (dp 2) for an epoch, a resume for the next,
    # against the data-parallel run over the four ranks
    work = out["dir"]

    def cfg(exp, mesh_cfg, num_epoch=1, resume=False):
        return Config(exp=exp, dataset="synthetic_latent", output_dir=work,
                      model=ModelConfig(model_type="DiT-T4/2", image_size=64, num_classes=1),
                      mesh=mesh_cfg,
                      train=TrainConfig(batch_size=8, num_epoch=num_epoch, lr=1e-3,
                                        no_lr_decay=True, use_ema=True, save_content=True,
                                        save_content_every=1, save_ckpt_every=1,
                                        plot_every=100, precision="f32", resume=resume))

    from lfm_tpu_torch.data import SyntheticLatentDataset

    quiet = lambda *a, **k: None  # noqa: E731
    data = SyntheticLatentDataset(n=16, latent_size=8, seed=100)
    plain = loop_mod.train(cfg("pp_plain", MeshConfig()), dataset=data, device="cpu",
                           log_fn=quiet)
    pp_cfg = MeshConfig(pp=2, pp_chunks=2)
    pp1 = loop_mod.train(cfg("pp_il", pp_cfg, num_epoch=0), dataset=data, device="cpu",
                         log_fn=quiet)
    content_1 = (ckpt.load_content(cfg("pp_il", pp_cfg).exp_path)["model_dict"]
                 if rank == 0 else None)
    pp2 = loop_mod.train(cfg("pp_il", pp_cfg, num_epoch=1, resume=True), dataset=data,
                         device="cpu", log_fn=quiet)
    out["loop"] = {"plain": state_arrays(plain), "pp1_step": pp1.step, "pp2": state_arrays(pp2),
                   "names": (plain.names, pp2.names), "content_1": content_1,
                   "exp": cfg("pp_il", pp_cfg).exp_path}


def run_sp_unet(rank, world, out, inputs):
    from lfm_tpu_torch.core.config import Config, ModelConfig, SampleConfig
    from lfm_tpu_torch.core.sharding import make_mesh
    from lfm_tpu_torch.nn.adm_unet import UNetModel
    from lfm_tpu_torch.nn.edm_unet import DhariwalUNet
    from lfm_tpu_torch.sample.sample import make_sampler
    from lfm_tpu_torch.sample.sp import make_spatial_sp_apply, sp_block, sp_gather

    inp = torch.load(inputs, weights_only=False)
    for name, build, (dp, sp) in inp["cases"]:
        mesh = make_mesh(dp=dp, sp=sp)
        with torch.device("cpu"):
            model = (UNetModel if build[0] == "adm" else DhariwalUNet)(**build[1]).eval()
        model.load_state_dict(inp[f"{name}_sd"])
        n = inp["x"].shape[0] // dp
        rows = slice(mesh.coords["data"] * n, (mesh.coords["data"] + 1) * n)
        y = None if inp.get(f"{name}_y") is None else inp[f"{name}_y"][rows]
        with torch.no_grad():
            got = make_spatial_sp_apply(model, mesh)(inp["t"][rows], sp_block(mesh, inp["x"]),
                                                     y)
        out[name] = sp_gather(mesh, got)
    mesh = make_mesh(dp=2, sp=2)
    with torch.device("cpu"):
        model = UNetModel(**inp["sampler_kw"]).eval()
    config = Config(model=ModelConfig(model_type="adm", image_size=128, num_classes=1, nf=32),
                    sample=SampleConfig(method="euler", num_steps=4))
    out["sampler"] = make_sampler(config, model, inp["sampler_sd"], device="cpu",
                                  sp_mesh=mesh)(inp["x"]).latents
    # a level whose rows do not split: 12 rows over sp=4 are 3 a rank
    mesh = make_mesh(dp=1, sp=4)
    try:
        make_spatial_sp_apply(model, mesh)(inp["t"][:1], sp_block(mesh, inp["x"][:1, :12]))
    except ValueError as e:
        out["odd_rows"] = str(e)


def main():
    mode, store, world, rank, out_dir = sys.argv[1:6]
    world, rank = int(world), int(rank)
    torch.set_num_threads(1)
    from lfm_tpu_torch.core import multihost

    if world == 1:  # one rank joins only through torchrun's environment, as in JAX
        os.environ.update(RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                          MASTER_PORT=sys.argv[-1])  # launch's last argument
        multihost.initialize(device="cpu")
    else:
        multihost.initialize(f"file://{store}", world, rank, device="cpu")
    out = {"dir": out_dir}
    if mode == "helpers":
        run_helpers(rank, world, out)
    elif mode == "fid":
        run_fid(rank, world, out, sys.argv[6])
    elif mode == "partition":
        run_partition(rank, world, out)
    elif mode == "train":
        run_train(rank, world, out)
    elif mode == "ring":
        run_ring(rank, world, out, sys.argv[6])
    elif mode == "pp":
        run_pp(rank, world, out, sys.argv[6])
    elif mode == "sp_unet":
        run_sp_unet(rank, world, out, sys.argv[6])
    else:
        raise ValueError(mode)
    multihost.sync_hosts()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    multihost.shutdown()


if __name__ == "__main__":
    main()
