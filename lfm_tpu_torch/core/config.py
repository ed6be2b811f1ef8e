"""Configuration tree for lfm_tpu_torch (a copy of lfm_tpu/core/config.py).

A single dataclass config replaces the reference's per-entry-point argparse
(~40 flags, reference train_flow_latent.py:220-338 / test_flow_latent.py:302-407)
and the sourced shell argfiles (reference test_args/*.txt, bash_scripts/run.sh).
The preset registry mirrors every released configuration 1:1 (same MODEL_TYPE /
METHOD / STEPS / CH_MULT / ATTN_RES / CFG knobs) so a reference user can address
experiments by the same names (celeb_f8_dit, imnet_f8_ditb2, ...).

The port keeps its own copy so that it never imports ``lfm_tpu``. The DiT
and ADM presets are here; of the ADM ones, ``use_origin_adm`` builds the
origin-ADM UNet (celeb256_adm, celeb512_adm, church_adm) and the others
EDM's DhariwalUNet (ffhq_adm, bed_adm, imnet_adm).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Velocity-network configuration (reference models/__init__.py:6-70)."""

    model_type: str = "adm"  # adm | ncsn++ | ddpm++ | DiT-{S,B,L,XL}/{2,4,8}
    image_size: int = 256  # pixel-space size; latent size = image_size // f
    f: int = 8  # VAE downsampling factor
    num_in_channels: int = 4
    num_out_channels: int = 4
    nf: int = 256  # base channel count for UNets
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = (16,)
    ch_mult: Tuple[int, ...] = (1, 2, 2, 2)
    dropout: float = 0.0
    label_dim: int = 0  # 0 => unconditional
    augment_dim: int = 0
    num_classes: Optional[int] = None
    label_dropout: float = 0.0
    # ADM-specific flags (reference train_flow_latent.py:289-299)
    use_origin_adm: bool = False
    layout: bool = False
    use_scale_shift_norm: bool = True
    resblock_updown: bool = False
    use_new_attention_order: bool = False
    resamp_with_conv: bool = True
    num_heads: int = 4
    num_head_upsample: int = -1
    num_head_channels: int = -1
    # Context conditioning (layout / semantic synthesis)
    context_dim: Optional[int] = None
    transformer_depth: int = 1
    # attention through kernels/flash_attention.attention_small (the CUDA
    # kernel on a CUDA tensor, its plain version on a CPU tensor)
    use_flash_attention: bool = True

    @property
    def latent_size(self) -> int:
        return self.image_size // self.f

    @property
    def is_dit(self) -> bool:
        return "DiT" in self.model_type


@dataclass(frozen=True)
class SampleConfig:
    """Sampling / evaluation configuration (reference test_flow_latent.py:302-407)."""

    method: str = "dopri5"  # dopri5|dopri8|adaptive_heun|bosh3|euler|midpoint|rk4|heun
    num_steps: int = 40  # fixed-step solvers only (STEPS in argfiles)
    atol: float = 1e-5
    rtol: float = 1e-5
    step_size: float = 0.01
    perturb: bool = False
    use_karras_samplers: bool = False
    # fused DiT block kernel for sampling (nn/dit_fused.py); ignored for
    # non-DiT or f32 models
    use_fused_dit: bool = True
    # w8a8 int8 DiT sampling (nn/dit_int8.py); wins over use_fused_dit,
    # ignored for non-DiT models
    use_int8_dit: bool = False
    # adaptive-solver noise floor: None = per-method policy (auto only for
    # bf16 dopri8; see sample.resolve_eval_noise), or a float / "auto"
    eval_noise: Optional[Any] = None
    cfg_scale: float = 1.0
    generator: str = "determ"  # dummy | determ | determ-indiv
    seed: int = 42
    n_sample: int = 50000
    batch_size: int = 200
    compute_fid: bool = False
    compute_nfe: bool = False
    measure_time: bool = False
    epoch_id: int = 1000
    real_img_dir: str = ""
    output_log: str = ""
    solver_dtype: str = "float32"  # controller dtype (f64 when the noise is f64)


@dataclass(frozen=True)
class TrainConfig:
    """Training configuration (reference train_flow_latent.py:220-338)."""

    seed: int = 1024
    lr: float = 5e-4
    beta1: float = 0.5
    beta2: float = 0.9
    weight_decay: float = 0.0
    batch_size: int = 128  # global batch size across the mesh
    num_epoch: int = 1200
    no_lr_decay: bool = False
    lr_min: float = 1e-5  # eta_min of cosine schedule
    use_ema: bool = False
    ema_decay: float = 0.9999
    use_grad_checkpointing: bool = False
    # selective remat (nn/dit.py::REMAT_POLICIES): None = full-block
    # recompute; "dots" = save Dense outputs, recompute elementwise +
    # attention; "all_dots" = also the batched products; "dots_attn" =
    # "dots" + the attention output (the attention runs once)
    remat_policy: Optional[str] = None
    save_content: bool = False
    save_content_every: int = 10
    save_ckpt_every: int = 25
    plot_every: int = 5
    resume: bool = False
    model_ckpt: Optional[str] = None
    precision: str = "bf16"  # compute dtype policy: bf16 | f32
    steps_per_epoch: int = 0  # 0 => derive from dataset length
    # multi-process preemption-flag all-reduce cadence, in steps. Must be
    # identical on every rank (it gates a collective), hence config-derived
    # — never wall-clock. The worst-case reaction lag to SIGTERM is
    # (cadence x step time): lower it for slow-step configs (512px ADM,
    # pipeline schedules at ~1 s/step) so the content checkpoint lands
    # inside the preemption grace window; the check itself is one scalar
    # all-reduce (~ms).
    preempt_check_every: int = 25


@dataclass(frozen=True)
class DataConfig:
    """Dataset configuration (reference datasets_prep/__init__.py:10-122)."""

    dataset: str = "cifar10"
    datadir: str = "./data"
    num_workers: int = 4
    # downstream-task knobs
    mask_kind: str = "mixed"  # inpainting mask generator
    num_seg_classes: int = 0  # semantic synthesis: one-hot channels
    cond_size: int = 32  # conditioner output spatial size


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout. The reference supports DP only (SURVEY.md §2.3);
    the JAX package adds dp/fsdp/tp/sp/pp axes; the port keeps the fields."""

    dp: int = -1  # -1 => all devices
    fsdp: int = 1
    tp: int = 1
    sp: int = 1  # sequence parallelism (core/ring.py ring attention)
    pp: int = 1  # pipeline parallelism (core/pipeline.py block stages)
    # virtual stages per device for pp > 1: the interleaved schedule
    # (core/pipeline.py::pipeline_blocks, num_chunks) divides the pipeline
    # bubble by pp_chunks; params are permuted to placement order internally
    # (checkpoints stay canonical — sample/pp.py::permute_state_blocks)
    pp_chunks: int = 1


@dataclass(frozen=True)
class Config:
    exp: str = "experiment_default"
    dataset: str = "cifar10"
    scale_factor: float = 0.18215
    pretrained_autoencoder_ckpt: str = "stabilityai/sd-vae-ft-mse"
    model: ModelConfig = field(default_factory=ModelConfig)
    sample: SampleConfig = field(default_factory=SampleConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    output_dir: str = "./saved_info/latent_flow"

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    @property
    def exp_path(self) -> str:
        # mirrors reference train_flow_latent.py:94-96
        return f"{self.output_dir}/{self.dataset}/{self.exp}"


def _dit(model_type: str, **kw) -> ModelConfig:
    return ModelConfig(model_type=model_type, **kw)


def _adm(ch_mult, attn_res, origin=True, **kw) -> ModelConfig:
    return ModelConfig(
        model_type="adm",
        use_origin_adm=origin,
        ch_mult=tuple(ch_mult),
        attn_resolutions=tuple(attn_res),
        **kw,
    )


# ---------------------------------------------------------------------------
# Preset registry — one entry per released configuration
# (reference test_args/*.txt + readme.md:101-185 checkpoint table).
# ---------------------------------------------------------------------------

PRESETS: dict[str, Config] = {
    # --- DiT family -------------------------------------------------------
    "celeb256_dit": Config(
        exp="celeb_f8_dit",
        dataset="celeba_256",
        model=_dit("DiT-L/2", image_size=256, num_classes=1),
        sample=SampleConfig(epoch_id=475),
        train=TrainConfig(batch_size=32, num_epoch=500, lr=2e-4, no_lr_decay=True,
                          use_ema=True, use_grad_checkpointing=True),
    ),
    "ffhq_dit": Config(
        exp="ffhq_f8_dit",
        dataset="ffhq_256",
        model=_dit("DiT-L/2", image_size=256, num_classes=1),
        sample=SampleConfig(epoch_id=475),
        train=TrainConfig(batch_size=32, num_epoch=500, lr=2e-4, no_lr_decay=True,
                          use_ema=True, use_grad_checkpointing=True),
    ),
    "bed_dit": Config(
        exp="bed_f8_dit",
        dataset="lsun_bedroom",
        model=_dit("DiT-L/2", image_size=256, num_classes=1),
        sample=SampleConfig(epoch_id=550),
        train=TrainConfig(batch_size=32, num_epoch=800, lr=1e-4, no_lr_decay=True,
                          use_ema=True, use_grad_checkpointing=True),
    ),
    "church_dit": Config(
        exp="church_f8_dit",
        dataset="lsun_church",
        model=_dit("DiT-L/2", image_size=256, num_classes=1),
        sample=SampleConfig(epoch_id=575),
        train=TrainConfig(batch_size=32, num_epoch=800, lr=1e-4, no_lr_decay=True,
                          use_ema=True, use_grad_checkpointing=True),
    ),
    "imnet_dit": Config(
        exp="imnet_f8_ditb2",
        dataset="imagenet_256",
        model=_dit(
            "DiT-B/2", image_size=256, num_classes=1000, label_dim=1000, label_dropout=0.1
        ),
        sample=SampleConfig(epoch_id=875, cfg_scale=1.5),
        train=TrainConfig(
            batch_size=160, num_epoch=1000, lr=1e-4, no_lr_decay=True,
            use_grad_checkpointing=True, use_ema=True,
        ),
    ),
    # --- ADM family -------------------------------------------------------
    "celeb256_adm": Config(
        exp="celeb256_f8_adm",
        dataset="celeba_256",
        model=_adm((1, 2, 2, 2), (16, 8), origin=True, image_size=256),
        sample=SampleConfig(epoch_id=450),
        train=TrainConfig(batch_size=112, num_epoch=500, lr=2e-5, use_ema=True),
    ),
    "celeb512_adm": Config(
        exp="celeb512_f8_adm",
        dataset="celeba_512",
        model=_adm((1, 2, 2, 2, 4), (16, 8), origin=True, image_size=512),
        sample=SampleConfig(epoch_id=425, batch_size=16),
        train=TrainConfig(batch_size=24, num_epoch=500, lr=2e-5, use_ema=True, precision="bf16"),
    ),
    "ffhq_adm": Config(
        exp="ffhq_f8_adm",
        dataset="ffhq_256",
        model=_adm((1, 2, 3, 4), (16, 8, 4), origin=False, image_size=256),
        sample=SampleConfig(epoch_id=400),
        train=TrainConfig(batch_size=128, num_epoch=500, lr=2e-5, use_ema=True),
    ),
    "bed_adm": Config(
        exp="bed_f8_adm",
        dataset="lsun_bedroom",
        model=_adm((1, 2, 3, 4), (16, 8, 4), origin=False, image_size=256),
        sample=SampleConfig(epoch_id=425),
        train=TrainConfig(batch_size=128, num_epoch=500, lr=1e-5, no_lr_decay=True, use_ema=True),
    ),
    "church_adm": Config(
        exp="church_f8_adm",
        dataset="lsun_church",
        model=_adm((1, 2, 3, 4), (16, 8), origin=True, image_size=256),
        sample=SampleConfig(epoch_id=425),
        train=TrainConfig(batch_size=128, num_epoch=500, lr=2e-5, use_ema=True),
    ),
    "imnet_adm": Config(
        exp="imnet_f8_adm",
        dataset="imagenet_256",
        model=_adm(
            (1, 2, 3, 4), (16, 8, 4), origin=False, image_size=256,
            num_classes=1000, label_dim=1000,
        ),
        sample=SampleConfig(epoch_id=1125, cfg_scale=1.25),
        train=TrainConfig(batch_size=96, num_epoch=1200, lr=1e-4, no_lr_decay=True, use_ema=True),
    ),
}

# Aliases matching the argfile basenames exactly.
PRESETS["celeb_f8_dit"] = PRESETS["celeb256_dit"]
PRESETS["imnet_f8_ditb2"] = PRESETS["imnet_dit"]


def get_preset(name: str) -> Config:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(PRESETS)}")
    return PRESETS[name]


def load_argfile(path: str) -> Config:
    """Parse a reference-style shell argfile (test_args/*.txt: KEY=VALUE lines)
    into a Config, for drop-in compatibility with `bash run_test.sh <argfile>`."""
    kv: dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            k, v = line.split("=", 1)
            kv[k.strip()] = v.strip().strip('"')

    model_type = kv.get("MODEL_TYPE", "adm")
    image_size = int(kv.get("IMG_SIZE", 256))
    use_origin = kv.get("USE_ORIGIN_ADM", "false").lower() == "true"
    ch_mult = tuple(int(c) for c in kv.get("CH_MULT", "1 2 2 2").split())
    attn_res = tuple(int(c) for c in kv.get("ATTN_RES", "16").split())
    cfg_scale = float(kv.get("CFG", 1.0))
    dataset = kv.get("DATASET", "cifar10")
    num_classes = 1000 if "imagenet" in dataset else None

    model = ModelConfig(
        model_type=model_type,
        image_size=image_size,
        use_origin_adm=use_origin,
        ch_mult=ch_mult,
        attn_resolutions=attn_res,
        num_classes=num_classes,
        label_dim=1000 if num_classes else 0,
        label_dropout=0.1 if (num_classes and "DiT" in model_type) else 0.0,
    )
    sample = SampleConfig(
        method=kv.get("METHOD", "dopri5"),
        num_steps=int(kv.get("STEPS", 0) or 0) or 40,
        use_karras_samplers=int(kv.get("STEPS", 0) or 0) > 0,
        cfg_scale=cfg_scale,
        epoch_id=int(kv.get("EPOCH_ID", 0) or 0),
        batch_size=int(kv.get("Bs", 200) or 200),
    )
    return Config(exp=kv.get("EXP", "exp"), dataset=dataset, model=model, sample=sample)
