"""Single-device sampling pipeline: noise -> ODE integrate -> VAE decode
(port of lfm_tpu/sample/sample.py; reference test_flow_latent.py:161-194).

``make_sampler`` returns ``fn(noise, y) -> SampleOutput``: per-sample latent
noise (core/rng.py), optional CFG as one doubled batch (ode/cfg.py), the
ODE from t=1 to t=0 (ode/solvers.py), the latent unscale, the VAE decode and
the [0, 1] clamp. The model is a DiT, the origin-ADM UNet or EDM's
DhariwalUNet. With ``use_int8_dit`` a DiT evaluates every block's four
matmuls in int8 (nn/dit_int8.py, through the int8 GEMM kernel), and this
wins over ``use_fused_dit``, with which a bf16 DiT evaluates every block
through the fused block kernel (nn/dit_fused.py); otherwise, and for a UNet
under either flag, the module path runs, whose attention goes through the
attention kernels when the model has ``use_flash``. Labels are drawn in
``[0, num_classes)`` only when ``num_classes > 1``, and CFG's null label is
the model's ``null_label``: the DiT's null class, 0 for the origin ADM, -1
(the zero one-hot row) for EDM. ``use_karras_samplers`` takes the Karras
euler / heun loops, and the adaptive methods take the ``eval_noise`` floor
that ``resolve_eval_noise`` picks. The sequence- and pipeline-parallel
paths are not ported yet.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from lfm_tpu_torch.core.config import Config
from lfm_tpu_torch.core.device import DeviceLike, resolve_device
from lfm_tpu_torch.core.rng import SampleRNG
from lfm_tpu_torch.ode.cfg import cfg_velocity, plain_velocity
from lfm_tpu_torch.ode.solvers import ADAPTIVE_SOLVERS, karras_sample, odeint


class SampleOutput(NamedTuple):
    images: torch.Tensor  # (N, H, W, 3) in [0, 1]
    latents: torch.Tensor
    nfe: float


def build_velocity(model, y: Optional[torch.Tensor], cfg_scale: float, *,
                   use_fused_dit: bool = False, int8_params=None) -> Callable:
    """v(t, x), CFG-fused when cfg_scale > 1 (test_flow_latent.py:55-59).

    With ``int8_params`` (``quantize_params_int8`` of a DiT's state dict,
    which ``make_sampler`` makes under ``use_int8_dit``) the model
    evaluates through ``dit_int8_apply``, whatever ``use_fused_dit`` says,
    as in the JAX sampler (lfm_tpu/sample/sample.py:95-116). Else, with
    ``use_fused_dit`` and ``fused_applicable`` (a bf16 DiT; never a UNet),
    it evaluates through ``dit_fused_apply`` on a bf16 copy of its
    parameters made once, at the first call."""
    apply = model
    if int8_params is not None:
        from lfm_tpu_torch.nn.dit_int8 import dit_int8_apply

        def apply(t, x, yy):
            return dit_int8_apply(model, int8_params, t, x, yy)
    elif use_fused_dit:
        from lfm_tpu_torch.nn.dit_fused import (cast_params_bf16, dit_fused_apply,
                                                fused_applicable)
        bf16_params = None

        def apply(t, x, yy):
            nonlocal bf16_params
            if not fused_applicable(model, x):
                return model(t, x, yy)
            if bf16_params is None:
                bf16_params = cast_params_bf16(model.state_dict())
            return dit_fused_apply(model, bf16_params, t, x, yy)

    if y is not None and cfg_scale > 1.0:
        y_null = torch.full_like(y, getattr(model, "null_label", -1))
        return cfg_velocity(apply, y, y_null, cfg_scale)
    return plain_velocity(apply, y)


def sample_latents(velocity: Callable, x_noise: torch.Tensor, *, method: str = "dopri5",
                   atol: float = 1e-5, rtol: float = 1e-5, num_steps: int = 40,
                   step_size: float = 0.01, use_karras: bool = False,
                   eval_noise=0.0, group=None) -> Tuple[torch.Tensor, float]:
    """Integrate t: 1 -> 0. Returns (z_0, nfe). With ``use_karras`` the
    Karras loop of ``method`` (euler or heun; any other method takes euler,
    as in JAX) runs over ``num_steps`` sigmas, and the NFE is JAX's count:
    ``num_steps - 1`` pairs, the first 39 corrected under heun.
    ``eval_noise`` noise-floors the adaptive error estimate (ode/solvers.py);
    ``group``: the ranks that split the batch, whose adaptive step control
    is shared (``odeint``)."""
    if use_karras:
        z = karras_sample(lambda x, sigma: velocity(sigma, x), x_noise, num_steps,
                          sampler=method if method in ("euler", "heun") else "euler")
        pairs = max(num_steps - 1, 0)
        if method == "heun":
            corrected = min(pairs, 39)
            nfe = 2 * corrected + (pairs - corrected)
        else:
            nfe = pairs
        return z, float(nfe)
    if method in ADAPTIVE_SOLVERS:
        res = odeint(velocity, x_noise, 1.0, 0.0, method=method, atol=atol, rtol=rtol,
                     eval_noise=eval_noise, group=group)
    else:
        res = odeint(velocity, x_noise, 1.0, 0.0, method=method, num_steps=num_steps,
                     step_size=step_size)
    return res.y, res.nfe


def resolve_eval_noise(sc, model):
    """The noise floor's policy (lfm_tpu/sample/sample.py::
    resolve_eval_noise): ``sc.eval_noise`` where it is set; else ``"auto"``
    for a bf16 model under dopri8, whose high-order error estimate sits at
    bf16's rounding floor and thrashes without it, and 0.0 (torchdiffeq's
    controller unchanged) for everything else."""
    if sc.eval_noise is not None:
        return sc.eval_noise
    bf16 = getattr(model, "dtype", torch.float32) == torch.bfloat16
    return "auto" if (bf16 and sc.method == "dopri8") else 0.0


def make_sampler(config: Config, model, params=None, vae=None, vae_params=None,
                 device: DeviceLike = None, group=None) -> Callable:
    """Returns ``fn(noise, y=None) -> SampleOutput``.

    ``model`` and ``vae`` are this package's modules; ``params`` and
    ``vae_params``, where given, are state dicts loaded into them. Both are
    moved to ``device`` (the card unless ``device="cpu"``). Without a VAE the
    latents are returned as the images. With ``use_int8_dit`` and a DiT
    (``int8_model_ok``, the JAX gate: on the model only) the block weights
    are quantized here, once, from the f32 parameters (JAX's ``params_pre
    == "int8"``); a UNet under ``use_int8_dit`` takes the module path, as
    in JAX. ``group``: the ranks that split each batch (sample/sharded.py),
    whose adaptive solvers step alike."""
    device = resolve_device(device)
    sc = config.sample
    eval_noise = resolve_eval_noise(sc, model)
    if params is not None:
        model.load_state_dict(params)
    model.to(device).eval()
    int8_params = None
    if sc.use_int8_dit:
        from lfm_tpu_torch.nn.dit_int8 import int8_model_ok, quantize_params_int8

        if int8_model_ok(model):
            int8_params = quantize_params_int8(model, model.state_dict())
    if vae is not None:
        if vae_params is not None:
            vae.load_state_dict(vae_params)
        vae.to(device).eval()

    @torch.no_grad()
    def fn(noise: torch.Tensor, y: Optional[torch.Tensor] = None) -> SampleOutput:
        noise = noise.to(device=device, dtype=torch.float32)
        y = None if y is None else y.to(device)
        velocity = build_velocity(model, y, sc.cfg_scale, use_fused_dit=sc.use_fused_dit,
                                  int8_params=int8_params)
        z0, nfe = sample_latents(velocity, noise, method=sc.method, atol=sc.atol,
                                 rtol=sc.rtol, num_steps=sc.num_steps,
                                 step_size=sc.step_size,
                                 use_karras=sc.use_karras_samplers,
                                 eval_noise=eval_noise, group=group)
        if vae is None:
            return SampleOutput(images=z0, latents=z0, nfe=nfe)
        img = vae.decode(z0 / config.scale_factor)
        img = torch.clamp((img + 1.0) / 2.0, 0.0, 1.0)  # test_flow_latent.py:128,266
        return SampleOutput(images=img, latents=z0, nfe=nfe)

    return fn


def noise_and_labels(config: Config, rng: SampleRNG, indices,
                     device: DeviceLike = None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Per-sample-index latent noise (N, s, s, C) and labels
    (test_flow_latent.py:162-169)."""
    device = resolve_device(device)
    s = config.model.latent_size
    noise = rng.randn(indices, (s, s, config.model.num_in_channels), device=device)
    y = None
    nc = config.model.num_classes
    if nc is not None and nc > 1:
        y = rng.randint(indices, 0, nc, device=device)
    return noise, y
