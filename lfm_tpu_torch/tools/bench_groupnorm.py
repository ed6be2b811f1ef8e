"""Times the port's K6 (``groupnorm_silu``) on the card, at single shapes and
over the GroupNorm + SiLU calls of one origin-ADM evaluation, with its error
against its plain version and against float64.

    python -m lfm_tpu_torch.tools.bench_groupnorm [--timing-only] [--f64-seeds N] [--layouts]

or, to time another checkout's kernel on the same inputs (its package is the
one imported; its kernels are built in that checkout):

    PYTHONPATH=<other checkout> python <this checkout>/lfm_tpu_torch/tools/bench_groupnorm.py

Rows: bf16 at (200, 32, 32, 256), (200, 32, 32, 768) (the largest in-norm
input of celeb256_adm) and (200, 4, 4, 1024), and ``gn_eval``: the 22
calls that one celeb256_adm evaluation makes with ``use_fused_gn`` at its
sampling batch (``gn_silu_shapes``: every ResBlock's in-norm, in forward
order), each on its own input, timed as one chain. Inputs come from a CUDA
generator seeded per shape; where one call's input fits the 50 MB L2, the
timed calls rotate over enough copies of it (``rotation``) that a call
does not find its input in L2. Each row is timed with CUDA events, the mean
of REPS calls after WARMUP, REPEATS times; without ``--timing-only`` also
by ``torch.profiler`` (device time over REPS), beside the plain version's
time, the bound (each input byte read once, each output byte written once,
at 3.35 TB/s), ``library_ms`` (``silu(group_norm)`` on the f32
channels-last view, as chip_smoke.py times it) and ``library_bf16_ms``
(the same call on the bf16 channels-last view), the error against the
plain version, the count of outputs that differ from the plain version's
and a digest of the output's bytes. Where the package has ``gn_plan``, each
row names its launch.

``--f64-seeds N`` gives, per shape and dtype (the distinct shapes of
``gn_eval`` in bf16, (8, 32, 32, 256) and (3, 5, 7, 96) in f32), the
kernel's and the plain version's max abs error against the same function
in float64 on the same input, for N seeded inputs each (seed 0 is the
timed input), and the count of bf16 outputs that differ from the plain
version's. ``--layouts`` times, at each distinct shape of ``gn_eval`` and of
celeb512_adm at its batch (16), the plan's launch and every other layout
(``layouts``: groups an item, CTAs a cluster, threads) through
``lfm_groupnorm_silu_layout``, each checked against the plain version:
the sweep that the plan's constants come from.
Prints one JSON line with the card's name and power limit and the file of
the package that ran. Needs a CUDA card.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import math
import subprocess
import sys

import torch

SHAPES = ((200, 32, 32, 256), (200, 32, 32, 768), (200, 4, 4, 1024))
F32_SHAPES = ((8, 32, 32, 256), (3, 5, 7, 96))
GN_EVAL_PRESET, GN_EVAL_BATCH = "celeb256_adm", 200
GROUPS, EPS = 32, 1e-5
WARMUP, REPS, REPEATS = 3, 20, 3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
ROTATE_BYTES = 150e6  # three times the L2


def gn_silu_shapes(model) -> list:
    """(H, W, C) of every GroupNorm + SiLU call in one forward of an origin
    ADM UNet (``ModelConfig`` ``model``) with ``use_fused_gn``, in order:
    each ResBlock's in-norm at its input, and its out-norm after the
    resample where the block has no scale-shift norm."""
    from lfm_tpu_torch.nn.adm_unet import build_unet_plan, plan_layers

    plan = build_unet_plan(model.nf, model.ch_mult, model.num_res_blocks, model.attn_resolutions,
                           model.num_in_channels, model.resblock_updown)
    size, shapes = model.latent_size, []
    for spec in plan_layers(plan):
        if spec.kind in ("res", "res_down", "res_up"):
            shapes.append((size, size, spec.in_ch))
        if spec.kind in ("down", "res_down"):
            size //= 2
        elif spec.kind in ("up", "res_up"):
            size *= 2
        if spec.kind.startswith("res") and not model.use_scale_shift_norm:
            shapes.append((size, size, spec.out_ch))
    return shapes


def bound_ms(shape, dtype) -> float:
    """Each input byte read once (x, scale, bias), each output byte written
    once, at the card's HBM rate."""
    numel, c = math.prod(shape), shape[-1]
    esize = torch.empty((), dtype=dtype).element_size()
    return (2 * numel * esize + 2 * c * 4) / HBM_BYTES_PER_S * 1e3


def rotation(x: torch.Tensor) -> list:
    """Copies of x, enough that cycling through them reads ROTATE_BYTES, so
    that a call does not find its input in the L2."""
    return [x] + [x.clone() for _ in range(math.ceil(ROTATE_BYTES / x.nbytes) - 1)]


def inputs(shape, dtype, seed: int = 0, offset: float = 0.0):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(sum(shape) + 1000 * seed)
    c = shape[-1]
    x = (torch.randn(*shape, generator=gen, device="cuda") + offset).to(dtype)
    scale = 1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")
    bias = 0.1 * torch.randn(c, generator=gen, device="cuda")
    return x, scale, bias


def time_ms(fn, reps: int = REPS) -> float:
    for _ in range(WARMUP):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn) -> float:
    """Device time of one call: the profiler's kernel rows over REPS calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / REPS / 1e3


def digest(*tensors) -> str:
    h = hashlib.sha1()
    for t in tensors:
        h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def library(x, scale, bias, dtype):
    """silu(group_norm) on x's channels-last view in ``dtype``."""
    import torch.nn.functional as F

    xl = x.to(dtype).permute(0, 3, 1, 2)
    return lambda: F.silu(F.group_norm(xl, GROUPS, scale.to(dtype), bias.to(dtype), EPS))


def reference_f64(x, scale, bias):
    """The function in float64 (two-pass statistics) on x's values."""
    n, h, w, c = x.shape
    xg = x.double().reshape(n, h * w, GROUPS, c // GROUPS)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
    y = ((xg - mean) / torch.sqrt(var + EPS)).reshape(n, h, w, c)
    y = y * scale.double() + bias.double()
    return y * torch.sigmoid(y)


def plan_of(shape, dtype):
    try:
        from lfm_tpu_torch.kernels.groupnorm_silu import gn_plan
    except ImportError:  # a checkout from before the plan
        return None
    n, h, w, c = shape
    return gn_plan(n, h * w, c, GROUPS, dtype)._asdict()


def bench_shape(shape, dtype, timing_only: bool):
    from lfm_tpu_torch.kernels.groupnorm_silu import groupnorm_silu, reference_groupnorm_silu

    x, scale, bias = inputs(shape, dtype)
    copies = rotation(x)
    xs = itertools.cycle(copies)
    row = {"shape": list(shape), "dtype": str(dtype).removeprefix("torch."),
           "ms": [time_ms(lambda: groupnorm_silu(next(xs), scale, bias))
                  for _ in range(REPEATS)],
           "bound_ms": bound_ms(shape, dtype)}
    row["bound_share"] = row["bound_ms"] / min(row["ms"])
    if timing_only:
        return row
    out, ref = groupnorm_silu(x, scale, bias), reference_groupnorm_silu(x, scale, bias)
    err = float((out.float() - ref.float()).abs().max())
    libs = itertools.cycle([library(xi, scale, bias, torch.float32) for xi in copies])
    libs_bf16 = itertools.cycle([library(xi, scale, bias, dtype) for xi in copies])
    return {**row, "plan": plan_of(shape, dtype), "max_abs_err": err,
            "rel_err": err / float(ref.float().abs().max()),
            "differ_from_plain": int((out != ref).sum()), "digest": digest(out),
            "device_ms": device_ms(lambda: groupnorm_silu(next(xs), scale, bias)),
            "plain_ms": time_ms(lambda: reference_groupnorm_silu(next(xs), scale, bias)),
            "library_ms": time_ms(lambda: next(libs)()),
            "library_bf16_ms": time_ms(lambda: next(libs_bf16)())}


def gn_eval_inputs(dtype=torch.bfloat16):
    from lfm_tpu_torch.core.config import get_preset

    shapes = [(GN_EVAL_BATCH,) + s for s in gn_silu_shapes(get_preset(GN_EVAL_PRESET).model)]
    return shapes, [inputs(s, dtype, seed=i) for i, s in enumerate(shapes)]


def bench_gn_eval(timing_only: bool):
    """The 22 calls of one celeb256_adm evaluation at batch 200, as one chain."""
    from lfm_tpu_torch.kernels.groupnorm_silu import groupnorm_silu, reference_groupnorm_silu

    shapes, args = gn_eval_inputs()

    def chain(fn):
        return lambda: [fn(*a) for a in args]

    row = {"set": GN_EVAL_PRESET, "batch": GN_EVAL_BATCH, "launches": len(shapes),
           "shapes": [list(s[1:]) for s in shapes],
           "ms": [time_ms(chain(groupnorm_silu), reps=5) for _ in range(REPEATS)],
           "bound_ms": sum(bound_ms(s, torch.bfloat16) for s in shapes)}
    row["bound_share"] = row["bound_ms"] / min(row["ms"])
    if timing_only:
        return row
    libs = [library(*a, torch.float32) for a in args]
    libs_bf16 = [library(*a, torch.bfloat16) for a in args]
    errs = []
    for a in args:
        ref = reference_groupnorm_silu(*a).float()
        err = float((groupnorm_silu(*a).float() - ref).abs().max())
        errs.append((err, err / float(ref.abs().max())))
    return {**row, "max_abs_err": max(e[0] for e in errs), "rel_err": max(e[1] for e in errs),
            "plain_ms": time_ms(chain(reference_groupnorm_silu), reps=2),
            "library_ms": time_ms(lambda: [f() for f in libs], reps=2),
            "library_bf16_ms": time_ms(lambda: [f() for f in libs_bf16], reps=2)}


def layouts(shape):
    """(groups an item, CTAs a cluster, threads) at a bf16 shape: groups
    from a span of one sector up to 64 KB (or all 32), clusters that leave
    a CTA 8-64 KB, threads that give a thread 8, 16 or 32 chunks."""
    n, h, w, c = shape
    gbytes, cg = h * w * c // GROUPS * 2, c // GROUPS
    out = []
    for gpc in (1, 2, 4, 8, 16, 32):
        cpp = gpc * cg * 2 // 16
        if (gpc > 1 and (gpc // 2) * cg * 2 % 32 == 0 and (gpc // 2) * gbytes >= 65536) \
                or cpp > 512:
            continue
        p2 = 1 << max(0, (cpp - 1).bit_length())
        for cl in (1, 2, 4, 8):
            part = gpc * gbytes // cl
            if cl > 1 and part < 8192:
                break
            if part > 65536:
                continue
            hwc = -(-h * w // cl)
            for per in (8, 16, 32):
                t = 1 << max(0, (-(-hwc * p2 // per) - 1).bit_length())
                if max(p2, 32) <= t <= 512 and (gpc, cl, t) not in out:
                    out.append((gpc, cl, t))
    return out


def bench_layouts():
    """Each distinct GroupNorm + SiLU shape of celeb256_adm (batch 200) and
    celeb512_adm (batch 16) at the plan's launch and at each of its layouts:
    ms, share of the bound, error relative to the plain version."""
    import ctypes

    from lfm_tpu_torch.core.config import get_preset
    from lfm_tpu_torch.kernels._build import load_library
    from lfm_tpu_torch.kernels.groupnorm_silu import gn_plan, reference_groupnorm_silu

    lib = load_library()
    rows = []
    shapes = [(GN_EVAL_BATCH,) + s for s in sorted(set(gn_silu_shapes(
        get_preset(GN_EVAL_PRESET).model)))]
    celeb512 = get_preset("celeb512_adm")
    shapes += [(celeb512.sample.batch_size,) + s
               for s in sorted(set(gn_silu_shapes(celeb512.model)))]
    for shape in shapes:
        n, h, w, c = shape
        x, scale, bias = inputs(shape, torch.bfloat16)
        copies = rotation(x)
        xs = itertools.cycle(copies)
        out = torch.empty_like(x)
        ref = reference_groupnorm_silu(x, scale, bias).float()
        plan = gn_plan(n, h * w, c, GROUPS, torch.bfloat16)
        planned = (plan.gpc, plan.cluster, plan.threads)
        for layout in [planned] + [lay for lay in layouts(shape) if lay != planned]:
            def call(a=None):
                rc = lib.lfm_groupnorm_silu_layout(
                    (a if a is not None else next(xs)).data_ptr(), scale.data_ptr(),
                    bias.data_ptr(), out.data_ptr(), n, h * w, c, GROUPS, ctypes.c_float(EPS), 0,
                    *layout, torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"layout {layout} at {shape}: CUDA error {rc}")

            call(x)
            err = float((out.float() - ref).abs().max()) / float(ref.abs().max())
            ms = min(time_ms(call) for _ in range(REPEATS))
            rows.append({"shape": list(shape), "layout": list(layout), "plan": layout == planned,
                         "ms": ms,
                         "bound_share": bound_ms(shape, torch.bfloat16) / ms, "rel_err": err})
        del x, copies, out, ref
    return rows


def f64_errors(seeds: int):
    """Per shape, dtype and seed: the kernel's and the plain version's max
    abs error against float64 on the same input, and the count of outputs
    that differ from the plain version's."""
    from lfm_tpu_torch.core.config import get_preset
    from lfm_tpu_torch.kernels.groupnorm_silu import groupnorm_silu, reference_groupnorm_silu

    eval_shapes = sorted(set(gn_silu_shapes(get_preset(GN_EVAL_PRESET).model)))
    cases = ([((GN_EVAL_BATCH,) + s, torch.bfloat16) for s in eval_shapes]
             + [(s, torch.float32) for s in F32_SHAPES])
    rows = []
    for shape, dtype in cases:
        for seed in range(seeds):
            x, scale, bias = inputs(shape, dtype, seed)
            f64 = reference_f64(x, scale, bias)
            out, ref = groupnorm_silu(x, scale, bias), reference_groupnorm_silu(x, scale, bias)
            rows.append({"shape": list(shape), "dtype": str(dtype).removeprefix("torch."),
                         "seed": seed, "err_f64": float((out.double() - f64).abs().max()),
                         "plain_err_f64": float((ref.double() - f64).abs().max()),
                         "differ_from_plain": int((out != ref).sum()), "numel": out.numel()})
            del x, f64, out, ref
            torch.cuda.empty_cache()
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bench_groupnorm needs a CUDA card")
    import lfm_tpu_torch

    args = sys.argv[1:]
    timing_only = "--timing-only" in args
    if "--f64-seeds" in args:
        rows = f64_errors(int(args[args.index("--f64-seeds") + 1]))
    elif "--layouts" in args:
        rows = bench_layouts()
    else:
        rows = ([bench_shape(s, torch.bfloat16, timing_only) for s in SHAPES]
                + [bench_gn_eval(timing_only)])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(json.dumps({"package": lfm_tpu_torch.__file__, "card": smi.stdout.strip(),
                      "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
