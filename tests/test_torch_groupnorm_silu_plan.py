"""K6's launch rule and its sums, on the CPU.

``gn_plan`` (the mirror of csrc/groupnorm_silu.cu's ``gn_make_plan``) is
checked over every GroupNorm + SiLU shape of celeb256_adm (22 calls an
evaluation) and celeb512_adm (27), at batch 200 and 16, in bf16 and f32:
each CTA's span is whole groups, its 16-byte chunks lie on 16-byte
boundaries (or the plan takes the one-element scalar edge), spans are whole
32-byte sectors, narrow groups pack into 64-byte spans, clusters split
the large slabs, and the shared memory fits a CTA (per CTA in a cluster).
``gn_silu_shapes`` is checked against the calls a small ADM makes.

``emulate`` repeats the kernel as it runs: the plan's CTAs and threads, each
thread's sum over its chunks (a pairwise tree inside a chunk, then pixel by
pixel), the warps' xor shuffles, the fold of a group's columns over the
warps, the cluster's ranks in order, the same divisions and square root,
every f32 operation rounded on its own but the affine's one FMA. Against the JAX package's Pallas
``groupnorm_silu`` in interpret mode and its plain version the tolerances
are those of tests/test_torch_groupnorm_silu.py: 1e-5 relative to the
largest output (the same arithmetic in another order; exp may differ by an
ulp), and 1e-4 against the Pallas kernel at a +8 mean offset (its E[x^2] -
mean^2 loses about 6 bits of the variance to cancellation).
"""

import collections
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from tests.torch_parity import leaves_process_as_found, rel_err  # noqa: E402,F401

from lfm_tpu.kernels import groupnorm_silu as jgn  # noqa: E402
from lfm_tpu_torch.core.config import get_preset  # noqa: E402
from lfm_tpu_torch.kernels import groupnorm_silu as tgn  # noqa: E402
from lfm_tpu_torch.nn import adm_unet as tadm  # noqa: E402
from lfm_tpu_torch.tools.bench_groupnorm import gn_silu_shapes  # noqa: E402

GROUPS, EPS = 32, 1e-5
CELEB256_GN = {(32, 32, 256): 2, (32, 32, 512): 2, (32, 32, 768): 1, (16, 16, 256): 1,
               (16, 16, 512): 1, (16, 16, 768): 1, (16, 16, 1024): 2, (8, 8, 512): 2,
               (8, 8, 1024): 3, (4, 4, 512): 4, (4, 4, 1024): 3}


def _esize(dtype):
    return torch.empty((), dtype=dtype).element_size()


def test_gn_silu_shapes_are_the_calls_of_an_adm_forward(monkeypatch):
    """celeb256_adm's 22 calls (the table of its evaluation) and
    celeb512_adm's 27; and, on a small ADM with use_fused_gn on the CPU,
    the shapes FusedGNSiLU.apply sees are gn_silu_shapes', in order, with
    and without scale-shift norm and resblock up/down."""
    assert collections.Counter(gn_silu_shapes(get_preset("celeb256_adm").model)) == CELEB256_GN
    assert len(gn_silu_shapes(get_preset("celeb512_adm").model)) == 27
    base = dataclasses.replace(get_preset("celeb256_adm").model, image_size=64, nf=32,
                               ch_mult=(1, 2), attn_resolutions=(2,), num_res_blocks=1)
    seen = []
    apply = tadm.FusedGNSiLU.apply

    def record(x, *args):
        seen.append(tuple(x.shape[1:]))
        return apply(x, *args)

    monkeypatch.setattr(tadm.FusedGNSiLU, "apply", staticmethod(record))
    for kw in ({}, {"use_scale_shift_norm": False, "resblock_updown": True}):
        cfg = dataclasses.replace(base, **kw)
        model = tadm.create_adm_unet(cfg, use_fused_gn=True, device="cpu").eval()
        seen.clear()
        with torch.no_grad():
            model(torch.full((1,), 0.5), torch.randn(1, cfg.latent_size, cfg.latent_size, 4),
                  torch.zeros(1, dtype=torch.long) if model.num_classes else None)
        assert seen == gn_silu_shapes(cfg) and len(seen) > 0, kw


def _plan_cases():
    cases = set()
    for preset in ("celeb256_adm", "celeb512_adm"):
        for h, w, c in gn_silu_shapes(get_preset(preset).model):
            for n in (200, 16):
                cases.update({(n, h, w, c, torch.bfloat16), (n, h, w, c, torch.float32)})
    cases.update({(3, 5, 7, 96, torch.float32), (3, 5, 7, 96, torch.bfloat16)})
    return sorted(cases, key=lambda k: k[:4] + (str(k[4]),))


@pytest.mark.parametrize("n,h,w,c,dtype", _plan_cases())
def test_gn_plan_spans_whole_groups_aligned_chunks_and_fits_shared_memory(n, h, w, c, dtype):
    hw, es = h * w, _esize(dtype)
    p = tgn.gn_plan(n, hw, c, GROUPS, dtype)
    cg = c // GROUPS
    # whole groups, every group in exactly one item's span
    assert GROUPS % p.gpc == 0 and p.items == n * (GROUPS // p.gpc)
    assert p.cpp * p.vec == p.gpc * cg
    if (cg * es) % 16 == 0:  # 16-byte chunks on 16-byte boundaries, spans of whole sectors
        assert p.vec * es == 16
        assert (p.gpc * cg * es) % 16 == 0 and (c * es) % 16 == 0
        assert (p.gpc * cg * es) % 32 == 0
    else:  # the scalar edge: (3, 5, 7, 96), cg = 3
        assert p.vec == 1 and (h, w, c) == (5, 7, 96)
    # lanes, threads, pixels
    assert p.p2 & (p.p2 - 1) == 0 and p.p2 >= min(p.cpp, tgn.MAX_THREADS) and p.p2 < 2 * p.cpp
    assert p.threads % 32 == 0 and p.p2 <= p.threads <= tgn.MAX_THREADS
    assert p.cluster in (1, 2, 4, 8) and p.hwc * p.cluster >= hw > p.hwc * (p.cluster - 1)
    # every ADM slab is held on chip, at most CTA_BYTES of it a CTA
    span = p.cpp * p.vec * es
    scratch = (2 * p.threads + 2 * p.gpc) * 4
    assert p.hold == 1 and p.smem == -(-p.hwc * span // 16) * 16 + scratch
    assert p.hwc * span <= tgn.CTA_BYTES and p.smem <= tgn.SMEM_MAX
    if p.cluster > 1:  # a cluster only where half as many CTAs would hold more
        assert -(-hw // (p.cluster // 2)) * span > tgn.CTA_BYTES
    # the fewest groups that span 64 bytes of a pixel (in whole sectors)
    half = p.gpc // 2 * cg * es
    assert p.gpc * cg * es >= tgn.SPAN_BYTES
    assert p.gpc == 1 or half < tgn.SPAN_BYTES or (p.vec > 1 and half % 32)
    # about CHUNKS_PER_THREAD chunks a thread
    assert p.threads == tgn.MAX_THREADS or p.threads == max(p.p2, tgn.MIN_THREADS) or \
        p.hwc * p.p2 / p.threads > tgn.CHUNKS_PER_THREAD / 2


def test_gn_plan_regimes_at_the_adm_shapes():
    """(200, 4, 4, 512) packs 2 groups an item, (200, 32, 32, 256) 4 (64 KB);
    (200, 32, 32, 768)'s two groups (96 KB) split over a cluster of two,
    celeb512_adm's (16, 64, 64, 768) over eight, in bf16 and in f32 (384
    KB a group); a slab past eight CTAs streams; unaligned memory takes the
    scalar edge."""
    bf, f32 = torch.bfloat16, torch.float32
    assert tgn.gn_plan(200, 16, 512, GROUPS, bf)[:2] == (8, 2)
    assert tgn.gn_plan(200, 1024, 256, GROUPS, bf)[:5] == (8, 4, 4, 4, 256)
    p = tgn.gn_plan(200, 1024, 768, GROUPS, bf)
    assert (p.gpc, p.cpp, p.p2, p.threads, p.cluster, p.hold) == (2, 6, 8, 256, 2, 1)
    assert tgn.gn_plan(16, 4096, 768, GROUPS, bf).cluster == 8
    p = tgn.gn_plan(16, 4096, 768, GROUPS, f32)
    assert (p.gpc, p.cluster, p.hwc) == (1, 8, 512)
    p = tgn.gn_plan(1, 256 * 256, 8, 1, f32)
    assert (p.hold, p.cluster, p.smem) == (0, 8, (2 * 512 + 2) * 4)
    assert tgn.gn_plan(200, 1024, 256, GROUPS, bf, aligned=False).vec == 1
    assert tgn.gn_plan(70000, 16, 256, GROUPS, bf).items == 70000 * 8  # past 65535 samples
    with pytest.raises(ValueError):
        tgn.gn_plan(0, 16, 256, GROUPS, bf)


def _tree(f):
    """Pairwise sum over the last dim: ((f0 + f1) + (f2 + f3)) + ..."""
    f = f.clone()
    v = f.shape[-1]
    w = 1
    while w < v:
        for i in range(0, v - w, 2 * w):
            f[..., i] = f[..., i] + f[..., i + w]
        w *= 2
    return f[..., 0]


def emulate(x, scale, bias, groups, eps, plan):
    """csrc/groupnorm_silu.cu's gn_silu_kernel on the CPU, in f32, before the
    one rounding to x's type: x (N, H, W, C) f32 holding x's values."""
    n, h, w, c = x.shape
    hw, cg = h * w, c // groups
    vec, gpc, cpp, p2, nt, cl, hwc = (plan.vec, plan.gpc, plan.cpp, plan.p2, plan.threads,
                                      plan.cluster, plan.hwc)
    cpg, gb_count, rows_a_sweep = cg // vec, groups // gpc, nt // p2
    chunks = x.reshape(n, hw, gb_count, cpp, vec)
    tid = torch.arange(nt)
    j, r = tid % p2, tid // p2
    count = torch.tensor(float(hw * cg), dtype=torch.float32)
    width = min(cpg, p2)  # columns a group folds

    def cta_sums(term):
        """(N, group blocks, cluster, gpc): each CTA's sum of term(chunk, jj)
        per group, as the threads, warps and fold of gn_group_sum take it."""
        sums = torch.zeros(n, gb_count, cl, gpc)
        for rank in range(cl):
            p0 = rank * hwc
            rows = max(0, min(hw - p0, hwc))
            acc = torch.zeros(n, gb_count, nt)
            for q in range(-(-cpp // p2)):
                jj = j + q * p2
                for k in range(-(-rows // rows_a_sweep)):
                    p = r + k * rows_a_sweep
                    valid = (jj < cpp) & (p < rows)
                    sel = chunks[:, p0 + p.clamp(max=hw - 1), :, jj.clamp(max=cpp - 1)]
                    t = _tree(term(sel.permute(1, 2, 0, 3), jj.clamp(max=cpp - 1)))
                    acc = torch.where(valid, acc + t, acc)
            if p2 < 32:
                lane = tid % 32
                o = 16
                while o >= p2:
                    acc = acc + acc[..., (tid - lane) + (lane ^ o)]
                    o //= 2
                red = acc.reshape(n, gb_count, nt // 32, 32)[..., :p2]
            else:
                red = acc.reshape(n, gb_count, nt // p2, p2)
            total = torch.zeros(n, gb_count, gpc)
            for b in range(red.shape[2]):
                for i in range(width):
                    total = total + red[:, :, b, torch.arange(gpc) * cpg + i]
            sums[:, :, rank] = total
        if cl == 1:
            return sums[:, :, 0]
        total = torch.zeros(n, gb_count, gpc)
        for rank in range(cl):
            total = total + sums[:, :, rank]
        return total

    def group_of(jj):  # (.., gpc) statistic -> per chunk column jj
        return jj // cpg

    mean = cta_sums(lambda v, jj: v) / count

    def sq(v, jj):
        d = v - mean[:, :, group_of(jj)].unsqueeze(-1)
        return d * d

    var = cta_sums(sq) / count
    inv = 1.0 / torch.sqrt(var + torch.tensor(eps, dtype=torch.float32))
    m = mean.repeat_interleave(cg, dim=-1).reshape(n, 1, c)
    s = inv.repeat_interleave(cg, dim=-1).reshape(n, 1, c)
    y = (x.reshape(n, hw, c) - m) * s
    y = (y.double() * scale.double() + bias.double()).float()  # one FMA: the product is exact
    return (y / (1.0 + torch.exp(-y))).reshape(n, h, w, c)


def _inputs(shape, offset=0.0, seed=0, round_bf16=False):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.standard_normal(shape) + offset).astype(np.float32)
    if round_bf16:
        x = torch.from_numpy(x).bfloat16().float().numpy()
    scale = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return x, scale, bias


# (shape, groups, the plan's dtype): the scalar edge (cg = 2, 8 groups a
# span); 4 groups of cg = 8 a span (p2 = 4); two groups of cg = 24 (cpp = 6,
# p2 = 8); 8 chunks a pixel; a cluster of two; a cluster of four; a cluster
# of eight that streams x; the odd (3, 5, 7, 96) at the scalar edge (p2 =
# 32: no shuffles); a group wider than a CTA's 512 lanes (cg = 521: each
# thread takes two chunk columns)
EMULATED = [((2, 8, 8, 64), GROUPS, torch.float32), ((2, 8, 8, 256), GROUPS, torch.bfloat16),
            ((2, 16, 16, 768), GROUPS, torch.bfloat16), ((2, 4, 4, 1024), GROUPS, torch.float32),
            ((1, 32, 32, 768), GROUPS, torch.float32), ((1, 64, 64, 256), GROUPS, torch.float32),
            ((1, 256, 256, 8), 1, torch.float32), ((3, 5, 7, 96), GROUPS, torch.float32),
            ((1, 2, 3, 32 * 521), GROUPS, torch.bfloat16)]


@pytest.mark.parametrize("offset", [0.0, 8.0])
@pytest.mark.parametrize("shape,groups,dtype", EMULATED)
def test_emulated_kernel_matches_pallas_kernel_and_plain(shape, groups, dtype, offset):
    n, h, w, c = shape
    plan = tgn.gn_plan(n, h * w, c, groups, dtype)
    x, scale, bias = _inputs(shape, offset, round_bf16=dtype == torch.bfloat16)
    tx, ts, tb = (torch.from_numpy(a) for a in (x, scale, bias))
    got = emulate(tx, ts, tb, groups, EPS, plan)
    assert got.shape == shape and bool(torch.isfinite(got).all())
    plain = tgn.reference_groupnorm_silu(tx, ts, tb, groups, EPS)
    assert rel_err(got, plain) < 1e-5
    with pltpu.force_tpu_interpret_mode():
        kernel = jgn.groupnorm_silu(*(jnp.asarray(a) for a in (x, scale, bias)), groups=groups,
                                    eps=EPS)
    assert rel_err(got, kernel) < (1e-5 if offset == 0.0 else 1e-4)


def test_emulated_sums_follow_the_plan():
    """The emulated statistics depend on the plan's blocking: the same input
    under two plans (one CTA, a cluster of four) gives different f32 sums
    (so the emulation follows the blocking it is given), each within 1e-5
    of the plain version."""
    shape = (1, 64, 64, 256)
    x, scale, bias = (torch.from_numpy(a) for a in _inputs(shape, 8.0, seed=3))
    one = tgn.gn_plan(1, 4096, 256, GROUPS, torch.float32)
    assert one.cluster == 4
    single = one._replace(cluster=1, hwc=4096)
    a = emulate(x, scale, bias, GROUPS, EPS, one)
    b = emulate(x, scale, bias, GROUPS, EPS, single)
    plain = tgn.reference_groupnorm_silu(x, scale, bias, GROUPS, EPS)
    assert not torch.equal(a, b)
    assert rel_err(a, plain) < 1e-5 and rel_err(b, plain) < 1e-5
