"""The port's CUDA kernels against their plain versions on the card, at
small and ragged shapes (T not a multiple of the 64-row tiles, every head
dim the kernel is built for). Marked ``cuda``: they skip without a card. On the card, whose
machine has no JAX (tests/conftest.py imports it):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -p no:cacheprovider

Tolerances: bf16 outputs, max abs error within 2e-2 of unit-scale
attention outputs (a few bf16 ulps), and within 2e-2 of the block's largest
update |plain - x| (rounding that falls the other way in the two GEMM
chains; measured against the update, so the residual x cannot hide it).
The backward (K3) is held to 2e-2 of the largest plain gradient in bf16
(p and ds round to bf16 on both sides, and a rounding that falls the other
way moves a term by 2^-8), and every f32 case to 1e-4 of the largest plain
value (f32 sums in another order). The small DiT's parameter gradients
through K1/K3 are held to 5e-2 of the largest plain gradient of each
tensor, the bf16 tolerance of the CPU parity tests. K4 is held to its plain
version on the same key blocks, and K6 to its plain version, at the same
2e-2 (bf16) and 1e-4 (f32); the small origin ADM through K1 and K6 to 5e-2
of its plain paths' largest output (bf16 roundings over the UNet's depth);
EDM's DhariwalUNet in f32 on the card to 1e-4 of its largest output on the
CPU (f32 convolutions and sums in other orders).
"""

import importlib.util
from pathlib import Path

import pytest
import torch
# torch.profiler (test_f32_attention_dispatch_by_length) imports
# torch._dynamo, which sets an environment variable when first imported;
# import it with the module, before the state guard looks
import torch._dynamo  # noqa: F401

# loaded by path: on the card's machine an installed package named `tests`
# shadows this directory's namespace package
_spec = importlib.util.spec_from_file_location(
    "torch_parity_guard", Path(__file__).with_name("torch_parity.py"))
_guard = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_guard)
leaves_process_as_found = _guard.leaves_process_as_found

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return gen


# bf16 K1 runs attention_sm90.cuh: whole-row mode up to T = 256, key blocks
# past it (257, 300, 1024), every head dim (56/64 pad to 64, 72/80 to 80)
@pytest.mark.parametrize("shape", [(2, 256, 4, 64), (3, 100, 2, 72), (1, 17, 3, 56),
                                   (2, 1024, 2, 80), (2, 64, 4, 64), (2, 257, 2, 64),
                                   (1, 1024, 4, 64), (2, 256, 2, 80), (1, 300, 2, 72)])
def test_attention_small_kernel_matches_plain(cuda, shape):
    from lfm_tpu_torch.kernels.flash_attention import (ATTENTION_SMALL, attention_small,
                                                       reference_attention)

    q, k, v = (torch.randn(*shape, generator=cuda, device="cuda").bfloat16() for _ in range(3))
    before = ATTENTION_SMALL.count
    out = attention_small(q, k, v)
    torch.cuda.synchronize()
    assert ATTENTION_SMALL.count == before + 1
    err = float((out.float() - reference_attention(q, k, v).float()).abs().max())
    assert err <= 2e-2
    # the thirds of a fused qkv row, read in place
    n, t, h, d = shape
    qkv = torch.randn(n, t, 3 * h * d, generator=cuda, device="cuda").bfloat16()
    qq, kk, vv = (a.view(n, t, h, d) for a in qkv.split(h * d, dim=-1))
    err = float((attention_small(qq, kk, vv).float()
                 - reference_attention(qq, kk, vv).float()).abs().max())
    assert err <= 2e-2


@pytest.mark.parametrize("n,t,c,heads", [(2, 64, 128, 2), (3, 100, 256, 4), (1, 256, 384, 6),
                                         (1, 64, 1152, 16), (1, 256, 1024, 16)])
def test_fused_dit_block_kernel_matches_plain(cuda, n, t, c, heads):
    from lfm_tpu_torch.kernels.dit_block import FUSED_DIT_BLOCK, fused_dit_block, reference_block

    hid = 4 * c

    def rn(*s, scale=1.0):
        return (scale * torch.randn(*s, generator=cuda, device="cuda")).bfloat16()

    args = dict(x=rn(n, t, c), mod=rn(n, 6 * c, scale=0.3), wqkv=rn(3 * c, c, scale=c ** -0.5),
                bqkv=rn(3 * c, scale=0.02), wproj=rn(c, c, scale=c ** -0.5),
                bproj=rn(c, scale=0.02), w1=rn(hid, c, scale=c ** -0.5), b1=rn(hid, scale=0.02),
                w2=rn(c, hid, scale=hid ** -0.5), b2=rn(c, scale=0.02))
    before = FUSED_DIT_BLOCK.count
    out = fused_dit_block(**args, num_heads=heads)
    torch.cuda.synchronize()
    assert FUSED_DIT_BLOCK.count == before + 1
    ref = reference_block(**args, num_heads=heads).float()
    update = float((ref - args["x"].float()).abs().max())
    assert float((out.float() - ref).abs().max()) <= 2e-2 * update
    with pytest.raises(ValueError):
        fused_dit_block(**{**args, "x": args["x"].float()}, num_heads=heads)


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max()) / float(want.float().abs().max())


@pytest.mark.parametrize("shape", [(2, 256, 4, 64), (1, 1024, 2, 72), (1, 100, 3, 56)])
def test_attention_small_f32_matches_plain(cuda, shape):
    from lfm_tpu_torch.kernels.flash_attention import attention_small, reference_attention

    q, k, v = (torch.randn(*shape, generator=cuda, device="cuda") for _ in range(3))
    out = attention_small(q, k, v)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32
    assert _rel(out, reference_attention(q, k, v)) <= 1e-4


# bf16 K3 (the wgmma + TMA kernels of attention_bwd_sm90.cuh) at every head
# dim and T in {100, 256, 1024}; f32 K3 (attention_row_f32.cuh at T <= 256,
# attention_long_f32.cuh's dq kernel past it) as before
@pytest.mark.parametrize("dtype,t,d", [(torch.bfloat16, t, d) for t in (100, 256, 1024)
                                       for d in (56, 64, 72, 80)]
                         + [(torch.float32, t, d) for t, d in ((256, 64), (1024, 64), (256, 72),
                                                               (1024, 72), (100, 56))])
def test_attention_small_bwd_kernel_matches_plain(cuda, dtype, t, d):
    from lfm_tpu_torch.kernels.flash_attention import (ATTENTION_SMALL_BWD, attention_small_bwd,
                                                       reference_attention_bwd)

    n, h = 2, 2
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    q, k, v, do = (torch.randn(n, t, h, d, generator=cuda, device="cuda").to(dtype)
                   for _ in range(4))
    before = ATTENTION_SMALL_BWD.count
    got = attention_small_bwd(q, k, v, do)
    torch.cuda.synchronize()
    assert ATTENTION_SMALL_BWD.count == before + 1
    for name, g, w in zip("qkv", got, reference_attention_bwd(q, k, v, do)):
        assert g.dtype == dtype and g.shape == (n, t, h, d)
        assert _rel(g, w) <= tol, f"d{name}"
    # the thirds of a fused qkv row, read in place
    qkv = torch.randn(n, t, 3 * h * d, generator=cuda, device="cuda").to(dtype)
    qq, kk, vv = (a.view(n, t, h, d) for a in qkv.split(h * d, dim=-1))
    for g, w in zip(attention_small_bwd(qq, kk, vv, do), reference_attention_bwd(qq, kk, vv, do)):
        assert _rel(g, w) <= tol


@pytest.mark.parametrize("t,d", [(256, 64), (100, 72)])
def test_attention_small_bwd_is_deterministic(cuda, t, d):
    """bf16 K3 sums without atomics: two runs give the same bits, on separate
    tensors and on the thirds of a qkv row."""
    from lfm_tpu_torch.kernels.flash_attention import attention_small_bwd, split_qkv

    n, h = 4, 3
    q, k, v, do = (torch.randn(n, t, h, d, generator=cuda, device="cuda").bfloat16()
                   for _ in range(4))
    qkv = torch.randn(n, t, 3 * h * d, generator=cuda, device="cuda").bfloat16()
    for args in ((q, k, v, do), (*split_qkv(qkv, h), do)):
        first = [g.clone() for g in attention_small_bwd(*args)]
        second = attention_small_bwd(*args)
        torch.cuda.synchronize()
        for a, b in zip(first, second):
            assert torch.equal(a, b)


def test_fused_attention_autograd_launches_k1_and_k3(cuda):
    from lfm_tpu_torch.kernels.flash_attention import (ATTENTION_SMALL, ATTENTION_SMALL_BWD,
                                                       fused_attention_qkv, reference_attention,
                                                       split_qkv)

    n, t, h, d = 2, 256, 4, 64
    qkv = torch.randn(n, t, 3 * h * d, generator=cuda, device="cuda").bfloat16()
    do = torch.randn(n, t, h, d, generator=cuda, device="cuda").bfloat16()
    a = qkv.clone().requires_grad_(True)
    k1, k3 = ATTENTION_SMALL.count, ATTENTION_SMALL_BWD.count
    fused_attention_qkv(a, h).backward(do)
    torch.cuda.synchronize()
    assert (ATTENTION_SMALL.count, ATTENTION_SMALL_BWD.count) == (k1 + 1, k3 + 1)
    assert a.grad.is_contiguous() and a.grad.shape == qkv.shape
    b = qkv.clone().requires_grad_(True)
    reference_attention(*split_qkv(b, h)).backward(do)
    assert _rel(a.grad, b.grad) <= 2e-2


def test_small_dit_grads_through_kernels_match_plain(cuda):
    """A 2-block DiT at DiT-L width (C = 1024, 16 heads, T = 256), batch 4,
    bf16 compute on f32 masters: the FM loss's parameter gradients with
    attention through K1/K3 against plain autograd of reference_attention."""
    from lfm_tpu_torch.nn.dit import DiT
    from lfm_tpu_torch.nn.init import seeded_init_
    from lfm_tpu_torch.ode.flow import interpolate

    grads = []
    for use_flash in (True, False):
        model = DiT(img_resolution=32, patch_size=2, hidden_size=1024, depth=2, num_heads=16,
                    dtype=torch.bfloat16, use_flash=use_flash).to("cuda")
        seeded_init_(model, 0)
        g = torch.Generator(device="cuda")
        g.manual_seed(1)
        z0 = torch.randn(4, 32, 32, 4, generator=g, device="cuda")
        z1 = torch.randn(4, 32, 32, 4, generator=g, device="cuda")
        t = torch.rand(4, generator=g, device="cuda")
        z_t, u = interpolate(z0, z1, t)
        loss = torch.mean(torch.square(model(t, z_t, train=True) - u))
        loss.backward()
        grads.append({k: p.grad.float() for k, p in model.named_parameters()})
    for name, want in grads[1].items():
        assert _rel(grads[0][name], want) <= 5e-2, name


def test_attention_small_refuses_unbuilt_head_dim(cuda):
    from lfm_tpu_torch.kernels.flash_attention import attention_small

    q = torch.randn(1, 64, 2, 32, generator=cuda, device="cuda").bfloat16()
    with pytest.raises(ValueError, match="head dim"):
        attention_small(q, q, q)


@pytest.mark.parametrize("shape", [(4, 16, 4, 128), (2, 64, 4, 128), (2, 16, 2, 256),
                                   (1, 64, 2, 256), (2, 100, 2, 128)]
                         + [(2, t, 2, d) for d in (128, 256) for t in (1, 15, 17, 32, 33)])
def test_attention_small_wide_f32_heads_match_plain(cuda, shape):
    """The origin ADM's f32 attention: D = 128 and 256 at T = 16 and 64 and at
    the one-pass kernel's tile boundaries (16 and 32 query rows; 16, 32 or 64
    keys), and past it at a ragged T (the 64-row kernel), on separate tensors
    and on the thirds of a fused qkv row (the ADM's layout)."""
    from lfm_tpu_torch.kernels.flash_attention import (ATTENTION_SMALL, attention_small,
                                                       reference_attention, split_qkv)

    q, k, v = (torch.randn(*shape, generator=cuda, device="cuda") for _ in range(3))
    before = ATTENTION_SMALL.count
    out = attention_small(q, k, v)
    torch.cuda.synchronize()
    assert ATTENTION_SMALL.count == before + 1
    assert _rel(out, reference_attention(q, k, v)) <= 1e-4
    n, t, h, d = shape
    qq, kk, vv = split_qkv(torch.randn(n, t, 3 * h * d, generator=cuda, device="cuda"), h)
    assert _rel(attention_small(qq, kk, vv), reference_attention(qq, kk, vv)) <= 1e-4
    with pytest.raises(ValueError, match="head dim"):
        attention_small(q.bfloat16(), k.bfloat16(), v.bfloat16())


# f32 K1 and K3 at the DiT's head dims: the one-pass kernels of
# attention_row_f32.cuh at T <= 256 (TK 64, 128, 256; D 64 and 72 pad to 64
# and 80); past it K1 runs attention_long_f32.cuh's key-block kernel and K3
# its dq kernel
ROW_F32_SHAPES = [(2, t, 16, d) for t in (64, 100, 256) for d in (64, 72)]


@pytest.mark.parametrize("shape", ROW_F32_SHAPES)
def test_attention_row_f32_kernels_match_plain(cuda, shape):
    from lfm_tpu_torch.kernels.flash_attention import (ATTENTION_SMALL, ATTENTION_SMALL_BWD,
                                                       attention_small, attention_small_bwd,
                                                       reference_attention,
                                                       reference_attention_bwd, split_qkv)

    n, t, h, d = shape
    q, k, v, do = (torch.randn(*shape, generator=cuda, device="cuda") for _ in range(4))
    k1, k3 = ATTENTION_SMALL.count, ATTENTION_SMALL_BWD.count
    out = attention_small(q, k, v)
    grads = attention_small_bwd(q, k, v, do)
    torch.cuda.synchronize()
    assert (ATTENTION_SMALL.count, ATTENTION_SMALL_BWD.count) == (k1 + 1, k3 + 1)
    assert out.dtype == torch.float32 and _rel(out, reference_attention(q, k, v)) <= 1e-4
    for name, g, w in zip("qkv", grads, reference_attention_bwd(q, k, v, do)):
        assert g.dtype == torch.float32 and g.shape == shape
        assert _rel(g, w) <= 1e-4, f"d{name}"
    # the thirds of a fused qkv row, read in place, and a rerun's bits
    qq, kk, vv = split_qkv(torch.randn(n, t, 3 * h * d, generator=cuda, device="cuda"), h)
    assert _rel(attention_small(qq, kk, vv), reference_attention(qq, kk, vv)) <= 1e-4
    first = [g.clone() for g in attention_small_bwd(qq, kk, vv, do)]
    for g, again, w in zip(first, attention_small_bwd(qq, kk, vv, do),
                           reference_attention_bwd(qq, kk, vv, do)):
        assert _rel(g, w) <= 1e-4 and torch.equal(g, again)


@pytest.mark.parametrize("t,d,fwd,bwd", [
    (256, 64, "attn_row_kernel", ("attn_row_bwd_dq_kernel", "attn_row_bwd_dkdv_kernel")),
    (257, 64, "flash_f32_kernel<64, 64, 512>", ("attn_long_bwd_dq_kernel",
                                                "attn_row_bwd_dkdv_kernel")),
    (600, 64, "flash_f32_kernel<64, 32, 1024>", ("attn_long_bwd_dq_kernel",
                                                 "attn_row_bwd_dkdv_kernel")),
    (64, 128, "attn_short_f32_kernel<128, 64, 32>", ()),
    (65, 128, "flash_f32_kernel<128, 64, 512>", ()),
    (513, 128, "flash_f32_kernel<128, 32, 1024>", ()),
    (64, 256, "attn_short_f32_kernel<256, 64, 32>", ()),
    (65, 256, "flash_f32_kernel<256, 32, 1024>", ())])
def test_f32_attention_dispatch_by_length(cuda, t, d, fwd, bwd):
    """f32 at D 64: T <= 256 launches attention_row_f32.cuh's kernels; past
    it K1 launches attention_long_f32.cuh's key-block kernel with its whole
    row one block (K4's instance up to T = 512, 32 query rows and 1024 keys
    past it, as f32_k1_route says) and K3 the dq kernel of
    attention_long_f32.cuh with the row kernels' dk/dv kernel. At the
    origin ADM's D = 128/256 (forward only) K1 launches attention_wide.cu's
    one-pass kernel up to T = 64 and past it the same key-block kernel: K4's
    instance at D = 128 up to T = 512, else 32 query rows and 1024 keys (the
    profiler's kernel names)."""
    from torch.profiler import ProfilerActivity, profile

    from lfm_tpu_torch.kernels.flash_attention import (attention_small, attention_small_bwd,
                                                       f32_k1_route)

    name, rows, keys = f32_k1_route(t, d)
    assert name in fwd, (name, fwd)
    if name == "flash_f32_kernel":
        assert fwd.endswith(f"<{d}, {rows}, {keys}>"), (rows, keys, fwd)

    q, k, v, do = (torch.randn(1, t, 2, d, generator=cuda, device="cuda") for _ in range(4))

    def run():
        attention_small(q, k, v)
        if bwd:
            attention_small_bwd(q, k, v, do)

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    lfm = [name for name in names if "lfm::" in name]
    assert len(lfm) == 1 + len(bwd), names
    assert fwd in lfm[0] and all(b in got for b, got in zip(bwd, lfm[1:])), lfm


def test_profilers_class_the_long_f32_kernels(cuda):
    """The names a trace shows for f32 K4 and f32 K3 past T = 256 land in
    the profilers' K4 and K3 classes."""
    from torch.profiler import ProfilerActivity, profile

    from lfm_tpu_torch.kernels.flash_attention import attention_small_bwd, flash_attention
    from lfm_tpu_torch.tools import profile_sample, profile_train

    q, k, v = (torch.randn(1, 1030, 2, 64, generator=cuda, device="cuda") for _ in range(3))
    short = [torch.randn(1, 300, 2, 64, generator=cuda, device="cuda") for _ in range(4)]
    flash_attention(q, k, v)
    attention_small_bwd(*short)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        flash_attention(q, k, v)
        torch.cuda.synchronize()
    fwd = [e.name for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA and "lfm::" in e.name]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        attention_small_bwd(*short)
        torch.cuda.synchronize()
    bwd = [e.name for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA and "lfm::" in e.name]
    assert len(fwd) == 1 and len(bwd) == 2, (fwd, bwd)
    assert profile_sample.classify(fwd[0]) == "K4 flash_attention", fwd
    assert all(profile_train._classify(name) == profile_train.K3 for name in bwd), bwd


def test_attention_row_f32_builds_without_spills(cuda):
    """ptxas's report of the f32 one-pass kernels: 6 K1 instances (D 64, 80 x
    TK 64, 128, 256), 6 of K3's dq kernel and 2 of its dk/dv kernel, none
    spills."""
    from lfm_tpu_torch.kernels import _build

    _build.load_library()
    fwd = {k: v for k, v in _build.ptxas_usage("attention_row_f32").items() if "attn_row" in k}
    bwd = {k: v for k, v in _build.ptxas_usage("attention_bwd_row_f32").items()
           if "attn_row_bwd" in k}
    assert len(fwd) == 6 and len(bwd) == 8, (sorted(fwd), sorted(bwd))
    for name, u in {**fwd, **bwd}.items():
        assert u["spill_stores"] == 0 and u["spill_loads"] == 0 and u["registers"] <= 255, name


# f32 K3 past T = 256 (attention_long_f32.cuh's dq kernel, TK 512 and 1024,
# and the row kernels' dk/dv kernel): ragged T, every padded head dim
@pytest.mark.parametrize("shape", [(2, 300, 2, 64), (2, 300, 2, 80), (1, 257, 3, 72),
                                   (1, 700, 2, 56), (2, 1024, 2, 64), (1, 513, 2, 80)])
def test_attention_long_f32_bwd_matches_plain(cuda, shape):
    from lfm_tpu_torch.kernels.flash_attention import (ATTENTION_SMALL_BWD, attention_small_bwd,
                                                       reference_attention_bwd, split_qkv)

    n, t, h, d = shape
    q, k, v, do = (torch.randn(*shape, generator=cuda, device="cuda") for _ in range(4))
    before = ATTENTION_SMALL_BWD.count
    grads = attention_small_bwd(q, k, v, do)
    torch.cuda.synchronize()
    assert ATTENTION_SMALL_BWD.count == before + 1
    for name, g, w in zip("qkv", grads, reference_attention_bwd(q, k, v, do)):
        assert g.dtype == torch.float32 and g.shape == shape
        assert _rel(g, w) <= 1e-4, f"d{name}"
    # the thirds of a fused qkv row, read in place, and a rerun's bits (no
    # atomics in the sums)
    qq, kk, vv = split_qkv(torch.randn(n, t, 3 * h * d, generator=cuda, device="cuda"), h)
    first = [g.clone() for g in attention_small_bwd(qq, kk, vv, do)]
    for g, again, w in zip(first, attention_small_bwd(qq, kk, vv, do),
                           reference_attention_bwd(qq, kk, vv, do)):
        assert _rel(g, w) <= 1e-4 and torch.equal(g, again)


def test_attention_long_f32_builds_without_spills(cuda):
    """ptxas's report of attention_long_f32.cuh: 3 instances of f32 K4 (DP 64,
    80, 128) and 4 of K3's dq kernel (DP 64, 80 x TK 512, 1024), none
    spills."""
    from lfm_tpu_torch.kernels import _build

    _build.load_library()
    k4 = {k: v for k, v in _build.ptxas_usage("flash_attention_f32").items()
          if "flash_f32_kernel" in k}
    k3 = {k: v for k, v in _build.ptxas_usage("attention_bwd_long_f32").items()
          if "attn_long_bwd_dq_kernel" in k}
    assert len(k4) == 3 and len(k3) == 4, (sorted(k4), sorted(k3))
    for name, u in {**k4, **k3}.items():
        assert u["spill_stores"] == 0 and u["spill_loads"] == 0 and u["registers"] <= 255, name


# f32 K1 past T = 256 (attention_long_f32.cuh, the whole row one key
# block): K4's 64-row instances up to T = 512, 32 rows and 1024 keys past
# it; ragged T (a block that ends inside a ring stage), every padded head dim
@pytest.mark.parametrize("shape", [(2, 300, 2, 64), (1, 257, 3, 72), (2, 512, 2, 56),
                                   (1, 513, 2, 64), (2, 700, 2, 80), (1, 1024, 3, 64),
                                   (2, 1024, 2, 72)])
def test_attention_long_f32_k1_matches_plain(cuda, shape):
    from lfm_tpu_torch.kernels.flash_attention import (ATTENTION_SMALL, attention_small,
                                                       reference_attention, split_qkv)

    n, t, h, d = shape
    q, k, v = (torch.randn(*shape, generator=cuda, device="cuda") for _ in range(3))
    before = ATTENTION_SMALL.count
    out = attention_small(q, k, v)
    torch.cuda.synchronize()
    assert ATTENTION_SMALL.count == before + 1
    assert out.dtype == torch.float32 and out.shape == shape
    assert _rel(out, reference_attention(q, k, v)) <= 1e-4
    # the thirds of a fused qkv row, read in place, and a rerun's bits
    qq, kk, vv = split_qkv(torch.randn(n, t, 3 * h * d, generator=cuda, device="cuda"), h)
    first = attention_small(qq, kk, vv).clone()
    assert _rel(first, reference_attention(qq, kk, vv)) <= 1e-4
    assert torch.equal(first, attention_small(qq, kk, vv))


def test_attention_long_f32_k1_builds_without_spills(cuda):
    """ptxas's report of f32 K1's own instances of attention_long_f32.cuh's
    key-block kernel at the DiT's heads (32 query rows, 1024 keys; DP 64,
    80), none spills; and no instance of the old two-sweep f32 kernel
    (attn_small_kernel) is built in any attention source: the origin ADM's
    D = 128/256 past T = 64 runs the key-block kernel too
    (test_attention_wide_f32_k1_builds_without_spills)."""
    import re

    from lfm_tpu_torch.kernels import _build

    _build.load_library()
    k1 = {k: v for k, v in _build.ptxas_usage("attention_long_f32").items()
          if "flash_f32_kernel" in k}
    args = sorted(m.groups() for k in k1
                  for m in [re.search(r"flash_f32_kernelILi(\d+)ELi(\d+)ELi(\d+)E", k)] if m)
    assert args == [("64", "32", "1024"), ("80", "32", "1024")] and len(k1) == 2, sorted(k1)
    for name, u in k1.items():
        assert u["spill_stores"] == 0 and u["spill_loads"] == 0 and u["registers"] <= 255, name
    small = [k for stem in ("attention", "attention_wide", "attention_long_f32",
                            "flash_attention_f32")
             for k in _build.ptxas_usage(stem) if "attn_small_kernel" in k]
    assert small == [], small


# f32 K1 at the origin ADM's D = 128/256 past T = 64: the key-block kernel
# with its whole row one block (K4's <128, 64, 512> at D = 128 up to T =
# 512, else 32 query rows and 1024 keys), at celeb512_adm's T = 256 and
# 1024 and at ragged T either side of the instances' edges
WIDE_K1_SHAPES = [(1, 65, 2, 128), (2, 256, 4, 128), (1, 300, 3, 128), (1, 512, 2, 128),
                  (1, 513, 2, 128), (1, 1024, 2, 128), (1, 65, 2, 256), (2, 256, 2, 256),
                  (1, 513, 2, 256), (1, 1024, 2, 256)]


@pytest.mark.parametrize("shape", WIDE_K1_SHAPES)
def test_attention_wide_f32_k1_matches_plain(cuda, shape):
    """On separate tensors and on the thirds of a fused qkv row (the ADM's
    layout), within 1e-4 of the largest plain value; a rerun gives the same
    bits."""
    from lfm_tpu_torch.kernels.flash_attention import (ATTENTION_SMALL, attention_small,
                                                       reference_attention, split_qkv)

    n, t, h, d = shape
    q, k, v = (torch.randn(*shape, generator=cuda, device="cuda") for _ in range(3))
    before = ATTENTION_SMALL.count
    out = attention_small(q, k, v)
    torch.cuda.synchronize()
    assert ATTENTION_SMALL.count == before + 1
    assert out.dtype == torch.float32 and out.shape == shape
    assert _rel(out, reference_attention(q, k, v)) <= 1e-4
    qq, kk, vv = split_qkv(torch.randn(n, t, 3 * h * d, generator=cuda, device="cuda"), h)
    first = attention_small(qq, kk, vv).clone()
    assert _rel(first, reference_attention(qq, kk, vv)) <= 1e-4
    assert torch.equal(first, attention_small(qq, kk, vv))


def test_attention_wide_f32_k1_builds_without_spills(cuda):
    """ptxas's report of attention_wide.cu: its 6 instances of the one-pass
    kernel (DP 128, 256 x 16/32/64 keys) and f32 K1's two 32-row instances
    of attention_long_f32.cuh's key-block kernel (DP 128 and 256, 1024
    keys), none spills."""
    import re

    from lfm_tpu_torch.kernels import _build

    _build.load_library()
    usage = _build.ptxas_usage("attention_wide")
    flash = sorted(m.groups() for k in usage
                   for m in [re.search(r"flash_f32_kernelILi(\d+)ELi(\d+)ELi(\d+)E", k)] if m)
    short = [k for k in usage if "attn_short_f32_kernel" in k]
    assert flash == [("128", "32", "1024"), ("256", "32", "1024")] and len(short) == 6, \
        sorted(usage)
    for name, u in usage.items():
        assert u["spill_stores"] == 0 and u["spill_loads"] == 0 and u["registers"] <= 255, name


# f32 K3 at the origin ADM's D = 128/256 (attention_bwd_wide_f32.cu): the
# presets' T = 16 and 64 (the one-pass kernel), past T = 64 and at the gate
# (the dq and dk/dv kernels), and every edge of the routes: the one-pass
# kernel's 16 / 32 / 64 (48 at D = 256) rows, the first T of the two
# kernels (65, 49), their dq kernel's 16- or 32-key stages and its second
# and third instances (257, 513)
WIDE_K3_SHAPES = ([(4, 16, 4, 128), (2, 64, 4, 128), (2, 16, 2, 256), (1, 100, 2, 128),
                   (1, 257, 2, 256), (1, 512, 2, 128), (1, 513, 2, 128), (1, 1024, 2, 128),
                   (1, 1024, 2, 256)]
                  + [(2, t, 2, d) for d in (128, 256)
                     for t in (1, 15, 17, 33, 48, 49, 65, 256, 257)])


@pytest.mark.parametrize("shape", WIDE_K3_SHAPES)
def test_attention_small_bwd_wide_f32_matches_plain(cuda, shape):
    """On separate tensors and on the thirds of a fused qkv row (the ADM's
    layout): one launch, within 1e-4 of the plain version, the same bits on
    a rerun."""
    from lfm_tpu_torch.kernels.flash_attention import (ATTENTION_SMALL_BWD, attention_small_bwd,
                                                       reference_attention_bwd, split_qkv)

    n, t, h, d = shape
    q, k, v, do = (torch.randn(*shape, generator=cuda, device="cuda") for _ in range(4))
    before = ATTENTION_SMALL_BWD.count
    got = [g.clone() for g in attention_small_bwd(q, k, v, do)]
    torch.cuda.synchronize()
    assert ATTENTION_SMALL_BWD.count == before + 1
    def close(g, w):  # at T = 1, dq and dk are zero: softmax over one key
        scale = float(w.abs().max())
        return _rel(g, w) <= 1e-4 if scale else bool((g == 0).all())

    for g, again, w in zip(got, attention_small_bwd(q, k, v, do),
                           reference_attention_bwd(q, k, v, do)):
        assert close(g, w) and torch.equal(g, again)
    qq, kk, vv = split_qkv(torch.randn(n, t, 3 * h * d, generator=cuda, device="cuda"), h)
    first = [g.clone() for g in attention_small_bwd(qq, kk, vv, do)]
    for g, again, w in zip(first, attention_small_bwd(qq, kk, vv, do),
                           reference_attention_bwd(qq, kk, vv, do)):
        assert close(g, w) and torch.equal(g, again)


@pytest.mark.parametrize("t,d", [(16, 128), (33, 128), (64, 128), (65, 128), (257, 128),
                                 (513, 128), (16, 256), (48, 256), (49, 256), (1024, 256)])
def test_f32_k3_wide_dispatch(cuda, t, d):
    """At D = 128/256 f32 K3 launches the kernels f32_k3_route names, in
    order (the profiler's kernel names, with their template arguments):
    the one-pass kernel sized to T, or the dq and dk/dv kernels."""
    from torch.profiler import ProfilerActivity, profile

    from lfm_tpu_torch.kernels.flash_attention import attention_small_bwd, f32_k3_route

    q, k, v, do = split_qkv_rows(cuda, t, d)
    attention_small_bwd(q, k, v, do)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        attention_small_bwd(q, k, v, do)
        torch.cuda.synchronize()
    lfm = [e.name for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA and "lfm::" in e.name]
    names, rows, keys = f32_k3_route(t, d)
    assert len(lfm) == len(names), lfm
    assert all(name in got for name, got in zip(names, lfm)), lfm
    if len(names) == 1:
        assert f"<{d}, {keys}>" in lfm[0], lfm
    else:
        assert f"<{d}, {rows}," in lfm[0] and f"<{d}>" in lfm[1], lfm


def split_qkv_rows(gen, t, d, n=1, h=2):
    """q, k, v as the thirds of a fused qkv row, do alone: (n, t, h, d)."""
    from lfm_tpu_torch.kernels.flash_attention import split_qkv

    qkv = torch.randn(n, t, 3 * h * d, generator=gen, device="cuda")
    return (*split_qkv(qkv, h), torch.randn(n, t, h, d, generator=gen, device="cuda"))


def test_attention_bwd_wide_f32_builds_without_spills(cuda):
    """ptxas's report of attention_bwd_wide_f32.cu: its 13 instances (the
    one-pass kernel at DP 128 x TK 16, 32, 64 and DP 256 x 16, 32, 48; the
    dq kernel at its five rows and whole-row keys; the dk/dv kernel at DP
    128 and 256), none spills."""
    import re

    from lfm_tpu_torch.kernels import _build

    _build.load_library()
    usage = _build.ptxas_usage("attention_bwd_wide_f32")
    found = sorted((m.group(1), tuple(int(a) for a in re.findall(r"Li(\d+)E", m.group(2))))
                   for name in usage
                   for m in [re.search(r"(attn_wide_bwd_\w+?_kernel)I((?:Li\d+E)+)E", name)] if m)
    assert found == sorted(
        [("attn_wide_bwd_short_kernel", a) for a in ((128, 16), (128, 32), (128, 64),
                                                     (256, 16), (256, 32), (256, 48))]
        + [("attn_wide_bwd_dq_kernel", a) for a in ((128, 64, 256), (128, 32, 512),
                                                    (128, 16, 1024), (256, 32, 256),
                                                    (256, 16, 1024))]
        + [("attn_wide_bwd_dkdv_kernel", (128,)), ("attn_wide_bwd_dkdv_kernel", (256,))]), found
    for name, u in usage.items():
        if "attn_wide_bwd_" in name:
            assert u["spill_stores"] == 0 and u["spill_loads"] == 0 and u["registers"] <= 255, name


def test_groupnorm_silu_raises_under_grad(cuda):
    """K6 has no backward: on a CUDA tensor it raises when grad is enabled
    and an operand requires grad (training through it would give x, scale
    and bias no gradient), and runs under no_grad or without such operands;
    an origin ADM with use_fused_gn raises in a train step's forward."""
    from lfm_tpu_torch.kernels.groupnorm_silu import FusedGNSiLU
    from lfm_tpu_torch.nn.adm_unet import UNetModel

    x = torch.randn(2, 4, 4, 64, generator=cuda, device="cuda")
    scale = torch.ones(64, device="cuda", requires_grad=True)
    bias = torch.zeros(64, device="cuda")
    with pytest.raises(RuntimeError, match="K6 backward"):
        FusedGNSiLU.apply(x, scale, bias)
    with pytest.raises(RuntimeError, match="K6 backward"):
        FusedGNSiLU.apply(x.requires_grad_(True), scale.detach(), bias)
    with torch.no_grad():
        out = FusedGNSiLU.apply(x, scale, bias)
    assert out.grad_fn is None and torch.isfinite(out).all()
    assert torch.isfinite(FusedGNSiLU.apply(x.detach(), scale.detach(), bias)).all()
    model = UNetModel(image_size=8, model_channels=64, channel_mult=(1,), num_res_blocks=1,
                      attention_resolutions=(), use_fused_gn=True).cuda()
    with pytest.raises(RuntimeError, match="K6 backward"):
        model(torch.rand(2, device="cuda"), torch.randn(2, 8, 8, 4, device="cuda"), train=True)


def test_small_f32_dit_grads_through_kernels_match_plain(cuda):
    """The 2-block DiT at DiT-L width in f32 (f32 compute, as train
    --precision f32): the FM loss's parameter gradients with attention
    through f32 K1/K3 against plain autograd of reference_attention, each
    within 1e-5 of its tensor's largest plain gradient (f32 sums in another
    order, through two blocks of the backward)."""
    from lfm_tpu_torch.nn.dit import DiT
    from lfm_tpu_torch.nn.init import seeded_init_
    from lfm_tpu_torch.ode.flow import interpolate

    grads = []
    for use_flash in (True, False):
        model = DiT(img_resolution=32, patch_size=2, hidden_size=1024, depth=2, num_heads=16,
                    dtype=torch.float32, use_flash=use_flash).to("cuda")
        seeded_init_(model, 0)
        g = torch.Generator(device="cuda")
        g.manual_seed(1)
        z0 = torch.randn(4, 32, 32, 4, generator=g, device="cuda")
        z1 = torch.randn(4, 32, 32, 4, generator=g, device="cuda")
        t = torch.rand(4, generator=g, device="cuda")
        z_t, u = interpolate(z0, z1, t)
        torch.mean(torch.square(model(t, z_t, train=True) - u)).backward()
        grads.append({k: p.grad.float() for k, p in model.named_parameters()})
    for name, want in grads[1].items():
        assert _rel(grads[0][name], want) <= 1e-5, name


@pytest.mark.parametrize("dtype,shape,bk", [
    (torch.bfloat16, (2, 2048, 2, 64), 512), (torch.bfloat16, (1, 1100, 2, 72), 512),
    (torch.bfloat16, (2, 256, 2, 56), 64), (torch.float32, (1, 2048, 2, 128), 512),
    (torch.float32, (1, 1030, 2, 80), 512), (torch.bfloat16, (1, 1200, 2, 64), 512),
    (torch.bfloat16, (1, 1030, 2, 80), 512), (torch.bfloat16, (2, 256, 2, 64), 512),
    (torch.float32, (1, 1100, 2, 64), 512), (torch.float32, (2, 2048, 2, 56), 256),
    (torch.float32, (1, 1200, 2, 128), 512), (torch.float32, (2, 256, 2, 72), 64)])
def test_flash_attention_kernel_matches_plain(cuda, dtype, shape, bk):
    """K4 against its plain version on the same key blocks: T past the gate,
    ragged T (1100 = 4 x 275, 1030 = 2 x 515 > 512, so 206-key blocks, 1200
    = 3 x 400: blocks that end inside a 64-key tile, or inside f32's stage of
    32 to 128 keys), blocks of 64, and one block of 256 keys (the whole-row
    mode of bf16)."""
    from lfm_tpu_torch.kernels.flash_attention import (FLASH_ATTENTION, flash_attention,
                                                       reference_flash_attention)

    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    q, k, v = (torch.randn(*shape, generator=cuda, device="cuda").to(dtype) for _ in range(3))
    before = FLASH_ATTENTION.count
    out = flash_attention(q, k, v, block_k=bk)
    torch.cuda.synchronize()
    assert FLASH_ATTENTION.count == before + 1 and out.dtype == dtype
    assert _rel(out, reference_flash_attention(q, k, v, block_k=bk)) <= tol
    n, t, h, d = shape
    qkv = torch.randn(n, t, 3 * h * d, generator=cuda, device="cuda").to(dtype)
    qq, kk, vv = (a.view(n, t, h, d) for a in qkv.split(h * d, dim=-1))
    assert _rel(flash_attention(qq, kk, vv, block_k=bk),
                reference_flash_attention(qq, kk, vv, block_k=bk)) <= tol


def test_flash_attention_f32_refuses_blocks_past_512(cuda):
    """f32 K4 holds a key block's scores on chip: blocks of more than 512 keys
    raise, and launch nothing."""
    from lfm_tpu_torch.kernels.flash_attention import FLASH_ATTENTION, flash_attention

    q, k, v = (torch.randn(1, 2048, 2, 64, generator=cuda, device="cuda") for _ in range(3))
    before = FLASH_ATTENTION.count
    with pytest.raises(ValueError, match="512"):
        flash_attention(q, k, v, block_k=1024)
    assert FLASH_ATTENTION.count == before


def test_fused_attention_past_the_gate_launches_k4(cuda):
    """Past T = 1024 the autograd Function runs K4 forward and the plain
    recompute backward."""
    from lfm_tpu_torch.kernels.flash_attention import (ATTENTION_SMALL, FLASH_ATTENTION,
                                                       fused_attention_qkv, reference_attention,
                                                       split_qkv)

    n, t, h, d = 1, 2048, 2, 64
    qkv = torch.randn(n, t, 3 * h * d, generator=cuda, device="cuda").bfloat16()
    do = torch.randn(n, t, h, d, generator=cuda, device="cuda").bfloat16()
    a = qkv.clone().requires_grad_(True)
    k1, k4 = ATTENTION_SMALL.count, FLASH_ATTENTION.count
    out = fused_attention_qkv(a, h)
    out.backward(do)
    torch.cuda.synchronize()
    assert (ATTENTION_SMALL.count, FLASH_ATTENTION.count) == (k1, k4 + 1)
    b = qkv.clone().requires_grad_(True)
    ref = reference_attention(*split_qkv(b, h))
    ref.backward(do)
    assert _rel(out.detach(), ref.detach()) <= 2e-2 and _rel(a.grad, b.grad) <= 2e-2


# K6 by plan regime (kernels/groupnorm_silu.gn_plan): a CTA of four packed
# groups (cg = 8, 64 KB), two groups of cg = 24 split over a cluster of two
# (96 KB), 16 pixels a CTA (4 x 4), the +8 offset, f32, the scalar edge
# (cg = 3), a cluster of eight splitting celeb512_adm's (64, 64, 768) in
# bf16 and in f32 (384 KB a group, past one SM), a cluster of eight
# streaming x (8 MB a span), and a group wider than a CTA's 512 lanes
# (cg = 521 at the scalar edge)
@pytest.mark.parametrize("dtype,shape,offset", [
    (torch.bfloat16, (4, 32, 32, 256), 0.0), (torch.bfloat16, (2, 32, 32, 768), 0.0),
    (torch.bfloat16, (8, 4, 4, 1024), 0.0), (torch.bfloat16, (4, 32, 32, 256), 8.0),
    (torch.float32, (2, 32, 32, 256), 0.0), (torch.float32, (3, 5, 7, 96), 8.0),
    (torch.bfloat16, (2, 64, 64, 768), 0.0), (torch.float32, (1, 64, 64, 768), 8.0),
    (torch.bfloat16, (1, 512, 512, 256), 0.0), (torch.bfloat16, (1, 2, 3, 32 * 521), 8.0)])
def test_groupnorm_silu_kernel_matches_plain(cuda, dtype, shape, offset):
    from lfm_tpu_torch.kernels.groupnorm_silu import (GROUPNORM_SILU, groupnorm_silu,
                                                      reference_groupnorm_silu)

    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    c = shape[-1]
    x = (torch.randn(*shape, generator=cuda, device="cuda") + offset).to(dtype)
    scale = 1.0 + 0.1 * torch.randn(c, generator=cuda, device="cuda")
    bias = 0.1 * torch.randn(c, generator=cuda, device="cuda")
    before = GROUPNORM_SILU.count
    out = groupnorm_silu(x, scale, bias)
    torch.cuda.synchronize()
    assert GROUPNORM_SILU.count == before + 1 and out.dtype == dtype
    assert _rel(out, reference_groupnorm_silu(x, scale, bias)) <= tol
    # fixed-order sums: the same bits again
    assert torch.equal(out, groupnorm_silu(x, scale, bias))
    with pytest.raises(ValueError, match="contiguous"):
        groupnorm_silu(x.transpose(1, 2), scale, bias)


def test_groupnorm_silu_unaligned_input_takes_the_scalar_edge(cuda):
    """x one element past a 16-byte boundary (contiguous, so it is taken):
    the one-element chunks of the same kernel, within the same tolerance as
    the aligned call."""
    from lfm_tpu_torch.kernels.groupnorm_silu import groupnorm_silu, reference_groupnorm_silu

    shape = (2, 16, 16, 256)
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        flat = torch.randn(1 + 2 * 16 * 16 * 256, generator=cuda, device="cuda").to(dtype)
        x = flat[1:].view(shape)
        assert x.is_contiguous() and x.data_ptr() % 16
        scale = 1.0 + 0.1 * torch.randn(256, generator=cuda, device="cuda")
        bias = 0.1 * torch.randn(256, generator=cuda, device="cuda")
        out = groupnorm_silu(x, scale, bias)
        assert _rel(out, reference_groupnorm_silu(x, scale, bias)) <= tol


def test_groupnorm_silu_plan_is_the_kernels(cuda):
    """gn_plan (Python) equals gn_make_plan (C, lfm_groupnorm_silu_plan) at
    every GroupNorm + SiLU shape of celeb256_adm and celeb512_adm, in bf16
    and f32, aligned or not, and at the regimes' edges; and the profiler
    names the instance the plan picks (chunk elements, held or streamed)."""
    import ctypes

    from lfm_tpu_torch.core.config import get_preset
    from lfm_tpu_torch.kernels import _build
    from lfm_tpu_torch.kernels.groupnorm_silu import gn_plan, groupnorm_silu
    from lfm_tpu_torch.tools.bench_groupnorm import gn_silu_shapes

    lib = _build.load_library()
    shapes = {s for p in ("celeb256_adm", "celeb512_adm") for s in gn_silu_shapes(
        get_preset(p).model)} | {(5, 7, 96), (512, 512, 256), (1, 1, 32), (3, 1, 64)}
    for h, w, c in sorted(shapes):
        for dtype in (torch.bfloat16, torch.float32):
            for aligned in (True, False):
                got = (ctypes.c_int * 10)()
                assert lib.lfm_groupnorm_silu_plan(16, h * w, c, 32, int(dtype == torch.float32),
                                                   int(aligned), got) == 0
                assert tuple(got) == tuple(gn_plan(16, h * w, c, 32, dtype, aligned)), (h, w, c)
    from torch.profiler import ProfilerActivity, profile

    for shape, dtype, name in (((2, 32, 32, 768), torch.bfloat16, "<__nv_bfloat16, 8, true>"),
                               ((3, 5, 7, 96), torch.float32, "<float, 1, true>"),
                               ((1, 512, 512, 256), torch.bfloat16, "<__nv_bfloat16, 8, false>")):
        x = torch.randn(*shape, generator=cuda, device="cuda").to(dtype)
        ones = torch.ones(shape[-1], device="cuda")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            groupnorm_silu(x, ones, ones)
            torch.cuda.synchronize()
        kernels = [e.key for e in prof.key_averages() if "gn_silu_kernel" in e.key]
        assert len(kernels) == 1 and name in kernels[0], kernels


def test_groupnorm_silu_layouts_match_plain(cuda):
    """lfm_groupnorm_silu_layout (tools/bench_groupnorm.py --layouts): other
    layouts than the plan's (one CTA of two groups, a cluster of four, one
    group a CTA, four groups over a cluster of two) agree with the plain
    version as the plan's launch does, and a layout that does not exist
    (groups that do not divide 32, a cluster of 16, fewer threads than a
    pixel's lanes, a thread count not a power of two) is refused."""
    import ctypes

    from lfm_tpu_torch.kernels import _build
    from lfm_tpu_torch.kernels.groupnorm_silu import reference_groupnorm_silu

    lib = _build.load_library()
    shape = (2, 32, 32, 768)
    x = torch.randn(*shape, generator=cuda, device="cuda").bfloat16()
    scale = 1.0 + 0.1 * torch.randn(768, generator=cuda, device="cuda")
    bias = 0.1 * torch.randn(768, generator=cuda, device="cuda")
    ref = reference_groupnorm_silu(x, scale, bias)
    stream = torch.cuda.current_stream().cuda_stream
    for layout in ((2, 1, 512), (2, 4, 128), (1, 1, 256), (4, 2, 256)):
        out = torch.empty_like(x)
        assert lib.lfm_groupnorm_silu_layout(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                                             out.data_ptr(), 2, 1024, 768, 32,
                                             ctypes.c_float(1e-5), 0, *layout, stream) == 0
        torch.cuda.synchronize()
        assert _rel(out, ref) <= 2e-2, layout
    for layout in ((3, 1, 256), (2, 16, 256), (2, 1, 4), (2, 1, 384)):
        assert lib.lfm_groupnorm_silu_layout(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                                             out.data_ptr(), 2, 1024, 768, 32,
                                             ctypes.c_float(1e-5), 0, *layout, stream) != 0


def test_groupnorm_silu_fast_division_is_ieee_division(cuda):
    """K6's SiLU divides without the IEEE division's per-element range check
    where gn_div_safe holds; there its quotient must have the division's
    bits. 2^24 pairs a round: y of every exponent in [-50, 50] and both
    signs, and the SiLU's own y ~ N(0, 8^2), over d = 1 + exp(-y) and d
    spread over [1, 2^45)."""
    from lfm_tpu_torch.kernels import _build

    lib = _build.load_library()
    stream = torch.cuda.current_stream().cuda_stream
    m, checked = 1 << 24, 0
    for rnd in range(4):
        if rnd % 2:
            y = 8.0 * torch.randn(m, generator=cuda, device="cuda")
        else:
            e = torch.randint(-50, 51, (m,), generator=cuda, device="cuda").float()
            sign = torch.randint(0, 2, (m,), generator=cuda, device="cuda") * 2 - 1
            y = (1 + torch.rand(m, generator=cuda, device="cuda")) * torch.exp2(e) * sign
        if rnd < 2:
            d = 1 + torch.exp(-y)
        else:
            spread = torch.randint(0, 45, (m,), generator=cuda, device="cuda").float()
            d = 1 + torch.rand(m, generator=cuda, device="cuda") * torch.exp2(spread)
        fast, exact = torch.empty_like(y), torch.empty_like(y)
        safe = torch.empty(m, dtype=torch.int32, device="cuda")
        assert lib.lfm_groupnorm_silu_div_check(y.data_ptr(), d.data_ptr(), fast.data_ptr(),
                                                exact.data_ptr(), safe.data_ptr(), m,
                                                stream) == 0
        ok = safe.bool()
        assert torch.equal(fast.view(torch.int32)[ok], exact.view(torch.int32)[ok])
        checked += int(ok.sum())
    assert checked > 2 * m


def test_groupnorm_silu_builds_without_spills(cuda):
    """ptxas's report of K6: its 8 instances (bf16 and f32 x 16-byte and
    one-element chunks x held and streamed), none spills, each within the
    64 registers that two CTAs of 512 threads on an SM leave it."""
    from lfm_tpu_torch.kernels import _build

    _build.load_library()
    usage = {k: v for k, v in _build.ptxas_usage("groupnorm_silu").items()
             if "gn_silu_kernel" in k}
    assert len(usage) == 8, sorted(usage)
    for name, u in usage.items():
        assert u["spill_stores"] == 0 and u["spill_loads"] == 0 and u["registers"] <= 64, name


def test_small_adm_runs_its_kernels_and_matches_plain(cuda):
    """A 2-level origin ADM at celeb256_adm's head width (C = 512, 4 heads,
    D = 128), bf16, use_flash and use_fused_gn: one forward launches K1 at
    every attention and K6 at every ResBlock's in-norm, and agrees with the
    same weights on the plain paths (use_flash and use_fused_gn off) within
    5e-2 of the largest output."""
    from lfm_tpu_torch.kernels.flash_attention import ATTENTION_SMALL
    from lfm_tpu_torch.kernels.groupnorm_silu import GROUPNORM_SILU
    from lfm_tpu_torch.nn.adm_unet import UNetModel, plan_layers
    from lfm_tpu_torch.nn.init import seeded_init_

    kw = dict(image_size=8, model_channels=256, channel_mult=(1, 2), num_res_blocks=1,
              attention_resolutions=(2,), num_heads=4, dtype=torch.bfloat16)
    fast = seeded_init_(UNetModel(**kw, use_flash=True, use_fused_gn=True).cuda(), 0)
    plain = UNetModel(**kw).cuda()
    plain.load_state_dict(fast.state_dict())
    t = torch.rand(4, generator=cuda, device="cuda")
    x = torch.randn(4, 8, 8, 4, generator=cuda, device="cuda")
    layers = list(plan_layers(fast.plan))
    k1, k6 = ATTENTION_SMALL.count, GROUPNORM_SILU.count
    with torch.no_grad():
        got = fast(t, x)
        want = plain(t, x)
    torch.cuda.synchronize()
    assert ATTENTION_SMALL.count - k1 == sum(s.kind == "attn" for s in layers)
    assert GROUPNORM_SILU.count - k6 == sum(s.kind.startswith("res") for s in layers)
    assert torch.isfinite(got).all() and _rel(got, want) <= 5e-2


def test_small_edm_unet_on_the_card_matches_the_cpu(cuda):
    """EDM's DhariwalUNet with two levels at imnet_adm's widths (C = 256 and
    512, attention at 4x4 with 8 heads of 64), 10 classes and CFG's null
    label -1, in f32: on the card (TF32 off within forward) within 1e-4 of
    the largest output of the same weights on the CPU, and no hand-written
    kernel launched (JAX's EDM attention and GroupNorm are plain)."""
    from lfm_tpu_torch.kernels.flash_attention import ATTENTION_SMALL, FLASH_ATTENTION
    from lfm_tpu_torch.kernels.groupnorm_silu import GROUPNORM_SILU
    from lfm_tpu_torch.nn.edm_unet import DhariwalUNet
    from lfm_tpu_torch.nn.init import seeded_init_

    kw = dict(img_resolution=8, model_channels=256, channel_mult=(1, 2), num_blocks=1,
              attn_resolutions=(4,), dropout=0.0, label_dim=10)
    cpu = seeded_init_(DhariwalUNet(**kw), 0)
    card = DhariwalUNet(**kw).cuda()
    card.load_state_dict(cpu.state_dict())
    t = torch.rand(4, generator=cuda, device="cuda")
    x = torch.randn(4, 8, 8, 4, generator=cuda, device="cuda")
    y = torch.tensor([0, 9, -1, -1], device="cuda")
    counters = (ATTENTION_SMALL, FLASH_ATTENTION, GROUPNORM_SILU)
    before = [c.count for c in counters]
    with torch.no_grad():
        got = card(t, x, y)
        want = cpu(t.cpu(), x.cpu(), y.cpu())
    torch.cuda.synchronize()
    assert [c.count for c in counters] == before
    assert torch.isfinite(got).all() and _rel(got.cpu(), want) <= 1e-4


# K5: the differentiable fused block (kernels/dit_block_train.py). Shapes:
# DiT-like widths, a batch whose N*T is not a multiple of the GEMMs' 128-row
# tiles (3 x 96 = 288), T not a multiple of the 64-row attention tiles, and
# DiT-XL's head dim 72. Outputs within 2e-2 of the largest plain value; out
# and x1 (dx1, dx) within 2e-2 of the block's update |plain - x| (|plain -
# dy|, |plain - dx1|), as K2, plus one bf16 ulp (2^-7 relative at most) of
# the largest output: the output's own rounding may fall the other way, and
# where the update is small against the residual that ulp is more than 2%
# of it.
K5_SHAPES = [(2, 64, 128, 2), (3, 96, 256, 4), (1, 256, 384, 6), (1, 64, 1152, 16)]


def _block_args(gen, n, t, c):
    hid = 4 * c

    def rn(*s, scale=1.0):
        return (scale * torch.randn(*s, generator=gen, device="cuda")).bfloat16()

    return dict(x=rn(n, t, c), mod=rn(n, 6 * c, scale=0.3), wqkv=rn(3 * c, c, scale=c ** -0.5),
                bqkv=rn(3 * c, scale=0.02), wproj=rn(c, c, scale=c ** -0.5),
                bproj=rn(c, scale=0.02), w1=rn(hid, c, scale=c ** -0.5), b1=rn(hid, scale=0.02),
                w2=rn(c, hid, scale=hid ** -0.5), b2=rn(c, scale=0.02))


def _within(got, want, base=None, tol=2e-2) -> bool:
    err = float((got.float() - want.float()).abs().max())
    if base is None:
        return err <= tol * float(want.float().abs().max())
    update = float((want.float() - base.float()).abs().max())
    return err <= tol * update + 2.0 ** -7 * float(want.float().abs().max())


@pytest.mark.parametrize("n,t,c,heads", [(2, 256, 1024, 16), (2, 272, 256, 4)])
def test_fused_blocks_attention_matches_plain_in_both_modes(cuda, n, t, c, heads):
    """K2 and K5's forward run their attention (p / l rounded before P V)
    through attention_sm90.cuh: DiT-L/2's block at T = 256 (whole-row
    mode) and T = 272 (key blocks)."""
    from lfm_tpu_torch.kernels.dit_block import fused_dit_block, reference_block
    from lfm_tpu_torch.kernels.dit_block_train import (block_train_fwd,
                                                       reference_block_fwd_streams)

    args = _block_args(cuda, n, t, c)
    assert _within(fused_dit_block(**args, num_heads=heads),
                   reference_block(**args, num_heads=heads), args["x"])
    got = block_train_fwd(**args, num_heads=heads)
    want = reference_block_fwd_streams(**args, num_heads=heads)
    names = ("out", "x1", "h2", "pr", "qkv", "ao", "u")
    for name, g, w in zip(names, got, want):
        base = args["x"] if name in ("out", "x1") else None
        assert _within(g, w, base), (name, _rel(g, w))


def test_sm90_attention_builds_without_spills(cuda):
    """ptxas's report of the wgmma attention: all 8 forward instances (2
    modes x 2 padded head dims x NORM_P) and all 4 of bf16 K3 (2 kernels x 2
    padded head dims) built, none spills."""
    from lfm_tpu_torch.kernels import _build

    _build.load_library()
    usage = {k: v for k, v in _build.ptxas_usage("attention_sm90").items() if "attn_" in k}
    assert len(usage) == 8
    bwd = {k: v for k, v in _build.ptxas_usage("attention_bwd").items() if "attn_bwd" in k}
    assert len(bwd) == 4
    usage.update(bwd)
    for name, u in usage.items():
        assert u["spill_stores"] == 0 and u["spill_loads"] == 0 and u["registers"] <= 255, name


# the NT GEMM of gemm_sm90.cuh through its own wrapper, every epilogue:
# (epilogue, M, K, N, bias, resid dtype, aux, aux2). M = 300 ends inside a
# 128-row tile; N = 384 and 1152 (C = 384 and 1152), and every N at M = 300
# or 256, take 128-wide tiles; M = 8192 (the train step's N*T) 256-wide ones
GEMM_CASES = [
    ("bias", 300, 1024, 3072, True, None, False, False),
    ("bias", 8192, 1024, 3072, True, None, False, False),
    ("store", 256, 128, 384, False, None, False, False),
    ("gelu", 300, 384, 1536, False, None, False, False),
    ("gelu", 8192, 1024, 4096, True, None, False, False),
    ("gelu_aux", 300, 1152, 1152, True, None, True, False),
    ("gelu_aux", 256, 256, 1024, True, None, False, False),
    ("gated", 300, 256, 384, True, torch.bfloat16, False, False),
    ("gated", 300, 1536, 384, True, torch.float32, False, False),
    ("gated_aux", 8192, 1024, 1024, True, torch.bfloat16, True, True),
    ("gated_aux", 8192, 4096, 1024, True, torch.float32, True, False),
    ("gated_aux", 300, 384, 1152, False, torch.bfloat16, True, False),
]


@pytest.mark.parametrize("epilogue,m,k,n,bias,resid,aux,aux2", GEMM_CASES)
def test_sm90_gemm_matches_plain(cuda, epilogue, m, k, n, bias, resid, aux, aux2):
    """The wgmma + TMA GEMM against its plain version: each f32 output
    within 1e-4 of its largest plain value (f32 sums in another order),
    each bf16 output within one bf16 ulp of its largest (a rounding that
    falls the other way), a gated bf16 output also within 2e-2 of the
    update resid + gate * value - resid."""
    from lfm_tpu_torch.kernels.gemm import GEMM, gemm, reference_gemm

    def rn(*s, scale=1.0, dtype=torch.bfloat16):
        return (scale * torch.randn(*s, generator=cuda, device="cuda")).to(dtype)

    tokens = 100 if m == 300 else 64
    a, w = rn(m, k), rn(n, k, scale=k ** -0.5)
    kw = dict(epilogue=epilogue, aux=aux, aux2=aux2)
    if bias:
        kw["bias"] = rn(n, scale=0.1)
    if resid is not None:
        kw.update(resid=rn(m, n, dtype=resid), mod=rn(m // tokens, 6 * n, scale=0.3), gate=4,
                  tokens=tokens, out_dtype=torch.float32 if resid == torch.bfloat16
                  else torch.bfloat16)
    before = GEMM.count
    got = gemm(a, w, **kw)
    torch.cuda.synchronize()
    assert GEMM.count == before + 1
    want = reference_gemm(a, w, **kw)
    for name, g, wt in zip(("out", "aux", "aux2"), got, want):
        assert (g is None) == (wt is None), name
        if g is None:
            continue
        assert g.dtype == wt.dtype and g.shape == (m, n), name
        err = float((g.float() - wt.float()).abs().max())
        top = float(wt.float().abs().max())
        assert top > 0 and err <= (1e-4 if g.dtype == torch.float32 else 2.0 ** -7) * top, \
            (name, err, top)
        if name == "out" and g.dtype == torch.bfloat16 and resid is not None:
            assert _within(g, wt, kw["resid"]), name


def test_sm90_gemm_refuses_what_it_does_not_take(cuda):
    from lfm_tpu_torch.kernels.gemm import gemm

    a = torch.zeros(64, 128, device="cuda", dtype=torch.bfloat16)
    w = torch.zeros(256, 128, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="K % 64"):
        gemm(a[:, :96].contiguous(), w[:, :96].contiguous())
    with pytest.raises(ValueError, match="N % 128"):
        gemm(a, w[:192].contiguous())
    with pytest.raises(ValueError, match="float32 resid into bfloat16"):
        gemm(a, w, epilogue="gated", resid=torch.zeros(64, 256, device="cuda"),
             mod=torch.zeros(1, 6 * 256, device="cuda", dtype=torch.bfloat16), tokens=64,
             out_dtype=torch.float32)


def test_sm90_gemm_builds_without_spills(cuda):
    """ptxas's report of the NT GEMM: its 8 instances (4 epilogue kinds x 2
    tile widths) built, none spills; and no instance of the WMMA
    gemm_kernel is left in any source (K5's attention backward runs the NN
    and TN wgmma GEMM too)."""
    import re

    from lfm_tpu_torch.kernels import _build

    _build.load_library()
    usage = {k: v for k, v in _build.ptxas_usage("gemm_sm90").items() if "gemm_sm90_kernel" in k}
    assert len(usage) == 8
    for name, u in usage.items():
        assert u["spill_stores"] == 0 and u["spill_loads"] == 0 and u["registers"] <= 255, name
    layouts = {stem: [int(m.group(1)) for k in _build.ptxas_usage(stem)
                      for m in [re.search(r"11gemm_kernelI.*?Li(\d)EEEv", k)] if m]
               for stem in ("dit_block", "dit_block_train", "int8_gemm")}
    assert layouts == {"dit_block": [], "dit_block_train": [], "int8_gemm": []}


# the NN and TN layouts of gemm_sm90.cuh through their own wrappers: (layout,
# epilogue, M, K, N). M = 300 and K = 200 end inside a tile and a k step (K
# zero-filled by TMA); N = 384 and 1152 take 128-wide tiles; K5 mlp's four
# GEMMs at N = 8 (M = 2048 token rows, C 1024, hidden 4096)
GEMM_BWD_CASES = [
    ("nn", "store", 300, 256, 384), ("nn", "store", 2048, 4096, 1024),
    ("nn", "dgelu", 300, 200, 512), ("nn", "dgelu", 2048, 1024, 4096),
    ("nn", "dgelu", 256, 384, 1152),
    ("tn", "store", 1024, 2048, 4096), ("tn", "store", 4096, 2048, 1024),
    ("tn", "store", 384, 200, 1152), ("tn", "store", 136, 96, 256),
]


@pytest.mark.parametrize("layout,epilogue,m,k,n", GEMM_BWD_CASES)
def test_sm90_gemm_nn_tn_match_plain(cuda, layout, epilogue, m, k, n):
    """The NN and TN GEMMs against their plain versions: an f32 output
    within 1e-4 of its largest plain value and dgelu's column sums within
    1e-4 of their largest (f32 sums in another order), du and gb within one
    bf16 ulp of their largest; a rerun gives the same bits (fixed-order
    sums)."""
    from lfm_tpu_torch.kernels.gemm import (GEMM, gemm_nn, gemm_tn, reference_gemm_nn,
                                            reference_gemm_tn)

    def rn(*s, scale=1.0):
        return (scale * torch.randn(*s, generator=cuda, device="cuda")).bfloat16()

    a = rn(m, k) if layout == "nn" else rn(k, m)
    b = rn(k, n, scale=k ** -0.5)
    u = rn(m, n) if epilogue == "dgelu" else None
    before = GEMM.count
    if layout == "nn":
        got, again = (gemm_nn(a, b, epilogue=epilogue, u=u) for _ in range(2))
        want = reference_gemm_nn(a, b, epilogue=epilogue, u=u)
    else:
        got, again = gemm_tn(a, b), gemm_tn(a, b)
        want = reference_gemm_tn(a, b)
    torch.cuda.synchronize()
    assert GEMM.count == before + 2
    got, again, want = ((x,) if torch.is_tensor(x) else x for x in (got, again, want))
    for g, g2, w in zip(got, again, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, g2)
        err, top = float((g.float() - w.float()).abs().max()), float(w.float().abs().max())
        assert top > 0 and err <= (1e-4 if g.dtype == torch.float32 else 2.0 ** -7) * top, \
            (err, top)


@pytest.mark.parametrize("m,k,n", [(300, 256, 384), (2048, 1024, 1024), (8192, 1024, 1024)])
def test_sm90_gemm_nn_into_bf16_matches_plain(cuda, m, k, n):
    """The NN store into bf16 (K5 attn's do = bf16(dpr Wproj); at N = 8 and
    32 of DiT-L/2's block) against its plain version within one bf16 ulp of
    the largest value; a rerun gives the same bits."""
    from lfm_tpu_torch.kernels.gemm import GEMM, gemm_nn, reference_gemm_nn

    a = torch.randn(m, k, generator=cuda, device="cuda").bfloat16()
    b = (k ** -0.5 * torch.randn(k, n, generator=cuda, device="cuda")).bfloat16()
    before = GEMM.count
    got, again = (gemm_nn(a, b, out_dtype=torch.bfloat16) for _ in range(2))
    torch.cuda.synchronize()
    assert GEMM.count == before + 2
    want = reference_gemm_nn(a, b, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n) and torch.equal(got, again)
    err, top = float((got.float() - want.float()).abs().max()), float(want.float().abs().max())
    assert top > 0 and err <= 2.0 ** -7 * top, (err, top)


def test_sm90_gemm_nn_tn_refuse_what_they_do_not_take(cuda):
    """The wrappers' refusals on the card, and the C entry's own below them
    (a TN M not a multiple of 8, dgelu into f32)."""
    from lfm_tpu_torch.kernels import _build
    from lfm_tpu_torch.kernels.gemm import gemm_nn, gemm_tn

    a = torch.zeros(64, 128, device="cuda", dtype=torch.bfloat16)
    b = torch.zeros(128, 256, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="N % 128"):
        gemm_nn(a, b[:, :192].contiguous())
    with pytest.raises(ValueError, match="K % 8"):
        gemm_nn(a[:, :100].contiguous(), b[:100].contiguous())
    with pytest.raises(ValueError, match="dgelu needs u"):
        gemm_nn(a, b, epilogue="dgelu")
    with pytest.raises(ValueError, match="M % 8"):
        gemm_tn(b[:, :100].contiguous(), b)
    out = torch.empty(64, 256, device="cuda")
    lib = _build.load_library()
    stream = torch.cuda.current_stream().cuda_stream
    assert lib.lfm_gemm_bwd(b.data_ptr(), b.data_ptr(), out.data_ptr(), None, None, None, 2, 5,
                            1, 100, 256, 128, stream) != 0  # TN, M = 100
    assert lib.lfm_gemm_bwd(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.data_ptr(),
                            out.data_ptr(), None, 1, 6, 1, 64, 256, 128, stream) != 0  # to f32


@pytest.mark.parametrize("layout,m,n", [("nn", 8192, 4096), ("tn", 1024, 4096),
                                        ("nn", 512, 1152), ("tn", 1152, 4608)])
def test_sm90_gemm_nn_tn_launch_the_tile_the_wrapper_names(cuda, layout, m, n):
    """launch_gemm_bwd's tile width (the kernel's third template argument in
    the profiler's name) and grid are gemm_tile's."""
    from torch.profiler import ProfilerActivity, profile

    from lfm_tpu_torch.kernels.gemm import gemm_nn, gemm_tile, gemm_tn

    k = 64
    a = torch.zeros((m, k) if layout == "nn" else (k, m), device="cuda", dtype=torch.bfloat16)
    b = torch.zeros(k, n, device="cuda", dtype=torch.bfloat16)
    run = (lambda: gemm_nn(a, b)) if layout == "nn" else (lambda: gemm_tn(a, b))
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
              and "gemm_sm90_kernel" in e.name]
    bn, _ = gemm_tile(m, n)
    lay = 1 if layout == "nn" else 2
    assert len(events) == 1 and f"gemm_sm90_kernel<{lay}, 0, {bn}, " in events[0].name, \
        [e.name for e in events]


def test_sm90_gemm_bwd_builds_without_spills(cuda):
    """ptxas's report of the NN and TN GEMMs (gemm_sm90_bwd.cu): 8 instances
    (NN dgelu into bf16, NN store into f32 and bf16, TN store into f32, x 2
    tile widths), none spills."""
    from lfm_tpu_torch.kernels import _build

    _build.load_library()
    usage = {k: v for k, v in _build.ptxas_usage("gemm_sm90_bwd").items()
             if "gemm_sm90_kernel" in k}
    assert len(usage) == 8, sorted(usage)
    for name, u in usage.items():
        assert u["spill_stores"] == 0 and u["spill_loads"] == 0 and u["registers"] <= 255, name


@pytest.mark.parametrize("mode", ["full", "slim"])
@pytest.mark.parametrize("n,t,c,heads", K5_SHAPES)
def test_block_train_fwd_kernel_matches_plain(cuda, n, t, c, heads, mode):
    from lfm_tpu_torch.kernels.dit_block_train import (BLOCK_TRAIN_FWD, block_train_fwd,
                                                       reference_block_fwd_streams)

    args = _block_args(cuda, n, t, c)
    before = BLOCK_TRAIN_FWD.count
    got = block_train_fwd(**args, num_heads=heads, save_streams=mode)
    torch.cuda.synchronize()
    assert BLOCK_TRAIN_FWD.count == before + 1
    want = reference_block_fwd_streams(**args, num_heads=heads, save_streams=mode)
    names = ("out", "h2", "pr", "qkv") if mode == "slim" else ("out", "x1", "h2", "pr", "qkv",
                                                              "ao", "u")
    assert len(got) == len(names)
    for name, g, w in zip(names, got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape, name
        base = args["x"] if name in ("out", "x1") else None
        assert _within(g, w, base), (name, _rel(g, w))


@pytest.mark.parametrize("n,t,c,heads", K5_SHAPES)
def test_block_train_bwd_kernels_match_plain(cuda, n, t, c, heads):
    from lfm_tpu_torch.kernels.dit_block_train import (ATTN_BWD, MLP_BWD, attn_bwd,
                                                       block_train_fwd, mlp_bwd,
                                                       reference_attn_bwd, reference_mlp_bwd)

    args = _block_args(cuda, n, t, c)
    _, x1, h2, pr, qkv, ao, u = block_train_fwd(**args, num_heads=heads)
    dy = torch.randn(n, t, c, generator=cuda, device="cuda").bfloat16()
    margs = (x1, args["mod"], h2, u, args["w1"], args["w2"], dy)
    before = MLP_BWD.count
    got = mlp_bwd(*margs)
    torch.cuda.synchronize()
    assert MLP_BWD.count == before + 1
    want = reference_mlp_bwd(*margs)
    for name, g, w in zip(("dx1", "dmod", "dw1", "db1", "dw2", "db2"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert _within(g, w, dy if name == "dx1" else None), (name, _rel(g, w))
    dx1 = got[0]
    aargs = (args["x"], args["mod"], pr, qkv, ao, args["wqkv"], args["wproj"], dx1)
    before = ATTN_BWD.count
    got = attn_bwd(*aargs, num_heads=heads)
    torch.cuda.synchronize()
    assert ATTN_BWD.count == before + 1
    want = reference_attn_bwd(*aargs, num_heads=heads)
    for name, g, w in zip(("dx", "dmod", "dwqkv", "dbqkv", "dwproj", "dbproj"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert _within(g, w, dx1 if name == "dx" else None), (name, _rel(g, w))


def test_mlp_bwd_is_deterministic(cuda):
    """K5 mlp at N = 8, DiT-L/2's block: two calls on the same inputs give the
    same bits in all six outputs (fixed-order sums, no atomics), and its path
    launches no WMMA GEMM (mma.sync)."""
    from torch.profiler import ProfilerActivity, profile

    from lfm_tpu_torch.kernels.dit_block_train import block_train_fwd, mlp_bwd

    args = _block_args(cuda, 8, 256, 1024)
    _, x1, h2, pr, qkv, ao, u = block_train_fwd(**args, num_heads=16)
    dy = torch.randn(8, 256, 1024, generator=cuda, device="cuda").bfloat16()
    margs = (x1, args["mod"], h2, u, args["w1"], args["w2"], dy)
    first = [g.clone() for g in mlp_bwd(*margs)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        again = mlp_bwd(*margs)
        torch.cuda.synchronize()
    for name, g, g2 in zip(("dx1", "dmod", "dw1", "db1", "dw2", "db2"), first, again):
        assert torch.equal(g, g2), name
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("gemm_sm90_kernel" in name for name in names) == 4, names
    assert not [name for name in names if "lfm::gemm_kernel" in name], names


@pytest.mark.parametrize("n", [8, 32])
def test_attn_bwd_matches_plain_and_is_deterministic(cuda, n):
    """K5 attn at N = 8 and 32, DiT-L/2's block, on the kernel forward's
    streams: all six outputs against the plain version (2e-2 of the largest
    plain value; dx against the update |plain - dx1|), two calls give the
    same bits (no atomics, no split of K), and its path launches its four
    GEMMs on the wgmma kernel (two NN, two TN) and no WMMA GEMM."""
    from torch.profiler import ProfilerActivity, profile

    from lfm_tpu_torch.kernels.dit_block_train import (attn_bwd, block_train_fwd,
                                                       reference_attn_bwd)

    args = _block_args(cuda, n, 256, 1024)
    _, _, _, pr, qkv, ao, _ = block_train_fwd(**args, num_heads=16)
    dx1 = torch.randn(n, 256, 1024, generator=cuda, device="cuda").bfloat16()
    aargs = (args["x"], args["mod"], pr, qkv, ao, args["wqkv"], args["wproj"], dx1)
    first = [g.clone() for g in attn_bwd(*aargs, num_heads=16)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        again = attn_bwd(*aargs, num_heads=16)
        torch.cuda.synchronize()
    want = reference_attn_bwd(*aargs, num_heads=16)
    for name, g, g2, w in zip(("dx", "dmod", "dwqkv", "dbqkv", "dwproj", "dbproj"), first, again,
                              want):
        assert torch.equal(g, g2), name
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert _within(g, w, dx1 if name == "dx" else None), (name, _rel(g, w))
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    gemms = [name for name in names if "gemm_sm90_kernel" in name]
    assert len(gemms) == 4, names
    assert sorted(name.split("gemm_sm90_kernel<")[1][0] for name in gemms) == ["1", "1", "2", "2"]
    assert not [name for name in names if "lfm::gemm_kernel" in name], names


@pytest.mark.parametrize("mode", [dict(), dict(pallas_bwd=True), dict(save_streams="slim")])
def test_fused_block_train_on_the_card_matches_the_plain_path(cuda, mode):
    """make_fused_block_train on CUDA tensors (its kernels, K3 in the hybrid
    backward, K1 in slim's recompute) against the same block on CPU tensors
    (the plain versions): the output and all 10 cotangents within 2e-2."""
    from lfm_tpu_torch.kernels.dit_block_train import (ATTN_BWD, BLOCK_TRAIN_FWD, MLP_BWD,
                                                       make_fused_block_train)
    from lfm_tpu_torch.kernels.flash_attention import ATTENTION_SMALL, ATTENTION_SMALL_BWD

    args = _block_args(cuda, 4, 64, 256)
    dy = torch.randn(4, 64, 256, generator=cuda, device="cuda").bfloat16()
    block = make_fused_block_train(4, 2, 2, **mode)
    results = []
    for dev in ("cuda", "cpu"):
        leaves = [a.detach().to(dev).requires_grad_(True) for a in args.values()]
        counters = (BLOCK_TRAIN_FWD, MLP_BWD, ATTN_BWD, ATTENTION_SMALL, ATTENTION_SMALL_BWD)
        before = [k.count for k in counters]
        out = block(*leaves)
        grads = torch.autograd.grad(out, leaves, dy.to(dev))
        launched = [k.count - b for k, b in zip(counters, before)]
        results.append((out, grads, launched))
    (out, grads, launched), (want_out, want_grads, cpu_launched) = results
    pallas, slim = mode.get("pallas_bwd", False), mode.get("save_streams") == "slim"
    assert launched == [1, int(pallas), int(pallas), int(slim), int(not pallas)]
    assert cpu_launched == [0] * 5
    assert _within(out.detach().cpu(), want_out.detach(), args["x"].cpu())
    for name, g, w in zip(args, grads, want_grads):
        assert g.dtype == torch.bfloat16, name
        assert _within(g.cpu(), w), (name, _rel(g.cpu(), w))


def test_block_train_kernels_refuse_what_they_do_not_take(cuda):
    """On a CUDA tensor the wrappers launch or raise: no CPU computation."""
    from lfm_tpu_torch.kernels.dit_block_train import attn_bwd, block_train_fwd, mlp_bwd

    args = _block_args(cuda, 2, 64, 128)
    with pytest.raises(ValueError, match="bf16"):
        block_train_fwd(**{**args, "x": args["x"].float()}, num_heads=2)
    with pytest.raises(ValueError, match="head dim"):
        block_train_fwd(**args, num_heads=4)  # head dim 32 is not built
    odd = _block_args(cuda, 1, 17, 128)  # N*T = 17 rows: not whole 32-row GEMM steps
    with pytest.raises(ValueError, match="unsupported shape"):
        block_train_fwd(**odd, num_heads=2)
    narrow = _block_args(cuda, 2, 64, 192)  # C % 128 != 0
    with pytest.raises(ValueError, match="unsupported shape"):
        block_train_fwd(**narrow, num_heads=3)
    # C > 4096: wider than the rows the LayerNorm backward holds in registers
    wide = torch.zeros(1, 32, 4224, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="unsupported shape"):
        mlp_bwd(wide, args["mod"], wide, args["x"], args["w1"], args["w2"], wide)
    with pytest.raises(ValueError, match="unsupported shape"):
        attn_bwd(wide, args["mod"], wide, wide, wide, args["wqkv"], args["wproj"], wide,
                 num_heads=66)
    x = args["x"]
    with pytest.raises(ValueError, match="contiguous"):
        mlp_bwd(x, args["mod"], x, torch.empty(2, 64, 512, device="cuda").bfloat16().transpose(0, 1)
                .contiguous().transpose(0, 1), args["w1"], args["w2"], x)
    with pytest.raises(ValueError, match="bf16"):
        attn_bwd(x, args["mod"], x, torch.empty(2, 64, 384, device="cuda"), x, args["wqkv"],
                 args["wproj"], x, num_heads=2)


def test_fused_train_step_launches_k5_forward_and_k3(cuda):
    """One make_train_step(model_apply=dit_fused_model_apply(model)) step of a
    2-block DiT at C = 256 on latents: the blocks launch K5's forward and K3
    once each, nothing else, and the parameters move."""
    from lfm_tpu_torch.kernels.dit_block_train import ATTN_BWD, BLOCK_TRAIN_FWD, MLP_BWD
    from lfm_tpu_torch.kernels.flash_attention import ATTENTION_SMALL, ATTENTION_SMALL_BWD
    from lfm_tpu_torch.nn.dit import DiT
    from lfm_tpu_torch.nn.init import seeded_init_
    from lfm_tpu_torch.train.state import AdamW, create_train_state
    from lfm_tpu_torch.nn.dit_fused import dit_fused_model_apply
    from lfm_tpu_torch.train.train import make_train_step

    model = DiT(img_resolution=16, patch_size=2, hidden_size=256, depth=2, num_heads=4,
                dtype=torch.bfloat16).to("cuda")
    seeded_init_(model, 0)
    state = create_train_state(model)
    p0 = [p.detach().clone() for p in state.params]
    step = make_train_step(model, AdamW(lr=lambda s: 1e-3),
                           model_apply=dit_fused_model_apply(model), is_latent_data=True)
    counters = (BLOCK_TRAIN_FWD, ATTENTION_SMALL_BWD, MLP_BWD, ATTN_BWD, ATTENTION_SMALL)
    before = [k.count for k in counters]
    loss, gnorm = step(state, {"x": torch.randn(4, 16, 16, 4, generator=cuda, device="cuda")})
    torch.cuda.synchronize()
    assert [k.count - b for k, b in zip(counters, before)] == [2, 2, 0, 0, 0]
    assert bool(torch.isfinite(loss)) and bool(torch.isfinite(gnorm))
    assert all(float((a - b.detach()).abs().max()) > 0 for a, b in zip(p0, state.params))


# P1: the int8 GEMM (int8_gemm_sm90.cuh), row quantization and the bf16 MLP
# (int8_gemm.cu).
# quant_rows is bit-exact (the same IEEE divisions and ties to even as its
# plain version); int8_dense within INT8_TOL of the largest plain output
# (exact int32 sums and the same f32 dequant, only the GELU's tanh may
# differ in the last bit); int8_mlp and bf16_mlp after INT8_CHAIN chained
# steps within 2e-2 (a GELU output that rounds the other way moves one int8
# step in the next product; bf16 sums in another order round the other way).
INT8_TOL = 1e-5
MLP_TOL = 2e-2
INT8_CHAIN = 8


def _int8_weight(gen, n, k):
    from lfm_tpu_torch.nn.dit_int8 import quantize_weight

    return quantize_weight(torch.randn(n, k, generator=gen, device="cuda") * k ** -0.5)


@pytest.mark.parametrize("dtype,shape", [(torch.bfloat16, (300, 1024)),
                                         (torch.float32, (100, 4096)),
                                         (torch.float32, (7, 128))])
def test_quant_rows_kernel_is_bit_exact(cuda, dtype, shape):
    from lfm_tpu_torch.kernels.int8_matmul import QUANT_ROWS, quant_rows, reference_quant_rows

    x = (3 * torch.randn(*shape, generator=cuda, device="cuda")).to(dtype)
    # row 0 hits the ties: max 127, so s = 1 and x / s = k + 0.5
    x[0] = 0.0
    x[0, :6] = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5], device="cuda").to(dtype)
    before = QUANT_ROWS.count
    q, s = quant_rows(x)
    torch.cuda.synchronize()
    assert QUANT_ROWS.count == before + 1 and q.dtype == torch.int8 and s.shape == (shape[0], 1)
    wq, ws = reference_quant_rows(x)
    assert torch.equal(q, wq) and torch.equal(s, ws)
    assert q[0, :6].tolist() == [127, 0, 2, 2, 0, -2]


@pytest.mark.parametrize("m,k,n", [(300, 128, 384), (257, 512, 128), (64, 1024, 256)])
@pytest.mark.parametrize("epilogue,out_dtype,bias", [("store", torch.float32, True),
                                                     ("store", torch.bfloat16, True),
                                                     ("gelu", torch.float32, True),
                                                     ("store", torch.float32, False)])
def test_int8_dense_kernel_matches_plain(cuda, m, k, n, epilogue, out_dtype, bias):
    from lfm_tpu_torch.kernels.int8_matmul import INT8_DENSE, int8_dense, reference_int8_dense

    x = torch.randn(m, k, generator=cuda, device="cuda")
    q, s = _int8_weight(cuda, n, k)
    b = (0.1 * torch.randn(n, generator=cuda, device="cuda")).bfloat16() if bias else None
    before = INT8_DENSE.count
    got = int8_dense(x, q, s, b, epilogue, out_dtype)
    torch.cuda.synchronize()
    assert INT8_DENSE.count == before + 1 and got.dtype == out_dtype and got.shape == (m, n)
    want = reference_int8_dense(x, q, s, b, epilogue, out_dtype)
    assert _rel(got, want) <= (INT8_TOL if out_dtype == torch.float32 else 2.0 ** -8)


# the s8 wgmma GEMM of int8_gemm_sm90.cuh against its plain version, bit for
# bit: M = 300 ends inside a tile, N = 384 takes the 128-wide tile and 512
# the 256-wide one, K = 192 ends in half a k step (TMA zero-fills the rest)
# and K = 1024 takes eight; M = 5200 makes more tiles than an H100 has SMs
# (164 of 128 rows at N = 1024), so that a CTA walks several
@pytest.mark.parametrize("m,k,n", [(300, 192, 384), (300, 192, 512), (1000, 1024, 256),
                                   (5200, 192, 1024)])
@pytest.mark.parametrize("epilogue,out_dtype", [("store", torch.float32),
                                                ("gelu", torch.float32),
                                                ("store", torch.bfloat16),
                                                ("gelu", torch.bfloat16)])
def test_int8_gemm_sm90_equals_plain(cuda, m, k, n, epilogue, out_dtype):
    from lfm_tpu_torch.kernels.int8_matmul import _launch_gemm, quant_rows, reference_int8_gemm

    x = torch.randn(m, k, generator=cuda, device="cuda")
    qx, sx = quant_rows(x)
    q, s = _int8_weight(cuda, n, k)
    b = (0.1 * torch.randn(n, generator=cuda, device="cuda")).bfloat16()
    got = _launch_gemm(qx, sx, q, s, b, epilogue == "gelu", out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == (m, n)
    assert torch.equal(got, reference_int8_gemm(qx, sx, q, s, b, epilogue, out_dtype))
    got = _launch_gemm(qx, sx, q, s, None, False, torch.float32)
    assert torch.equal(got, reference_int8_gemm(qx, sx, q, s, None))


@pytest.mark.parametrize("n,epilogue,out_dtype", [(3072, "store", torch.bfloat16),
                                                   (1024, "store", torch.float32),
                                                   (4096, "gelu", torch.float32),
                                                   (3456, "store", torch.bfloat16)])
def test_int8_dense_launches_the_tile_the_wrapper_names(cuda, n, epilogue, out_dtype):
    """lfm_int8_gemm's own choice of tile width (its kernel's first template
    argument in the profiler's name) is int8_gemm_tile's."""
    from torch.profiler import ProfilerActivity, profile

    from lfm_tpu_torch.kernels.int8_matmul import int8_dense, int8_gemm_tile

    x = torch.randn(256, 128, generator=cuda, device="cuda")
    q, s = _int8_weight(cuda, n, 128)
    int8_dense(x, q, s, None, epilogue, out_dtype)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        int8_dense(x, q, s, None, epilogue, out_dtype)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
             and "int8_gemm_sm90_kernel" in e.name]
    tile = int8_gemm_tile(n, 128)
    assert len(names) == 1 and f"int8_gemm_sm90_kernel<{tile}, " in names[0], names


def test_int8_gemm_sm90_refuses_what_the_wrapper_refuses(cuda):
    """The C entry's own checks, below the wrapper's: N = 320 (not a multiple
    of 128) and K = 96 (not of 64)."""
    from lfm_tpu_torch.kernels.int8_matmul import _launch_gemm, quant_rows

    for n, k in ((320, 128), (256, 96)):
        qx, sx = quant_rows(torch.randn(64, k, device="cuda"))
        q, s = _int8_weight(cuda, n, k)
        with pytest.raises(RuntimeError, match="int8_gemm: CUDA error"):
            _launch_gemm(qx, sx, q, s, None, False, torch.float32)


def test_int8_gemm_sm90_builds_without_spills(cuda):
    """ptxas's report of the int8 GEMM: its 8 instances (tile widths 256 and
    128; GELU or not; f32 or bf16 out) built, none spills, and no WMMA int8
    kernel is left."""
    from lfm_tpu_torch.kernels import _build

    _build.load_library()
    usage = _build.ptxas_usage("int8_gemm")
    sm90 = {k: v for k, v in usage.items() if "int8_gemm_sm90_kernel" in k}
    assert len(sm90) == 8
    for name, u in sm90.items():
        assert u["spill_stores"] == 0 and u["spill_loads"] == 0 and u["registers"] <= 255, name
    assert not [k for k in usage if "int8_gemm_kernel" in k]


def test_int8_mlp_and_bf16_mlp_chains_match_plain(cuda):
    from lfm_tpu_torch.kernels.int8_matmul import (BF16_MLP, INT8_MLP, bf16_mlp, int8_mlp,
                                                   reference_bf16_mlp, reference_int8_mlp)

    rows, d, h = 1000, 256, 1024
    q1, s1 = _int8_weight(cuda, h, d)
    q2, s2 = _int8_weight(cuda, d, h)
    s1, s2 = 1.25 * s1, 1.25 * s2  # a chain that neither vanishes nor explodes
    w1, w2 = (q1.float() * s1[:, None]).bfloat16(), (q2.float() * s2[:, None]).bfloat16()
    x = torch.randn(rows, d, generator=cuda, device="cuda").bfloat16()
    before = (INT8_MLP.count, BF16_MLP.count)
    gi, wi, gb, wb = x.float(), x.float(), x, x
    for _ in range(INT8_CHAIN):
        gi = int8_mlp(gi, q1, s1, None, q2, s2, None)
        wi = reference_int8_mlp(wi, q1, s1, None, q2, s2, None)
        gb, wb = bf16_mlp(gb, w1, w2), reference_bf16_mlp(wb, w1, w2)
    torch.cuda.synchronize()
    assert (INT8_MLP.count, BF16_MLP.count) == (before[0] + INT8_CHAIN, before[1] + INT8_CHAIN)
    assert float(wi.abs().max()) > 1e-2 and float(wb.float().abs().max()) > 1e-2
    assert _rel(gi, wi) <= MLP_TOL and _rel(gb, wb) <= MLP_TOL


def test_int8_kernels_refuse_what_they_do_not_take(cuda):
    from lfm_tpu_torch.kernels.int8_matmul import bf16_mlp, int8_dense, quant_rows

    x = torch.randn(64, 128, device="cuda")
    q, s = _int8_weight(cuda, 256, 128)
    with pytest.raises(ValueError, match="N % 128"):
        int8_dense(x, q[:200].contiguous(), s[:200].contiguous())
    with pytest.raises(ValueError, match="K % 64"):
        int8_dense(x[:, :96].contiguous(), q[:, :96].contiguous(), s)
    with pytest.raises(ValueError, match="contiguous"):
        quant_rows(x.t())
    with pytest.raises(ValueError, match="bias"):
        int8_dense(x, q, s, torch.zeros(256, device="cuda"))
    with pytest.raises(ValueError, match="float16"):
        quant_rows(x.half())
    w = torch.zeros(256, 128, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="N % 128"):
        bf16_mlp(x.bfloat16()[:, :96].contiguous(), w[:, :96].contiguous(),
                 w.t()[:96].contiguous())


def test_small_dit_int8_velocity_matches_plain(cuda):
    """dit_int8_apply of a small DiT on the card: 4 int8_dense launches a
    block, nothing of K1 or K2, and the velocity within 1e-2 of the plain
    int8 path on the card (a few GELU outputs that round the other way
    change an int8 step of fc2's input, 3 blocks deep)."""
    from lfm_tpu_torch.kernels.dit_block import FUSED_DIT_BLOCK
    from lfm_tpu_torch.kernels.flash_attention import ATTENTION_SMALL
    from lfm_tpu_torch.kernels.int8_matmul import INT8_DENSE, QUANT_ROWS
    from lfm_tpu_torch.nn.dit import DiT
    from lfm_tpu_torch.nn.dit_int8 import dit_int8_apply, quantize_params_int8
    from lfm_tpu_torch.nn.init import seeded_init_

    model = DiT(img_resolution=16, patch_size=2, hidden_size=128, depth=3, num_heads=4,
                num_classes=10, dtype=torch.bfloat16, use_flash=True).to("cuda")
    seeded_init_(model, 0)
    qp = quantize_params_int8(model, model.state_dict())
    x = torch.randn(4, 16, 16, 4, generator=cuda, device="cuda")
    t = torch.linspace(0.1, 0.9, 4, device="cuda")
    y = torch.tensor([0, 3, 5, 9], device="cuda")
    counters = (INT8_DENSE, QUANT_ROWS, ATTENTION_SMALL, FUSED_DIT_BLOCK)
    before = [c.count for c in counters]
    with torch.no_grad():
        got = dit_int8_apply(model, qp, t, x, y)
        torch.cuda.synchronize()
        assert [c.count - b for c, b in zip(counters, before)] == [12, 12, 0, 0]
        want = dit_int8_apply(model, qp, t, x, y, plain=True)
    assert got.shape == (4, 16, 16, 4) and bool(torch.isfinite(got).all())
    assert _rel(got, want) <= 1e-2


def _small_downstream_adm(in_ch, use_flash, dtype=torch.float32):
    """A 2-level origin ADM at celeb256_adm's head width (C = 512, 4 heads,
    D = 128) with the downstream tasks' input channels, on the card."""
    from lfm_tpu_torch.nn.adm_unet import UNetModel

    return UNetModel(image_size=8, in_channels=in_ch, model_channels=256, channel_mult=(1, 2),
                     num_res_blocks=1, attention_resolutions=(2,), num_heads=4, dtype=dtype,
                     use_flash=use_flash).cuda()


@pytest.mark.parametrize("task", ["inpaint", "semantic"])
def test_cond_loss_gradients_through_k1_k3_match_plain(cuda, task):
    """cond_fm_loss of each downstream task on a small f32 ADM (9 or 8 input
    channels; semantic synthesis with the SpatialRescaler) through f32 K1 /
    K3: one K1 and one K3 per attention layer, and every gradient, the
    rescaler's too, within 1e-5 of the largest of its tensor (floored at
    1e-3 of the step's largest) of the same weights with use_flash=False,
    TF32 off."""
    from lfm_tpu_torch.core.device import no_tf32
    from lfm_tpu_torch.kernels.flash_attention import ATTENTION_SMALL, ATTENTION_SMALL_BWD
    from lfm_tpu_torch.nn.adm_unet import plan_layers
    from lfm_tpu_torch.nn.encoders import SpatialRescaler
    from lfm_tpu_torch.nn.init import seeded_init_
    from lfm_tpu_torch.train.conditional import (cond_fm_loss, inpainting_condition,
                                                 semantic_condition)
    from lfm_tpu_torch.vae.autoencoder_kl import AutoencoderKL

    vae = seeded_init_(AutoencoderKL((32, 32, 32, 32)).cuda(), 1).eval()
    x = torch.rand(4, 64, 64, 3, generator=cuda, device="cuda") * 2 - 1
    if task == "inpaint":
        mask = (torch.rand(4, 64, 64, 1, generator=cuda, device="cuda") < 0.3).float()
        batch, in_ch = {"x": x, "mask": mask, "masked": x * (1 - mask)}, 9
        cond_fn, n_eps = inpainting_condition(vae, 0.18215), 2
    else:
        batch = {"x": x, "seg": torch.randint(0, 7, (4, 64, 64), generator=cuda, device="cuda")}
        in_ch, cond_fn, n_eps = 8, semantic_condition(vae, 0.18215, 7), 1
    eps = [torch.randn(4, 8, 8, 4, generator=cuda, device="cuda") for _ in range(n_eps)]
    t = torch.rand(4, generator=cuda, device="cuda")
    z1 = torch.randn(4, 8, 8, 4, generator=cuda, device="cuda")
    grads, weights = {}, None
    for use_flash in (True, False):
        model = _small_downstream_adm(in_ch, use_flash)
        weights = weights or seeded_init_(model, 0).state_dict()
        model.load_state_dict(weights)
        rescaler = None
        if task == "semantic":
            rescaler = SpatialRescaler(3, in_channels=7, out_channels=4).cuda()
            rescaler.reset_parameters(torch.Generator(device="cuda").manual_seed(2))
        k1, k3 = ATTENTION_SMALL.count, ATTENTION_SMALL_BWD.count
        with no_tf32():
            cond_fm_loss(model, cond_fn, rescaler, batch, t, z1, eps=eps).backward()
        torch.cuda.synchronize()
        n_attn = sum(s.kind == "attn" for s in plan_layers(model.plan)) if use_flash else 0
        assert (ATTENTION_SMALL.count - k1, ATTENTION_SMALL_BWD.count - k3) == (n_attn, n_attn)
        named = list(model.named_parameters()) + (
            [] if rescaler is None else [("cond." + n, p) for n, p in rescaler.named_parameters()])
        grads[use_flash] = {n: p.grad for n, p in named}
    floor = 1e-3 * max(float(g.abs().max()) for g in grads[False].values())
    for name, want in grads[False].items():
        err = float((grads[True][name] - want).abs().max())
        assert err <= 1e-5 * max(float(want.abs().max()), floor), name
    if task == "semantic":
        assert float(grads[True]["cond.channel_mapper.weight"].abs().max()) > 0


def test_inpainting_sampler_on_the_card(cuda):
    """make_inpainting_sampler on a small bf16 9-channel ADM through K1,
    euler at 3 steps: (attention layers) x 3 K1 launches and nothing else,
    the composite equal to the input image outside the hole, bit for bit."""
    import dataclasses

    from lfm_tpu_torch.core.config import Config, SampleConfig
    from lfm_tpu_torch.kernels.flash_attention import ATTENTION_SMALL
    from lfm_tpu_torch.nn.adm_unet import plan_layers
    from lfm_tpu_torch.nn.init import seeded_init_
    from lfm_tpu_torch.sample.downstream import make_inpainting_sampler
    from lfm_tpu_torch.vae.autoencoder_kl import AutoencoderKL

    model = seeded_init_(_small_downstream_adm(9, True, torch.bfloat16), 0)
    vae = seeded_init_(AutoencoderKL((32, 32, 32, 32), dtype=torch.bfloat16).cuda(), 1)
    cfg = dataclasses.replace(Config(), sample=SampleConfig(method="euler", num_steps=3))
    img = torch.rand(2, 64, 64, 3, generator=cuda, device="cuda") * 2 - 1
    mask = torch.zeros(2, 64, 64, 1, device="cuda")
    mask[:, 16:48, 8:40] = 1
    before = ATTENTION_SMALL.count
    out = make_inpainting_sampler(cfg, model, None, vae, None, device="cuda")(
        img, mask, img * (1 - mask), [0, 1])
    torch.cuda.synchronize()
    assert out.nfe == 3.0
    assert ATTENTION_SMALL.count - before == 3 * sum(s.kind == "attn"
                                                      for s in plan_layers(model.plan))
    keep = (mask == 0).expand_as(img)
    assert torch.isfinite(out.images).all()
    assert torch.equal(out.images[keep], ((img + 1) / 2)[keep])
