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
of its plain paths' largest output (bf16 roundings over the UNet's depth).
"""

import importlib.util
from pathlib import Path

import pytest
import torch

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


@pytest.mark.parametrize("shape", [(2, 256, 4, 64), (3, 100, 2, 72), (1, 17, 3, 56),
                                   (2, 1024, 2, 80), (2, 64, 4, 64)])
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
                                         (1, 64, 1152, 16)])
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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t,d", [(256, 64), (1024, 64), (256, 72), (1024, 72), (100, 56)])
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
                                   (1, 64, 2, 256), (2, 100, 2, 128)])
def test_attention_small_wide_f32_heads_match_plain(cuda, shape):
    """The origin ADM's f32 attention: D = 128 and 256 at T = 16 and 64 (a
    quarter and all of one key tile), and a ragged T."""
    from lfm_tpu_torch.kernels.flash_attention import (ATTENTION_SMALL, attention_small,
                                                       reference_attention)

    q, k, v = (torch.randn(*shape, generator=cuda, device="cuda") for _ in range(3))
    before = ATTENTION_SMALL.count
    out = attention_small(q, k, v)
    torch.cuda.synchronize()
    assert ATTENTION_SMALL.count == before + 1
    assert _rel(out, reference_attention(q, k, v)) <= 1e-4
    with pytest.raises(ValueError, match="head dim"):
        attention_small(q.bfloat16(), k.bfloat16(), v.bfloat16())


@pytest.mark.parametrize("dtype,shape,bk", [
    (torch.bfloat16, (2, 2048, 2, 64), 512), (torch.bfloat16, (1, 1100, 2, 72), 512),
    (torch.bfloat16, (2, 256, 2, 56), 64), (torch.float32, (1, 2048, 2, 128), 512),
    (torch.float32, (1, 1030, 2, 80), 512)])
def test_flash_attention_kernel_matches_plain(cuda, dtype, shape, bk):
    """K4 against its plain version on the same key blocks: T past the gate,
    ragged T (1100 = 4 x 275, 1030 = 2 x 515 > 512, so 206-key blocks), and
    blocks of 64."""
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


@pytest.mark.parametrize("dtype,shape,offset", [
    (torch.bfloat16, (4, 32, 32, 256), 0.0), (torch.bfloat16, (2, 32, 32, 768), 0.0),
    (torch.bfloat16, (8, 4, 4, 1024), 0.0), (torch.bfloat16, (4, 32, 32, 256), 8.0),
    (torch.float32, (2, 32, 32, 256), 0.0), (torch.float32, (3, 5, 7, 96), 8.0)])
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
    with pytest.raises(ValueError, match="contiguous"):
        groupnorm_silu(x.transpose(1, 2), scale, bias)


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


# P1: the int8 GEMM, row quantization and the bf16 MLP (int8_gemm.cu).
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
