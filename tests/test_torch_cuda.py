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
