"""The port's CUDA kernels against their plain versions on the card, at
small and ragged shapes (T not a multiple of the 64-row tiles, every head
dim the kernel is built for). Marked ``cuda``: they skip without a card. On the card, whose
machine has no JAX (tests/conftest.py imports it):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -p no:cacheprovider

Tolerances: bf16 outputs, max abs error within 2e-2 of unit-scale
attention outputs (a few bf16 ulps), and within 2e-2 of the block's largest
update |plain - x| (rounding that falls the other way in the two GEMM
chains; measured against the update, so the residual x cannot hide it).
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


def test_attention_small_refuses_unbuilt_head_dim(cuda):
    from lfm_tpu_torch.kernels.flash_attention import attention_small

    q = torch.randn(1, 64, 2, 32, generator=cuda, device="cuda").bfloat16()
    with pytest.raises(ValueError, match="head dim"):
        attention_small(q, q, q)
