"""The NT GEMM's plain version (lfm_tpu_torch/kernels/gemm.py::reference_gemm,
the arithmetic of csrc/gemm_sm90.cuh) against the same products and
epilogues written with jnp as lfm_tpu/kernels/dit_block.py's
`_dit_block_kernel` writes them (dit_block.py:67-132): bf16 operands,
`dot_general` with f32 results, + the f32 bias, tanh-GELU, x + gate *
value, on seeded numpy inputs; and the wrapper's refusals, which do not
depend on the device.

Tolerances: an f32 output within 1e-5 of its largest value (f32 sums of
the same exact bf16 products in another order), a bf16 output within one
bf16 ulp of its largest value (2^-7: such a sum, or XLA's and torch's
tanh, rounds the other way now and then).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tests.torch_parity import leaves_process_as_found  # noqa: E402,F401

from lfm_tpu_torch.kernels.dit_block import layernorm_f32, reference_block_parts  # noqa: E402
from lfm_tpu_torch.kernels.gemm import GEMM, gemm, reference_gemm  # noqa: E402

BF, F32 = torch.bfloat16, torch.float32
F32_TOL, BF16_TOL = 1e-5, 2.0 ** -7


def _bf16(rng, shape, scale=1.0) -> np.ndarray:
    """Seeded normal values, rounded to bf16 and held as f32."""
    x = (scale * rng.standard_normal(shape)).astype(np.float32)
    return torch.from_numpy(x).to(BF).float().numpy()


def _jax_gemm(a, w, bias, epilogue, resid, mod, gate, tokens):
    """The epilogue in jnp, as `_dit_block_kernel` computes qkv, proj, h1 and
    h2 and their residuals (w in flax's (in, out) layout): (out, aux, aux2)
    in f32, aux = value + bias and aux2 = out before any rounding."""
    value = jax.lax.dot_general(jnp.asarray(a, jnp.bfloat16), jnp.asarray(w.T, jnp.bfloat16),
                                (((1,), (0,)), ((), ())), preferred_element_type=jnp.float32)
    if bias is not None and epilogue != "store":
        value = value + jnp.asarray(bias, jnp.bfloat16).astype(jnp.float32)
    aux = value
    if epilogue.startswith("gelu"):
        return jax.nn.gelu(value, approximate=True), aux, None
    if epilogue.startswith("gated"):
        m, n = value.shape
        g = jnp.asarray(mod, jnp.bfloat16).astype(jnp.float32).reshape(m // tokens, 1, 6, n)
        x = jnp.asarray(resid, jnp.float32).reshape(m // tokens, tokens, n)
        out = (x + g[:, :, gate] * value.reshape(m // tokens, tokens, n)).reshape(m, n)
        return out, aux, out
    return value, aux, None


# (epilogue, M, K, N, bias, resid dtype, aux, aux2): every epilogue the
# kernel is built for, M not a multiple of 128, N = 384 (C = 384), null
# bias (lfm_bf16_mlp's GELU), null aux (K5's slim streams)
CASES = [
    ("bias", 300, 128, 384, True, None, False, False),
    ("store", 64, 256, 256, False, None, False, False),
    ("gelu", 300, 192, 512, False, None, False, False),
    ("gelu", 128, 128, 384, True, None, False, False),
    ("gelu_aux", 300, 128, 512, True, None, True, False),
    ("gated", 300, 128, 384, True, BF, False, False),
    ("gated", 200, 512, 256, True, F32, False, False),
    ("gated_aux", 300, 128, 256, True, BF, True, True),
    ("gated_aux", 256, 256, 384, True, F32, True, False),
]


@pytest.mark.parametrize("epilogue,m,k,n,bias,resid,aux,aux2", CASES)
def test_reference_gemm_matches_jnp(epilogue, m, k, n, bias, resid, aux, aux2):
    rng = np.random.default_rng(m + k + n)
    tokens = 100 if m % 100 == 0 else 64
    a, w = _bf16(rng, (m, k)), _bf16(rng, (n, k), k ** -0.5)
    b = _bf16(rng, (n,), 0.1) if bias else None
    r = md = None
    kw = dict(epilogue=epilogue, aux=aux, aux2=aux2)
    if resid is not None:
        r = _bf16(rng, (m, n)) if resid == BF else rng.standard_normal((m, n)).astype(np.float32)
        md = _bf16(rng, (m // tokens, 6 * n), 0.3)
        kw.update(resid=torch.from_numpy(r).to(resid), mod=torch.from_numpy(md).to(BF), gate=4,
                  tokens=tokens, out_dtype=F32 if resid == BF else BF)
    got = gemm(torch.from_numpy(a).to(BF), torch.from_numpy(w).to(BF),
               None if b is None else torch.from_numpy(b).to(BF), **kw)
    want = jax.jit(_jax_gemm, static_argnums=(3, 6, 7))(a, w, b, epilogue, r, md, 4, tokens)
    for name, g, wt in zip(("out", "aux", "aux2"), got, want):
        if not {"aux": aux, "aux2": aux2}.get(name, True):
            assert g is None, name
            continue
        wt = np.array(wt, np.float32)
        if g.dtype == BF:  # the kernel rounds this output to bf16 once
            wt = torch.from_numpy(wt).to(BF).float().numpy()
        err = np.abs(g.float().numpy() - wt).max()
        tol = F32_TOL if g.dtype == F32 else BF16_TOL
        assert err <= tol * np.abs(wt).max(), (name, err, np.abs(wt).max())


def test_gemm_on_the_cpu_is_the_plain_version_and_launches_nothing():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(_bf16(rng, (100, 128))).to(BF)
    w = torch.from_numpy(_bf16(rng, (256, 128))).to(BF)
    before = GEMM.count
    got = gemm(a, w, epilogue="gelu")
    assert GEMM.count == before
    assert torch.equal(got[0], reference_gemm(a, w, epilogue="gelu")[0])
    assert got[1] is None and got[2] is None


def test_block_from_gemm_parts_is_reference_block():
    """reference_gemm's epilogues at K2's four call sites, with the
    LayerNorm and the block's attention between them, give
    reference_block's qkv and output: the GEMM's plain version keeps the
    block's rounding points."""
    rng = np.random.default_rng(1)
    n, t, c, heads = 2, 64, 128, 2
    hid = 4 * c

    def rn(*shape, scale=1.0):
        return torch.from_numpy(_bf16(rng, shape, scale)).to(BF)

    blk = dict(x=rn(n, t, c), mod=rn(n, 6 * c, scale=0.3), wqkv=rn(3 * c, c, scale=c ** -0.5),
               bqkv=rn(3 * c, scale=0.02), wproj=rn(c, c, scale=c ** -0.5),
               bproj=rn(c, scale=0.02), w1=rn(hid, c, scale=c ** -0.5), b1=rn(hid, scale=0.02),
               w2=rn(c, hid, scale=hid ** -0.5), b2=rn(c, scale=0.02))
    m6 = blk["mod"].float().view(n, 6, 1, c)

    def ln_mod(x, shift, scale):
        return (layernorm_f32(x.float().view(n, t, c)) * (1 + m6[:, scale])
                + m6[:, shift]).to(BF).view(n * t, c)

    parts = reference_block_parts(**blk, num_heads=heads)
    qkv = gemm(ln_mod(blk["x"], 0, 1), blk["wqkv"], blk["bqkv"])[0]
    want_qkv = parts["qkv"].reshape(n * t, 3 * c).float()
    assert float((qkv.float() - want_qkv).abs().max()) <= BF16_TOL * float(want_qkv.abs().max())
    ao = parts["ao"].reshape(n * t, c)  # the block's attention, not the GEMM's
    x1 = gemm(ao, blk["wproj"], blk["bproj"], epilogue="gated",
              resid=blk["x"].reshape(n * t, c), mod=blk["mod"], gate=2, tokens=t,
              out_dtype=F32)[0]
    u = gemm(ln_mod(x1, 3, 4), blk["w1"], blk["b1"], epilogue="gelu")[0]
    out = gemm(u, blk["w2"], blk["b2"], epilogue="gated", resid=x1, mod=blk["mod"], gate=5,
               tokens=t)[0]
    want = parts["out"]
    update = float((want.float() - blk["x"].float()).abs().max())
    err = float((out.view(n, t, c).float() - want.float()).abs().max())
    # bf16 roundings of the same values in both, one ulp of the largest
    # output at most where a sum in another order falls the other way
    assert err <= 2e-2 * update + BF16_TOL * float(want.float().abs().max())


def _refusal_args():
    a, w = torch.zeros(64, 128, dtype=BF), torch.zeros(256, 128, dtype=BF)
    mod = torch.zeros(1, 6 * 256, dtype=BF)
    return [
        ("K % 64", (a[:, :96].contiguous(), w[:, :96].contiguous()), {}),
        ("N % 128", (a, w[:192].contiguous()), {}),
        ("epilogue must be", (a, w), dict(epilogue="relu")),
        ("must be \\(M, K\\)", (a, w[:, :64].contiguous()), {}),
        ("float32 resid into bfloat16",
         (a, w), dict(epilogue="gated", resid=torch.zeros(64, 256), mod=mod, tokens=64,
                      out_dtype=F32)),
        ("needs resid and mod", (a, w), dict(epilogue="gated_aux")),
        ("writes no aux", (a, w), dict(epilogue="gelu", aux=True)),
        ("writes no aux2", (a, w), dict(epilogue="gelu_aux", aux2=True)),
        ("writes bfloat16", (a, w), dict(out_dtype=F32)),
        ("contiguous", (a, w.t().contiguous().t()), {}),
        ("a must be torch.bfloat16", (a.float(), w), {}),
        ("M % tokens", (a, w), dict(epilogue="gated", resid=torch.zeros(64, 256, dtype=BF),
                                    mod=mod, tokens=48, out_dtype=F32)),
    ]


@pytest.mark.parametrize("match,args,kw", _refusal_args(),
                         ids=[c[0] for c in _refusal_args()])
def test_gemm_refuses_what_the_kernel_does_not_take(match, args, kw):
    with pytest.raises(ValueError, match=match):
        gemm(*args, **kw)
