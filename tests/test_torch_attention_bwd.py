"""Port parity of the attention backward: the plain version of K3
(``reference_attention_bwd``) against lfm_tpu's Pallas ``attention_small_bwd``
run in interpret mode (as tests/test_kernels.py runs it), and the autograd
``fused_attention`` against ``jax.grad`` of the JAX ``fused_attention``
custom_vjp, on the CPU.

Tolerances: f32 1e-5 relative to the largest value (same arithmetic, other
reduction order); bf16 5e-2 (p and ds round to bf16 on both sides, and a
rounding that falls the other way moves a term by 2^-8).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from tests.torch_parity import leaves_process_as_found, rel_err, to_np  # noqa: E402,F401

from lfm_tpu.kernels import flash_attention as jattn  # noqa: E402
from lfm_tpu_torch.kernels import flash_attention as tattn  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 5e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 128, 4, 64), (1, 100, 2, 72)])
def test_reference_attention_bwd_matches_pallas_kernel(dtype, shape):
    q, k, v, do = _inputs(shape)
    with pltpu.force_tpu_interpret_mode():
        want = jattn.attention_small_bwd(*(jnp.asarray(a, JDT[dtype]) for a in (q, k, v, do)))
    got = tattn.reference_attention_bwd(*(torch.from_numpy(a).to(TDT[dtype])
                                          for a in (q, k, v, do)))
    for g, w in zip(got, want):
        assert g.dtype == TDT[dtype]
        assert rel_err(to_np(g), np.asarray(w, np.float32)) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_attention_grads_match_jax(dtype):
    """Loss sum(o * w) through the autograd Function against jax.grad of the
    JAX custom_vjp (on the CPU both take their plain paths)."""
    q, k, v, w = _inputs((2, 64, 4, 32), seed=1)

    def jloss(q_, k_, v_):
        o = jattn.fused_attention(q_, k_, v_)
        return jnp.sum(o.astype(jnp.float32) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a, JDT[dtype]) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).to(TDT[dtype]).requires_grad_(True) for a in (q, k, v))
    (tattn.fused_attention(tq, tk, tv).float() * torch.from_numpy(w)).sum().backward()
    for g, ww in zip((tq.grad, tk.grad, tv.grad), want):
        assert rel_err(to_np(g), np.asarray(ww, np.float32)) < TOL[dtype]


def test_fused_attention_qkv_gives_one_packed_gradient():
    """The packed Function's gradient equals the three of K3's plain
    version, laid out as one (N, T, 3C) tensor (no concatenation in the qkv
    backward)."""
    n, t, h, d = 2, 64, 4, 32
    rng = np.random.default_rng(2)
    qkv = torch.from_numpy(rng.standard_normal((n, t, 3 * h * d)).astype(np.float32))
    do = torch.from_numpy(rng.standard_normal((n, t, h, d)).astype(np.float32))
    a = qkv.clone().requires_grad_(True)
    tattn.fused_attention_qkv(a, h).backward(do)
    grads = tattn.reference_attention_bwd(*tattn.split_qkv(qkv, h), do)
    want = torch.cat([g.reshape(n, t, h * d) for g in grads], dim=-1)
    assert a.grad.shape == qkv.shape and a.grad.is_contiguous()
    assert torch.equal(a.grad, want)


def test_fused_attention_backward_past_the_gate_recomputes_on_the_cpu():
    """Past T = 1024 the CPU takes the plain recompute, as the JAX
    custom_vjp does off the TPU."""
    rng = np.random.default_rng(3)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((1, 1040, 1, 8)).astype(np.float32))
                   for _ in range(4))
    assert not tattn._small_shape_ok(q)
    a = [x.clone().requires_grad_(True) for x in (q, k, v)]
    tattn.fused_attention(*a).backward(do)
    b = [x.clone().requires_grad_(True) for x in (q, k, v)]
    tattn.reference_attention(*b).backward(do)
    for x, y in zip(a, b):
        assert torch.allclose(x.grad, y.grad, rtol=1e-5, atol=1e-6)
