"""Port parity of K6's plain version (``reference_groupnorm_silu``) against
lfm_tpu's plain version and its Pallas ``groupnorm_silu`` run in interpret
mode (``pltpu.force_tpu_interpret_mode``), on the CPU, and the module-level
dispatch ``FusedGNSiLU.apply``.

Tolerances: f32 1e-5 relative to the largest output (same arithmetic,
other reduction order). With a +8 mean offset the Pallas kernel's E[x^2] -
mean^2 loses about 6 bits of the variance to cancellation, so against it
the offset case is held to 1e-4; against JAX's two-pass plain version it
stays at 1e-5.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from tests.torch_parity import leaves_process_as_found, rel_err  # noqa: E402,F401

from lfm_tpu.kernels import groupnorm_silu as jgn  # noqa: E402
from lfm_tpu_torch.kernels import groupnorm_silu as tgn  # noqa: E402


def _inputs(shape, offset=0.0, seed=0):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.standard_normal(shape) + offset).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("offset", [0.0, 8.0])
@pytest.mark.parametrize("shape", [(2, 8, 8, 64), (2, 4, 4, 96)])
def test_reference_matches_jax_reference_and_pallas_kernel(shape, offset):
    x, scale, bias = _inputs(shape, offset)
    got = tgn.reference_groupnorm_silu(*(torch.from_numpy(a) for a in (x, scale, bias)))
    assert got.dtype == torch.float32 and got.shape == shape
    plain = jax.jit(jgn.reference_groupnorm_silu)(*(jnp.asarray(a) for a in (x, scale, bias)))
    assert rel_err(got, plain) < 1e-5
    with pltpu.force_tpu_interpret_mode():
        kernel = jgn.groupnorm_silu(*(jnp.asarray(a) for a in (x, scale, bias)))
    assert rel_err(got, kernel) < (1e-5 if offset == 0.0 else 1e-4)


def test_fused_gn_silu_dispatch_on_the_cpu_keeps_the_type():
    """FusedGNSiLU.apply on a CPU tensor is the plain version, in x's type;
    bf16 in gives the f32 result rounded once."""
    x, scale, bias = _inputs((2, 4, 4, 64), seed=1)
    xb = torch.from_numpy(x).bfloat16()
    before = tgn.GROUPNORM_SILU.count
    got = tgn.FusedGNSiLU.apply(xb, torch.from_numpy(scale), torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16 and tgn.GROUPNORM_SILU.count == before
    want = tgn.reference_groupnorm_silu(xb.float(), torch.from_numpy(scale),
                                        torch.from_numpy(bias)).bfloat16()
    assert torch.equal(got, want)
