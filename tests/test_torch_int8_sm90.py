"""The host side of P1's s8 wgmma GEMM (csrc/int8_gemm_sm90.cuh), on the CPU:
its tile width (kernels/int8_matmul.py::int8_gemm_tile, the rule of the
C launcher's launch_by_n) on every DiT width, the shapes it refuses
(exactly the WMMA kernel's: N % 128 or K % 64), and the wrappers on CPU
tensors, which compute their plain versions and launch nothing. The plain
GEMM (``reference_int8_gemm``, what the kernel must equal bit for bit on
the card) is held against lfm_tpu/nn/dit_int8.py::_dense_int8's int8 dot
and f32 dequant on the same quantized rows, run op by op: equal, since the
int32 sums are exact and both dequantize in the same f32 order.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tests.torch_parity import leaves_process_as_found  # noqa: E402,F401

from lfm_tpu.nn import dit_int8 as jax_int8  # noqa: E402
from lfm_tpu_torch.kernels import int8_matmul as p1  # noqa: E402
from lfm_tpu_torch.nn.dit import DIT_CONFIGS  # noqa: E402
from lfm_tpu_torch.nn.dit_int8 import quantize_weight  # noqa: E402


def _products(hidden: int):
    """(name, K, N, epilogue, out dtype) of a DiT block's four quantized
    products (MLP ratio 4), as nn/dit_int8.py calls them."""
    return (("qkv", hidden, 3 * hidden, "store", torch.bfloat16),
            ("proj", hidden, hidden, "store", torch.float32),
            ("fc1", hidden, 4 * hidden, "gelu", torch.float32),
            ("fc2", 4 * hidden, hidden, "store", torch.float32))


# every width of the port's DiT registry but the test-scale ones (hidden
# 64, which no kernel takes): S 384, B 768, L 1024, XL 1152
WIDTHS = sorted({c[1] for c in DIT_CONFIGS.values() if c[1] % 128 == 0})


@pytest.mark.parametrize("hidden", WIDTHS)
def test_gemm_tile_takes_every_dit_width(hidden):
    """Every product of every DiT width gets a tile the kernel is built for:
    256 columns where N % 256 == 0, else 128."""
    for name, k, n, _, _ in _products(hidden):
        tile = p1.int8_gemm_tile(n, k)
        assert tile in (128, 256) and n % tile == 0, (name, n, tile)
        assert tile == (256 if n % 256 == 0 else 128), (name, n, tile)


def test_gemm_tile_on_dit_xl_takes_the_narrow_tile_for_qkv():
    """DiT-XL's qkv (N = 3456 = 27 x 128) needs the 128-wide tile; its fc1
    (4608 = 18 x 256) takes the wide one, as its proj and fc2 (1152) do not."""
    assert WIDTHS == [384, 768, 1024, 1152]
    assert p1.int8_gemm_tile(3456, 1152) == 128
    assert p1.int8_gemm_tile(4608, 1152) == 256
    assert p1.int8_gemm_tile(1152, 4608) == 128


def test_gemm_tile_refuses_what_the_wmma_kernel_refused():
    """The WMMA kernel's launcher refused N % 128 and K % 64 (its 128 x 128
    x 64 tile); the new GEMM takes and refuses the same (N, K), over a grid
    of N and K in steps of 32 up to 1024."""
    for n in range(32, 1056, 32):
        for k in range(32, 1056, 32):
            if n % 128 or k % 64:
                with pytest.raises(ValueError, match="N % 128 == 0 and K % 64 == 0"):
                    p1.int8_gemm_tile(n, k)
            else:
                assert p1.int8_gemm_tile(n, k) in (128, 256), (n, k)


def _inputs(rows, k, n, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((rows, k)).astype(np.float32))
    w = torch.from_numpy((k ** -0.5 * rng.standard_normal((n, k))).astype(np.float32))
    q_w, s_w = quantize_weight(w)
    bias = torch.from_numpy((0.1 * rng.standard_normal(n)).astype(np.float32)).bfloat16()
    return x, q_w, s_w, bias


@pytest.mark.parametrize("epilogue,out_dtype", [("store", torch.float32),
                                                ("gelu", torch.float32),
                                                ("store", torch.bfloat16)])
def test_wrappers_on_the_cpu_compute_their_plain_versions_and_launch_nothing(epilogue,
                                                                            out_dtype):
    x, q_w, s_w, bias = _inputs(300, 192, 384, 0)
    counters = (p1.QUANT_ROWS, p1.INT8_DENSE, p1.INT8_MLP)
    before = [c.count for c in counters]
    got_dense = p1.int8_dense(x, q_w, s_w, bias, epilogue, out_dtype)
    q2, s2 = quantize_weight(torch.from_numpy(
        np.random.default_rng(1).standard_normal((192, 384)).astype(np.float32)) / 20)
    got_mlp = p1.int8_mlp(x, q_w, s_w, bias, q2, s2, None)
    assert [c.count for c in counters] == before
    assert torch.equal(got_dense, p1.reference_int8_dense(x, q_w, s_w, bias, epilogue,
                                                          out_dtype))
    assert torch.equal(got_mlp, p1.reference_int8_mlp(x, q_w, s_w, bias, q2, s2, None))
    assert got_dense.dtype == out_dtype and got_dense.shape == (300, 384)


@pytest.mark.parametrize("rows,k,n,bias", [(300, 192, 384, True), (64, 1024, 512, False)])
def test_reference_int8_gemm_equals_jax_dense_int8(rows, k, n, bias):
    """``reference_int8_gemm`` on JAX's quantized rows equals
    ``_dense_int8``'s int8 dot (int32 sums) and f32 dequant, run op by op
    (under jit, XLA's CPU fusion of the dequant rounds some 6% of the
    values the other way in the last bit)."""
    x, q_w, s_w, b = _inputs(rows, k, n, rows + k)
    qx, sx = jax_int8._quant_rows(jnp.asarray(x.numpy()))
    kernel = {"q": jnp.asarray(q_w.numpy().T), "s": jnp.asarray(s_w.numpy())}
    jb = jnp.asarray(b.float().numpy()).astype(jnp.bfloat16) if bias else None
    want = np.asarray(jax_int8._dense_int8(jnp.asarray(x.numpy()), kernel, jb))
    got = p1.reference_int8_gemm(torch.from_numpy(np.array(qx)),
                                 torch.from_numpy(np.array(sx)), q_w, s_w,
                                 b if bias else None)
    assert np.array_equal(got.numpy(), want)
