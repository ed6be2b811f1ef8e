"""Port parity of K4 and of the attention dispatch on the CPU: the plain
version of K4 (``reference_flash_attention``, which ``flash_attention``
runs on a CPU tensor) against lfm_tpu's Pallas ``flash_attention`` in
interpret mode with small blocks; ``fused_attention`` forward and backward
past the small-T gate against the JAX ``fused_attention``'s CPU path; and
``fused_attention`` on the origin ADM's legacy-layout q, k, v views (head
dims 128 and 256) against the JAX ``fused_attention`` on the same views.

Tolerances: f32 1e-5 relative to the largest value (same arithmetic; the
blocked online softmax against the whole-row one differs only in the order
of f32 sums); bf16 2e-2 (p rounds to bf16 after a max taken per block or
per row).
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


def _inputs(shape, n=3, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_flash_plain_version_matches_pallas_kernel(dtype, tol):
    """(1, 256, 2, 64) with 64-row blocks: four key blocks of online
    softmax on both sides."""
    q, k, v = _inputs((1, 256, 2, 64))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = jattn.flash_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                     block_q=64, block_k=64)
    args = [torch.from_numpy(a).to(tdt) for a in (q, k, v)]
    before = tattn.FLASH_ATTENTION.count
    got = tattn.flash_attention(*args, block_q=64, block_k=64)
    assert got.dtype == tdt and tattn.FLASH_ATTENTION.count == before
    assert torch.equal(got, tattn.reference_flash_attention(*args, block_k=64))
    assert rel_err(to_np(got), np.asarray(want, np.float32)) < tol


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("shape", [(1, 257, 2, 64), (1, 300, 2, 72)])
def test_attention_plain_version_past_the_whole_row_width_matches_pallas(shape, dtype, tol):
    """K1's plain version (``reference_attention``, which ``attention_small``
    runs on a CPU tensor) against lfm_tpu's Pallas ``attention_small`` in
    interpret mode at ragged T past 256, where the card's kernel leaves its
    whole-row mode for key blocks; D = 72 pads to 80 there."""
    q, k, v = _inputs(shape, seed=3)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = jattn.attention_small(*(jnp.asarray(a, jdt) for a in (q, k, v)))
    args = [torch.from_numpy(a).to(tdt) for a in (q, k, v)]
    before = tattn.ATTENTION_SMALL.count
    got = tattn.attention_small(*args)
    assert got.dtype == tdt and got.shape == shape and tattn.ATTENTION_SMALL.count == before
    assert rel_err(to_np(got), np.asarray(want, np.float32)) < tol


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_flash_plain_version_with_ragged_key_blocks_matches_pallas(dtype, tol):
    """(1, 600, 2, 64) with block_k = 200: three key blocks that end inside
    the card kernel's 64-key tiles (200 = 3 x 64 + 8), so its masking at the
    block end matters; the plain version takes the same blocks as JAX."""
    q, k, v = _inputs((1, 600, 2, 64), seed=4)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = jattn.flash_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)), block_k=200)
    args = [torch.from_numpy(a).to(tdt) for a in (q, k, v)]
    got = tattn.flash_attention(*args, block_k=200)
    assert tattn._pick_block(600, 200) == 200
    assert torch.equal(got, tattn.reference_flash_attention(*args, block_k=200))
    assert rel_err(to_np(got), np.asarray(want, np.float32)) < tol


def test_pick_block_matches_jax():
    for t, target in ((4096, 512), (2048, 512), (1040, 512), (256, 64), (100, 512), (97, 64),
                      (1200, 512), (1100, 512), (1030, 512), (600, 200)):
        assert tattn._pick_block(t, target) == jattn._pick_block(t, target)


def test_fused_attention_past_the_gate_matches_jax():
    """T = 2048 (1 head, D 64), f32: past the small-T gate the forward is
    K4's plain version here and reference_attention in JAX's CPU path; the
    backward recomputes the plain version on both sides."""
    q, k, v, w = _inputs((1, 2048, 1, 64), n=4, seed=1)
    assert not tattn._small_shape_ok(torch.from_numpy(q))

    def jloss(q_, k_, v_):
        return jnp.sum(jattn.fused_attention(q_, k_, v_) * w)

    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want_out = jax.jit(jattn.fused_attention)(jq, jk, jv)
    want_grads = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(jq, jk, jv)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = tattn.fused_attention(tq, tk, tv)
    (out * torch.from_numpy(w)).sum().backward()
    assert rel_err(to_np(out), np.asarray(want_out)) < 1e-5
    for g, want in zip((tq.grad, tk.grad, tv.grad), want_grads):
        assert rel_err(to_np(g), np.asarray(want)) < 1e-5


@pytest.mark.parametrize("shape", [(2, 16, 4, 128), (2, 16, 2, 256)])
def test_fused_attention_on_legacy_layout_views(shape):
    """The origin ADM's legacy qkv order (heads, 3, hd): q, k, v are strided
    views of one (N, T, 3C) row, which fused_attention packs and the JAX
    fused_attention takes as they are."""
    n, t, h, d = shape
    (qkv,) = _inputs((n, t, h, 3, d), n=1, seed=2)
    want = jattn.fused_attention(*(jnp.asarray(qkv)[..., i, :] for i in range(3)))
    views = torch.from_numpy(qkv).unbind(3)
    assert views[0].stride(2) == 3 * d  # not the (T, H*D) rows the kernels read in place
    got = tattn.fused_attention(*views)
    assert got.shape == shape
    assert rel_err(to_np(got), np.asarray(want)) < 1e-5


def test_dit_past_the_gate_samples_through_k4s_path(monkeypatch):
    """A DiT with 1089 tokens (DiT-T/2 on 66x66 latents) samples through
    fused_attention's long-T branch, K4's plain version on the CPU, once
    per block and evaluation, and the fused block path stands aside."""
    import dataclasses

    from lfm_tpu_torch.core.config import get_preset
    from lfm_tpu_torch.nn.dit import DiT
    from lfm_tpu_torch.nn.init import seeded_init_
    from lfm_tpu_torch.sample.sample import make_sampler

    calls = []
    real = tattn.flash_attention
    monkeypatch.setattr(tattn, "flash_attention",
                        lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    cfg = get_preset("celeb256_dit")
    cfg = dataclasses.replace(cfg, sample=dataclasses.replace(cfg.sample, method="euler",
                                                              num_steps=2))
    model = seeded_init_(DiT(img_resolution=66, patch_size=2, hidden_size=64, depth=2,
                             num_heads=4, dtype=torch.bfloat16, use_flash=True), 0)
    noise = torch.from_numpy(np.random.default_rng(4).standard_normal((1, 66, 66, 4))
                             .astype(np.float32))
    out = make_sampler(cfg, model, device="cpu")(noise)
    assert out.nfe == 2.0 and torch.isfinite(out.latents).all()
    assert calls == [(1, 33 * 33, 4, 16)] * (2 * 2)
