"""Port parity of the w8a8 int8 DiT path (nn/dit_int8.py) and of P1's plain
versions (kernels/int8_matmul.py) against lfm_tpu, on the CPU: the DiT of
tests/test_dit_int8.py (16x16 latents, patch 2, hidden 128, depth 3, 4
heads), weights from a numpy seed, every tensor non-zero.

Tolerances and why:
- ``quantize_weight``: q bit-exact (the same f32 divisions, ties to even),
  s within 1 ulp.
- The plain int8 chain against ``_kernel_int8`` in interpret mode. With the
  probe's own scale, ``max|x| * (1 / 127)``: one step bit-exact; the chain
  of 8 within 5e-3 of the largest output (XLA's and torch's tanh differ in
  the last f32 bit now and then, and a GELU output that lands on the other
  side of a rounding boundary moves one int8 step in the next product).
  With the path's ``max|x| / 127`` (what the port's kernel computes) the
  two scales can differ in their last bit, which moves int8 values across
  rounding boundaries more often: 2e-2 of the largest output after one
  step, 1e-1 after the chain of 8 (the flips compound through 8 GELUs and
  16 quantizations). The bf16 chain against ``_kernel_bf16``: 2e-2 (f32 sums in
  another order round to bf16 the other way now and then).
- ``dit_int8_apply`` and the int8 sampler against JAX's: 2e-2 and 3e-2 of
  the largest output. Both compute the same program, but the LayerNorm and
  softmax sums run in another order, and a value that lands on the other
  side of a quantization boundary moves one int8 step (1/127 of its row's
  max) in one product term.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
# importing pallas sets CUDA_ROOT in os.environ; import it with the module,
# before the state guard looks
import jax.experimental.pallas as pl  # noqa: E402
import torch  # noqa: E402

from tests.torch_parity import leaves_process_as_found, randomize, rel_err  # noqa: E402,F401

import tools.microbench_int8_pallas as jprobe  # noqa: E402
from lfm_tpu.core import config as jconfig  # noqa: E402
from lfm_tpu.nn import dit as jdit  # noqa: E402
from lfm_tpu.nn import dit_int8 as jint8  # noqa: E402
from lfm_tpu.sample.sample import make_sampler as jmake_sampler  # noqa: E402
from lfm_tpu_torch.core import config as tconfig  # noqa: E402
from lfm_tpu_torch.kernels import int8_matmul as im  # noqa: E402
from lfm_tpu_torch.nn import dit as tdit  # noqa: E402
from lfm_tpu_torch.nn import dit_int8 as tint8  # noqa: E402
from lfm_tpu_torch.nn.convert_dit import dit_params_from_jax  # noqa: E402
from lfm_tpu_torch.nn.factory import create_network  # noqa: E402
from lfm_tpu_torch.sample.sample import make_sampler  # noqa: E402

SMALL = dict(img_resolution=16, patch_size=2, in_channels=4, hidden_size=128, depth=3,
             num_heads=4)
DIT_TOL = 2e-2
SAMPLER_TOL = 3e-2
STEP_TOL = 2e-2
CHAIN_TOL = 1e-1
PROBE_CHAIN_TOL = 5e-3
BF16_TOL = 2e-2
# the probe's shapes cut to size: rows, D, hidden
R, D, H = 64, 128, 256


def _pair(num_classes=10, seed=0):
    jm = jdit.DiT(**SMALL, num_classes=num_classes, dtype=jnp.bfloat16, scan_blocks=True)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1,)), jnp.zeros((1, 16, 16, 4)),
                     jnp.zeros((1,), jnp.int32))
    params = randomize(params, seed)
    tm = tdit.DiT(**SMALL, num_classes=num_classes, dtype=torch.bfloat16)
    tm.load_state_dict(dit_params_from_jax(params))
    return jm, params, tm.eval()


def test_quantize_weight_matches_jax():
    """q is JAX's q transposed, bit for bit, ties to even included; s within
    one ulp."""
    rng = np.random.default_rng(0)
    w = (0.3 * rng.standard_normal((64, 96))).astype(np.float32)  # flax (in, out)
    # column 0 has max 127, so s = 1 and x / s hits the .5 ties exactly
    w[:, 0] = 0.0
    w[:8, 0] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]
    jq, js = jint8.quantize_weight(jnp.asarray(w))
    q, s = tint8.quantize_weight(torch.from_numpy(w.T.copy()))
    assert q.dtype == torch.int8 and tuple(q.shape) == (96, 64) and tuple(s.shape) == (96,)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq).T)
    np.testing.assert_array_max_ulp(s.numpy(), np.asarray(js)[0], maxulp=1)
    assert list(q[0, :8]) == [127, 0, 2, 2, 0, -2, -2, 126]


def test_quantize_params_int8_matches_the_jax_tree():
    """The converted tree quantized by the port equals JAX's quantized tree:
    each block's q transposed and s, and every other leaf in bf16."""
    jm, params, tm = _pair()
    jq = jint8.quantize_params_int8(jm, params)
    qp = tint8.quantize_params_int8(tm, tm.state_dict())
    jblocks = jq["params"]["blocks"]["block"]
    # a copy of JAX's tree whose quantized kernels become zeros, for the converter
    dq = jax.tree_util.tree_map(lambda a: a, jq)
    for path in (("attn", "qkv"), ("attn", "proj"), ("mlp", "fc1"), ("mlp", "fc2")):
        kern = jblocks[path[0]][path[1]]["kernel"]
        for i in range(SMALL["depth"]):
            key = f"blocks.{i}.{path[0]}.{path[1]}"
            assert qp[f"{key}.q"].dtype == torch.int8
            np.testing.assert_array_equal(qp[f"{key}.q"].numpy(), np.asarray(kern["q"][i]).T)
            np.testing.assert_array_equal(qp[f"{key}.s"].numpy(), np.asarray(kern["s"][i, 0]))
            assert f"{key}.weight" not in qp
        dq["params"]["blocks"]["block"][path[0]][path[1]]["kernel"] = np.zeros(
            kern["q"].shape, np.float32)
    rest = dit_params_from_jax(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), dq))
    for key, want in rest.items():
        if key.endswith(".weight") and any(layer in key for layer in tint8.QUANT_LAYERS):
            continue
        assert qp[key].dtype == torch.bfloat16, key
        np.testing.assert_array_equal(qp[key].float().numpy(), want.numpy(), err_msg=key)


def _probe_inputs():
    """x (R, D) bf16; int8 weights in JAX's (in, out) layout; scales that
    keep the 8-step chain's size within a factor of a few of its input's
    (neither vanishing nor exploding)."""
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((R, D)).astype(np.float32), jnp.bfloat16)
    w1 = rng.integers(-127, 128, (D, H)).astype(np.int8)
    w2 = rng.integers(-127, 128, (H, D)).astype(np.int8)
    s1 = np.full((1, H), 1.2 / (73 * np.sqrt(D)), np.float32)
    s2 = np.full((1, D), 1.2 / (73 * np.sqrt(H)), np.float32)
    return x, w1, s1, w2, s2


def _pallas(body, chain, out_rows, *args, monkeypatch):
    monkeypatch.setattr(jprobe, "CHAIN", chain)
    out = pl.pallas_call(body, grid=(1,), interpret=True,
                         out_shape=jax.ShapeDtypeStruct((out_rows, D), jnp.bfloat16))(*args)
    return np.asarray(out, np.float32)


def _probe_quant_rows(x):
    """The probe's _quant_rows (microbench_int8_pallas.py:28-32): the scale
    times the f32 reciprocal of 127."""
    xf = x.float()
    m = xf.abs().amax(dim=-1, keepdim=True)
    s = torch.clamp(m, min=1e-8) * torch.full_like(m, np.float32(1.0 / 127.0))
    return torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8), s


@pytest.mark.parametrize("chain,tol,probe_tol", [(1, STEP_TOL, 0.0),
                                                 (8, CHAIN_TOL, PROBE_CHAIN_TOL)])
def test_plain_int8_mlp_chain_matches_kernel_int8(chain, tol, probe_tol, monkeypatch):
    x, w1, s1, w2, s2 = _probe_inputs()
    want = _pallas(jprobe._kernel_int8, chain, R, x, jnp.asarray(w1), jnp.asarray(s1),
                   jnp.asarray(w2), jnp.asarray(s2), monkeypatch=monkeypatch)
    args = (torch.from_numpy(w1.T.copy()), torch.from_numpy(s1[0]), None,
            torch.from_numpy(w2.T.copy()), torch.from_numpy(s2[0]), None)

    def run():
        xf = torch.from_numpy(np.asarray(x, np.float32))
        for _ in range(chain):
            xf = im.int8_mlp(xf, *args)
        return xf.to(torch.bfloat16).float().numpy()

    path = run()
    assert 0.3 < float(np.abs(want).max()) / float(np.abs(np.asarray(x, np.float32)).max()) < 3
    assert rel_err(path, want) < tol
    monkeypatch.setattr(im, "reference_quant_rows", _probe_quant_rows)
    assert rel_err(run(), want) <= probe_tol


def test_plain_bf16_mlp_chain_matches_kernel_bf16(monkeypatch):
    x, w1, s1, w2, s2 = _probe_inputs()
    w1b = jnp.asarray(w1.astype(np.float32) * s1, jnp.bfloat16)
    w2b = jnp.asarray(w2.astype(np.float32) * s2, jnp.bfloat16)
    want = _pallas(jprobe._kernel_bf16, 8, R, x, w1b, w2b, monkeypatch=monkeypatch)
    xt = torch.from_numpy(np.asarray(x, np.float32)).bfloat16()
    t1, t2 = (torch.from_numpy(np.asarray(w, np.float32).T.copy()).bfloat16() for w in (w1b, w2b))
    for _ in range(8):
        xt = im.bf16_mlp(xt, t1, t2)
    assert xt.dtype == torch.bfloat16
    assert rel_err(xt.float(), want) < BF16_TOL


@pytest.mark.parametrize("num_classes", [10, 1])
def test_dit_int8_apply_matches_jax(num_classes):
    """Conditional (10 classes, labels) and unconditional (one class, y None)."""
    jm, params, tm = _pair(num_classes)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 16, 16, 4)).astype(np.float32)
    t = np.linspace(0.1, 0.9, 4).astype(np.float32)
    y = np.array([0, 3, 5, 9]) if num_classes > 1 else None
    jq = jint8.quantize_params_int8(jm, params)
    want = jax.jit(lambda qp, t, x, y: jint8.dit_int8_apply(jm, qp, t, x, y))(
        jq, jnp.asarray(t), jnp.asarray(x), None if y is None else jnp.asarray(y))
    qp = tint8.quantize_params_int8(tm, tm.state_dict())
    with torch.no_grad():
        got = tint8.dit_int8_apply(tm, qp, torch.from_numpy(t), torch.from_numpy(x),
                                   None if y is None else torch.from_numpy(y))
    assert got.dtype == torch.float32 and tuple(got.shape) == (4, 16, 16, 4)
    assert rel_err(got, want) < DIT_TOL
    assert tint8.int8_applicable(tm, got)


def _sample_configs(**sample_kw):
    out = []
    for mod in (jconfig, tconfig):
        mc = mod.ModelConfig(model_type="DiT-S/2", image_size=128, num_classes=10)
        out.append(mod.Config(model=mc, sample=mod.SampleConfig(
            method="euler", num_steps=6, cfg_scale=1.5, **sample_kw)))
    return out


def test_int8_sampler_matches_jax(monkeypatch):
    """make_sampler(use_int8_dit=True), euler 6 with CFG 1.5 (as
    tests/test_dit_int8.py:83-106), against JAX's int8 sampler on the same
    weights and noise; every evaluation goes through dit_int8_apply, which
    wins over the fused blocks (on by default)."""
    from lfm_tpu_torch.nn import dit_int8

    calls = []
    real = dit_int8.dit_int8_apply
    monkeypatch.setattr(dit_int8, "dit_int8_apply",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    jm, params, tm = _pair()
    cfg_j, cfg_t = _sample_configs(use_int8_dit=True)
    assert cfg_t.sample.use_fused_dit
    noise = np.random.default_rng(2).standard_normal((4, 16, 16, 4)).astype(np.float32)
    y = np.array([1, 2, 3, 4])
    jout = jmake_sampler(cfg_j, jm, params, jit=True)(jnp.asarray(noise), jnp.asarray(y))
    tout = make_sampler(cfg_t, tm, None, device="cpu")(torch.from_numpy(noise),
                                                      torch.from_numpy(y))
    assert tout.nfe == float(jout.nfe) == 6.0 and len(calls) == 6
    assert np.isfinite(tout.latents.numpy()).all()
    assert rel_err(tout.latents, jout.latents) < SAMPLER_TOL


def test_unet_under_int8_takes_the_module_path():
    """The gate is the model only, as in JAX: a UNet with use_int8_dit
    samples exactly as without it."""
    base = tconfig.get_preset("celeb256_adm")
    model = dataclasses.replace(base.model, image_size=32, f=2, nf=32, ch_mult=(1, 2),
                                num_res_blocks=1, attn_resolutions=(2,))
    outs = []
    for int8 in (False, True):
        sample = dataclasses.replace(base.sample, method="euler", num_steps=2, use_int8_dit=int8)
        cfg = dataclasses.replace(base, model=model, sample=sample)
        torch.manual_seed(0)
        unet = create_network(cfg.model, device="cpu")
        noise = torch.from_numpy(
            np.random.default_rng(4).standard_normal((2, 16, 16, 4)).astype(np.float32))
        outs.append(make_sampler(cfg, unet, None, device="cpu")(noise).latents)
    assert not tint8.int8_model_ok(unet)
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


def test_cli_samples_int8_on_the_cpu(tmp_path, capsys, monkeypatch):
    """``cli.main sample --int8_dit --device cpu`` on a small DiT runs every
    evaluation through dit_int8_apply."""
    from lfm_tpu_torch.cli import main as cli
    from lfm_tpu_torch.nn import dit_int8

    calls = []
    real = dit_int8.dit_int8_apply
    monkeypatch.setattr(dit_int8, "dit_int8_apply",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    out = tmp_path / "s.npy"
    path = cli.main(["sample", "--preset", "celeb256_dit", "--device", "cpu", "--int8_dit",
                     "--model_type", "DiT-T/2", "--image_size", "32", "--method", "euler",
                     "--steps", "2", "--batch_size", "2", "--out", str(out)])
    img = np.load(path)
    assert img.shape == (2, 32, 32, 3) and np.isfinite(img).all()
    assert len(calls) == 2
    assert "seeded random DiT-T/2 weights" in capsys.readouterr().err


def _bad_calls():
    x = torch.zeros(4, 128)
    q = torch.zeros(256, 128, dtype=torch.int8)
    s = torch.zeros(256)
    w = torch.zeros(256, 128, dtype=torch.bfloat16)
    return {
        "quant_rows_3d": lambda: im.quant_rows(torch.zeros(2, 4, 128)),
        "dense_k_mismatch": lambda: im.int8_dense(torch.zeros(4, 64), q, s),
        "dense_float_weight": lambda: im.int8_dense(x, q.float(), s),
        "dense_scale_shape": lambda: im.int8_dense(x, q, s[:, None]),
        "dense_bias_shape": lambda: im.int8_dense(x, q, s, torch.zeros(128)),
        "dense_epilogue": lambda: im.int8_dense(x, q, s, epilogue="relu"),
        "dense_out_dtype": lambda: im.int8_dense(x, q, s, out_dtype=torch.float16),
        "mlp_second_shape": lambda: im.int8_mlp(x, q, s, None, q, s, None),
        "bf16_mlp_shapes": lambda: im.bf16_mlp(x.bfloat16(), w, w),
    }


@pytest.mark.parametrize("case", sorted(_bad_calls()))
def test_wrappers_refuse_shapes_they_do_not_take(case):
    with pytest.raises(ValueError):
        _bad_calls()[case]()


def test_probe_tool_chains_the_wrappers_at_the_jax_tools_shapes():
    """tools/microbench_int8.py keeps the JAX probe's shapes and chain, and
    its two calls chain int8_mlp and bf16_mlp (here their plain versions,
    on a cut-down input)."""
    from lfm_tpu_torch.tools import microbench_int8 as mb

    assert (mb.GRID * mb.ROWS, mb.D, mb.H, mb.CHAIN) == (
        jprobe.GRID * jprobe.ROWS, jprobe.D, jprobe.H, jprobe.CHAIN)
    x, w1, s1, w2, s2 = _probe_inputs()
    inp = dict(x=torch.from_numpy(np.asarray(x, np.float32)).bfloat16(),
               w1=torch.from_numpy(w1.T.copy()), s1=torch.from_numpy(s1[0]),
               w2=torch.from_numpy(w2.T.copy()), s2=torch.from_numpy(s2[0]))
    inp["w1b"] = (inp["w1"].float() * inp["s1"][:, None]).bfloat16()
    inp["w2b"] = (inp["w2"].float() * inp["s2"][:, None]).bfloat16()
    xf, xt = inp["x"], inp["x"]
    for _ in range(mb.CHAIN):
        xf = im.reference_int8_mlp(xf, inp["w1"], inp["s1"], None, inp["w2"], inp["s2"], None)
        xt = im.reference_bf16_mlp(xt, inp["w1b"], inp["w2b"])
    torch.testing.assert_close(mb.run_int8(inp), xf.bfloat16(), rtol=0, atol=0)
    torch.testing.assert_close(mb.run_bf16(inp), xt, rtol=0, atol=0)
