"""Port parity: the origin-ADM UNet of lfm_tpu_torch against lfm_tpu's on
the CPU at a small size (latents 16x16, nf 32, ch_mult (1, 2), 1 ResBlock
per level, attention at both levels, so T = 256 and 64 with head dims 8
and 16), one set of seeded non-zero weights carried across by
``adm_params_from_jax``; the ADM presets, the state-dict names, the
sampler and the CLI.

On the CPU the JAX package takes its plain paths (``FusedGNSiLU.apply`` ->
``reference_groupnorm_silu``, ``_dispatch_attention`` ->
``reference_attention``), and so does the port.

Tolerances: max abs error / max |JAX| within 1e-4 in f32 (same
arithmetic; GroupNorm statistics two-pass against flax's E[x^2] - mean^2,
other reduction orders) and 5e-2 in bf16 (bf16 roundings that fall the
other way, compounded over the UNet's depth).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
# lfm_tpu's modules import pallas lazily, and that import sets CUDA_ROOT in
# os.environ; import it with the module, before the state guard looks
import jax.experimental.pallas  # noqa: E402,F401
import torch  # noqa: E402

from tests.torch_parity import leaves_process_as_found, randomize, rel_err  # noqa: E402,F401

from lfm_tpu.core import config as jconfig  # noqa: E402
from lfm_tpu.nn import adm_unet as jadm  # noqa: E402
from lfm_tpu.nn.convert_adm import convert_adm_state_dict  # noqa: E402
from lfm_tpu.nn.layers import GroupNorm32 as JGroupNorm32  # noqa: E402
from lfm_tpu.sample.sample import make_sampler as jmake_sampler  # noqa: E402
from lfm_tpu_torch.core import config as tconfig  # noqa: E402
from lfm_tpu_torch.core.checkpoint import reference_model_dict, reference_state_dict  # noqa: E402
from lfm_tpu_torch.core.rng import SampleRNG  # noqa: E402
from lfm_tpu_torch.nn import adm_unet as tadm  # noqa: E402
from lfm_tpu_torch.nn.convert_adm import adm_params_from_jax  # noqa: E402
from lfm_tpu_torch.nn.factory import create_network  # noqa: E402
from lfm_tpu_torch.nn.init import seeded_init_  # noqa: E402
from lfm_tpu_torch.nn.layers import GroupNorm32  # noqa: E402
from lfm_tpu_torch.sample.sample import make_sampler, noise_and_labels  # noqa: E402

SMALL = dict(image_size=16, in_channels=4, model_channels=32, out_channels=4,
             num_res_blocks=1, attention_resolutions=(1, 2), channel_mult=(1, 2))
N = 2

# each case switches flags off the base (legacy qkv order, scale-shift on)
CASES = {
    "base": {},
    "new_order": dict(use_new_attention_order=True),
    "no_scale_shift": dict(use_scale_shift_norm=False),
    "resblock_updown": dict(resblock_updown=True),
    "classes": dict(num_classes=5),
    "flash": dict(use_flash=True),
    "flash_new_order": dict(use_flash=True, use_new_attention_order=True),
    "fused_gn": dict(use_fused_gn=True),
    "fused_gn_no_scale_shift": dict(use_fused_gn=True, use_scale_shift_norm=False),
    "all": dict(use_new_attention_order=True, resblock_updown=True, num_classes=5,
                use_flash=True, use_fused_gn=True),
}


def _inputs(seed, num_classes=None):
    rng = np.random.default_rng(seed)
    t = rng.uniform(0.0, 1.0, (N,)).astype(np.float32)
    x = rng.standard_normal((N, 16, 16, 4)).astype(np.float32)
    y = None if num_classes is None else rng.integers(0, num_classes, (N,)).astype(np.int32)
    return t, x, y


def _pair(flags, seed=3, dtype="float32"):
    """The JAX model, its seeded params and the port's model on them."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    kw = {**SMALL, **flags}
    jm = jadm.UNetModel(**kw, dtype=jdt)
    t, x, y = _inputs(0, kw.get("num_classes"))
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(t), jnp.asarray(x),
                     None if y is None else jnp.asarray(y))
    params = randomize(params, seed, scale=0.2)
    tm = tadm.UNetModel(**kw, dtype=tdt).eval()
    tm.load_state_dict(adm_params_from_jax(params, tm.plan))
    return jm, params, tm


def _forward_both(jm, params, tm, seed=1):
    t, x, y = _inputs(seed, tm.num_classes)
    want = jax.jit(jm.apply)(params, jnp.asarray(t), jnp.asarray(x),
                             None if y is None else jnp.asarray(y))
    with torch.no_grad():
        got = tm(torch.from_numpy(t), torch.from_numpy(x),
                 None if y is None else torch.from_numpy(y).long())
    return got, np.asarray(want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_adm_unet_f32_matches_jax(case):
    jm, params, tm = _pair(CASES[case])
    got, want = _forward_both(jm, params, tm)
    assert got.shape == (N, 16, 16, 4) and got.dtype == torch.float32
    assert np.abs(want).max() > 1e-2  # the zero-initialised output conv is seeded
    assert rel_err(got, want) < 1e-4


@pytest.mark.parametrize("case", ["base", "flash", "fused_gn", "all"])
def test_adm_unet_bf16_matches_jax(case):
    jm, params, tm = _pair(CASES[case], dtype="bfloat16")
    got, want = _forward_both(jm, params, tm)
    assert rel_err(got, want) < 5e-2


def test_plan_and_attention_counts_of_the_presets():
    """build_unet_plan equals the JAX package's for every origin-ADM preset,
    and celeb256_adm attends 6 times per evaluation at (T, C) = (16, 512)
    over 22 ResBlocks (the counts the chip check expects)."""
    for name in ("celeb256_adm", "celeb512_adm", "church_adm"):
        m = tconfig.get_preset(name).model
        args = (m.nf, m.ch_mult, m.num_res_blocks, m.attn_resolutions, m.num_in_channels,
                m.resblock_updown)
        plan = tadm.build_unet_plan(*args)
        assert dataclasses.asdict(plan) == dataclasses.asdict(jadm.build_unet_plan(*args))
    m = tconfig.get_preset("celeb256_adm").model
    plan = tadm.build_unet_plan(m.nf, m.ch_mult, m.num_res_blocks, m.attn_resolutions,
                                m.num_in_channels, m.resblock_updown)
    layers = list(tadm.plan_layers(plan))
    assert [s.out_ch for s in layers if s.kind == "attn"] == [512] * 6
    assert sum(s.kind.startswith("res") for s in layers) == 22


@pytest.mark.parametrize("name", sorted(n for n in jconfig.PRESETS if "adm" in n))
def test_adm_presets_match_lfm_tpu(name):
    assert dataclasses.asdict(tconfig.get_preset(name)) == dataclasses.asdict(
        jconfig.get_preset(name))


def test_state_dict_names_convert_through_the_jax_converter():
    """The port's state_dict, read by lfm_tpu's reference-checkpoint
    converter, gives the JAX model the port's weights: a reference
    model_{E}.pth loads into both packages by the same names."""
    flags = CASES["all"]
    jm, _, tm = _pair(flags)
    seeded_init_(tm, 11)
    params = convert_adm_state_dict(tm.state_dict(), jm)
    got, want = _forward_both(jm, params, tm, seed=2)
    assert rel_err(got, want) < 1e-4


def test_reference_named_dict_loads(tmp_path):
    """A synthetic reference-named dict, with the DDP ``module.`` prefix and
    Conv1d-shaped qkv / proj_out, loads strictly through the checkpoint
    reader; the reference's names are the port's own."""
    tm = tadm.UNetModel(**SMALL, num_classes=5)
    seeded_init_(tm, 5)
    sd = {f"module.{k}": v.clone() for k, v in tm.state_dict().items()}
    qkv = sd["module.middle_block.1.qkv.weight"]
    assert qkv.shape == (3 * 64, 64, 1)
    assert sd["module.middle_block.1.proj_out.weight"].shape == (64, 64, 1)
    for key in ("time_embed.0.weight", "time_embed.2.weight", "label_emb.weight",
                "input_blocks.0.0.weight", "input_blocks.1.0.in_layers.0.weight",
                "input_blocks.1.0.in_layers.2.weight", "input_blocks.1.0.emb_layers.1.weight",
                "input_blocks.1.0.out_layers.0.weight", "input_blocks.1.0.out_layers.3.weight",
                "input_blocks.2.0.op.weight", "input_blocks.3.0.skip_connection.weight",
                "output_blocks.1.2.conv.weight", "out.0.weight", "out.2.weight"):
        assert f"module.{key}" in sd, key
    path = tmp_path / "model_450.pth"
    torch.save(sd, path)
    fresh = tadm.UNetModel(**SMALL, num_classes=5)
    fresh.load_state_dict(reference_state_dict(str(path)))
    assert all(torch.equal(a, b) for a, b in zip(fresh.state_dict().values(),
                                                  tm.state_dict().values()))
    assert list(reference_model_dict(tm)) == list(tm.state_dict())


def test_seeded_init_leaves_no_tensor_zero():
    """Zero-initialised output convs and attention projections would hide a
    wrong K1 or K6; the seeded weights give every tensor signal."""
    tm = seeded_init_(tadm.UNetModel(**SMALL, num_classes=5), 0)
    for name, p in tm.named_parameters():
        assert int(torch.count_nonzero(p)) == p.numel(), name


def test_group_norm32_matches_flax():
    """GroupNorm32 (F.group_norm, two-pass) against flax's GroupNorm
    (E[x^2] - mean^2) in f32: within 1e-5 of the largest output at unit
    inputs, and 1e-4 with a +8 mean offset, where flax's E[x^2] - mean^2
    loses about log2(1 + 8^2) = 6 bits of the variance to cancellation."""
    gn = GroupNorm32(64)
    with torch.no_grad():
        gn.weight.copy_(1.0 + 0.1 * torch.randn(64, generator=torch.Generator().manual_seed(0)))
        gn.bias.copy_(0.1 * torch.randn(64, generator=torch.Generator().manual_seed(1)))
    jgn = JGroupNorm32()
    params = {"params": {"norm": {"scale": gn.weight.detach().numpy(),
                                  "bias": gn.bias.detach().numpy()}}}
    for offset, tol in ((0.0, 1e-5), (8.0, 1e-4)):
        x = (np.random.default_rng(2).standard_normal((2, 8, 8, 64)) + offset).astype(np.float32)
        want = jgn.apply(params, jnp.asarray(x))
        with torch.no_grad():
            got = gn(torch.from_numpy(x))
        assert rel_err(got, want) < tol


def test_factory_builds_the_adm_and_names_what_is_missing():
    cfg = dataclasses.replace(tconfig.get_preset("celeb256_adm").model, nf=32,
                              ch_mult=(1, 2), image_size=64)
    model = create_network(cfg, dtype=torch.bfloat16, use_flash=True, device="cpu")
    assert isinstance(model, tadm.UNetModel) and model.use_flash and model.null_label == 0
    assert model.num_classes is None and model.dtype == torch.bfloat16
    with pytest.raises(NotImplementedError, match="DhariwalUNet"):
        create_network(tconfig.get_preset("ffhq_adm").model, device="cpu")
    with pytest.raises(NotImplementedError, match="layout"):
        create_network(dataclasses.replace(cfg, layout=True), device="cpu")


def _small_adm_config(cfg, method, **model_kw):
    model = dataclasses.replace(cfg.model, image_size=32, f=2, nf=32, ch_mult=(1, 2),
                                num_res_blocks=1, attn_resolutions=(2,), **model_kw)
    sample = dataclasses.replace(cfg.sample, method=method, num_steps=2)
    return dataclasses.replace(cfg, model=model, sample=sample)


@pytest.mark.parametrize("num_classes,cfg_scale", [(None, 1.0), (5, 1.5)])
def test_make_sampler_adm_matches_jax(num_classes, cfg_scale):
    """make_sampler on a small origin ADM (euler, 2 steps, latents only)
    against lfm_tpu's, unconditional and with labels and CFG (the null
    label is class 0); use_fused_dit is on and ignored for a UNet."""
    cfgs = []
    for mod in (jconfig, tconfig):
        c = _small_adm_config(mod.get_preset("celeb256_adm"), "euler", num_classes=num_classes)
        cfgs.append(dataclasses.replace(
            c, sample=dataclasses.replace(c.sample, cfg_scale=cfg_scale)))
    cfg_j, cfg_t = cfgs
    assert cfg_t.sample.use_fused_dit
    kw = dict(image_size=16, model_channels=32, num_res_blocks=1, attention_resolutions=(2,),
              channel_mult=(1, 2), num_classes=num_classes)
    jm = jadm.UNetModel(**kw, use_flash=True)
    t, x, y = _inputs(4, num_classes)
    params = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(t), jnp.asarray(x),
                               None if y is None else jnp.asarray(y)), seed=6, scale=0.2)
    tm = create_network(cfg_t.model, use_flash=True, device="cpu")
    assert tm.null_label == 0
    noise = np.random.default_rng(8).standard_normal((N, 16, 16, 4)).astype(np.float32)
    yj = None if y is None else jnp.asarray(y)
    jout = jmake_sampler(cfg_j, jm, params, jit=True)(jnp.asarray(noise), yj)
    tout = make_sampler(cfg_t, tm, adm_params_from_jax(params, tm.plan), device="cpu")(
        torch.from_numpy(noise), None if y is None else torch.from_numpy(y).long())
    assert tout.nfe == float(jout.nfe) == 2.0
    assert rel_err(tout.latents, jout.latents) < 1e-4
    _, labels = noise_and_labels(cfg_t, SampleRNG(0), range(N), device="cpu")
    assert (labels is None) == (num_classes is None)


@pytest.mark.parametrize("source", [["--preset", "celeb256_adm"],
                                    ["--argfile", "test_args/celeb256_adm.txt"]])
def test_cli_samples_a_small_adm_on_the_cpu(tmp_path, capsys, source):
    """``cli.main sample`` on the celeb256_adm preset or its argfile, with
    the model-override flags, builds the origin ADM they describe and
    samples on the CPU."""
    import os

    from lfm_tpu_torch.cli import main as cli

    out = tmp_path / "s.npy"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if source[0] == "--argfile":
        source = [source[0], os.path.join(repo, source[1])]
    path = cli.main(["sample", *source, "--device", "cpu",
                     "--image_size", "16", "--nf", "32", "--ch_mult", "1", "2",
                     "--attn_resolutions", "1", "--num_res_blocks", "1", "--scale_factor", "1.0",
                     "--method", "euler", "--steps", "2", "--batch_size", "2",
                     "--out", str(out)])
    assert path == str(out)
    img = np.load(out)
    assert img.shape == (2, 16, 16, 3) and np.isfinite(img).all()
    assert img.min() >= 0.0 and img.max() <= 1.0
    err = capsys.readouterr().err
    assert "seeded random origin-ADM UNet weights" in err
