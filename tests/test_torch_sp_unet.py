"""The row-sharded UNet forward (sample/sp.py::make_spatial_sp_apply and
the layers' halo, GroupNorm and attention exchanges) on four gloo ranks,
held against JAX's GSPMD-partitioned forward on the conftest's virtual
8-device CPU mesh (tests/test_sp_adm.py's cases).

One launch of tests/torch_dist_worker.py ``sp_unet`` runs every rank-side
check: TINY_ADM's UNetModel at dp 1 x sp 4 and dp 2 x sp 2, with classes,
scale-shift norm and resblock up/down-sampling at dp 2 x sp 2, EDM's
DhariwalUNet at sp 4, and the euler sampler over dp 2 x sp 2. Tolerances
are JAX's own: the forwards 2e-5, the sampler 2e-4, f32.
"""

import jax
import jax.experimental.pallas  # noqa: F401  # sets CUDA_ROOT: before the state guard looks
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from tests import torch_dist_worker as w
from tests.torch_parity import leaves_process_as_found, randomize  # noqa: F401

from lfm_tpu.core.config import Config, ModelConfig, SampleConfig
from lfm_tpu.core.sharding import DATA_AXIS, SEQ_AXIS
from lfm_tpu.core.sharding import make_mesh as jmake_mesh
from lfm_tpu.nn.adm_unet import UNetModel as JUNet
from lfm_tpu.nn.edm_unet import DhariwalUNet as JDhariwal
from lfm_tpu.sample.sample import make_sampler as jmake_sampler
from lfm_tpu.sample.sp import make_spatial_sp_apply as jmake_spatial
from lfm_tpu.sample.sp import sp_data_sharding
from lfm_tpu_torch.core.sharding import AXES, Mesh
from lfm_tpu_torch.nn import adm_unet as tadm
from lfm_tpu_torch.nn.convert_adm import adm_params_from_jax
from lfm_tpu_torch.nn.convert_edm import edm_params_from_jax
from lfm_tpu_torch.sample.sp import make_spatial_sp_apply

FWD_TOL, SAMPLER_TOL = 2e-5, 2e-4
TINY_ADM = dict(image_size=16, in_channels=4, model_channels=32, out_channels=4,
                num_res_blocks=1, attention_resolutions=(8, 4), channel_mult=(1, 2),
                num_heads=2)
DHARIWAL = dict(img_resolution=16, model_channels=32, channel_mult=(1, 2), num_blocks=1,
                attn_resolutions=(8,), dropout=0.0)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The inputs, the JAX results and the ranks' results."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 16, 16, 4)).astype(np.float32)
    t = np.linspace(0.2, 0.8, 4).astype(np.float32)
    y = rng.integers(0, 5, size=(4,)).astype(np.int32)
    jt, jx, jy = jnp.asarray(t), jnp.asarray(x), jnp.asarray(y)
    want, inputs, cases = {}, {"x": torch.from_numpy(x), "t": torch.from_numpy(t)}, []
    adm_kw = {**TINY_ADM, "num_classes": 5, "use_scale_shift_norm": True,
              "resblock_updown": True}
    for name, kind, kw, (dp, sp), labels in (
            ("adm_1x4", "adm", TINY_ADM, (1, 4), False),
            ("adm_2x2", "adm", TINY_ADM, (2, 2), False),
            ("adm_classes", "adm", adm_kw, (2, 2), True),
            ("dhariwal", "edm", DHARIWAL, (1, 4), False)):
        jm = (JUNet if kind == "adm" else JDhariwal)(**kw)
        params = randomize(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jt, jx,
                                          jy if labels else None), 9, scale=0.2)
        mesh = jmake_mesh(dp=dp, sp=sp, devices=jax.devices()[:4])
        xs = jax.device_put(jx, sp_data_sharding(mesh))
        if kind == "adm":
            apply = jmake_spatial(jm, mesh, has_labels=labels)
            got = jax.jit(apply)(params, jt, xs, *((jy,) if labels else ()))
            tm = tadm.UNetModel(**kw)
            sd = adm_params_from_jax(params, tm.plan)
        else:
            sh = NamedSharding(mesh, P(DATA_AXIS, SEQ_AXIS, None, None))
            got = jax.jit(lambda p, t_, x_: jax.lax.with_sharding_constraint(
                jm.apply(p, t_, jax.lax.with_sharding_constraint(x_, sh)), sh))(params, jt, xs)
            sd = edm_params_from_jax(params)
        want[name] = np.asarray(got)
        inputs[f"{name}_sd"] = sd
        inputs[f"{name}_y"] = torch.from_numpy(y).long() if labels else None
        cases.append((name, (kind, kw), (dp, sp)))
    inputs["cases"] = cases

    # the sampler: euler 4 over dp 2 x sp 2 (tests/test_sp_adm.py's end to end)
    jm = JUNet(**TINY_ADM)
    params = randomize(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jt, jx, None), 10,
                       scale=0.2)
    config = Config(model=ModelConfig(model_type="adm", image_size=128, num_classes=1, nf=32),
                    sample=SampleConfig(method="euler", num_steps=4))
    mesh = jmake_mesh(dp=2, sp=2, devices=jax.devices()[:4])
    want["sampler"] = np.asarray(jmake_sampler(config, jm, params, sp_mesh=mesh)(jx).latents)
    inputs["sampler_kw"] = TINY_ADM
    inputs["sampler_sd"] = adm_params_from_jax(params, tadm.UNetModel(**TINY_ADM).plan)

    work = tmp_path_factory.mktemp("sp_unet")
    torch.save(inputs, work / "inputs.pt")
    return want, w.launch("sp_unet", 4, work, args=(work / "inputs.pt",))


@pytest.mark.parametrize("name", ["adm_1x4", "adm_2x2", "adm_classes", "dhariwal"])
def test_row_sharded_unet_matches_jax(case, name):
    want, ranks = case
    assert np.abs(want[name]).max() > 1e-2
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got[name].numpy(), want[name], rtol=FWD_TOL, atol=FWD_TOL,
                                   err_msg=f"rank {r}")


def test_row_sharded_adm_sampler_matches_jax(case):
    want, ranks = case
    for got in ranks:
        np.testing.assert_allclose(got["sampler"].numpy(), want["sampler"], rtol=SAMPLER_TOL,
                                   atol=SAMPLER_TOL)


def test_a_level_that_does_not_split_raises_naming_it(case):
    _, ranks = case
    for got in ranks:
        assert "level 0" in got["odd_rows"] and "sp=4" in got["odd_rows"]


@pytest.mark.parametrize("kind", ["layout", "adm_context", "song"])
def test_other_networks_raise_under_sp(kind):
    """SongUNet, the layout UNet and adm_context are not row-sharded
    (ROADMAP Queue 1 item 11)."""
    from lfm_tpu_torch.nn import edm_unet as tedm

    with torch.device("cpu"):
        model = {"layout": lambda: tadm.UNetModel(**TINY_ADM, use_spatial_transformer=True,
                                                  context_dim=8),
                 "adm_context": lambda: tedm.DhariwalUNet(**DHARIWAL, use_context=True),
                 "song": lambda: tedm.SongUNet(img_resolution=16, model_channels=16,
                                               channel_mult=(1, 2), num_blocks=1,
                                               attn_resolutions=(8,))}[kind]()
    mesh = Mesh(dict(zip(AXES, (1, 1, 1, 1, 2))), {a: 0 for a in AXES})
    with pytest.raises(NotImplementedError, match="item 11"):
        make_spatial_sp_apply(model, mesh)
