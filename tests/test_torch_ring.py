"""Ring sequence parallelism through the port (core/ring.py, nn/dit.py's row
shards, sample/sp.py, the sampler's ``sp_mesh``) on four gloo ranks, held
against JAX on the conftest's virtual 8-device CPU mesh (tests/test_sp.py's
cases through ``shard_map``).

One launch of tests/torch_dist_worker.py ``ring`` runs every rank-side
check: the ring at dp 1 x sp 4 and dp 2 x sp 2, its gradients at sp 4, the
DiT-T/2 at dp 2 x sp 2 with labels, the euler + CFG sampler over that
mesh, and the CLI's ``sample --sp 2`` and ``--pp 2``. Tolerances are JAX's
own (tests/test_sp.py): the ring 2e-5, its gradients 5e-5, the DiT and the
sampler 2e-4, all f32; the CLI's bf16 images against one process 2e-2.
"""

import jax
import jax.experimental.pallas  # noqa: F401  # sets CUDA_ROOT: before the state guard looks
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from tests import torch_dist_worker as w
from tests.torch_parity import leaves_process_as_found, randomize  # noqa: F401

from lfm_tpu.core.config import Config, ModelConfig, SampleConfig
from lfm_tpu.core.ring import ring_attention as jring
from lfm_tpu.core.sharding import DATA_AXIS, SEQ_AXIS
from lfm_tpu.core.sharding import make_mesh as jmake_mesh
from lfm_tpu.nn.dit import create_dit as jcreate_dit
from lfm_tpu.sample.sample import make_sampler as jmake_sampler
from lfm_tpu.sample.sp import make_sp_apply as jmake_sp_apply
from lfm_tpu.sample.sp import sp_data_sharding
from lfm_tpu_torch.core.ring import ring_attention
from lfm_tpu_torch.nn.convert_dit import dit_params_from_jax

RING_TOL, GRAD_TOL, DIT_TOL = 2e-5, 5e-5, 2e-4
CLI_TOL = 2e-2


def _np(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _jax_ring(mesh, spec, q, k, v):
    return shard_map(lambda q, k, v: jring(q, k, v, SEQ_AXIS), mesh=mesh, in_specs=(spec,) * 3,
                     out_specs=spec, check_vma=False)(q, k, v)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The inputs, the JAX results and the ranks' results."""
    qkv = np.stack([_np((4, 16, 4, 16), s) for s in range(3)])
    gqkv = np.stack([_np((2, 16, 2, 8), 10 + s) for s in range(3)])
    gco = _np((2, 16, 2, 8), 13)
    want = {}
    for dp, sp in ((1, 4), (2, 2)):
        mesh = jmake_mesh(dp=dp, sp=sp, devices=jax.devices()[:4])
        want[f"ring_{dp}x{sp}"] = np.asarray(jax.jit(
            lambda q, k, v: _jax_ring(mesh, P(DATA_AXIS, SEQ_AXIS, None, None), q, k, v))(
                *map(jnp.asarray, qkv)))
    mesh = jmake_mesh(dp=1, sp=4, devices=jax.devices()[:4])
    spec = P(None, SEQ_AXIS, None, None)
    want["ring_grads"] = [np.asarray(g) for g in jax.jit(jax.grad(
        lambda q, k, v: jnp.sum(_jax_ring(mesh, spec, q, k, v) * gco), (0, 1, 2)))(
            *map(jnp.asarray, gqkv))]

    # DiT-T/2 at dp 2 x sp 2 with labels (tests/test_sp.py's mixed mesh)
    mesh = jmake_mesh(dp=2, sp=2, devices=jax.devices()[:4])
    kw = dict(img_resolution=16, num_classes=10)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(8, 16, 16, 4)).astype(np.float32)
    t = rng.uniform(size=(8,)).astype(np.float32)
    y = rng.integers(0, 10, size=(8,)).astype(np.int32)
    model = jcreate_dit("DiT-T/2", **kw)
    params = randomize(jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.asarray(t),
                                      jnp.asarray(x), jnp.asarray(y)), 4, scale=0.1)
    apply_sp = jmake_sp_apply(jcreate_dit("DiT-T/2", sp_axis=SEQ_AXIS, **kw), mesh)
    want["sp_dit"] = np.asarray(jax.jit(apply_sp)(
        params, jnp.asarray(t), jax.device_put(jnp.asarray(x), sp_data_sharding(mesh)),
        jnp.asarray(y)))

    # the sampler: euler + CFG over dp 2 x sp 2 (tests/test_sp.py's end to end)
    smodel = jcreate_dit("DiT-T/2", img_resolution=16, num_classes=10, label_dropout=0.1)
    sparams = randomize(jax.eval_shape(smodel.init, jax.random.PRNGKey(0), jnp.zeros((1,)),
                                       jnp.zeros((1, 16, 16, 4)), jnp.zeros((1,), jnp.int32)),
                        5, scale=0.1)
    noise = _np((4, 16, 16, 4), 6)
    labels = np.random.default_rng(7).integers(0, 10, size=(4,)).astype(np.int32)
    config = Config(model=ModelConfig(model_type="DiT-T/2", image_size=128, num_classes=10),
                    sample=SampleConfig(method="euler", num_steps=4, cfg_scale=1.5))
    want["sp_sampler"] = np.asarray(jmake_sampler(config, smodel, sparams, sp_mesh=mesh)(
        jnp.asarray(noise), jnp.asarray(labels)).latents)

    work = tmp_path_factory.mktemp("ring")
    inputs = work / "inputs.pt"
    torch.save({"qkv": torch.from_numpy(qkv), "grad_qkv": torch.from_numpy(gqkv),
                "grad_co": torch.from_numpy(gco), "x": torch.from_numpy(x),
                "t": torch.from_numpy(t), "y": torch.from_numpy(y).long(),
                "dit": dit_params_from_jax(params), "dit_cfg": dit_params_from_jax(sparams),
                "noise": torch.from_numpy(noise), "labels": torch.from_numpy(labels).long()},
               inputs)
    return want, w.launch("ring", 4, work, args=(inputs,))


@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
def test_ring_attention_matches_jax(case, mesh):
    want, ranks = case
    for got in ranks:
        np.testing.assert_allclose(got[f"ring_{mesh}"].numpy(), want[f"ring_{mesh}"],
                                   rtol=RING_TOL, atol=RING_TOL)


def test_ring_attention_grads_match_jax(case):
    want, ranks = case
    for got in ranks:
        for a, b in zip(got["ring_grads"], want["ring_grads"]):
            np.testing.assert_allclose(a.numpy(), b, rtol=GRAD_TOL, atol=GRAD_TOL)


def test_sp_dit_matches_jax_and_restores_the_model(case):
    want, ranks = case
    for got in ranks:
        np.testing.assert_allclose(got["sp_dit"].numpy(), want["sp_dit"], rtol=DIT_TOL,
                                   atol=DIT_TOL)
        assert got["row_shard_after"] is None


def test_sp_sampler_matches_jax(case):
    want, ranks = case
    for got in ranks:
        assert got["sp_sampler"].shape == (4, 16, 16, 4)
        np.testing.assert_allclose(got["sp_sampler"].numpy(), want["sp_sampler"],
                                   rtol=DIT_TOL, atol=DIT_TOL)


@pytest.mark.parametrize("name", list(w.CLI_MESH_FLAGS))
def test_cli_sample_over_the_ranks_matches_one_process(case, name, tmp_path):
    """``sample --sp 2`` and ``--pp 2`` over the four ranks write (rank 0)
    the images one process writes, within bf16's rounding of the ring's
    and the microbatches' other sums (the CLI's bf16 DiT, 2e-2 of [0, 1])."""
    from lfm_tpu_torch.cli import main as cli

    _, ranks = case
    path = str(tmp_path / "one.npy")
    cli.main(["sample", *w.CLI_SAMPLE_FLAGS, "--out", path])
    want = np.load(path)
    assert [got[name][1] for got in ranks] == [True, None, None, None]
    got = np.load(ranks[0][name][0])
    assert got.shape == want.shape == (4, 32, 32, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=CLI_TOL)


def test_ring_of_one_rank_is_plain_attention():
    """Without a group the ring is one step: softmax attention with f32
    statistics, as tests/test_sp.py's reference."""
    q, k, v = (torch.from_numpy(_np((2, 8, 2, 8), s)) for s in range(3))
    s = torch.einsum("nqhd,nkhd->nhqk", q, k) / np.sqrt(8)
    want = torch.einsum("nhqk,nkhd->nqhd", torch.softmax(s, dim=-1), v)
    torch.testing.assert_close(ring_attention(q, k, v, None), want, rtol=RING_TOL,
                               atol=RING_TOL)
