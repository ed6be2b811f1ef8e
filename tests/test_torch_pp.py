"""Pipeline parallelism through the port (core/pipeline.py, sample/pp.py,
the sampler's ``pp_mesh``, train/loop.py's pp training) on four gloo
ranks, held against JAX on the conftest's virtual 8-device CPU mesh
(tests/test_pp.py's cases) and against the port's own one-process runs.

One launch of tests/torch_dist_worker.py ``pp`` runs every rank-side
check: GPipe forward at dp 1 x pp 4, with labels and two microbatches at
dp 2 x pp 2, the gradients of GPipe at pp 4 and of the interleaved
schedule (2 chunks) at dp 2 x pp 2, one train step at dp 2 x pp 2 against
one process, the euler + CFG sampler and the interleaved sampler, and the
loop at pp 2 x 2 chunks with a resume, against the data-parallel run.
Tolerances are JAX's own (tests/test_pp.py), all f32: forwards 2e-5,
gradients 1e-4 relative + 1e-5 absolute, samplers 2e-4, the loop 5e-4 +
1e-5; the train step against JAX's step on the same draws 1e-5 relative on
the loss and 1e-4 on the gradient norm, and against one process also 2e-5
absolute on the parameters (tests/test_torch_dist_train.py's bounds).
"""

import jax
import jax.experimental.pallas  # noqa: F401  # sets CUDA_ROOT: before the state guard looks
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_dist_worker as w
from tests.torch_parity import leaves_process_as_found, randomize  # noqa: F401

from lfm_tpu.core.config import Config, MeshConfig, ModelConfig, SampleConfig
from lfm_tpu.core.sharding import make_mesh as jmake_mesh
from lfm_tpu.nn.dit import DiT as JDiT
from lfm_tpu.ode.flow import interpolate as jinterpolate
from lfm_tpu.sample import pp as jpp
from lfm_tpu.sample.sample import make_sampler as jmake_sampler
from lfm_tpu_torch.core import checkpoint as ckpt
from lfm_tpu_torch.core.rng import seeded_generator
from lfm_tpu_torch.core.sharding import AXES, Mesh
from lfm_tpu_torch.nn.convert_dit import dit_params_from_jax
from lfm_tpu_torch.sample import pp as tpp

FWD_TOL, SAMPLER_TOL = 2e-5, 2e-4
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
LOOP_RTOL, LOOP_ATOL = 5e-4, 1e-5
STEP_LOSS_RTOL, STEP_GNORM_RTOL, STEP_PARAM_TOL = 1e-5, 1e-4, 2e-5


def jtiny(depth=4, **kw):
    kw = {**dict(img_resolution=8, patch_size=2, in_channels=4, hidden_size=64, num_heads=4,
                 num_classes=1), **kw}
    return JDiT(depth=depth, **kw)


def _np(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The inputs, the JAX results and the ranks' results."""
    mesh = jmake_mesh(dp=2, pp=4)
    want, inputs = {}, {}

    # GPipe forwards: plain and with labels + two microbatches
    for name, kw, mb in (("gpipe", {}, None), ("labels_mb", dict(num_classes=10), 2)):
        model = jtiny(**kw)
        x, t = _np((8, 8, 8, 4), 1), np.random.default_rng(2).uniform(size=(8,)).astype(
            np.float32)
        y = np.random.default_rng(3).integers(0, 10, size=(8,)).astype(np.int32)
        params = randomize(jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.asarray(t),
                                          jnp.asarray(x), jnp.asarray(y) if kw else None), 11,
                           scale=0.1)
        apply = jpp.make_pp_apply(model, mesh, has_labels=bool(kw), num_microbatches=mb)
        args = (jnp.asarray(t), jnp.asarray(x)) + ((jnp.asarray(y),) if kw else ())
        want[name] = np.asarray(jax.jit(apply)(params, *args))
        inputs.update({f"{name}_sd": dit_params_from_jax(params), f"{name}_x": _t(x),
                       f"{name}_t": _t(t), f"{name}_y": _t(y).long()})

    # gradients: GPipe at pp 4 and interleaved (2 chunks) at dp 2 x pp 4
    for name, depth, chunks, n, pmesh in (
            ("grads", 4, 1, 4, jmake_mesh(dp=1, pp=4, devices=jax.devices()[:4])),
            ("il", 8, 2, 8, mesh)):
        model = jtiny(depth=depth, hidden_size=32, num_heads=2)
        x, co = _np((n, 8, 8, 4), 20 + depth), _np((n, 8, 8, 4), 30 + depth)
        t = np.random.default_rng(depth).uniform(size=(n,)).astype(np.float32)
        params = randomize(jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.asarray(t),
                                          jnp.asarray(x), None), 12 + depth, scale=0.1)
        placed = jpp.interleave_block_params(params, 4, chunks)
        apply = jpp.make_pp_apply(model, pmesh, has_labels=False, num_chunks=chunks)
        xt = (jnp.asarray(t), jnp.asarray(x))
        want[name] = np.asarray(jax.jit(apply)(placed, *xt))
        g = jax.jit(jax.grad(lambda p: jnp.sum(apply(p, *xt) * co)))(placed)
        want[f"{name}_grads"] = {k: v.numpy() for k, v in dit_params_from_jax(
            jpp.deinterleave_block_params(g, 4, chunks)).items()}
        inputs.update({f"{name}_sd": dit_params_from_jax(params), f"{name}_x": _t(x),
                       f"{name}_t": _t(t), f"{name}_co": _t(co)})

    # the train step's model and batch (held against one process on the
    # ranks), and JAX's loss and gradient norm on the draws one process makes
    # for the global batch: t, then z1, from seeded_generator(seed, step 0)
    model = jtiny(hidden_size=32, num_heads=2)
    params = randomize(jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1,)),
                                      jnp.zeros((1, 8, 8, 4)), None), 15, scale=0.1)
    x = _np((8, 8, 8, 4), 4)
    gen = seeded_generator("cpu", w.PP_STEP_SEED, 0)
    t = torch.rand((8,), generator=gen).numpy()
    z1 = torch.randn(x.shape, generator=gen).numpy()

    def loss(p):
        z_t, u = jinterpolate(jnp.asarray(x), jnp.asarray(z1), jnp.asarray(t))
        v = model.apply(p, jnp.asarray(t), z_t)
        return jnp.mean(jnp.square(v.astype(jnp.float32) - u))

    jloss, jgrads = jax.jit(jax.value_and_grad(loss))(params)
    want["step"] = (float(jloss), float(jnp.sqrt(sum(
        jnp.sum(jnp.square(g)) for g in jax.tree_util.tree_leaves(jgrads)))))
    inputs.update(step_sd=dit_params_from_jax(params), step_x=_t(x))

    # the samplers: euler + CFG, and the interleaved schedule (pp_chunks 2)
    model = jtiny(hidden_size=32, num_heads=2, num_classes=10, label_dropout=0.1)
    x, y = _np((4, 8, 8, 4), 5), np.random.default_rng(5).integers(0, 10, (4,)).astype(np.int32)
    params = randomize(jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1,)),
                                      jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32)), 16,
                       scale=0.1)
    config = Config(model=ModelConfig(model_type="DiT-T/2", image_size=64, num_classes=10),
                    sample=SampleConfig(method="euler", num_steps=4, cfg_scale=1.5))
    want["sampler"] = np.asarray(jmake_sampler(config, model, params, pp_mesh=mesh)(
        jnp.asarray(x), jnp.asarray(y)).latents)
    inputs.update(sampler_sd=dit_params_from_jax(params), sampler_x=_t(x),
                  sampler_y=_t(y).long())
    model = jtiny(depth=8, hidden_size=32, num_heads=2)
    x = _np((16, 8, 8, 4), 7)
    params = randomize(jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1,)),
                                      jnp.zeros((1, 8, 8, 4)), None), 17, scale=0.1)
    config = Config(model=ModelConfig(model_type="DiT-T/2", image_size=64, num_classes=1),
                    sample=SampleConfig(method="euler", num_steps=4),
                    mesh=MeshConfig(pp=4, pp_chunks=2))
    want["sampler_il"] = np.asarray(jmake_sampler(config, model, params, pp_mesh=mesh)(
        jnp.asarray(x)).latents)
    inputs.update(sampler_il_sd=dit_params_from_jax(params), sampler_il_x=_t(x))

    work = tmp_path_factory.mktemp("pp")
    torch.save(inputs, work / "inputs.pt")
    return want, w.launch("pp", 4, work, args=(work / "inputs.pt",))


@pytest.mark.parametrize("name", ["gpipe", "labels_mb"])
def test_pp_forward_matches_jax(case, name):
    want, ranks = case
    for r, got in enumerate(ranks):
        lo, hi = got[f"{name}_rows"]
        np.testing.assert_allclose(got[name].numpy(), want[name][lo:hi], rtol=FWD_TOL,
                                   atol=FWD_TOL, err_msg=f"rank {r}")


def test_each_stage_holds_its_blocks(case):
    _, ranks = case
    assert [got["gpipe_blocks"] for got in ranks] == [(0,), (1,), (2,), (3,)]
    assert [got["labels_mb_blocks"] for got in ranks] == [(0, 1), (2, 3), (0, 1), (2, 3)]


@pytest.mark.parametrize("name", ["grads", "il"])
def test_pp_gradients_match_jax(case, name):
    """Forward and the gradient of every parameter, gathered from the
    stages into canonical names, against JAX's pipelined gradients."""
    want, ranks = case
    for r, got in enumerate(ranks):
        lo, hi = got[name]["rows"]
        np.testing.assert_allclose(got[name]["out"].numpy(), want[name][lo:hi], rtol=FWD_TOL,
                                   atol=FWD_TOL)
        grads = got[name]["grads"]
        if name == "il":
            # each data index's gradient is its rows' share; their sum is JAX's
            other = ranks[(r + 2) % 4][name]["grads"]
            grads = {k: grads[k] + other[k] for k in grads}
        assert sorted(grads) == sorted(want[f"{name}_grads"])
        for k, g in grads.items():
            np.testing.assert_allclose(g.numpy(), want[f"{name}_grads"][k], rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL, err_msg=f"rank {r} {k}")


def test_pp_train_step_matches_jax(case):
    """Every rank's loss and gradient norm (its blocks' squares summed over
    pipe, the replicated layers' counted once) against JAX's whole-batch
    step on the same draws."""
    want, ranks = case
    jloss, jnorm = want["step"]
    for r, got in enumerate(ranks):
        pp = got["step"]["pp"]
        assert abs(pp["loss"] - jloss) <= STEP_LOSS_RTOL * abs(jloss), (r, pp["loss"], jloss)
        assert abs(pp["gnorm"] - jnorm) <= STEP_GNORM_RTOL * jnorm, (r, pp["gnorm"], jnorm)


def test_pp_train_step_matches_one_process(case):
    _, ranks = case
    for got in ranks:
        plain, pp = got["step"]["plain"], got["step"]["pp"]
        assert np.isfinite(pp["loss"])
        np.testing.assert_allclose(pp["loss"], plain["loss"], rtol=STEP_LOSS_RTOL)
        np.testing.assert_allclose(pp["gnorm"], plain["gnorm"], rtol=STEP_GNORM_RTOL)
        assert list(pp["params"]) == list(plain["params"])
        for k, v in plain["params"].items():
            np.testing.assert_allclose(pp["params"][k].numpy(), v.numpy(), atol=STEP_PARAM_TOL,
                                       err_msg=k)


@pytest.mark.parametrize("name", ["sampler", "sampler_il"])
def test_pp_sampler_matches_jax(case, name):
    want, ranks = case
    for got in ranks:
        np.testing.assert_allclose(got[name].numpy(), want[name], rtol=SAMPLER_TOL,
                                   atol=SAMPLER_TOL)


def test_loop_pp_interleaved_matches_plain_and_checkpoints_are_canonical(case):
    """train(...) at pp 2 x 2 chunks: an epoch, a resume through the content
    checkpoint (written canonical, cut back to each stage), a second epoch;
    params and EMA as the data-parallel run's. One process loads the
    checkpoint into a whole model."""
    _, ranks = case
    for got in ranks:
        loop = got["loop"]
        assert loop["pp1_step"] == 2 and loop["pp2"]["step"] == loop["plain"]["step"] == 4
        assert loop["names"][0] == loop["names"][1]
        for what in ("params", "ema"):
            for k, a, b in zip(loop["names"][0], loop["pp2"][what], loop["plain"][what]):
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=LOOP_RTOL, atol=LOOP_ATOL,
                                           err_msg=f"{what}:{k}")
    loop = ranks[0]["loop"]
    names = [k for k in loop["content_1"] if k.startswith("blocks.")]
    assert names[0].startswith("blocks.0.") and names[-1].startswith("blocks.3.")
    model = w.tiny_pp_dit(hidden_size=64, num_heads=4)
    from lfm_tpu_torch.train.state import create_train_state

    state = create_train_state(model)
    assert ckpt.restore_content(loop["exp"], model, state) == 2
    for k, p in zip(state.names, state.params):
        np.testing.assert_allclose(p.detach().numpy(),
                                   loop["pp2"]["params"][loop["names"][1].index(k)].numpy(),
                                   rtol=LOOP_RTOL, atol=LOOP_ATOL, err_msg=k)


@pytest.mark.parametrize("stages,chunks", [(4, 2), (2, 4), (4, 1), (8, 2)])
def test_interleave_permutation_matches_jax(stages, chunks):
    """The port's key renames give JAX's permutation of the stacked depth
    axis, and invert it."""
    model = jtiny(depth=16, hidden_size=32, num_heads=2)
    params = randomize(jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1,)),
                                      jnp.zeros((1, 8, 8, 4)), None), 1)
    sd = dit_params_from_jax(params)
    want = dit_params_from_jax(jpp.interleave_block_params(params, stages, chunks))
    got = tpp.interleave_block_params(sd, stages, chunks)
    assert sorted(got) == sorted(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    back = tpp.deinterleave_block_params(got, stages, chunks)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    order = tpp.placement_order(16, stages, chunks)
    assert sorted(order) == list(range(16))
    per = 16 // stages
    assert [b for s in range(stages) for b in tpp.stage_blocks(16, stages, chunks, s)] == order
    assert all(len(tpp.stage_blocks(16, stages, chunks, s)) == per for s in range(stages))


def test_pp_rejects_bad_configs():
    """JAX's asserts: depth divisible by the stages x chunks, and no label
    dropout in training."""
    mesh = Mesh(dict(zip(AXES, (2, 1, 4, 1, 1))), {a: 0 for a in AXES})
    with pytest.raises(ValueError, match="not divisible"):
        tpp.make_pp_apply(w.tiny_pp_dit(depth=2), mesh)
    with pytest.raises(ValueError, match="label dropout"):
        tpp.make_pp_apply(w.tiny_pp_dit(num_classes=10, label_dropout=0.1), mesh, train=True)
