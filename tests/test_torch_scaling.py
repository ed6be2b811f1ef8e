"""Port parity of dynamic loss scaling (train/scaling.py) against lfm_tpu's
``dynamic_loss_scale`` around each package's AdamW (train/state.py), on
the CPU: the same scale trajectory, growth counter and skipped steps over
a gradient sequence with non-finite steps, and the parameters and Adam
moments within 1e-6 of each tensor's largest value (the optimizer's
tolerance in tests/test_torch_train.py).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from tests.torch_parity import leaves_process_as_found, rel_err, to_np  # noqa: E402,F401

from lfm_tpu.core import config as jconfig  # noqa: E402
from lfm_tpu.train import state as jstate  # noqa: E402
from lfm_tpu.train.scaling import dynamic_loss_scale as jdynamic_loss_scale  # noqa: E402
from lfm_tpu_torch.core.config import TrainConfig  # noqa: E402
from lfm_tpu_torch.train import state as tstate  # noqa: E402
from lfm_tpu_torch.train.scaling import LossScaleState, dynamic_loss_scale  # noqa: E402

SHAPES = {"b": (5,), "w": (3, 5)}
CFG = dict(lr=1e-3, weight_decay=0.05, no_lr_decay=False, num_epoch=10, lr_min=1e-5)
SPE = 2  # steps per epoch: the cosine schedule moves every second step taken


def _port_state(params):
    names = sorted(params)
    p = [torch.from_numpy(np.array(params[n])) for n in names]
    return tstate.TrainState(names=names, params=p, mu=[torch.zeros_like(x) for x in p],
                             nu=[torch.zeros_like(x) for x in p], ema=[x.clone() for x in p])


@pytest.mark.parametrize("bad", [{3: np.inf, 4: np.nan}, {0: -np.inf}, {}],
                         ids=["inf_then_nan", "inf_first", "all_finite"])
def test_loss_scale_follows_jax(bad):
    """growth_interval 3, init scale 2^20: growth after three clean steps,
    backoff and a skipped step (parameters, moments, the schedule's count
    as they were) on a non-finite gradient, the counter reset by both."""
    rng = np.random.default_rng(0)
    params = {n: (0.1 * rng.standard_normal(s)).astype(np.float32) for n, s in SHAPES.items()}
    tx = jdynamic_loss_scale(jstate.make_optimizer(jconfig.TrainConfig(**CFG), SPE),
                             growth_interval=3)
    jls = tx.init(params)
    jparams = {n: jnp.asarray(v) for n, v in params.items()}

    @jax.jit
    def jstep(grads, ls, p):
        updates, ls = tx.update(grads, ls, p)
        return optax.apply_updates(p, updates), ls

    init, scaled_update = dynamic_loss_scale(
        tstate.make_fused_adamw_ema(tstate.make_optimizer(TrainConfig(**CFG), SPE),
                                    use_ema=False), growth_interval=3)
    ls = init()
    assert ls == LossScaleState(2.0 ** 20, 0)
    state = _port_state(params)
    taken = 0
    for step in range(9):
        g = {n: (rng.standard_normal(s) * ls.scale).astype(np.float32) for n, s in SHAPES.items()}
        if step in bad:
            g["w"][1, 2] = bad[step]
        jparams, jls = jstep({n: jnp.asarray(v) for n, v in g.items()}, jls, jparams)
        ls, gnorm = scaled_update(state, ls, [torch.from_numpy(g[n]) for n in state.names])
        assert (ls.scale, ls.growth_counter) == (float(jls.scale), int(jls.growth_counter)), step
        assert (gnorm is None) == (step in bad)
        taken += step not in bad
        adam = jls.inner[0]
        for key, tree in (("params", jparams), ("mu", adam.mu), ("nu", adam.nu)):
            for name, got in zip(state.names, getattr(state, key)):
                assert rel_err(to_np(got), np.asarray(tree[name])) < 1e-6, (step, key, name)
        assert state.count == taken == int(adam.count)
    assert state.step == taken
