"""FSDP and tensor-parallel layouts (core/partition.py) on the CPU: JAX's
rules (tests/test_partition.py), and a train step over four gloo ranks in
each of JAX's three layouts at half its ranks, dp=2 x fsdp=2, dp=2 x tp=2
and fsdp=2 x tp=2, held against the replicated step in one process.

Tolerances: the loss 1e-5 relative and the gathered parameters 2e-5
absolute (JAX's own, tests/test_partition.py:95-99), except the elements
whose replicated gradient is below 1e-6, 100 times Adam's eps (the qkv
bias's key third, whose gradient is zero in exact arithmetic): Adam's first
step moves those by up to the learning rate on each side from an f32
rounding, so they are held within 2 x lr. Each rank's qkv product at tp=2
equals the replicated product's heads of that rank in each of q, k and v
within 1e-6 (one f32 product over half the columns).
"""

import pytest
import torch

from tests import torch_dist_worker as w
from tests.torch_parity import leaves_process_as_found  # noqa: F401

from lfm_tpu_torch.core.partition import (Shard, _chunks, _unchunk, combined_shardings,
                                          dit_tp_shardings, fsdp_shardings)
from lfm_tpu_torch.core.sharding import AXES, Mesh, mesh_shape
from lfm_tpu_torch.train.state import create_train_state

LR = 1e-3


def _mesh(**axes) -> Mesh:
    """A mesh's shape alone (the rules read no group)."""
    shape = dict(zip(AXES, mesh_shape(8, **axes)))
    return Mesh(shape, {a: 0 for a in AXES})


def test_fsdp_shards_large_params():
    model = w.part_model()
    sh = fsdp_shardings(model, _mesh(dp=2, fsdp=4), min_size=1024)
    assert sh["blocks.0.attn.qkv.weight"] == Shard("fsdp", 0)  # (384, 128): the 384
    assert sh["blocks.0.mlp.fc2.weight"] == Shard("fsdp", 1)  # (128, 512): the 512
    assert sh["t_embedder.mlp.0.bias"] is None  # tiny: replicated


def test_tp_rules():
    model = w.part_model()
    sh = dit_tp_shardings(model, _mesh(dp=2, tp=4))
    # a Linear's weight is (out, in): columns are dim 0, rows dim 1
    assert sh["blocks.1.attn.qkv.weight"] == Shard("tensor", 0, thirds=True)
    assert sh["blocks.1.attn.qkv.bias"] == Shard("tensor", 0, thirds=True)
    assert sh["blocks.1.attn.proj.weight"] == Shard("tensor", 1)
    assert sh["blocks.1.attn.proj.bias"] is None
    assert sh["blocks.1.mlp.fc1.weight"] == Shard("tensor", 0)
    assert sh["blocks.1.mlp.fc2.weight"] == Shard("tensor", 1)
    assert sh["blocks.1.adaLN_modulation.1.weight"] is None
    combined = combined_shardings(model, _mesh(dp=2, fsdp=2, tp=2), tp_rules="dit",
                                  fsdp_min_size=1024)
    assert combined["blocks.0.attn.qkv.weight"].axis == "tensor"
    assert combined["blocks.0.adaLN_modulation.1.weight"] == Shard("fsdp", 0)


def test_qkv_split_takes_whole_heads_of_each_third():
    """JAX splits qkv's columns contiguously (right in global semantics);
    a rank that attends locally takes q, k and v of its own heads."""
    qkv = torch.arange(3 * 8).reshape(24, 1)  # 3 thirds x 4 heads x 2 dims
    parts = _chunks(qkv, Shard("tensor", 0, thirds=True), 2)
    assert parts[0].flatten().tolist() == [0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 19]
    assert torch.equal(_unchunk(parts, Shard("tensor", 0, thirds=True)), qkv)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return w.launch("partition", 4, tmp_path_factory.mktemp("partition"))


@pytest.fixture(scope="module")
def replicated():
    model = w.part_model()
    state = create_train_state(model)
    loss, _ = w.part_step(model)(state, {"x": torch.from_numpy(w.part_batch()["x"])})
    return state, float(loss), [p.grad.detach().abs() for p in state.params]


@pytest.mark.parametrize("layout", list(w.LAYOUTS))
def test_sharded_training_matches_replicated(ranks, replicated, layout):
    state, loss, grads = replicated
    for r in ranks:
        got = r[layout]
        assert abs(got["loss"] - loss) <= 1e-5 * abs(loss)
        for name, a, b, g in zip(state.names, got["params"], state.params, grads):
            tol = torch.where(g < 1e-6, torch.full_like(b, 2 * LR), torch.full_like(b, 2e-5))
            err = (a - b.detach()).abs()
            assert bool((err <= tol).all()), (layout, name, float(err.max()))


@pytest.mark.parametrize("layout", list(w.LAYOUTS))
def test_layout_holds_slices_and_local_heads(ranks, layout):
    """fsdp keeps a slice of each large parameter as the optimizer's
    master; tp splits the blocks' heads and each rank's qkv product holds
    whole heads of q, k and v."""
    cfg = w.LAYOUTS[layout]
    heads = w.PART_DIT["num_heads"] // cfg["tp"]
    full = {n: tuple(p.shape) for n, p in w.part_model().named_parameters()}
    for r in ranks:
        got = r[layout]
        assert got["heads"] == [heads] * w.PART_DIT["depth"]
        shapes = dict(zip(full, got["master_shapes"]))
        if cfg["fsdp"] > 1:
            assert shapes["blocks.0.adaLN_modulation.1.weight"] == (384, 128)  # 768 / 2
        if cfg["tp"] > 1:
            assert shapes["blocks.0.attn.qkv.weight"] == (192, 128)
            assert got["qkv_width"] == 3 * w.PART_DIT["hidden_size"] // 2
            assert got["qkv_heads_err"] <= 1e-6
        else:
            assert "qkv_heads_err" not in got
