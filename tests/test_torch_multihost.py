"""core/multihost.py and core/sharding.py (the port of lfm_tpu/core/
multihost.py and sharding.py; tests/test_multihost.py's cases), and the
CLI's multi-process flags.

One process: the rank-0 gates, the collective OR and the barrier without
a job, ``initialize``'s idempotence, its single-process mode and its
errors (``torch.distributed.init_process_group`` mocked). Two gloo ranks
(tests/torch_dist_worker.py ``helpers``): the barrier, the collective OR
and the mesh's rows. Exact comparisons throughout.
"""

import os

import numpy as np
import pytest
import torch.distributed as dist

from tests import torch_dist_worker as w
from tests.torch_parity import leaves_process_as_found  # noqa: F401

from lfm_tpu_torch.cli import main as cli
from lfm_tpu_torch.core import multihost
from lfm_tpu_torch.core.sharding import (batch_rows, local_batch_size, make_mesh, mesh_shape,
                                         process_sample_shard, shard_batch)


@pytest.fixture(autouse=True)
def _reset_flag():
    multihost._initialized = False
    yield
    multihost._initialized = False


def test_single_process_gates():
    assert multihost.process_index() == 0
    assert multihost.process_count() == 1
    assert multihost.is_main_process()
    assert multihost.data_shard() == (0, 1)
    assert multihost.sync_hosts() == 1.0
    assert multihost.any_process_flag(True) is True
    assert multihost.any_process_flag(False) is False


def test_initialize_single_process_joins_nothing(monkeypatch):
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: pytest.fail("must not join for num_processes=1"))
    multihost.initialize(num_processes=1)
    assert multihost._initialized
    multihost._initialized = False
    monkeypatch.delenv("RANK", raising=False)
    multihost.initialize()  # no coordinator and no torchrun: one process
    assert not multihost._initialized and multihost.process_count() == 1


def test_initialize_is_idempotent_and_uses_the_coordinator(monkeypatch):
    calls = []
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **k: calls.append((a, k)))
    multihost.initialize("10.0.0.1:1234", 2, 1, device="cpu")
    multihost.initialize("10.0.0.1:1234", 2, 1, device="cpu")  # a no-op
    assert calls == [(("gloo",), {"init_method": "tcp://10.0.0.1:1234", "world_size": 2,
                                  "rank": 1})]


def test_initialize_from_torchrun_environment(monkeypatch):
    calls = []
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **k: calls.append((a, k)))
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    multihost.initialize(device="cpu")
    assert calls == [(("gloo",), {})]


def test_initialize_raises_and_never_falls_back(monkeypatch):
    """A real error re-raises; NCCL, the card's default, is not traded for
    gloo when it fails to start."""
    calls = []

    def refuse(backend, **k):
        calls.append(backend)
        raise RuntimeError("connection refused by coordinator")

    monkeypatch.setattr(dist, "init_process_group", refuse)
    monkeypatch.setattr(multihost.torch.cuda, "set_device", lambda d: None)
    monkeypatch.setattr(multihost, "local_device", lambda device=None: "cuda:0")
    with pytest.raises(RuntimeError, match="connection refused"):
        multihost.initialize("addr:1", 2, 0)
    assert calls == ["nccl"] and not multihost._initialized
    with pytest.raises(ValueError, match="coordinator"):
        multihost.initialize(None, 2, 0)
    assert multihost.default_backend("cpu") == "gloo"
    assert multihost.default_backend() == multihost.default_backend("cuda") == "nccl"


def test_mesh_arithmetic_and_batch_rows():
    assert mesh_shape(8, dp=-1, fsdp=2, tp=2) == (2, 2, 1, 2, 1)
    assert mesh_shape(4) == (4, 1, 1, 1, 1)
    with pytest.raises(ValueError):
        mesh_shape(8, dp=3)
    for axes in ({"sp": 2}, {"pp": 2}):
        with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
            mesh_shape(8, **axes)
    mesh = make_mesh()
    assert mesh.size == 1 and mesh.device_mesh is None and mesh.group("data") is None
    assert local_batch_size(mesh, 6) == 6 and batch_rows(mesh, 6) == (0, 6)
    batch = {"x": np.arange(6), "y": None}
    assert shard_batch(mesh, batch)["x"].tolist() == list(range(6))
    assert process_sample_shard(50_000, 125, 0, 8) == (50_000, 50)
    assert process_sample_shard(10, 4, 1, 2) == (16, 2)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return w.launch("helpers", 2, tmp_path_factory.mktemp("helpers"))


def test_two_ranks_barrier_and_collective_or(ranks):
    for r, got in enumerate(ranks):
        assert (got["index"], got["count"], got["main"], got["shard"]) == (r, 2, r == 0, (r, 2))
        assert got["sync"] == 2.0
        # rank 1 alone raises the flag: every rank sees it; none or all, alike
        assert (got["any_one"], got["any_none"], got["any_all"]) == (True, False, True)


def test_two_ranks_mesh_rows(ranks):
    """dp=-1 gives each rank its contiguous rows; at tp=2 both ranks share
    one data index, so they hold the same rows (JAX's batch split) and the
    data axis runs no collective."""
    assert [got["rows"] for got in ranks] == [[0, 1], [2, 3]]
    assert [got["mesh_coords"]["data"] for got in ranks] == [0, 1]
    for r, got in enumerate(ranks):
        shape, coords = got["tp_mesh"]
        assert (shape["data"], shape["tensor"], coords["tensor"]) == (1, 2, r)
        assert got["tp_rows"] == [0, 1]
        assert got["data_group"] and not got["tp_data_group"]


def test_a_job_of_one_rank_keeps_its_collectives(tmp_path):
    """A joined job of one rank (NCCL on one card) runs its collectives over
    itself, so that path is exercised where only one card exists."""
    (got,) = w.launch("helpers", 1, tmp_path)
    assert (got["count"], got["sync"], got["data_group"]) == (1, 1.0, True)
    assert got["rows"] == [0, 1] and got["any_one"] is True


SUBCOMMANDS = ["train", "sample", "fid", "nfe", "time", *cli.DOWNSTREAM]


@pytest.mark.parametrize("cmd", SUBCOMMANDS)
def test_every_subcommand_takes_the_process_flags(cmd):
    args = cli._build_parser().parse_args(
        [cmd, "--coordinator", "h:5", "--num_procs", "4", "--process_id", "3"])
    assert (args.coordinator, args.num_procs, args.process_id) == ("h:5", 4, 3)


@pytest.mark.parametrize("cmd", [c for c in SUBCOMMANDS if c not in cli._MULTIPROC_CMDS])
def test_single_process_subcommands_exit_on_num_procs(cmd, monkeypatch):
    """JAX's message (lfm_tpu/cli/main.py:361-372), before anything runs;
    torchrun's world counts the same."""
    monkeypatch.setattr(multihost, "initialize", lambda *a, **k: pytest.fail("joined"))
    with pytest.raises(SystemExit, match="not supported for"):
        cli.main([cmd, "--preset", "celeb256_dit", "--num_procs", "2"])
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match=f"'{cmd}'"):
        cli.main([cmd, "--preset", "celeb256_dit"])


def test_train_and_fid_join_the_job(monkeypatch):
    joined = []
    monkeypatch.setattr(cli, "initialize", lambda *a, **k: joined.append((a, k)))
    for cmd in cli._MULTIPROC_CMDS:
        args = cli._build_parser().parse_args(
            [cmd, "--coordinator", "h:5", "--num_procs", "2", "--process_id", "1",
             "--device", "cpu"])
        cli._join(args)
    assert joined == [(("h:5", 2, 1), {"device": "cpu"})] * 2
    args = cli._build_parser().parse_args(["train", "--preempt_check_every", "7", "--dp", "2",
                                           "--fsdp", "2", "--tp", "2"])
    cfg = cli._resolve_train_config(args)
    assert cfg.train.preempt_check_every == 7
    assert (cfg.mesh.dp, cfg.mesh.fsdp, cfg.mesh.tp) == (2, 2, 2)
    assert "RANK" not in os.environ


@pytest.mark.parametrize("flag", ["--sp", "--pp", "--pp_chunks"])
def test_sequence_and_pipeline_flags_raise(flag):
    for cmd in ("train", "sample"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
            cli.main([cmd, "--preset", "celeb256_dit", "--device", "cpu", flag, "2"])
