"""The mesh of ranks and the batch split (port of lfm_tpu/core/sharding.py).

JAX builds a ``jax.sharding.Mesh`` over its devices and lets XLA insert
the collectives. Here the mesh is over the ranks of ``torch.distributed``
(one process per GPU, core/multihost.py): ``make_mesh`` lays the world out
as (data, fsdp, pipe, tensor, seq) in JAX's order on
``torch.distributed.device_mesh.init_device_mesh``, and each axis gives
the process group that its collectives run over. A rank computes only its
own rows of a batch; the collectives are written out where they belong
(train/train.py, core/partition.py, sample/sharded.py).

One process that joined no job builds no ``DeviceMesh``: every axis has
size 1 and no collective runs. A joined job of one rank keeps its groups,
so that its collectives run (over NCCL on one card they are copies): the
multi-rank path on a machine with one card. Ring sequence parallelism and
pipeline parallelism (``sp``, ``pp`` above 1) are not ported (ROADMAP
Queue 1 item 8).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from lfm_tpu_torch.core.multihost import process_count

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
PIPE_AXIS = "pipe"
TENSOR_AXIS = "tensor"
SEQ_AXIS = "seq"
AXES = (DATA_AXIS, FSDP_AXIS, PIPE_AXIS, TENSOR_AXIS, SEQ_AXIS)


@dataclass(frozen=True)
class Mesh:
    """The ranks laid out over the named axes: ``shape`` gives each axis's
    size, ``coords`` this rank's index on it; ``device_mesh`` is None in a
    process that joined no job."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    device_mesh: Any = None

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def group(self, axis: str):
        """The process group of ``axis`` through this rank, or None where
        no collective is needed: no job, or an axis of one rank in a job of
        several (a job of one rank keeps its groups)."""
        if self.device_mesh is None or (self.shape[axis] == 1 and self.size > 1):
            return None
        return self.device_mesh.get_group(axis)


def mesh_shape(n: int, dp: int = -1, fsdp: int = 1, tp: int = 1, sp: int = 1,
               pp: int = 1) -> Tuple[int, ...]:
    """(data, fsdp, pipe, tensor, seq) for ``n`` ranks; ``dp=-1`` takes the
    ranks the other axes leave (lfm_tpu/core/sharding.py:28-52)."""
    if sp > 1 or pp > 1:
        raise NotImplementedError(
            f"sp={sp}, pp={pp}: ring sequence parallelism and pipeline parallelism are not "
            "ported yet (ROADMAP Queue 1 item 8)")
    rest = fsdp * pp * tp * sp
    if dp == -1:
        if n % rest:
            raise ValueError(f"{n} ranks are not divisible by fsdp*pp*tp*sp={rest}")
        dp = n // rest
    if dp * rest != n:
        raise ValueError(f"mesh {dp}x{fsdp}x{pp}x{tp}x{sp} != {n} ranks")
    return dp, fsdp, pp, tp, sp


def make_mesh(dp: int = -1, fsdp: int = 1, tp: int = 1, sp: int = 1, pp: int = 1) -> Mesh:
    """The mesh over every rank of the job (one rank when none was
    joined). The tensor and seq axes are innermost, so that ranks of one
    tensor group are neighbours, as in JAX's mesh."""
    n = process_count()
    shape = dict(zip(AXES, mesh_shape(n, dp, fsdp, tp, sp, pp)))
    if not dist.is_initialized():
        return Mesh(shape, {a: 0 for a in AXES})
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(device_type, tuple(shape.values()), mesh_dim_names=AXES)
    return Mesh(shape, dict(zip(AXES, dm.get_coordinate())), dm)


def local_batch_size(mesh: Mesh, global_batch: int) -> int:
    dp = mesh.shape[DATA_AXIS]
    if global_batch % dp:
        raise ValueError(f"global batch {global_batch} is not divisible by dp {dp}")
    return global_batch // dp


def batch_rows(mesh: Mesh, global_batch: int) -> Tuple[int, int]:
    """[start, stop) of this rank's rows of a global batch: its data
    index's contiguous block."""
    local = local_batch_size(mesh, global_batch)
    start = mesh.coords[DATA_AXIS] * local
    return start, start + local


def global_rows(mesh: Optional[Mesh], local: int) -> Optional[Tuple[int, int, int]]:
    """(start, stop, total) of this rank's ``local`` rows in the global
    batch, or None where no data group splits it."""
    if mesh is None or mesh.group(DATA_AXIS) is None:
        return None
    start = mesh.coords[DATA_AXIS] * local
    return start, start + local, local * mesh.shape[DATA_AXIS]


def shard_batch(mesh: Mesh, batch):
    """This rank's rows of a host batch (a tensor, an array or a dict,
    list or tuple of them), split over the data axis. Every rank holds
    the identical full batch, as in JAX (lfm_tpu/core/sharding.py:84-91),
    so ranks that share a data index compute the same rows."""
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(mesh, v) for v in batch)
    if batch is None:
        return None
    start, stop = batch_rows(mesh, batch.shape[0])
    return batch[start:stop]


def process_sample_shard(n_sample: int, batch_size: int, rank: int, world_size: int):
    """(total, steps) of the FID sample-index space, rounded up to a
    multiple of the global batch (reference test_flow_latent.py:248-272)."""
    global_batch = batch_size * world_size
    total = int(math.ceil(n_sample / global_batch) * global_batch)
    return total, total // global_batch


BUCKET_ELEMS = 1 << 26  # 256 MB of f32 an all-reduce


def all_reduce_mean_(tensors, group: Optional[Any]) -> None:
    """Each tensor replaced in place by its mean over ``group``, in buckets
    of at most ``BUCKET_ELEMS`` elements of one dtype (one all-reduce a
    bucket). No group: unchanged."""
    if group is None:
        return
    n = dist.get_world_size(group)
    bucket, size = [], 0
    for t in list(tensors) + [None]:
        if t is not None and (not bucket or (t.dtype == bucket[0].dtype
                                            and size + t.numel() <= BUCKET_ELEMS)):
            bucket.append(t)
            size += t.numel()
            continue
        if bucket:
            flat = torch.cat([b.reshape(-1) for b in bucket])
            dist.all_reduce(flat, group=group)
            flat /= n
            for b, f in zip(bucket, flat.split([b.numel() for b in bucket])):
                b.copy_(f.view_as(b))
        bucket, size = ([t], t.numel()) if t is not None else ([], 0)
