"""Multi-process start-up and the host-level collectives (port of
lfm_tpu/core/multihost.py; the reference's ddp_utils.py:17-30).

One process per GPU under ``torch.distributed``: the world of ranks takes
the place of JAX's device mesh. ``initialize`` joins the job, from the
torchrun environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` / ``MASTER_PORT``) where it is set, else from an explicit
coordinator address, world size and rank. The backend is NCCL on the card
and gloo when the caller asks for the CPU; gloo on the card is taken only
when asked for by name (two ranks that share one card, which NCCL
refuses). A failure to start NCCL raises: nothing falls back to gloo.

Each rank's device is ``cuda:LOCAL_RANK`` (``local_device``). Without a
joined group every helper answers for one process and runs no collective.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from lfm_tpu_torch.core.device import DeviceLike

# set once this process has joined a job, or chosen to run alone
_initialized = False


def from_torchrun() -> bool:
    """Whether torchrun's environment names this process's rank."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def default_backend(device: DeviceLike = None) -> str:
    """NCCL unless the caller asks for the CPU."""
    return "gloo" if device is not None and torch.device(device).type == "cpu" else "nccl"


def local_rank() -> int:
    """This process's index among the ranks of its host."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    if not dist.is_initialized() or not torch.cuda.is_available():
        return 0
    return dist.get_rank() % torch.cuda.device_count()


def local_device(device: DeviceLike = None) -> torch.device:
    """The device of this rank: ``device`` where given (``"cpu"``, or the
    one card that ranks share), else ``cuda:LOCAL_RANK``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return torch.device("cuda", local_rank())


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               backend: Optional[str] = None, device: DeviceLike = None) -> None:
    """Join the job. Idempotent; ``num_processes == 1`` is the
    single-process mode and joins nothing, as is a call with neither a
    coordinator nor the torchrun environment (lfm_tpu/core/multihost.py:
    36-75). ``coordinator_address`` is ``host:port`` (a TCP rendezvous) or
    an init-method URL such as ``file:///path``. ``backend`` defaults to
    NCCL, or gloo when ``device`` is the CPU. A real error raises."""
    global _initialized
    if _initialized or dist.is_initialized():
        _initialized = True
        return
    if num_processes == 1:
        _initialized = True
        return
    env = from_torchrun()
    if coordinator_address is None and not env:
        if num_processes is None:
            return  # nothing to join: one process
        raise ValueError(f"{num_processes} processes need a coordinator address "
                         "(--coordinator host:port) or the torchrun environment")
    backend = backend or default_backend(device)
    on_card = device is None or torch.device(device).type == "cuda"
    if on_card and (backend == "nccl" or torch.cuda.is_available()):
        torch.cuda.set_device(local_device(device))
    if env:
        dist.init_process_group(backend)
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and process_id")
        url = coordinator_address if "://" in coordinator_address else (
            f"tcp://{coordinator_address}")
        dist.init_process_group(backend, init_method=url, world_size=num_processes,
                                rank=process_id)
    _initialized = True


def shutdown() -> None:
    """Leave the job (the process group is destroyed); a later
    ``initialize`` may join another."""
    global _initialized
    if dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    """The rank-0 gate for logging, plots and files."""
    return process_index() == 0


def collective_device() -> torch.device:
    """Where a small tensor for a collective lives: the rank's card under
    NCCL, the host under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _collective_sum(val: float) -> float:
    """The sum of a host scalar over every rank, read back on each: the
    primitive under ``sync_hosts`` and ``any_process_flag``."""
    x = torch.tensor([val], dtype=torch.float32, device=collective_device())
    dist.all_reduce(x)
    return float(x.item())  # the read waits for the collective


def sync_hosts() -> float:
    """A barrier (the reference's dist.barrier, test_flow_latent.py:275):
    an all-reduce of 1.0 whose result is read on the host. Returns the
    number of ranks."""
    if not dist.is_initialized():
        return 1.0
    return _collective_sum(1.0)


def any_process_flag(flag: bool) -> bool:
    """Collective OR of a host flag: True on every rank when any rank set
    it. Each rank calls it at the same point and all act on the agreed
    value, so that a SIGTERM that reaches one rank makes every rank save
    together (lfm_tpu/core/multihost.py:126-138). One process: the flag."""
    if process_count() == 1:
        return bool(flag)
    return _collective_sum(1.0 if flag else 0.0) > 0.0


def data_shard() -> Tuple[int, int]:
    """(rank, world) for the loader's host sharding."""
    return process_index(), process_count()
