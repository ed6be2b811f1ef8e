"""Parameter partitioning over the mesh: FSDP and tensor parallelism
(port of lfm_tpu/core/partition.py).

The rules are JAX's:

* FSDP: a parameter of at least ``min_size`` elements is split over the
  ``fsdp`` axis on its largest dimension that the axis divides; smaller
  ones are replicated.
* Tensor parallelism (Megatron, the DiT's blocks): ``attn.qkv`` and
  ``mlp.fc1`` split by output columns, ``attn.proj`` and ``mlp.fc2`` by
  input rows; the TP rules take precedence over FSDP.

JAX gives the parameters shardings and XLA inserts the collectives in
global semantics. Here each rank computes locally, so the collectives are
written out, with ``all_reduce`` and ``all_gather`` only (the same code
runs over NCCL and over gloo, on the CPU or on a card):

* FSDP: a rank keeps its slice as the master the optimizer updates; at
  each step the slices are all-gathered into the module's parameter, and
  the rank keeps its slice of the gradient (averaged over the data axis
  like every other). The batch is split over ``data`` only, as in JAX, so
  the ranks of one fsdp group compute the same rows.
* TP: the module holds only the rank's part. A column-split layer's input
  gradient is summed over the tensor group (``copy_to_group``), a
  row-split layer's partial products are summed before its bias
  (``reduce_from_group``). JAX splits qkv's 3C output columns
  contiguously, which is right only in global semantics: a rank that
  attends locally must hold q, k and v of its own heads, so qkv is split
  within each third and the attention runs over num_heads / tp heads.

Used by tests and by chip_smoke.py, as JAX's by __graft_entry__.py and its
tests; the training loop replicates the state whatever ``--fsdp/--tp``
say, as JAX's does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch import nn

from lfm_tpu_torch.core.sharding import FSDP_AXIS, TENSOR_AXIS, Mesh


@dataclass(frozen=True)
class Shard:
    """A parameter split over mesh ``axis`` on dimension ``dim``; with
    ``thirds`` each third of that dimension (q, k, v) is split alike."""

    axis: str
    dim: int
    thirds: bool = False


Shardings = Dict[str, Optional[Shard]]  # parameter name -> Shard, None = replicated


def _largest_divisible_dim(shape, n: int) -> Optional[int]:
    """Index of the largest dim divisible by n, else None."""
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[i] >= n and shape[i] % n == 0:
            return i
    return None


def fsdp_shardings(model: nn.Module, mesh: Mesh, min_size: int = 2 ** 16) -> Shardings:
    n = mesh.shape[FSDP_AXIS]
    out = {}
    for name, p in model.named_parameters():
        dim = (_largest_divisible_dim(p.shape, n) if n > 1 and p.numel() >= min_size
               else None)
        out[name] = None if dim is None else Shard(FSDP_AXIS, dim)
    return out


# (parent module, leaf module) -> split; a Linear's weight is (out, in)
_DIT_TP_RULES = {("attn", "qkv"): "col", ("attn", "proj"): "row",
                 ("mlp", "fc1"): "col", ("mlp", "fc2"): "row"}


def _tp_kind(name: str) -> Optional[str]:
    parts = name.split(".")
    kind = None
    for (parent, leaf), k in _DIT_TP_RULES.items():
        if parent in parts and leaf in parts:
            kind = k
    return kind


def dit_tp_shardings(model: nn.Module, mesh: Mesh) -> Shardings:
    """Megatron's split of nn/dit.py's blocks over the tensor axis."""
    n = mesh.shape[TENSOR_AXIS]
    out = {}
    for name, p in model.named_parameters():
        kind, leaf = _tp_kind(name), name.rsplit(".", 1)[-1]
        dim = None
        if n > 1 and kind is not None:
            if leaf == "weight" and p.ndim >= 2:
                dim = 0 if kind == "col" else 1
            elif leaf == "bias" and kind == "col":
                dim = 0
        thirds = ".qkv." in f".{name}"
        if dim is not None and p.shape[dim] % (3 * n if thirds else n) == 0:
            out[name] = Shard(TENSOR_AXIS, dim, thirds)
        else:
            out[name] = None
    return out


def combined_shardings(model: nn.Module, mesh: Mesh, *, tp_rules: str = "none",
                       fsdp_min_size: int = 2 ** 16) -> Shardings:
    """TP rules take precedence; everything else falls to FSDP or is
    replicated."""
    fsdp = fsdp_shardings(model, mesh, fsdp_min_size)
    if tp_rules != "dit":
        return fsdp
    tp = dit_tp_shardings(model, mesh)
    return {k: tp[k] if tp[k] is not None else fsdp[k] for k in fsdp}


def _chunks(x: torch.Tensor, spec: Shard, n: int) -> List[torch.Tensor]:
    """The n ranks' parts of x, in rank order."""
    if not spec.thirds:
        return list(x.chunk(n, dim=spec.dim))
    parts = [t.chunk(n, dim=spec.dim) for t in x.chunk(3, dim=spec.dim)]
    return [torch.cat([p[r] for p in parts], dim=spec.dim) for r in range(n)]


def _unchunk(parts: List[torch.Tensor], spec: Shard) -> torch.Tensor:
    if not spec.thirds:
        return torch.cat(parts, dim=spec.dim)
    thirds = [t.chunk(3, dim=spec.dim) for t in parts]
    return torch.cat([torch.cat([t[i] for t in thirds], dim=spec.dim) for i in range(3)],
                     dim=spec.dim)


def _all_gather(x: torch.Tensor, group) -> List[torch.Tensor]:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return parts


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the gradient summed over the group (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromGroup(torch.autograd.Function):
    """The sum over the group forward; identity backward (Megatron's g)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromGroup.apply(x, group)


class Partitioned:
    """A model's parameters laid out by ``shardings`` on this rank.

    ``masters`` are the tensors the optimizer updates, in
    ``named_parameters`` order: the module's own parameter where it is
    replicated or split over the tensor axis (the module then holds only
    the rank's part), a slice of it where it is split over fsdp.
    ``gather_()`` fills the module's fsdp-split parameters from the
    masters; ``local_grads`` gives the masters' gradients; ``full``
    gathers a list of master-shaped tensors whole (for a checkpoint, or
    a comparison with the replicated run)."""

    def __init__(self, model: nn.Module, shardings: Shardings, mesh: Mesh):
        self.model, self.mesh = model, mesh
        named = list(model.named_parameters())
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.specs = [shardings.get(n) for n in self.names]
        self.groups = [None if s is None else mesh.group(s.axis) for s in self.specs]
        self.masters = []
        with torch.no_grad():
            for name, p, spec in zip(self.names, self.params, self.specs):
                if spec is None:
                    self.masters.append(p)
                    continue
                part = _chunks(p.detach(), spec, mesh.shape[spec.axis])[
                    mesh.coords[spec.axis]].clone()
                if spec.axis == TENSOR_AXIS:
                    p.data = part
                    self.masters.append(p)
                else:
                    self.masters.append(part)
        self._mark_tensor_parallel()

    def _mark_tensor_parallel(self) -> None:
        """Tell each split Linear its group, and each attention with a split
        qkv its local head count."""
        n = self.mesh.shape[TENSOR_AXIS]
        for name, spec in zip(self.names, self.specs):
            if spec is None or spec.axis != TENSOR_AXIS or not name.endswith(".weight"):
                continue
            layer_name = name.rsplit(".", 1)[0]
            layer = self.model.get_submodule(layer_name)
            layer.tensor_parallel = (_tp_kind(name), self.mesh.group(TENSOR_AXIS))
            if spec.thirds:
                attn = self.model.get_submodule(layer_name.rsplit(".", 1)[0])
                if attn.num_heads % n:
                    raise ValueError(f"{attn.num_heads} heads do not split over tp={n}")
                attn.num_heads //= n

    def is_fsdp(self, i: int) -> bool:
        return self.specs[i] is not None and self.specs[i].axis == FSDP_AXIS

    @torch.no_grad()
    def gather_(self) -> None:
        for i, (p, spec) in enumerate(zip(self.params, self.specs)):
            if self.is_fsdp(i):
                p.copy_(_unchunk(_all_gather(self.masters[i], self.groups[i]), spec))

    def local_grads(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The masters' gradients from the module parameters' gradients."""
        return [_chunks(g, self.specs[i], self.mesh.shape[FSDP_AXIS])[
                    self.mesh.coords[FSDP_AXIS]] if self.is_fsdp(i) else g
                for i, g in enumerate(grads)]

    @torch.no_grad()
    def full(self, values: List[torch.Tensor]) -> List[torch.Tensor]:
        return [v if g is None else _unchunk(_all_gather(v, g), spec)
                for v, spec, g in zip(values, self.specs, self.groups)]


def shard_params(model: nn.Module, shardings: Shardings, mesh: Mesh) -> Partitioned:
    """Lay ``model``'s parameters out by ``shardings`` on this rank (JAX's
    ``shard_params``; the module is changed in place)."""
    return Partitioned(model, shardings, mesh)
