"""Sequence-parallel model evaluation: a latent's rows split over the
``seq`` axis of the ranks (port of lfm_tpu/sample/sp.py).

JAX maps the model over the mesh with ``shard_map`` (the DiT) or lets
XLA's partitioner split a UNet's rows. Here each rank runs the model on
its own block, batch rows over ``data`` and latent rows over ``seq``, and
the exchanges are written out:

* the DiT (``make_sp_apply``): every token-local layer runs on the rank's
  rows, the position table is sliced to them, and the attention is the
  ring over the seq group (core/ring.py);
* the origin ADM UNet and EDM's DhariwalUNet (``make_spatial_sp_apply``):
  each padded convolution takes a halo of its neighbours' rows, GroupNorm
  sums its statistics over the group, the attentions gather k and v of
  every rank's rows, and the timestep embedding is replicated. Stride-2
  convolutions, average pools and the 2x resampling filters need an even
  number of rows a rank at every level that down-samples, which the apply
  checks before it runs, naming the level.

Both run the model inside ``layers.row_sharded``, which tells the layers
that cross rows the seq group, this rank's index on it and its size.
The parameters are those of the whole model on every rank, so a converted
reference checkpoint loads unchanged. ``sp_block`` cuts a rank's block out
of a global batch and ``sp_gather`` joins the blocks again.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from lfm_tpu_torch.core.sharding import (DATA_AXIS, SEQ_AXIS, Mesh, all_gather_cat,
                                         local_batch_size)

__all__ = ["make_sp_apply", "make_spatial_sp_apply", "sp_block", "sp_gather"]


def sp_block(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's block of a global (N, H, ...) batch: its rows of the
    batch over ``data`` and its contiguous latent rows over ``seq`` (JAX's
    ``P(data, seq)``)."""
    b = local_batch_size(mesh, x.shape[0])
    i = mesh.coords[DATA_AXIS]
    x = x[i * b:(i + 1) * b]
    sp = mesh.shape[SEQ_AXIS]
    if x.shape[1] % sp:
        raise ValueError(f"{x.shape[1]} rows do not split over sp={sp}")
    rows = x.shape[1] // sp
    j = mesh.coords[SEQ_AXIS]
    return x[:, j * rows:(j + 1) * rows]


def sp_gather(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The global batch from every rank's block (the inverse of
    ``sp_block``), on every rank."""
    x = all_gather_cat(x, mesh.group(SEQ_AXIS), dim=1)
    return all_gather_cat(x, mesh.group(DATA_AXIS), dim=0)


def _row_sharded(mesh: Mesh):
    """``layers.row_sharded`` over ``mesh``'s seq axis: this rank's group,
    index and size."""
    from lfm_tpu_torch.nn.layers import row_sharded

    return row_sharded(mesh.group(SEQ_AXIS), mesh.coords[SEQ_AXIS], mesh.shape[SEQ_AXIS])


def make_sp_apply(model, mesh: Mesh, *, has_labels: bool = True) -> Callable:
    """``apply(t, x[, y])`` of a DiT over this rank's block: x (N_local,
    H / sp, W, C) its rows (``sp_block``), t and y its batch rows. The
    result is the same block of the velocity. The rows a rank holds must
    align to the patch size."""
    from lfm_tpu_torch.nn.dit import DiT

    if not isinstance(model, DiT):
        raise TypeError(f"make_sp_apply takes a DiT, got {type(model).__name__}; a UNet "
                        "takes make_spatial_sp_apply")

    def apply(t, x, y=None, **kw):
        with _row_sharded(mesh):
            return model(t, x, y, **kw)

    if has_labels:
        return apply
    return lambda t, x, **kw: apply(t, x, None, **kw)


# the networks whose forward is written out over row shards (the two that
# tests/test_sp_adm.py covers); the others raise, ROADMAP Queue 1 item 11
def _spatial_kind(model) -> str:
    from lfm_tpu_torch.nn.adm_unet import UNetModel
    from lfm_tpu_torch.nn.edm_unet import DhariwalUNet

    if type(model) is UNetModel and not model.use_spatial_transformer:
        return "adm"
    if type(model) is DhariwalUNet and not model.use_context:
        return "edm"
    name = type(model).__name__
    if getattr(model, "use_spatial_transformer", False):
        name += " (layout)"
    if getattr(model, "use_context", False):
        name += " (adm_context)"
    raise NotImplementedError(f"{name}: row-sharded sequence parallelism covers the origin ADM "
                              "UNet and EDM's DhariwalUNet only (ROADMAP Queue 1 item 11)")


def check_spatial_rows(model, rows: int, sp: int) -> None:
    """Raise unless ``rows`` latent rows split over ``sp`` ranks at every
    level: each level that down-samples needs an even number of rows a
    rank."""
    kind = _spatial_kind(model)
    if kind == "adm":
        levels = sum(s.kind in ("down", "res_down") for b in model.plan.input_blocks for s in b)
    else:
        levels = sum(k.endswith("_down") for k in model.enc)
    if rows % sp:
        raise ValueError(f"{rows} latent rows do not split over sp={sp}")
    local = rows // sp
    for level in range(levels):
        if local % 2:
            raise ValueError(f"sp={sp}: level {level} ({rows >> level} rows, {local} a rank) "
                             "does not split into whole rows at the next level")
        local //= 2


def make_spatial_sp_apply(model, mesh: Mesh, *, has_labels: bool = True) -> Callable:
    """``apply(t, x[, y])`` of the origin ADM UNet or EDM's DhariwalUNet
    over this rank's block (``sp_block``): the forward with every layer
    that crosses rows exchanging them over the seq group (the module
    docstring). SongUNet, the layout UNet, ``adm_context`` and the variants
    raise."""
    _spatial_kind(model)
    sp = mesh.shape[SEQ_AXIS]

    def apply(t, x, y=None, **kw):
        check_spatial_rows(model, x.shape[1] * sp, sp)
        with _row_sharded(mesh):
            return model(t, x, y, **kw)

    if has_labels:
        return apply
    return lambda t, x, **kw: apply(t, x, None, **kw)


def sp_norm_group(mesh: Optional[Mesh]):
    """The ranks whose blocks make up one batch of latents, over which an
    adaptive solver's norms are summed: data and seq."""
    return None if mesh is None else mesh.group_over(DATA_AXIS, SEQ_AXIS)
