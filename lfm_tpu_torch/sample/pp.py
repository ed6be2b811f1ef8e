"""Pipeline-parallel DiT evaluation: block stages over the ``pipe`` axis of
the ranks (port of lfm_tpu/sample/pp.py).

The DiT's blocks are split into stages over the pipe group; microbatches
go from stage to stage through core/pipeline.py. The embedders and the
final layer (under 1% of the work and the parameters) are replicated and
run on every stage, as in JAX. The blocks run the module path, so with
``use_flash`` every stage's attention launches ``attention_small`` (K1)
forward and ``attention_small_bwd`` (K3) backward at the microbatch's rows,
as JAX's ``assume_local_devices`` lets its Pallas kernel run in each stage.

The parameter names are those of the whole model (``blocks.{i}`` in the
checkpoint's, canonical, order). JAX permutes the stacked depth axis into
placement order (``interleave_block_params``) and shards it over pipe;
here the same permutation renames ``blocks.{i}`` keys, and
``place_stage_blocks_`` keeps on each rank only its slab of placement
order, its depth / S blocks, so block memory is 1/S. Device d's slab holds
its ``num_chunks`` virtual stages k S + d, chunk-major.

Differentiable: the sampler and the train step (``train=True``, as
``model_apply``) use it.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Mapping, Optional

import torch
from torch import nn

from lfm_tpu_torch.core.pipeline import pipeline_blocks
from lfm_tpu_torch.core.sharding import PIPE_AXIS, Mesh

__all__ = ["make_pp_apply", "interleave_block_params", "deinterleave_block_params",
           "permute_state_blocks", "placement_order", "stage_blocks", "place_stage_blocks_",
           "pipe_norm_groups"]

_BLOCK = re.compile(r"^((?:.*\.)?blocks)\.(\d+)(\..*)?$")


def _check_depth(depth: int, n_stages: int, num_chunks: int) -> int:
    if depth % (n_stages * num_chunks):
        raise ValueError(f"depth {depth} not divisible into {n_stages} stages x "
                         f"{num_chunks} chunks")
    return depth // (n_stages * num_chunks)


def placement_order(depth: int, n_stages: int, num_chunks: int) -> List[int]:
    """The canonical block at each placement position: position d (v lc) +
    k lc + j holds block (k S + d) lc + j (JAX's reshape(v, S, lc) and
    swap of the first two axes)."""
    lc = _check_depth(depth, n_stages, num_chunks)
    return [(k * n_stages + d) * lc + j for d in range(n_stages)
            for k in range(num_chunks) for j in range(lc)]


def stage_blocks(depth: int, n_stages: int, num_chunks: int, stage: int) -> List[int]:
    """The canonical blocks stage ``stage`` holds, in its local order
    (chunk k's blocks k lc .. (k + 1) lc - 1)."""
    per = depth // n_stages
    return placement_order(depth, n_stages, num_chunks)[stage * per:(stage + 1) * per]


def _rename_blocks(tree: Mapping, new_index: Callable[[int], int]) -> Dict:
    out = {}
    for key, val in tree.items():
        m = _BLOCK.match(key) if isinstance(key, str) else None
        if m is None:
            out[key] = val
        else:
            out[f"{m.group(1)}.{new_index(int(m.group(2)))}{m.group(3) or ''}"] = val
    return out


def _depth(tree: Mapping) -> int:
    idx = {int(m.group(2)) for k in tree if isinstance(k, str) and (m := _BLOCK.match(k))}
    return max(idx) + 1 if idx else 0


def permute_state_blocks(tree: Mapping, n_stages: int, num_chunks: int, *,
                         inverse: bool = False) -> Dict:
    """A mapping keyed by parameter name (a state dict, or the moments or
    EMA of one) with every ``blocks.{i}`` key renamed from the canonical
    order to the placement order, or back with ``inverse``; other keys
    unchanged (JAX's ``permute_state_blocks`` over a pytree)."""
    if num_chunks <= 1:
        return dict(tree)
    order = placement_order(_depth(tree), n_stages, num_chunks)
    if inverse:
        return _rename_blocks(tree, lambda p: order[p])
    pos = {c: p for p, c in enumerate(order)}
    return _rename_blocks(tree, lambda c: pos[c])


def interleave_block_params(params: Mapping, n_stages: int, num_chunks: int) -> Dict:
    """The checkpoint's order -> the interleaved placement order; invert
    with ``deinterleave_block_params`` before saving."""
    return permute_state_blocks(params, n_stages, num_chunks)


def deinterleave_block_params(params: Mapping, n_stages: int, num_chunks: int) -> Dict:
    """Inverse of ``interleave_block_params`` (the canonical order)."""
    return permute_state_blocks(params, n_stages, num_chunks, inverse=True)


def place_stage_blocks_(model, mesh: Mesh, num_chunks: int = 1):
    """Keep on this rank only its stage's blocks (``stage_blocks``), in its
    local order, and free the others: the module's ``blocks`` become the
    stage's ``depth / S``. ``model.pp_blocks`` records the canonical index
    of each. Returns the model."""
    n_stages = mesh.shape[PIPE_AXIS]
    idx = stage_blocks(model.depth, n_stages, num_chunks, mesh.coords[PIPE_AXIS])
    model.blocks = nn.ModuleList(model.blocks[i] for i in idx)
    model.pp_blocks = (tuple(idx), n_stages, num_chunks)
    return model


def pipe_norm_groups(names: List[str], mesh: Mesh) -> List:
    """A placed model's ``TrainState.norm_groups``: a block's parameters are
    split over pipe (each stage holds its own), the rest replicated."""
    group = mesh.group(PIPE_AXIS)
    return [group if _BLOCK.match(n) else None for n in names]


def make_pp_apply(model, mesh: Mesh, *, has_labels: bool = True,
                  num_microbatches: Optional[int] = None, train: bool = False,
                  num_chunks: int = 1) -> Callable:
    """``apply(t, x[, y], generator=None)`` of a DiT with its blocks
    pipelined over ``mesh``'s pipe group: x (N, H, W, C) this rank's rows
    of the batch over ``data`` (the same on every rank of the pipe group),
    N divisible by the microbatch count (default S). ``model`` holds either
    every block or, after ``place_stage_blocks_``, its stage's.

    ``num_chunks`` > 1 takes the interleaved schedule: rank d runs virtual
    stages d, S + d, ... (its placement slab). ``train`` turns on the
    forward's train mode, which label dropout would need per-stage draws
    for, so a model with label dropout raises, as in JAX."""
    from lfm_tpu_torch.nn.dit import DiT

    if not isinstance(model, DiT):
        raise TypeError(f"pipeline parallelism stages a DiT's blocks, got "
                        f"{type(model).__name__}")
    n_stages = mesh.shape[PIPE_AXIS]
    lc = _check_depth(model.depth, n_stages, num_chunks)
    if train and model.label_dropout > 0:
        raise ValueError("label dropout under pp would need per-stage rng plumbing; train the "
                         "CFG-dropout recipe with dp/fsdp/tp instead")
    group = mesh.group(PIPE_AXIS)

    def local_blocks():
        placed = getattr(model, "pp_blocks", None)
        if placed is not None:
            if placed[1:] != (n_stages, num_chunks):
                raise ValueError(f"the model's blocks are placed for {placed[1]} stages x "
                                 f"{placed[2]} chunks, not {n_stages} x {num_chunks}")
            return list(model.blocks)
        return [model.blocks[i] for i in stage_blocks(model.depth, n_stages, num_chunks,
                                                      mesh.coords[PIPE_AXIS])]

    def apply(t, x, y=None, generator=None):
        blocks = local_blocks()
        tok, c = model.embed(t, x, y, train, generator)
        remat = model.remat and torch.is_grad_enabled()
        dt = model.dtype

        def apply_chunk(k, xb, cb):
            for block in blocks[k * lc:(k + 1) * lc]:
                if remat:
                    xb = block.forward_remat(xb, cb, dt, model.remat_policy)
                else:
                    xb = block(xb, cb, dt)
            return xb

        tok = pipeline_blocks(apply_chunk, tok, c, group, num_chunks, num_microbatches)
        tok = model.final_layer(tok, c, dt)
        return model.unpatchify(tok).float()

    if has_labels:
        return apply
    return lambda t, x, generator=None: apply(t, x, None, generator)


def _to_local(model) -> Dict[int, int]:
    """canonical block index -> this rank's local index, for a placed model."""
    return {c: j for j, c in enumerate(model.pp_blocks[0])}


def stage_names(model, names) -> List[Optional[str]]:
    """Each canonical parameter name as this rank's placed model names it,
    or None for a block another stage holds."""
    local = _to_local(model)
    out = []
    for name in names:
        m = _BLOCK.match(name)
        if m is None:
            out.append(name)
        else:
            j = local.get(int(m.group(2)))
            out.append(None if j is None else f"{m.group(1)}.{j}{m.group(3) or ''}")
    return out


def load_stage_state_dict(model, state_dict: Mapping) -> None:
    """Load the whole model's ``state_dict`` into ``model``: all of it, or,
    after ``place_stage_blocks_``, the replicated layers and this rank's
    blocks."""
    if getattr(model, "pp_blocks", None) is None:
        model.load_state_dict(state_dict)
        return
    names = stage_names(model, list(state_dict))
    model.load_state_dict({n: v for n, v in zip(names, state_dict.values()) if n is not None})


def stage_content(content: Mapping, model) -> Dict:
    """A ``content.pth`` dict (canonical names) cut to a placed model: the
    replicated layers and this rank's blocks under their local names, with
    the optimizer state re-indexed to them (core/checkpoint.py keys it by
    position in ``model_dict``)."""
    from lfm_tpu_torch.core.checkpoint import strip_ddp_prefix

    md = strip_ddp_prefix(content["model_dict"])
    opt = content["optimizer"]["state"]
    new_md, new_opt = {}, {}
    for i, (name, local) in enumerate(zip(md, stage_names(model, list(md)))):
        if local is None:
            continue
        if i in opt:
            new_opt[len(new_md)] = opt[i]
        new_md[local] = md[name]
    return {**content, "model_dict": new_md,
            "optimizer": {**content["optimizer"], "state": new_opt}}


def gather_canonical(model, mesh: Mesh, names: List[str], tensors: List[torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """Every rank's ``tensors`` (named by the placed model's ``names``)
    under the whole model's canonical names and in its parameter order,
    on every rank of the pipe group (a collective); replicated tensors are
    this rank's."""
    import torch.distributed as dist

    _, n_stages, num_chunks = model.pp_blocks
    group = mesh.group(PIPE_AXIS)
    depth = model.depth
    blocks: Dict[int, Dict[str, torch.Tensor]] = {}
    out: Dict[str, Optional[torch.Tensor]] = {}
    for name, t in zip(names, tensors):
        m = _BLOCK.match(name)
        if m is None:
            out[name] = t
            continue
        t = t.detach().contiguous()
        parts = [t]
        if group is not None and n_stages > 1:
            parts = [torch.empty_like(t) for _ in range(n_stages)]
            dist.all_gather(parts, t, group=group)
        for s, part in enumerate(parts):
            c = stage_blocks(depth, n_stages, num_chunks, s)[int(m.group(2))]
            blocks.setdefault(c, {})[f"{m.group(1)}.{c}{m.group(3) or ''}"] = part
        out.setdefault("\0blocks", None)  # where the blocks stand in the order
    ordered: Dict[str, torch.Tensor] = {}
    for name, t in out.items():
        if name == "\0blocks":
            for c in sorted(blocks):
                ordered.update(blocks[c])
        else:
            ordered[name] = t
    return ordered
