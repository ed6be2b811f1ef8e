"""Checkpoints in the reference's own ``.pth`` layouts (port of
lfm_tpu/core/checkpoint.py and the ``.pth`` side of convert_optimizer.py).

* ``content.pth``, the full resume state (reference
  train_flow_latent.py:193-205): epoch, global_step, args, ``model_dict``,
  the AdamW ``optimizer`` state dict with the EMA weights as
  ``state[i]['ema']`` (reference EMA.py:38-41) and the cosine ``scheduler``;
* ``model_{E}.pth``, the EMA weights alone (the reference's swap-save-swap,
  EMA.py:71-91).

Both follow the reference DiT's ``state_dict``: its fixed ``pos_embed`` is a
Parameter registered on the DiT itself, so it comes first in ``state_dict``
and ``parameters()`` order and holds optimizer index 0 (no Adam state; an
EMA copy under the EMA wrapper). In this package it is a buffer, rebuilt
rather than stored, so the files add it on save and drop it on load. The
optimizer state is keyed by that index, as torch keys it. A reference
``model_{E}.pth`` or ``content.pth`` (with or without the DDP ``module.``
prefix) loads with no converter, and lfm_tpu reads these files with
``load_reference_content``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Mapping, Optional, Union

import torch
from torch import nn

from lfm_tpu_torch.core.config import Config
from lfm_tpu_torch.train.state import AdamW, TrainState

CONTENT = "content.pth"


def strip_ddp_prefix(sd: Mapping) -> Dict:
    return {(k[7:] if k.startswith("module.") else k): v for k, v in sd.items()}


def reference_state_dict(src: Union[str, Mapping]) -> Dict[str, torch.Tensor]:
    """A reference ``model_{E}.pth`` (a path or the loaded dict) of a DiT,
    an origin-ADM UNet or EDM's DhariwalUNet (whose ``resample_filter``
    buffers the port's module holds too), ready for a strict
    ``load_state_dict``: the DDP ``module.`` prefix stripped and a DiT's
    fixed ``pos_embed`` dropped (lfm_tpu/nn/convert_dit.py:3-9,27)."""
    if isinstance(src, str):
        src = torch.load(src, map_location="cpu", weights_only=True)
    sd = strip_ddp_prefix(src)
    sd.pop("pos_embed", None)
    return {k: v.float() for k, v in sd.items()}


def reference_model_dict(model: nn.Module,
                         values: Optional[List[torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """The model's ``state_dict`` as the reference holds it: a DiT's fixed
    ``pos_embed`` first, then every parameter (or ``values`` in their place,
    such as the EMA weights), on the CPU."""
    sd = {}
    if isinstance(getattr(model, "pos_embed", None), torch.Tensor):
        sd["pos_embed"] = model.pos_embed.detach().cpu().clone()
    named = list(model.named_parameters())
    values = [p for _, p in named] if values is None else values
    for (name, _), v in zip(named, values):
        sd[name] = v.detach().cpu().clone()
    return sd


def _save(obj, path: str) -> None:
    """torch.save through a temporary name, so a killed save leaves the
    previous file whole."""
    tmp = f"{path}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def has_content(exp_path: str) -> bool:
    return os.path.isfile(os.path.join(exp_path, CONTENT))


def save_content(exp_path: str, model: nn.Module, state: TrainState, tx: AdamW, epoch: int,
                 config: Config, *, use_ema: bool = True) -> None:
    tc = config.train
    model_dict = reference_model_dict(model)
    index = {name: i for i, name in enumerate(model_dict)}
    opt_state = {}
    if use_ema and "pos_embed" in index:
        opt_state[index["pos_embed"]] = {"ema": model_dict["pos_embed"].clone()}
    step = torch.tensor(float(state.count))
    for name, m, v, e in zip(state.names, state.mu, state.nu, state.ema):
        s = {"step": step.clone(), "exp_avg": m.detach().cpu().clone(),
             "exp_avg_sq": v.detach().cpu().clone()}
        if use_ema:
            s["ema"] = e.detach().cpu().clone()
        opt_state[index[name]] = s
    lr = tx.lr(state.step)
    group = {"lr": lr, "betas": (tx.b1, tx.b2), "eps": tx.eps,
             "weight_decay": tx.weight_decay, "amsgrad": False, "maximize": False,
             "foreach": None, "capturable": False, "differentiable": False, "fused": None,
             "initial_lr": tc.lr, "params": list(range(len(model_dict)))}
    # torch's CosineAnnealingLR(optimizer, num_epoch, eta_min=lr_min), stepped per epoch
    scheduler = {"T_max": tc.num_epoch, "eta_min": tc.lr_min, "base_lrs": [tc.lr],
                 "last_epoch": epoch, "_step_count": epoch + 1, "_last_lr": [lr],
                 "_get_lr_called_within_step": False}
    content = {"epoch": epoch, "global_step": state.step, "args": dataclasses.asdict(config),
               "model_dict": model_dict,
               "optimizer": {"state": opt_state, "param_groups": [group]},
               "scheduler": scheduler}
    os.makedirs(exp_path, exist_ok=True)
    _save(content, os.path.join(exp_path, CONTENT))
    with open(os.path.join(exp_path, "config.json"), "w") as f:
        f.write(config.to_json())


def load_content(path: str) -> Dict:
    """A ``content.pth`` (the file, or the directory that holds it)."""
    if os.path.isdir(path):
        path = os.path.join(path, CONTENT)
    return torch.load(path, map_location="cpu", weights_only=False)


def restore_content(content: Union[str, Mapping], model: nn.Module, state: TrainState) -> int:
    """Load a ``content.pth`` (this package's or the reference's; a path as
    for ``load_content``, or the loaded dict) into ``model`` and ``state``
    in place; returns its epoch. Parameters without Adam state get zero
    moments; without EMA entries the EMA is a copy of the parameters
    (lfm_tpu/core/convert_optimizer.py::_state_dicts_from_optimizer)."""
    if isinstance(content, str):
        content = load_content(content)
    names = list(strip_ddp_prefix(content["model_dict"]))
    model.load_state_dict(reference_state_dict(content["model_dict"]))
    index = {name: i for i, name in enumerate(names)}
    opt = content["optimizer"]["state"]
    has_ema = any("ema" in s for s in opt.values())
    count = 0
    with torch.no_grad():
        for i, name in enumerate(state.names):
            s = opt.get(index[name], {})
            for dst, key in ((state.mu[i], "exp_avg"), (state.nu[i], "exp_avg_sq")):
                if key in s:
                    dst.copy_(s[key])
                else:
                    dst.zero_()
            state.ema[i].copy_(s["ema"] if has_ema and "ema" in s else state.params[i])
            if "step" in s:
                count = max(count, int(s["step"]))
    state.count = count
    state.step = int(content.get("global_step", count))
    return int(content.get("epoch", 0))


def save_model(exp_path: str, model: nn.Module, values: List[torch.Tensor], epoch: int) -> str:
    """``model_{epoch}.pth``: ``values`` (the EMA weights) under the
    reference's key names. Returns the path."""
    os.makedirs(exp_path, exist_ok=True)
    path = os.path.join(exp_path, f"model_{epoch}.pth")
    _save(reference_model_dict(model, values), path)
    return path
