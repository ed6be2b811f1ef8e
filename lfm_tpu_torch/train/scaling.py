"""Dynamic loss scaling (port of lfm_tpu/train/scaling.py).

The reference's vendored ADM MixedPrecisionTrainer grows the loss scale
after clean steps and backs it off on overflow (reference
models/guided_diffusion/fp16_util.py:139-221). bf16 training needs none of
it; it exists for fp16 experiments. ``dynamic_loss_scale`` wraps the
optimizer update of train/state.py (``make_fused_adamw_ema``), as the JAX
package's wraps an optax transform. Neither package wires it into an entry
point.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from lfm_tpu_torch.train.state import TrainState


class LossScaleState(NamedTuple):
    scale: float  # the current loss scale, an f32 value
    growth_counter: int  # clean steps since the scale last changed


def dynamic_loss_scale(
    update: Callable[[TrainState, List[torch.Tensor]], torch.Tensor],
    init_scale: float = 2.0 ** 20,  # fp16_util INITIAL_LOG_LOSS_SCALE = 20
    growth_interval: int = 2000,
    growth_factor: float = 2.0,
    backoff_factor: float = 0.5,  # fp16_util: lg_loss_scale -= 1
) -> Tuple[Callable[[], LossScaleState], Callable]:
    """Returns ``(init, scaled_update)``. ``scaled_update(state, ls, grads)
    -> (ls, grad_norm or None)`` takes gradients pre-multiplied by
    ``ls.scale`` (the loss scaled before backward) and divides them by it.
    If every one is finite it runs ``update`` on them and counts a clean
    step; ``growth_interval`` clean steps multiply the scale by
    ``growth_factor`` and reset the count. Otherwise it skips the step,
    leaving the parameters and the optimizer's state as they were (the
    norm is None), multiplies the scale by ``backoff_factor`` and resets
    the count. The finiteness check waits for the card."""

    def init() -> LossScaleState:
        return LossScaleState(scale=float(np.float32(init_scale)), growth_counter=0)

    def scaled_update(state: TrainState, ls: LossScaleState,
                      grads: List[torch.Tensor]) -> Tuple[LossScaleState, Optional[torch.Tensor]]:
        scale = np.float32(ls.scale)
        unscaled = [g.float() / float(scale) for g in grads]
        finite = bool(torch.stack([torch.isfinite(g).all() for g in unscaled]).all())
        if not finite:
            return LossScaleState(float(scale * np.float32(backoff_factor)), 0), None
        gnorm = update(state, unscaled)
        counter = ls.growth_counter + 1
        if counter >= growth_interval:
            return LossScaleState(float(scale * np.float32(growth_factor)), 0), gnorm
        return LossScaleState(float(scale), counter), gnorm

    return init, scaled_update
