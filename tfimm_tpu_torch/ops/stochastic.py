"""Dropout and DropPath (stochastic depth); mirror of tfimm_tpu/ops/stochastic.py.

Both are the identity at inference or when ``rate == 0``. In training they
draw their masks from an explicit ``torch.Generator``; there is no hidden
global stream.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["dropout", "drop_path"]


def _keep_mask(shape, keep: float, like: torch.Tensor,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    if generator is None:
        raise ValueError(
            "A stochastic layer (dropout / drop_path) ran in training mode "
            "but no generator was supplied. Pass generator= to the model.")
    u = torch.rand(shape, generator=generator, device=generator.device)
    return (u < keep).to(device=like.device)


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = _keep_mask(x.shape, keep, x, generator)
    return torch.where(mask, x / keep, torch.zeros_like(x))


def drop_path(x: torch.Tensor, rate: float, training: bool,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Per-sample residual-branch drop, rescaled by the keep probability."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    mask = _keep_mask(shape, keep, x, generator)
    return torch.where(mask, x / keep, torch.zeros_like(x))
