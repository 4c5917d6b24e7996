"""Classifier head; mirror of tfimm_tpu/ops/classifier.py."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from tfimm_tpu_torch.core import current_context
from tfimm_tpu_torch.ops.basic import Dense
from tfimm_tpu_torch.ops.stochastic import dropout

__all__ = ["ClassifierHead", "global_pool_2d"]


def global_pool_2d(x: torch.Tensor, pool_type: str = "avg") -> torch.Tensor:
    """Pool (B, H, W, C) -> (B, C), or pass token input (B, C) through."""
    if x.dim() == 2 or pool_type == "":
        return x
    if pool_type == "avg":
        return x.mean(dim=(1, 2))
    if pool_type == "max":
        return x.amax(dim=(1, 2))
    raise ValueError(f"Unknown pool type: {pool_type}")


class ClassifierHead(nn.Module):
    """Global pool -> dropout -> Dense (``fc``). ``nb_classes == 0`` gives
    the pooled features."""

    def __init__(self, nb_classes: int, in_features: int,
                 pool_type: str = "avg", drop_rate: float = 0.0, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.pool_type = pool_type
        self.drop_rate = drop_rate
        self.fc = (Dense(in_features, nb_classes, generator=generator)
                   if nb_classes > 0 else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ctx = current_context()
        x = global_pool_2d(x, self.pool_type)
        x = dropout(x, self.drop_rate, ctx.training, ctx.generator)
        return self.fc(x) if self.fc is not None else x
