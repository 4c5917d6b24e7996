"""Transformer MLP; mirror of ``MLP`` in tfimm_tpu/ops/mlp.py."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from tfimm_tpu_torch.core import current_context
from tfimm_tpu_torch.ops.basic import Dense, act_layer_factory
from tfimm_tpu_torch.ops.stochastic import dropout

__all__ = ["MLP"]


class MLP(nn.Module):
    """fc1 -> act -> drop -> fc2 -> drop. Parameters: fc1.*, fc2.*."""

    def __init__(self, in_features: int, hidden_features: int,
                 act_layer: str = "gelu", drop_rate: float = 0.0, *,
                 weight_std: Optional[float] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc1 = Dense(in_features, hidden_features, weight_std=weight_std,
                         generator=generator)
        self.fc2 = Dense(hidden_features, in_features, weight_std=weight_std,
                         generator=generator)
        self.act = act_layer_factory(act_layer)
        self.drop_rate = drop_rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ctx = current_context()
        x = self.act(self.fc1(x))
        x = dropout(x, self.drop_rate, ctx.training, ctx.generator)
        x = self.fc2(x)
        return dropout(x, self.drop_rate, ctx.training, ctx.generator)
