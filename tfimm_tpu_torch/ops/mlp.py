"""Transformer MLP and its 1x1-conv form; mirror of ``MLP`` and ``ConvMLP``
in tfimm_tpu/ops/mlp.py."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from tfimm_tpu_torch.core import current_context
from tfimm_tpu_torch.ops.basic import Dense, act_layer_factory
from tfimm_tpu_torch.ops.conv import Conv2d
from tfimm_tpu_torch.ops.stochastic import dropout

__all__ = ["MLP", "ConvMLP"]


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


class ConvMLP(nn.Module):
    """MLP as 1x1 convs on NHWC maps (ConvNeXt's conv-MLP blocks).
    Parameters: fc1.weight (H, C, 1, 1), fc1.bias, fc2.*."""

    def __init__(self, in_features: int, hidden_features: int,
                 act_layer: str = "gelu", drop_rate: float = 0.0, *,
                 weight_std: Optional[float] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc1 = Conv2d(in_features, hidden_features, 1,
                          weight_std=weight_std, generator=generator)
        self.fc2 = Conv2d(hidden_features, in_features, 1,
                          weight_std=weight_std, generator=generator)
        self.act = act_layer_factory(act_layer)
        self.drop_rate = drop_rate

    forward = MLP.forward
