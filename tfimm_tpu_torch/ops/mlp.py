"""Transformer MLP, its 1x1-conv form and the gated MLPs of the Mixer
family; mirror of tfimm_tpu/ops/mlp.py."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from tfimm_tpu_torch.core import current_context
from tfimm_tpu_torch.ops.basic import Dense, act_layer_factory
from tfimm_tpu_torch.ops.conv import Conv2d
from tfimm_tpu_torch.ops.norm import LayerNorm
from tfimm_tpu_torch.ops.stochastic import dropout

__all__ = ["MLP", "ConvMLP", "GluMLP", "SpatialGatingUnit", "GatedMLP"]


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


class GluMLP(nn.Module):
    """MLP with a GLU on the hidden units: fc1's output split in half, the
    first half times the activation of the second (gMixer). Parameters:
    fc1.* (hidden, in), fc2.* (out, hidden / 2)."""

    def __init__(self, in_features: int, hidden_features: int,
                 act_layer: str = "sigmoid", drop_rate: float = 0.0, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        assert hidden_features % 2 == 0
        self.fc1 = Dense(in_features, hidden_features, generator=generator)
        self.fc2 = Dense(hidden_features // 2, in_features,
                         generator=generator)
        self.act = act_layer_factory(act_layer)
        self.drop_rate = drop_rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ctx = current_context()
        x, gates = self.fc1(x).chunk(2, dim=-1)
        x = x * self.act(gates)
        x = dropout(x, self.drop_rate, ctx.training, ctx.generator)
        x = self.fc2(x)
        return dropout(x, self.drop_rate, ctx.training, ctx.generator)


class SpatialGatingUnit(nn.Module):
    """gMLP's spatial gating of (B, N, C) tokens: the channels split in
    half, the second half normalised (LayerNorm, eps 1e-5) and mixed across
    the N tokens by ``proj`` (``F.linear`` over the transposed tokens), then
    times the first. ``proj`` starts near zero (truncated normal, std 1e-6)
    with its bias at one, so that the unit starts as the identity gate."""

    def __init__(self, dim: int, seq_len: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.norm = LayerNorm(dim // 2, eps=1e-5)
        self.proj = Dense(seq_len, seq_len, weight_std=1e-6,
                          generator=generator)
        with torch.no_grad():
            self.proj.bias.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        u, v = x.chunk(2, dim=-1)
        v = self.proj(self.norm(v).transpose(-1, -2)).transpose(-1, -2)
        return u * v


class GatedMLP(nn.Module):
    """gMLP's channel MLP: fc1 -> act -> drop -> spatial gating -> fc2 ->
    drop. Parameters: fc1.*, gate.norm.*, gate.proj.*, fc2.*."""

    def __init__(self, in_features: int, hidden_features: int, seq_len: int,
                 act_layer: str = "gelu", drop_rate: float = 0.0, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc1 = Dense(in_features, hidden_features, generator=generator)
        self.gate = SpatialGatingUnit(hidden_features, seq_len,
                                      generator=generator)
        self.fc2 = Dense(hidden_features // 2, in_features,
                         generator=generator)
        self.act = act_layer_factory(act_layer)
        self.drop_rate = drop_rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ctx = current_context()
        x = self.act(self.fc1(x))
        x = dropout(x, self.drop_rate, ctx.training, ctx.generator)
        x = self.fc2(self.gate(x))
        return dropout(x, self.drop_rate, ctx.training, ctx.generator)
