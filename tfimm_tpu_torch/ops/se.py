"""Channel attention: squeeze-excite and ECA; mirror of tfimm_tpu/ops/se.py."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from tfimm_tpu_torch.ops.basic import act_layer_factory
from tfimm_tpu_torch.ops.conv import Conv1d, Conv2d
from tfimm_tpu_torch.utils.etc import make_divisible

__all__ = ["SEModule", "EcaModule", "attn_layer_factory"]


class SEModule(nn.Module):
    """Squeeze-and-excitation of (B, H, W, C) maps: the spatial mean
    through two 1x1 convs (``fc1``, ``fc2``), the gate times x. The reduced
    width is rounded to ``rd_divisor``."""

    def __init__(self, in_channels: int, rd_ratio: float = 1.0 / 16,
                 rd_channels: Optional[int] = None, rd_divisor: int = 8,
                 act_layer: str = "relu", gate_layer: str = "sigmoid",
                 mlp_bias: bool = True, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if rd_channels is None:
            rd_channels = make_divisible(in_channels * rd_ratio, rd_divisor,
                                         round_limit=0.0)
        self.fc1 = Conv2d(in_channels, rd_channels, 1, use_bias=mlp_bias,
                          generator=generator)
        self.fc2 = Conv2d(rd_channels, in_channels, 1, use_bias=mlp_bias,
                          generator=generator)
        self.act = act_layer_factory(act_layer)
        self.gate = act_layer_factory(gate_layer)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(1, 2), keepdim=True)
        s = self.fc2(self.act(self.fc1(s)))
        return x * self.gate(s)


class EcaModule(nn.Module):
    """Efficient channel attention: the spatial mean of (B, H, W, C) maps,
    a 1-D conv across channels (``conv``, no bias, kernel size from
    log2 C unless given), the gate times x."""

    def __init__(self, in_channels: int, kernel_size: Optional[int] = None,
                 gamma: int = 2, beta: int = 1, gate_layer: str = "sigmoid",
                 *, generator: Optional[torch.Generator] = None):
        super().__init__()
        if kernel_size is None:
            t = int(abs(math.log(in_channels, 2) + beta) / gamma)
            kernel_size = max(t if t % 2 else t + 1, 3)
        assert kernel_size % 2 == 1
        self.conv = Conv1d(1, 1, kernel_size, padding=(kernel_size - 1) // 2,
                           generator=generator)
        self.gate = act_layer_factory(gate_layer)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(1, 2))[:, None, :]    # (B, 1, C)
        s = self.gate(self.conv(s)[:, 0])     # (B, C)
        return x * s[:, None, None, :]


def attn_layer_factory(attn_layer: str):
    """String -> channel-attention constructor taking the channel count (or
    None for ``""``)."""
    if attn_layer == "":
        return lambda channels, **kw: None
    if attn_layer == "se":
        return lambda channels, **kw: SEModule(channels, **kw)
    if attn_layer == "eca":
        return lambda channels, **kw: EcaModule(channels, **kw)
    raise ValueError(f"Unknown attention layer: {attn_layer}")
