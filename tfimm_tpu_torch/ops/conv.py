"""Convolutions on NHWC input; the parts of tfimm_tpu/ops/conv.py that the
ported families use.

``Conv2d`` here is a convolution with stride equal to its kernel and no
padding (ViT's patch embedding, ConvNeXt's stem and downsampling, 1x1
convs). It cuts the image into non-overlapping patches and multiplies them
with the flattened OIHW weight, which is exactly the convolution; the
product goes through ``F.linear``, so it never meets cuDNN's default TF32
convolutions.

``DepthwiseConv2d`` is ConvNeXt's 7x7 depthwise conv, computed by
``F.conv2d`` (the JAX package leaves it to XLA too). It runs on the
channels-last view of the NHWC tensor and returns the NHWC view of the
result, so neither side is copied; in f32 on the card its precision follows
``torch.backends.cudnn.allow_tf32``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from tfimm_tpu_torch.ops.basic import trunc_normal_

__all__ = ["Conv2d", "DepthwiseConv2d"]


class Conv2d(nn.Module):
    """Square ``kernel_size`` x ``kernel_size`` patches. Parameters:
    ``weight`` (out, in, k, k) and ``bias`` (out,).

    (B, H, W, C) -> (B, H // k, W // k, out); trailing rows and columns
    that do not fill a patch are dropped, as by a valid convolution.
    ``zero_bias`` starts the bias at zero (ConvNeXt's stem and downsampling).
    """

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, *,
                 weight_std: Optional[float] = None, zero_bias: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = kernel_size
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels))
        bound = 1.0 / math.sqrt(in_channels * kernel_size ** 2)
        with torch.no_grad():
            if weight_std is not None:
                trunc_normal_(self.weight, weight_std, generator)
            else:
                self.weight.uniform_(-bound, bound, generator=generator)
            if zero_bias:
                self.bias.zero_()
            else:
                self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        kh = kw = self.kernel_size
        gh, gw = h // kh, w // kw
        x = x[:, :gh * kh, :gw * kw]
        patches = (x.reshape(b, gh, kh, gw, kw, c)
                   .permute(0, 1, 3, 5, 2, 4)          # (B, gh, gw, C, kh, kw)
                   .reshape(b, gh, gw, c * kh * kw))
        weight = self.weight.to(x.dtype).reshape(self.out_channels, -1)
        return F.linear(patches, weight, self.bias.to(x.dtype))


class DepthwiseConv2d(nn.Module):
    """Depthwise ``kernel_size`` x ``kernel_size`` conv, stride 1, "same"
    padding, one filter per channel. Parameters: ``weight`` (C, 1, k, k),
    initialised as ConvNeXt does (truncated normal, std 0.02), and ``bias``
    (C,), zero. (B, H, W, C) -> (B, H, W, C)."""

    def __init__(self, channels: int, kernel_size: int = 7, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.channels = channels
        self.padding = kernel_size // 2
        self.weight = nn.Parameter(
            torch.empty(channels, 1, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(channels))
        with torch.no_grad():
            trunc_normal_(self.weight, 0.02, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype),
                     self.bias.to(x.dtype), padding=self.padding,
                     groups=self.channels)
        return y.permute(0, 2, 3, 1)
