"""Patchifying convolution; the part of tfimm_tpu/ops/conv.py that ViT uses.

``Conv2d`` here is a convolution with stride equal to its kernel and no
padding, on NHWC input. It cuts the image into non-overlapping patches and
multiplies them with the flattened OIHW weight, which is exactly the
convolution; the product goes through ``F.linear``, so it never meets
cuDNN's default TF32 convolutions.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from tfimm_tpu_torch.ops.basic import trunc_normal_

__all__ = ["Conv2d"]


class Conv2d(nn.Module):
    """Square ``kernel_size`` x ``kernel_size`` patches. Parameters:
    ``weight`` (out, in, k, k) and ``bias`` (out,).

    (B, H, W, C) -> (B, H // k, W // k, out); trailing rows and columns
    that do not fill a patch are dropped, as by a valid convolution.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, *,
                 weight_std: Optional[float] = None,
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
