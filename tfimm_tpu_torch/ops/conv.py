"""Convolutions on NHWC input; the parts of tfimm_tpu/ops/conv.py that the
ported families use.

``Conv2d`` cuts the image into patches and multiplies them with the
flattened OIHW weight, which is exactly the convolution; the product goes
through ``F.linear``, so it never meets cuDNN's default TF32 convolutions.
By default its stride equals its kernel and it pads nothing (ViT's patch
embedding, ConvNeXt's stem and downsampling, 1x1 convs): the patches are a
reshape of the image. With another stride or a zero padding (SAM's 3x3
neck conv) they are gathered with ``unfold``.

``DepthwiseConv2d`` is ConvNeXt's 7x7 depthwise conv, computed by
``F.conv2d`` (the JAX package leaves it to XLA too). It runs on the
channels-last view of the NHWC tensor and returns the NHWC view of the
result, so neither side is copied; in f32 on the card its precision follows
``torch.backends.cudnn.allow_tf32``.

``ConvTranspose2d`` is SAM's mask-decoder upscaling, ``F.conv_transpose2d``
on the channels-first view (the JAX package's ``ConvTranspose2d`` in
``segment_anything/mask_decoder.py``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from tfimm_tpu_torch.ops.basic import trunc_normal_

__all__ = ["Conv2d", "DepthwiseConv2d", "ConvTranspose2d"]


class Conv2d(nn.Module):
    """Square ``kernel_size`` x ``kernel_size`` patches. Parameters:
    ``weight`` (out, in, k, k) and ``bias`` (out,), or no bias with
    ``use_bias=False``.

    (B, H, W, C) -> (B, (H + 2p - k) // s + 1, (W + 2p - k) // s + 1, out)
    for stride s (default k) and zero padding p on every side (default 0);
    trailing rows and columns that do not fill a patch are dropped, as by a
    valid convolution. ``zero_bias`` starts the bias at zero (ConvNeXt's
    stem and downsampling).
    """

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, *, stride: Optional[int] = None,
                 padding: int = 0, use_bias: bool = True,
                 weight_std: Optional[float] = None, zero_bias: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = kernel_size
        self.stride = kernel_size if stride is None else stride
        self.padding = padding
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel_size, kernel_size))
        self.bias = (nn.Parameter(torch.empty(out_channels)) if use_bias
                     else None)
        bound = 1.0 / math.sqrt(in_channels * kernel_size ** 2)
        with torch.no_grad():
            if weight_std is not None:
                trunc_normal_(self.weight, weight_std, generator)
            else:
                self.weight.uniform_(-bound, bound, generator=generator)
            if self.bias is not None:
                if zero_bias:
                    self.bias.zero_()
                else:
                    self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s, p = self.kernel_size, self.stride, self.padding
        if s == k and p == 0:
            b, h, w, c = x.shape
            gh, gw = h // k, w // k
            x = x[:, :gh * k, :gw * k]
            patches = (x.reshape(b, gh, k, gw, k, c)
                       .permute(0, 1, 3, 5, 2, 4)      # (B, gh, gw, C, kh, kw)
                       .reshape(b, gh, gw, c * k * k))
        else:
            if p:
                x = F.pad(x, (0, 0, p, p, p, p))
            patches = x.unfold(1, k, s).unfold(2, k, s)  # (B, gh, gw, C, kh, kw)
            patches = patches.reshape(*patches.shape[:3], -1)
        weight = self.weight.to(x.dtype).reshape(self.out_channels, -1)
        bias = self.bias.to(x.dtype) if self.bias is not None else None
        return F.linear(patches, weight, bias)


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


class ConvTranspose2d(nn.Module):
    """Transposed conv on NHWC maps, no padding. Parameters: ``weight``
    (in, out, k, k), PyTorch's ``nn.ConvTranspose2d`` layout, and ``bias``.

    The JAX package keeps its kernel as (k, k, in, out) in PyTorch's tap
    order and flips it only to make ``lax.conv_transpose`` compute what
    ``F.conv_transpose2d`` computes; here that kernel is taken as
    ``transpose(2, 3, 0, 1)``, with no flip (``utils/convert.py``). In f32
    on the card its precision follows ``torch.backends.cudnn.allow_tf32``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(
            torch.empty(in_channels, out_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels))
        bound = 1.0 / math.sqrt(in_channels * kernel_size ** 2)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype),
                               self.bias.to(x.dtype), stride=self.stride)
        return y.permute(0, 2, 3, 1)
