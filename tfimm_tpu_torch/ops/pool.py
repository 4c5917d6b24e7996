"""Pools on NHWC maps; mirror of tfimm_tpu/ops/pool.py: PoolFormer's token
mixer, PVTv2's linear spatial reduction, ResNet's blur pool and average
downsampling, VGG's max pool.

``padding`` is "VALID" or XLA's "SAME" (the larger pad after), as in the
JAX functions. ``avg_pool_2d`` divides its window sums by the window's
area with the pads counted, as the JAX function does (PyTorch's
``count_include_pad=False`` would not); ``max_pool_2d`` pads with -inf.
"""

from __future__ import annotations

import math

from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from tfimm_tpu_torch.ops.conv import same_pads as _same_pads

__all__ = ["BlurPool2d", "avg_pool_2d", "max_pool_2d",
           "avg_pool_2d_exclude_pad", "adaptive_avg_pool_2d"]


class BlurPool2d(nn.Module):
    """Anti-aliased downsampling: a fixed binomial blur as a depthwise conv
    after reflect padding, at ``stride``. The kernel is a non-persistent
    buffer, no state-dict key (the JAX model lists ``blur_kernel`` among
    the keys it may miss on load)."""

    def __init__(self, channels: int, filter_size: int = 3, stride: int = 2):
        super().__init__()
        self.channels = channels
        self.stride = stride
        coeffs = np.poly1d((0.5, 0.5)) ** (filter_size - 1)
        blur_1d = np.asarray(coeffs.coeffs, dtype=np.float32)
        kernel = torch.from_numpy(np.outer(blur_1d, blur_1d))
        self.register_buffer(
            "blur_kernel",
            kernel[None, None].repeat(channels, 1, 1, 1), persistent=False)
        lo = (filter_size - 1) // 2
        self.pad = (lo, lo + (filter_size - 1) % 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.pad(x.permute(0, 3, 1, 2), self.pad * 2, mode="reflect")
        y = F.conv2d(x, self.blur_kernel.to(x.dtype), stride=self.stride,
                     groups=self.channels)
        return y.permute(0, 2, 3, 1).contiguous()


def _padded(x: torch.Tensor, window: int, stride: int, padding: str,
            value: float) -> torch.Tensor:
    """The NCHW view of (B, H, W, C) ``x``, padded with ``value`` as
    ``padding`` ("VALID" or "SAME") asks."""
    x = x.permute(0, 3, 1, 2)
    if padding.upper() == "SAME":
        h, w = x.shape[2:]
        pads = (_same_pads(h, window, stride), _same_pads(w, window, stride))
        x = F.pad(x, (*pads[1], *pads[0]), value=value)
    elif padding.upper() != "VALID":
        raise ValueError(f"Unknown padding: {padding}")
    return x


def avg_pool_2d(x: torch.Tensor, window: int, stride: Optional[int] = None,
                padding: str = "VALID") -> torch.Tensor:
    """Average pool of (B, H, W, C): zero-padded window sums over
    ``window`` squared."""
    stride = stride or window
    y = F.avg_pool2d(_padded(x, window, stride, padding, 0.0), window, stride)
    return y.permute(0, 2, 3, 1)


def max_pool_2d(x: torch.Tensor, window: int, stride: Optional[int] = None,
                padding: str = "VALID") -> torch.Tensor:
    """Max pool of (B, H, W, C), padded with -inf."""
    stride = stride or window
    y = F.max_pool2d(_padded(x, window, stride, padding, -math.inf), window,
                     stride)
    return y.permute(0, 2, 3, 1)


def _window_sum(x: torch.Tensor, window: int, stride: int, pads) -> torch.Tensor:
    """Sums over the zero-padded windows of an NCHW tensor."""
    x = F.pad(x, (*pads[1], *pads[0]))
    return F.avg_pool2d(x, window, stride, divisor_override=1)


def avg_pool_2d_exclude_pad(x: torch.Tensor, window: int,
                            stride: int = 1) -> torch.Tensor:
    """SAME average pool of (B, H, W, C) whose divisor counts only the
    in-bounds taps (PyTorch's ``count_include_pad=False``), as the JAX
    function divides its window sums by the window sums of ones."""
    h, w = x.shape[1:3]
    pads = (_same_pads(h, window, stride), _same_pads(w, window, stride))
    summed = _window_sum(x.permute(0, 3, 1, 2), window, stride, pads)
    ones = torch.ones((1, 1, h, w), dtype=x.dtype, device=x.device)
    counts = _window_sum(ones, window, stride, pads)
    return (summed / counts).permute(0, 2, 3, 1)


def adaptive_avg_pool_2d(x: torch.Tensor,
                         output_size: Union[int, Tuple[int, int]]) -> torch.Tensor:
    """``nn.AdaptiveAvgPool2d`` on (B, H, W, C): output bin i averages input
    rows [floor(i H / out), ceil((i + 1) H / out)), and likewise columns."""
    y = F.adaptive_avg_pool2d(x.permute(0, 3, 1, 2), output_size)
    return y.permute(0, 2, 3, 1)
