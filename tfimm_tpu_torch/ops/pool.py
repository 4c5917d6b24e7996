"""Average pools on NHWC maps; the parts of tfimm_tpu/ops/pool.py that the
ported families use (PoolFormer's token mixer, PVTv2's linear spatial
reduction). ``BlurPool2d`` and ``max_pool_2d`` come with the families that
use them (ROADMAP.md, queue A, A8).
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F

__all__ = ["avg_pool_2d_exclude_pad", "adaptive_avg_pool_2d"]


def _same_pads(size: int, window: int, stride: int) -> Tuple[int, int]:
    """XLA's "SAME" padding of one axis: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


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
