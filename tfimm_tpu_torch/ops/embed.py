"""Patch embedding; mirror of ``PatchEmbeddings`` in tfimm_tpu/ops/embed.py.

Position-embedding interpolation is not ported yet (ROADMAP.md): the JAX
package resizes with ``jax.image.resize`` bicubic (Keys a = -0.5,
antialiased), which ``F.interpolate`` bicubic (a = -0.75) does not match.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from tfimm_tpu_torch.ops.conv import Conv2d

__all__ = ["PatchEmbeddings"]


class PatchEmbeddings(nn.Module):
    """Conv patchify: (B, H, W, C) -> (B, N, D) tokens and the grid shape."""

    def __init__(self, patch_size: int, embed_dim: int, in_channels: int = 3,
                 *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.proj = Conv2d(in_channels, embed_dim, patch_size,
                           weight_std=0.02, generator=generator)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, int]]:
        x = self.proj(x)
        grid = (x.shape[1], x.shape[2])
        return x.reshape(x.shape[0], grid[0] * grid[1], x.shape[-1]), grid
