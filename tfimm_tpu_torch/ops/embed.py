"""Patch embedding and position-embedding interpolation; mirror of
tfimm_tpu/ops/embed.py. The interpolation resizes with ``ops/resize.py ·
resize_cubic``, the port's copy of ``jax.image.resize`` bicubic (Keys
a = -0.5, antialiased), which ``F.interpolate`` bicubic (a = -0.75) does
not match.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from tfimm_tpu_torch.ops.conv import Conv2d
from tfimm_tpu_torch.ops.norm import norm_layer_factory
from tfimm_tpu_torch.ops.resize import resize_cubic

__all__ = ["PatchEmbeddings", "interpolate_pos_embeddings",
           "interpolate_pos_embeddings_grid"]


class PatchEmbeddings(nn.Module):
    """Conv patchify: (B, H, W, C) -> (B, N, D) tokens and the grid shape,
    or with ``flatten=False`` the (B, gh, gw, D) map (PoolFormer). The conv
    takes ``stride`` (default: the patch size) and a zero ``padding`` on
    every side, overlapping patches for PVTv2 and PoolFormer. An optional
    norm follows (Swin's ``patch_norm``, PVT's; its parameters are
    ``norm.*``)."""

    def __init__(self, patch_size: int, embed_dim: int, in_channels: int = 3,
                 norm_layer: Optional[str] = None, *,
                 stride: Optional[int] = None, padding: int = 0,
                 flatten: bool = True, use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.flatten = flatten
        self.proj = Conv2d(in_channels, embed_dim, patch_size, stride=stride,
                           padding=padding, use_bias=use_bias,
                           weight_std=0.02, generator=generator)
        self.norm = (norm_layer_factory(norm_layer)(embed_dim) if norm_layer
                     else None)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, int]]:
        x = self.proj(x)
        grid = (x.shape[1], x.shape[2])
        if self.flatten:
            x = x.reshape(x.shape[0], grid[0] * grid[1], x.shape[-1])
        if self.norm is not None:
            x = self.norm(x)
        return x, grid


def interpolate_pos_embeddings_grid(pos_embed: torch.Tensor,
                                    src_grid: Tuple[int, int],
                                    dst_grid: Tuple[int, int]) -> torch.Tensor:
    """Bicubic resize of a (1, H * W, D) or (H, W, D) grid of position
    embeddings to (1, H' * W', D), in float32, cast back to the table's
    dtype."""
    d = pos_embed.shape[-1]
    grid = pos_embed.reshape(src_grid[0], src_grid[1], d).float()
    grid = resize_cubic(grid, (dst_grid[0], dst_grid[1], d))
    return grid.reshape(1, dst_grid[0] * dst_grid[1], d).to(pos_embed.dtype)


def interpolate_pos_embeddings(pos_embed: torch.Tensor,
                               src_grid: Tuple[int, int],
                               dst_grid: Tuple[int, int],
                               nb_tokens: int = 1) -> torch.Tensor:
    """Interpolate token-layout position embeddings (1, nb_tokens + H * W,
    D), keeping the leading class and distillation tokens fixed."""
    tokens = pos_embed[:, :nb_tokens]
    grid = interpolate_pos_embeddings_grid(pos_embed[:, nb_tokens:],
                                           src_grid, dst_grid)
    return torch.cat([tokens, grid], dim=1)
