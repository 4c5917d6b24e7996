"""SAM prompt encoder; mirror of
tfimm_tpu/architectures/segment_anything/prompt_encoder.py.

Encodes point, box and mask prompts into sparse and dense embeddings. The
prompt counts follow from the shapes of the inputs, as in the JAX package.
No kernel runs here in either package.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from tfimm_tpu_torch.architectures.segment_anything.common import Embedding
from tfimm_tpu_torch.ops.basic import act_layer_factory
from tfimm_tpu_torch.ops.conv import Conv2d
from tfimm_tpu_torch.ops.norm import norm_layer_factory

__all__ = ["PromptEncoder", "PositionalEmbeddingRandom", "MaskDownscaling"]


class PositionalEmbeddingRandom(nn.Module):
    """Fourier positional embedding with random, frozen spatial frequencies.
    The (2, D / 2) matrix is a buffer, ``positional_encoding_gaussian_matrix``,
    which the state dict carries."""

    def __init__(self, embed_dim: int, scale: float = 1.0, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embed_dim = embed_dim
        self.register_buffer(
            "positional_encoding_gaussian_matrix",
            scale * torch.randn(2, embed_dim // 2, generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Embed points normalised to [0, 1]: (..., 2) -> (..., D), in f32."""
        mat = self.positional_encoding_gaussian_matrix.float()
        x = 2 * x - 1
        x = (2 * math.pi) * torch.matmul(x.float(), mat)
        return torch.cat([torch.sin(x), torch.cos(x)], dim=-1)

    def embed_grid(self, size: Tuple[int, int]) -> torch.Tensor:
        h, w = size
        device = self.positional_encoding_gaussian_matrix.device
        ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
        grid = torch.stack(torch.meshgrid(xs, ys, indexing="xy"), dim=-1)
        return self(grid)                                      # (h, w, D)

    def embed_points(self, points: torch.Tensor,
                     image_size: Tuple[int, int]) -> torch.Tensor:
        x = points[..., 0] / image_size[1]
        y = points[..., 1] / image_size[0]
        return self(torch.stack([x, y], dim=-1))


class MaskDownscaling(nn.Module):
    """4x downscale conv stack embedding mask prompts. Parameters keep Meta's
    sequential names: 0 (2x2 conv), 1 (LayerNorm), 3 (2x2 conv),
    4 (LayerNorm), 6 (1x1 conv)."""

    def __init__(self, embed_dim: int, mask_hidden_dim: int, act_layer: str, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        norm = norm_layer_factory("layer_norm_eps_1e-6")
        self.act = act_layer_factory(act_layer)
        self.add_module("0", Conv2d(1, mask_hidden_dim // 4, 2, generator=g))
        self.add_module("1", norm(mask_hidden_dim // 4))
        self.add_module("3", Conv2d(mask_hidden_dim // 4, mask_hidden_dim, 2,
                                    generator=g))
        self.add_module("4", norm(mask_hidden_dim))
        self.add_module("6", Conv2d(mask_hidden_dim, embed_dim, 1, generator=g))

    def forward(self, masks: torch.Tensor) -> torch.Tensor:
        """(N, M, H, W) masks -> (N, H / 4, W / 4, D), summed over M."""
        layer = self._modules
        n, m, h, w = masks.shape
        x = masks.reshape(n * m, h, w, 1)
        x = self.act(layer["1"](layer["0"](x)))
        x = self.act(layer["4"](layer["3"](x)))
        x = layer["6"](x)
        _, hh, ww, d = x.shape
        return x.reshape(n, m, hh, ww, d).sum(dim=1)


class PromptEncoder(nn.Module):
    """Parameters: pe_layer.positional_encoding_gaussian_matrix,
    point_embeddings.{0-3}.weight (1, D; negative and positive points, the
    two box corners), not_a_point_embed.weight, no_mask_embed.weight,
    mask_downscaling.*."""

    def __init__(self, embed_dim: int, mask_hidden_dim: int,
                 act_layer: str = "gelu", *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.embed_dim = embed_dim
        self.pe_layer = PositionalEmbeddingRandom(embed_dim, generator=g)
        self.point_embeddings = nn.ModuleList(
            Embedding(1, embed_dim, g) for _ in range(4))
        self.not_a_point_embed = Embedding(1, embed_dim, g)
        self.no_mask_embed = Embedding(1, embed_dim, g)
        self.mask_downscaling = MaskDownscaling(embed_dim, mask_hidden_dim,
                                                act_layer, generator=g)

    def _embed_points(self, points, labels, input_size):
        points = points + 0.5  # shift to pixel centres
        emb = self.pe_layer.embed_points(points, input_size)
        return emb + torch.where(labels[..., None] == 0,
                                 self.point_embeddings[0].weight,
                                 self.point_embeddings[1].weight)

    def _embed_boxes(self, boxes, input_size):
        n, m, _ = boxes.shape
        corners = (boxes + 0.5).reshape(n * m, 2, 2)
        emb = self.pe_layer.embed_points(corners, input_size)
        corner_emb = torch.stack([self.point_embeddings[2].weight[0],
                                  self.point_embeddings[3].weight[0]], dim=0)
        return (emb + corner_emb[None]).reshape(n, 2 * m, self.embed_dim)

    def forward(self, inputs: Dict[str, torch.Tensor]):
        """``inputs``: points (N, M1, 2), labels (N, M1), boxes (N, M2, 4),
        masks (N, M3, H, W). Returns (sparse embeddings (N, M, D), dense
        embeddings (N, H / 4, W / 4, D))."""
        points, labels = inputs["points"], inputs["labels"]
        boxes, masks = inputs["boxes"], inputs["masks"]
        n = points.shape[0]
        h, w = masks.shape[2], masks.shape[3]
        input_size = (4 * h, 4 * w)

        point_emb = self._embed_points(points, labels, input_size)
        parts = [point_emb]
        if points.shape[1] > 0 and boxes.shape[1] == 0:
            pad = self.not_a_point_embed.weight[None].expand(n, 1,
                                                            self.embed_dim)
            parts.append(pad.to(point_emb.dtype))
        parts.append(self._embed_boxes(boxes, input_size))
        sparse = torch.cat(parts, dim=1)

        if masks.shape[1] == 0:
            dense = self.no_mask_embed.weight.reshape(1, 1, 1, -1).expand(
                n, h // 4, w // 4, self.embed_dim)
        else:
            dense = self.mask_downscaling(masks)
        return sparse, dense

    def get_dense_pe(self, grid_size: Tuple[int, int]) -> torch.Tensor:
        return self.pe_layer.embed_grid(grid_size)
