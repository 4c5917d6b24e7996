"""PiT, the Pooling-based Vision Transformer; mirror of
tfimm_tpu/architectures/pit.py.

Stages of ViT blocks (``vit.py · ViTBlock``, whose attention takes
``fused_mha`` below 1024 tokens and ``flash_attention`` from there), with
token pooling between them: a grouped strided conv on the token grid and a
Dense on the class (and distillation) tokens. The position embedding is
kept in timm's (1, C, H, W) layout. Parameter names are timm's
(``patch_embed.conv``, ``transformers.{j}.blocks.{k}``,
``transformers.{j}.pool.conv``); the pool between stages j and j + 1 sits
in stage j + 1, as in timm. Distilled variants return (B, 2, classes).

Paper: Rethinking Spatial Dimensions of ViTs, https://arxiv.org/abs/2103.16302.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from tfimm_tpu_torch.architectures.vit import ViTBlock
from tfimm_tpu_torch.core import capture_feature, current_context
from tfimm_tpu_torch.models.base import Model
from tfimm_tpu_torch.models.config import ModelConfig
from tfimm_tpu_torch.models.registry import register_model
from tfimm_tpu_torch.ops.basic import Dense, trunc_normal_
from tfimm_tpu_torch.ops.conv import Conv2d
from tfimm_tpu_torch.ops.embed import interpolate_pos_embeddings_grid
from tfimm_tpu_torch.ops.norm import norm_layer_factory
from tfimm_tpu_torch.ops.stochastic import dropout
from tfimm_tpu_torch.utils.constants import (
    IMAGENET_DEFAULT_MEAN,
    IMAGENET_DEFAULT_STD,
)

__all__ = ["PoolingVisionTransformer", "PoolingVisionTransformerConfig"]


@dataclass
class PoolingVisionTransformerConfig(ModelConfig):
    nb_classes: int = 1000
    in_channels: int = 3
    input_size: Tuple[int, int] = (224, 224)
    patch_size: int = 16
    stride: int = 8
    embed_dim: Tuple = (64, 128, 256)
    nb_blocks: Tuple = (2, 6, 4)
    nb_heads: Tuple = (2, 4, 8)
    mlp_ratio: float = 4.0
    distilled: bool = False
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.0
    norm_layer: str = "layer_norm_eps_1e-6"
    act_layer: str = "gelu"
    interpolate_input: bool = False
    crop_pct: float = 0.9
    interpolation: str = "bicubic"
    mean: Tuple[float, float, float] = IMAGENET_DEFAULT_MEAN
    std: Tuple[float, float, float] = IMAGENET_DEFAULT_STD
    first_conv: str = "patch_embed.conv"
    classifier: Union[str, Tuple[str, str]] = "head"

    @property
    def nb_tokens(self) -> int:
        return 2 if self.distilled else 1

    @property
    def grid_size(self) -> Tuple[int, int]:
        return ((self.input_size[0] - self.patch_size) // self.stride + 1,
                (self.input_size[1] - self.patch_size) // self.stride + 1)

    @property
    def transform_weights(self):
        return {"pos_embed": PoolingVisionTransformer.transform_pos_embed}


class ConvHeadPooling(nn.Module):
    """Downsampling of the token grid by a grouped conv (``stride + 1``
    taps, ``stride // 2`` zero padding, one group an input channel); the
    class tokens go through a Dense."""

    def __init__(self, nb_tokens: int, in_channels: int, out_channels: int,
                 stride: int, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.nb_tokens = nb_tokens
        self.conv = Conv2d(in_channels, out_channels, stride + 1,
                           stride=stride, padding=stride // 2,
                           groups=in_channels, generator=generator)
        self.fc = Dense(in_channels, out_channels, generator=generator)

    def forward(self, x: torch.Tensor, grid: Tuple[int, int]
                ) -> Tuple[torch.Tensor, Tuple[int, int]]:
        b, _, c = x.shape
        tokens = self.fc(x[:, :self.nb_tokens])
        y = self.conv(x[:, self.nb_tokens:].reshape(b, *grid, c))
        grid = (y.shape[1], y.shape[2])
        y = y.reshape(b, grid[0] * grid[1], y.shape[-1])
        return torch.cat([tokens, y], dim=1), grid


class _Stage(nn.Module):
    """timm's ``Transformer``: the pool into this stage (none in the first)
    and its blocks."""

    def __init__(self, blocks, pool: Optional[ConvHeadPooling]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.pool = pool


class PoolingVisionTransformer(Model):
    cfg_class = PoolingVisionTransformerConfig

    def __init__(self, cfg: PoolingVisionTransformerConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg)
        g = generator
        self.nb_features = cfg.embed_dim[-1]
        self.patch_embed = nn.ModuleDict({"conv": Conv2d(
            cfg.in_channels, cfg.embed_dim[0], cfg.patch_size,
            stride=cfg.stride, padding="valid", weight_std=0.02,
            generator=g)})
        h, w = cfg.grid_size
        self.pos_embed = nn.Parameter(torch.empty(1, cfg.embed_dim[0], h, w))
        self.cls_token = nn.Parameter(
            torch.empty(1, cfg.nb_tokens, cfg.embed_dim[0]))
        with torch.no_grad():
            trunc_normal_(self.pos_embed, 0.02, g)
            trunc_normal_(self.cls_token, 0.02, g)
        dpr = np.linspace(0.0, cfg.drop_path_rate, sum(cfg.nb_blocks))
        dpr = np.split(dpr, np.cumsum(cfg.nb_blocks))
        stages = []
        for j, depth in enumerate(cfg.nb_blocks):
            pool = (ConvHeadPooling(cfg.nb_tokens, cfg.embed_dim[j - 1],
                                    cfg.embed_dim[j], stride=2, generator=g)
                    if j > 0 else None)
            blocks = [ViTBlock(cfg.embed_dim[j], cfg.nb_heads[j],
                               cfg.mlp_ratio, True, cfg.drop_rate,
                               cfg.attn_drop_rate, float(dpr[j][k]),
                               cfg.norm_layer, cfg.act_layer, generator=g)
                      for k in range(depth)]
            stages.append(_Stage(blocks, pool))
        self.transformers = nn.ModuleList(stages)
        self.norm = norm_layer_factory(cfg.norm_layer)(cfg.embed_dim[-1])
        self.head = (Dense(cfg.embed_dim[-1], cfg.nb_classes, generator=g)
                     if cfg.nb_classes > 0 else None)
        self.head_dist = (Dense(cfg.embed_dim[-1], cfg.nb_classes, generator=g)
                          if cfg.distilled and cfg.nb_classes > 0 else None)

    def transform_pos_embed(self, weight: torch.Tensor,
                            target_cfg: PoolingVisionTransformerConfig
                            ) -> torch.Tensor:
        """The weight-transfer hook: ``weight``, a (1, C, H, W) position
        table, resized bicubically to ``target_cfg``'s grid."""
        return self._resized_pos_embed(weight, target_cfg.grid_size)

    @staticmethod
    def _resized_pos_embed(pos_embed: torch.Tensor,
                           grid: Tuple[int, int]) -> torch.Tensor:
        _, c, h, w = pos_embed.shape
        table = pos_embed.permute(0, 2, 3, 1).reshape(1, h * w, c)
        table = interpolate_pos_embeddings_grid(table, src_grid=(h, w),
                                                dst_grid=grid)
        return table.reshape(1, *grid, c).permute(0, 3, 1, 2)

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        ctx = current_context()
        x = self.patch_embed["conv"](x)
        b, h, w, c = x.shape
        pos_embed = self.pos_embed
        if cfg.interpolate_input and (h, w) != tuple(pos_embed.shape[2:]):
            pos_embed = self._resized_pos_embed(pos_embed, (h, w))
        x = x + pos_embed.permute(0, 2, 3, 1).to(x.dtype)
        x = dropout(x, cfg.drop_rate, ctx.training, ctx.generator)
        grid = (h, w)
        cls = self.cls_token.to(x.dtype).expand(b, -1, -1)
        x = torch.cat([cls, x.reshape(b, h * w, c)], dim=1)
        capture_feature("patch_embedding", x)

        for j, stage in enumerate(self.transformers):
            if stage.pool is not None:
                x, grid = stage.pool(x, grid)
                capture_feature(f"stage_{j - 1}/pool", x)
            for k, block in enumerate(stage.blocks):
                x = block(x)
                capture_feature(f"stage_{j}/block_{k}", x)
        capture_feature("features_all", x)
        x = self.norm(x[:, :cfg.nb_tokens])
        x = x if cfg.distilled else x[:, 0]
        capture_feature("features", x)
        return x

    def forward_head(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.distilled:
            y = self.head(x[:, 0]) if self.head is not None else x[:, 0]
            y_dist = (self.head_dist(x[:, 1]) if self.head_dist is not None
                      else x[:, 1])
            x = torch.stack([y, y_dist], dim=1)
        elif self.head is not None:
            x = self.head(x)
        capture_feature("logits", x)
        return x

    @property
    def feature_names(self):
        names = ["patch_embedding"]
        for j, n in enumerate(self.cfg.nb_blocks):
            names += [f"stage_{j}/block_{k}" for k in range(n)]
            if j < len(self.cfg.nb_blocks) - 1:
                names.append(f"stage_{j}/pool")
        return tuple(names + ["features_all", "features", "logits"])


# -- variant registrations ---------------------------------------------------
# The same variants, with the same configs, as tfimm_tpu/architectures/pit.py.

def _register(name, **kwargs):
    def fn():
        return PoolingVisionTransformer, PoolingVisionTransformerConfig(
            name=name, url="[timm]", **kwargs)

    fn.__name__ = name
    fn.__qualname__ = name
    fn.__module__ = __name__
    globals()[name] = fn
    register_model(fn)


_register("pit_ti_224", patch_size=16, stride=8, embed_dim=(64, 128, 256),
          nb_blocks=(2, 6, 4), nb_heads=(2, 4, 8))
_register("pit_xs_224", patch_size=16, stride=8, embed_dim=(96, 192, 384),
          nb_blocks=(2, 6, 4), nb_heads=(2, 4, 8))
_register("pit_s_224", patch_size=16, stride=8, embed_dim=(144, 288, 576),
          nb_blocks=(2, 6, 4), nb_heads=(3, 6, 12))
_register("pit_b_224", patch_size=14, stride=7, embed_dim=(256, 512, 1024),
          nb_blocks=(3, 6, 4), nb_heads=(4, 8, 16))
_register("pit_ti_distilled_224", patch_size=16, stride=8,
          embed_dim=(64, 128, 256), nb_blocks=(2, 6, 4), nb_heads=(2, 4, 8),
          distilled=True, classifier=("head", "head_dist"))
_register("pit_xs_distilled_224", patch_size=16, stride=8,
          embed_dim=(96, 192, 384), nb_blocks=(2, 6, 4), nb_heads=(2, 4, 8),
          distilled=True, classifier=("head", "head_dist"))
_register("pit_s_distilled_224", patch_size=16, stride=8,
          embed_dim=(144, 288, 576), nb_blocks=(2, 6, 4), nb_heads=(3, 6, 12),
          distilled=True, classifier=("head", "head_dist"))
_register("pit_b_distilled_224", patch_size=14, stride=7,
          embed_dim=(256, 512, 1024), nb_blocks=(3, 6, 4), nb_heads=(4, 8, 16),
          distilled=True, classifier=("head", "head_dist"))
