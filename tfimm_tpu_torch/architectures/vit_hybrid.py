"""Hybrid Vision Transformer (ResNetV2 + ViT); mirror of
tfimm_tpu/architectures/vit_hybrid.py.

A non-preact ResNetV2 stem (or stem and stages) feeds the ViT's patch
projection. The registrations reuse ``ViT`` with
``patch_layer="hybrid_embeddings"``; parameter names are timm's
(``patch_embed.backbone.stem.conv``, ``patch_embed.backbone.stages.0...``,
``patch_embed.proj``). The blocks' attention takes ``fused_mha`` as every
ViT's does (``ops/attention.py``).

Paper: ViT (hybrid variants), https://arxiv.org/abs/2010.11929.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from tfimm_tpu_torch.architectures.resnetv2 import (
    ResNetV2,
    ResNetV2Config,
    ResNetV2Stem,
)
from tfimm_tpu_torch.architectures.vit import ViT, ViTConfig
from tfimm_tpu_torch.core import current_context
from tfimm_tpu_torch.models.registry import register_model
from tfimm_tpu_torch.ops.conv import Conv2d

__all__ = ["HybridEmbeddings"]


class HybridEmbeddings(nn.Module):
    """CNN features, then a conv projection to patch tokens: (B, H, W, C) ->
    (B, N, D) and the grid. The backbone is the "same" non-preact stem alone
    (64 channels) where ``nb_blocks`` is empty, else a headless non-preact
    ResNetV2 with those stages, whose ``drop_path_rate`` is the ViT's."""

    def __init__(self, in_channels: int, input_size: Tuple[int, int],
                 nb_blocks: tuple, patch_size: int, embed_dim: int,
                 drop_path_rate: float = 0.0, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if nb_blocks == ():
            self.backbone = ResNetV2Stem(
                in_channels, stem_type="same", stem_width=64,
                conv_padding="same", preact=False, act_layer="relu",
                norm_layer="group_norm", generator=generator)
            backbone_out = 64
        else:
            self.backbone = ResNetV2(ResNetV2Config(
                nb_classes=0, in_channels=in_channels, input_size=input_size,
                nb_blocks=nb_blocks, preact=False, stem_type="same",
                global_pool="", conv_padding="same",
                drop_path_rate=drop_path_rate), generator=generator)
            backbone_out = self.backbone.nb_features
        self.proj = Conv2d(backbone_out, embed_dim, patch_size,
                           stride=patch_size, padding="valid", weight_std=0.02,
                           generator=generator)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, int]]:
        # The backbone's features are not the ViT's: capture is off inside
        # it, as the JAX layer turns it off.
        ctx = current_context()
        saved = ctx.capture_features
        ctx.capture_features = False
        try:
            if isinstance(self.backbone, ResNetV2):
                x = self.backbone.forward_features(x)
            else:
                x = self.backbone(x)
        finally:
            ctx.capture_features = saved
        x = self.proj(x)
        grid = (x.shape[1], x.shape[2])
        return x.reshape(x.shape[0], grid[0] * grid[1], x.shape[-1]), grid


# -- variant registrations ---------------------------------------------------
# The same variants, with the same configs, as
# tfimm_tpu/architectures/vit_hybrid.py.

def _register(name, **kwargs):
    def fn():
        return ViT, ViTConfig(name=name, url="[timm]",
                              patch_layer="hybrid_embeddings", **kwargs)

    fn.__name__ = name
    fn.__qualname__ = name
    fn.__module__ = __name__
    globals()[name] = fn
    register_model(fn)


_STEM_FC = "patch_embed.backbone.conv"
_FULL_FC = "patch_embed.backbone.stem.conv"

_register("vit_tiny_r_s16_p8_224", patch_nb_blocks=(), patch_size=8,
          embed_dim=192, nb_blocks=12, nb_heads=3, crop_pct=0.9,
          first_conv=_STEM_FC)
_register("vit_tiny_r_s16_p8_384", input_size=(384, 384), patch_nb_blocks=(),
          patch_size=8, embed_dim=192, nb_blocks=12, nb_heads=3, crop_pct=1.0,
          first_conv=_STEM_FC)
_register("vit_small_r26_s32_224", patch_nb_blocks=(2, 2, 2, 2), patch_size=1,
          embed_dim=384, nb_blocks=12, nb_heads=6, crop_pct=0.9,
          first_conv=_FULL_FC)
_register("vit_small_r26_s32_384", input_size=(384, 384),
          patch_nb_blocks=(2, 2, 2, 2), patch_size=1, embed_dim=384,
          nb_blocks=12, nb_heads=6, crop_pct=1.0, first_conv=_FULL_FC)
_register("vit_base_r50_s16_384", input_size=(384, 384),
          patch_nb_blocks=(3, 4, 9), patch_size=1, embed_dim=768, nb_blocks=12,
          nb_heads=12, crop_pct=1.0, first_conv=_FULL_FC)
_register("vit_large_r50_s32_224", patch_nb_blocks=(3, 4, 6, 3), patch_size=1,
          embed_dim=1024, nb_blocks=24, nb_heads=16, crop_pct=0.9,
          first_conv=_FULL_FC)
_register("vit_large_r50_s32_384", input_size=(384, 384),
          patch_nb_blocks=(3, 4, 6, 3), patch_size=1, embed_dim=1024,
          nb_blocks=24, nb_heads=16, crop_pct=1.0, first_conv=_FULL_FC)
_register("vit_tiny_r_s16_p8_224_in21k", nb_classes=21843, patch_nb_blocks=(),
          patch_size=8, embed_dim=192, nb_blocks=12, nb_heads=3, crop_pct=0.9,
          first_conv=_STEM_FC)
_register("vit_small_r26_s32_224_in21k", nb_classes=21843,
          patch_nb_blocks=(2, 2, 2, 2), patch_size=1, embed_dim=384,
          nb_blocks=12, nb_heads=6, crop_pct=0.9, first_conv=_FULL_FC)
_register("vit_base_r50_s16_224_in21k", nb_classes=21843,
          patch_nb_blocks=(3, 4, 9), patch_size=1, embed_dim=768, nb_blocks=12,
          nb_heads=12, representation_size=768, crop_pct=0.9,
          first_conv=_FULL_FC)
_register("vit_large_r50_s32_224_in21k", nb_classes=21843,
          patch_nb_blocks=(3, 4, 6, 3), patch_size=1, embed_dim=1024,
          nb_blocks=24, nb_heads=16, crop_pct=0.9, first_conv=_FULL_FC)
