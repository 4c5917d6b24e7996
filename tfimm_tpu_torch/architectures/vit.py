"""Vision Transformer (ViT) and DeiT; mirror of tfimm_tpu/architectures/vit.py.

Class/dist tokens, learned position embeddings, optional representation
(pre-logits) layer and distilled dual heads. Parameter names are timm's
(``blocks.0.attn.qkv.weight`` ...), so timm checkpoints load with
``load_state_dict``. Position-embedding interpolation (``interpolate_input``)
and the hybrid patch embedding are not ported yet.

Papers: ViT https://arxiv.org/abs/2010.11929, DeiT https://arxiv.org/abs/2012.12877.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch
import torch.nn as nn

from tfimm_tpu_torch.core import capture_feature, current_context
from tfimm_tpu_torch.models.base import Model
from tfimm_tpu_torch.models.config import ModelConfig
from tfimm_tpu_torch.models.registry import register_model
from tfimm_tpu_torch.ops.attention import MultiHeadAttention
from tfimm_tpu_torch.ops.basic import Dense, trunc_normal_
from tfimm_tpu_torch.ops.embed import PatchEmbeddings
from tfimm_tpu_torch.ops.mlp import MLP
from tfimm_tpu_torch.ops.norm import norm_layer_factory
from tfimm_tpu_torch.ops.stochastic import drop_path, dropout
from tfimm_tpu_torch.utils.constants import (
    IMAGENET_DEFAULT_MEAN,
    IMAGENET_DEFAULT_STD,
    IMAGENET_INCEPTION_MEAN,
    IMAGENET_INCEPTION_STD,
)

__all__ = ["ViT", "ViTBlock", "ViTConfig"]


@dataclass
class ViTConfig(ModelConfig):
    nb_classes: int = 1000
    in_channels: int = 3
    input_size: Tuple[int, int] = (224, 224)
    patch_layer: str = "patch_embeddings"
    patch_size: int = 16
    embed_dim: int = 768
    nb_blocks: int = 12
    nb_heads: int = 12
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    representation_size: Optional[int] = None
    distilled: bool = False
    # Regularization
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.0
    # Other parameters
    norm_layer: str = "layer_norm_eps_1e-6"
    act_layer: str = "gelu"
    # Parameters for inference
    interpolate_input: bool = False
    crop_pct: float = 0.875
    interpolation: str = "bicubic"
    mean: Tuple[float, float, float] = IMAGENET_INCEPTION_MEAN
    std: Tuple[float, float, float] = IMAGENET_INCEPTION_STD
    classifier: Union[str, Tuple[str, str]] = "head"

    @property
    def nb_tokens(self) -> int:
        return 2 if self.distilled else 1

    @property
    def grid_size(self) -> Tuple[int, int]:
        return (self.input_size[0] // self.patch_size,
                self.input_size[1] // self.patch_size)

    @property
    def nb_patches(self) -> int:
        return self.grid_size[0] * self.grid_size[1]


class ViTBlock(nn.Module):
    """Pre-norm transformer encoder block (attn + MLP, residuals, drop-path)."""

    def __init__(self, embed_dim, nb_heads, mlp_ratio=4.0, qkv_bias=True,
                 drop_rate=0.0, attn_drop_rate=0.0, drop_path_rate=0.0,
                 norm_layer="layer_norm_eps_1e-6", act_layer="gelu", *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        norm = norm_layer_factory(norm_layer)
        self.norm1 = norm(embed_dim)
        self.attn = MultiHeadAttention(
            embed_dim, nb_heads, qkv_bias=qkv_bias,
            attn_drop_rate=attn_drop_rate, proj_drop_rate=drop_rate,
            generator=generator,
        )
        self.norm2 = norm(embed_dim)
        self.mlp = MLP(embed_dim, int(embed_dim * mlp_ratio),
                       act_layer=act_layer, drop_rate=drop_rate,
                       weight_std=0.02, generator=generator)
        self.drop_path_rate = drop_path_rate

    def forward(self, x: torch.Tensor,
                feature_name: Optional[str] = None) -> torch.Tensor:
        ctx = current_context()
        y = self.attn(self.norm1(x), feature_name=feature_name)
        x = x + drop_path(y, self.drop_path_rate, ctx.training, ctx.generator)
        y = self.mlp(self.norm2(x))
        return x + drop_path(y, self.drop_path_rate, ctx.training,
                             ctx.generator)


class ViT(Model):
    def __init__(self, cfg: ViTConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg)
        if cfg.patch_layer == "hybrid_embeddings":
            raise NotImplementedError(
                "patch_layer='hybrid_embeddings' waits for the vit_hybrid port "
                "(ROADMAP.md, queue A, item 8)")
        if cfg.patch_layer != "patch_embeddings":
            raise ValueError(f"Unknown patch layer: {cfg.patch_layer}.")
        if cfg.representation_size and cfg.distilled:
            raise ValueError("Cannot combine distillation and representation "
                             "layer.")
        g = generator
        self.nb_features = cfg.representation_size or cfg.embed_dim
        self.patch_embed = PatchEmbeddings(cfg.patch_size, cfg.embed_dim,
                                           in_channels=cfg.in_channels,
                                           generator=g)
        d = cfg.embed_dim
        self.cls_token = nn.Parameter(torch.empty(1, 1, d))
        self.pos_embed = nn.Parameter(
            torch.empty(1, cfg.nb_patches + cfg.nb_tokens, d))
        self.dist_token = (nn.Parameter(torch.empty(1, 1, d)) if cfg.distilled
                           else None)
        with torch.no_grad():
            for t in (self.cls_token, self.pos_embed, self.dist_token):
                if t is not None:
                    trunc_normal_(t, 0.02, g)
        self.blocks = nn.ModuleList(
            ViTBlock(d, cfg.nb_heads, cfg.mlp_ratio, cfg.qkv_bias,
                     cfg.drop_rate, cfg.attn_drop_rate, cfg.drop_path_rate,
                     cfg.norm_layer, cfg.act_layer, generator=g)
            for _ in range(cfg.nb_blocks))
        self.norm = norm_layer_factory(cfg.norm_layer)(d)
        self.pre_logits = (
            nn.ModuleDict({"fc": Dense(d, cfg.representation_size,
                                       weight_std=0.02, generator=g)})
            if cfg.representation_size else None)
        # The heads start at zero, as in the JAX package: logits of a freshly
        # initialised model are all zero.
        self.head = (Dense(self.nb_features, cfg.nb_classes, zero_init=True)
                     if cfg.nb_classes > 0 else None)
        self.head_dist = (Dense(d, cfg.nb_classes, zero_init=True)
                          if cfg.distilled and cfg.nb_classes > 0 else None)

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        ctx = current_context()
        batch = x.shape[0]
        x, grid = self.patch_embed(x)
        if cfg.interpolate_input and grid != cfg.grid_size:
            raise NotImplementedError(
                "interpolate_input waits for the interpolate_pos_embeddings "
                "port (ROADMAP.md, queue A, item 1)")
        tokens = [self.cls_token.to(x.dtype).expand(batch, -1, -1)]
        if cfg.distilled:
            tokens.append(self.dist_token.to(x.dtype).expand(batch, -1, -1))
        x = torch.cat(tokens + [x], dim=1)
        x = x + self.pos_embed.to(x.dtype)
        x = dropout(x, cfg.drop_rate, ctx.training, ctx.generator)
        capture_feature("patch_embedding", x)

        for j, block in enumerate(self.blocks):
            x = block(x, feature_name=f"block_{j}/attn")
            capture_feature(f"block_{j}", x)
        x = self.norm(x)
        capture_feature("features_all", x)

        if cfg.distilled:
            # Both tokens, stacked, so that every model has a single output.
            x = x[:, :2]
        elif cfg.representation_size:
            x = torch.tanh(self.pre_logits["fc"](x[:, 0]))
        else:
            x = x[:, 0]
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
        for j in range(self.cfg.nb_blocks):
            names += [f"block_{j}/attn", f"block_{j}"]
        return tuple(names + ["features_all", "features", "logits"])


# -- variant registrations ---------------------------------------------------
# The same variants, with the same configs, as tfimm_tpu/architectures/vit.py.

def _vit_cfg(name, **kwargs):
    return ViTConfig(name=name, url="[timm]", **kwargs)


def _deit_kwargs():
    return dict(mean=IMAGENET_DEFAULT_MEAN, std=IMAGENET_DEFAULT_STD)


@register_model
def vit_tiny_patch16_224():
    return ViT, _vit_cfg("vit_tiny_patch16_224", patch_size=16, embed_dim=192,
                         nb_blocks=12, nb_heads=3)


@register_model
def vit_tiny_patch16_384():
    return ViT, _vit_cfg("vit_tiny_patch16_384", input_size=(384, 384),
                         patch_size=16, embed_dim=192, nb_blocks=12, nb_heads=3,
                         crop_pct=1.0)


@register_model
def vit_small_patch32_224():
    return ViT, _vit_cfg("vit_small_patch32_224", patch_size=32, embed_dim=384,
                         nb_blocks=12, nb_heads=6)


@register_model
def vit_small_patch32_384():
    return ViT, _vit_cfg("vit_small_patch32_384", input_size=(384, 384),
                         patch_size=32, embed_dim=384, nb_blocks=12, nb_heads=6,
                         crop_pct=1.0)


@register_model
def vit_small_patch16_224():
    return ViT, _vit_cfg("vit_small_patch16_224", patch_size=16, embed_dim=384,
                         nb_blocks=12, nb_heads=6)


@register_model
def vit_small_patch16_384():
    return ViT, _vit_cfg("vit_small_patch16_384", input_size=(384, 384),
                         patch_size=16, embed_dim=384, nb_blocks=12, nb_heads=6,
                         crop_pct=1.0)


@register_model
def vit_base_patch32_224():
    return ViT, _vit_cfg("vit_base_patch32_224", patch_size=32, embed_dim=768,
                         nb_blocks=12, nb_heads=12)


@register_model
def vit_base_patch32_384():
    return ViT, _vit_cfg("vit_base_patch32_384", input_size=(384, 384),
                         patch_size=32, embed_dim=768, nb_blocks=12, nb_heads=12,
                         crop_pct=1.0)


@register_model
def vit_base_patch16_224():
    return ViT, _vit_cfg("vit_base_patch16_224", patch_size=16, embed_dim=768,
                         nb_blocks=12, nb_heads=12)


@register_model
def vit_base_patch16_384():
    return ViT, _vit_cfg("vit_base_patch16_384", input_size=(384, 384),
                         patch_size=16, embed_dim=768, nb_blocks=12, nb_heads=12,
                         crop_pct=1.0)


@register_model
def vit_base_patch8_224():
    return ViT, _vit_cfg("vit_base_patch8_224", patch_size=8, embed_dim=768,
                         nb_blocks=12, nb_heads=12)


@register_model
def vit_large_patch32_224():
    return ViT, _vit_cfg("vit_large_patch32_224", patch_size=32, embed_dim=1024,
                         nb_blocks=24, nb_heads=16)


@register_model
def vit_large_patch32_384():
    return ViT, _vit_cfg("vit_large_patch32_384", input_size=(384, 384),
                         patch_size=32, embed_dim=1024, nb_blocks=24, nb_heads=16,
                         crop_pct=1.0)


@register_model
def vit_large_patch16_224():
    return ViT, _vit_cfg("vit_large_patch16_224", patch_size=16, embed_dim=1024,
                         nb_blocks=24, nb_heads=16)


@register_model
def vit_large_patch16_384():
    return ViT, _vit_cfg("vit_large_patch16_384", input_size=(384, 384),
                         patch_size=16, embed_dim=1024, nb_blocks=24, nb_heads=16,
                         crop_pct=1.0)


@register_model
def vit_base_patch32_sam_224():
    return ViT, _vit_cfg("vit_base_patch32_sam_224", patch_size=32, embed_dim=768,
                         nb_blocks=12, nb_heads=12)


@register_model
def vit_base_patch16_sam_224():
    return ViT, _vit_cfg("vit_base_patch16_sam_224", patch_size=16, embed_dim=768,
                         nb_blocks=12, nb_heads=12)


@register_model
def vit_tiny_patch16_224_in21k():
    return ViT, _vit_cfg("vit_tiny_patch16_224_in21k", nb_classes=21843,
                         patch_size=16, embed_dim=192, nb_blocks=12, nb_heads=3)


@register_model
def vit_small_patch32_224_in21k():
    return ViT, _vit_cfg("vit_small_patch32_224_in21k", nb_classes=21843,
                         patch_size=32, embed_dim=384, nb_blocks=12, nb_heads=6)


@register_model
def vit_small_patch16_224_in21k():
    return ViT, _vit_cfg("vit_small_patch16_224_in21k", nb_classes=21843,
                         patch_size=16, embed_dim=384, nb_blocks=12, nb_heads=6)


@register_model
def vit_base_patch32_224_in21k():
    return ViT, _vit_cfg("vit_base_patch32_224_in21k", nb_classes=21843,
                         patch_size=32, embed_dim=768, nb_blocks=12, nb_heads=12)


@register_model
def vit_base_patch16_224_in21k():
    return ViT, _vit_cfg("vit_base_patch16_224_in21k", nb_classes=21843,
                         patch_size=16, embed_dim=768, nb_blocks=12, nb_heads=12)


@register_model
def vit_base_patch8_224_in21k():
    return ViT, _vit_cfg("vit_base_patch8_224_in21k", nb_classes=21843,
                         patch_size=8, embed_dim=768, nb_blocks=12, nb_heads=12)


@register_model
def vit_large_patch32_224_in21k():
    return ViT, _vit_cfg("vit_large_patch32_224_in21k", nb_classes=21843,
                         patch_size=32, embed_dim=1024, nb_blocks=24, nb_heads=16,
                         representation_size=1024)


@register_model
def vit_large_patch16_224_in21k():
    return ViT, _vit_cfg("vit_large_patch16_224_in21k", nb_classes=21843,
                         patch_size=16, embed_dim=1024, nb_blocks=24, nb_heads=16)


@register_model
def vit_huge_patch14_224_in21k():
    return ViT, _vit_cfg("vit_huge_patch14_224_in21k", nb_classes=21843,
                         patch_size=14, embed_dim=1280, nb_blocks=32, nb_heads=16,
                         representation_size=1280)


@register_model
def deit_tiny_patch16_224():
    return ViT, _vit_cfg("deit_tiny_patch16_224", patch_size=16, embed_dim=192,
                         nb_blocks=12, nb_heads=3, **_deit_kwargs())


@register_model
def deit_small_patch16_224():
    return ViT, _vit_cfg("deit_small_patch16_224", patch_size=16, embed_dim=384,
                         nb_blocks=12, nb_heads=6, **_deit_kwargs())


@register_model
def deit_base_patch16_224():
    return ViT, _vit_cfg("deit_base_patch16_224", patch_size=16, embed_dim=768,
                         nb_blocks=12, nb_heads=12, **_deit_kwargs())


@register_model
def deit_base_patch16_384():
    return ViT, _vit_cfg("deit_base_patch16_384", input_size=(384, 384),
                         patch_size=16, embed_dim=768, nb_blocks=12, nb_heads=12,
                         crop_pct=1.0, **_deit_kwargs())


def _deit_distilled_cfg(name, **kwargs):
    return ViTConfig(name=name, url="[timm]", distilled=True,
                     classifier=("head", "head_dist"), **_deit_kwargs(), **kwargs)


@register_model
def deit_tiny_distilled_patch16_224():
    return ViT, _deit_distilled_cfg("deit_tiny_distilled_patch16_224",
                                    patch_size=16, embed_dim=192, nb_blocks=12,
                                    nb_heads=3)


@register_model
def deit_small_distilled_patch16_224():
    return ViT, _deit_distilled_cfg("deit_small_distilled_patch16_224",
                                    patch_size=16, embed_dim=384, nb_blocks=12,
                                    nb_heads=6)


@register_model
def deit_base_distilled_patch16_224():
    return ViT, _deit_distilled_cfg("deit_base_distilled_patch16_224",
                                    patch_size=16, embed_dim=768, nb_blocks=12,
                                    nb_heads=12)


@register_model
def deit_base_distilled_patch16_384():
    return ViT, _deit_distilled_cfg("deit_base_distilled_patch16_384",
                                    input_size=(384, 384), patch_size=16,
                                    embed_dim=768, nb_blocks=12, nb_heads=12,
                                    crop_pct=1.0)


@register_model
def vit_base_patch16_224_miil_in21k():
    return ViT, _vit_cfg("vit_base_patch16_224_miil_in21k", nb_classes=11221,
                         patch_size=16, embed_dim=768, nb_blocks=12, nb_heads=12,
                         qkv_bias=False, interpolation="bilinear",
                         mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0))


@register_model
def vit_base_patch16_224_miil():
    return ViT, _vit_cfg("vit_base_patch16_224_miil", patch_size=16,
                         embed_dim=768, nb_blocks=12, nb_heads=12,
                         qkv_bias=False, interpolation="bilinear",
                         mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0))
