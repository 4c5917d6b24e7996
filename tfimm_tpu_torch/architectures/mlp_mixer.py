"""MLP-Mixer, ResMLP and gMLP; mirror of
tfimm_tpu/architectures/mlp_mixer.py.

A patchify stem, then one of three blocks on (B, N, C) tokens:
``MixerBlock`` (a token MLP and a channel MLP, each after a LayerNorm),
``ResBlock`` (ResMLP: an ``Affine`` norm, one token Dense and a channel
MLP, each branch scaled by ``ls1`` / ``ls2``) or ``SpatialGatingBlock``
(gMLP: a ``GatedMLP``). Token mixing is ``F.linear`` over the transposed
tokens. The input size is fixed (the token Dense layers have N inputs).
Parameter names are timm's (``stem.proj``, ``blocks.{j}.mlp_tokens.fc1``,
``norm``, ``head``). No TPU kernel is on this path.

Papers: MLP-Mixer https://arxiv.org/abs/2105.01601,
ResMLP 2105.03404, gMLP 2105.08050.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn as nn

from tfimm_tpu_torch.core import capture_feature, current_context
from tfimm_tpu_torch.models.base import Model
from tfimm_tpu_torch.models.config import ModelConfig
from tfimm_tpu_torch.models.registry import register_model
from tfimm_tpu_torch.ops.basic import Dense
from tfimm_tpu_torch.ops.embed import PatchEmbeddings
from tfimm_tpu_torch.ops.mlp import MLP, GatedMLP, GluMLP
from tfimm_tpu_torch.ops.norm import norm_layer_factory
from tfimm_tpu_torch.ops.stochastic import drop_path
from tfimm_tpu_torch.utils.constants import (
    IMAGENET_DEFAULT_MEAN,
    IMAGENET_DEFAULT_STD,
)

__all__ = ["MLPMixer", "MLPMixerConfig"]


@dataclass
class MLPMixerConfig(ModelConfig):
    nb_classes: int = 1000
    in_channels: int = 3
    input_size: Tuple[int, int] = (224, 224)
    patch_size: int = 16
    embed_dim: int = 512
    nb_blocks: int = 16
    mlp_ratio: Tuple[float, float] = (0.5, 4.0)
    block_layer: str = "mixer_block"
    mlp_layer: str = "mlp"
    # Regularization
    drop_rate: float = 0.0
    drop_path_rate: float = 0.0
    # Other parameters
    norm_layer: str = "layer_norm_eps_1e-6"
    act_layer: str = "gelu"
    init_values: float = 1e-4  # layer-scale init for ResBlocks
    nlhb: bool = False
    stem_norm: bool = False
    # Parameters for inference
    crop_pct: float = 0.875
    interpolation: str = "bicubic"
    mean: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    std: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    # Weight transfer
    first_conv: str = "stem.proj"
    classifier: str = "head"

    @property
    def nb_patches(self) -> int:
        return ((self.input_size[0] // self.patch_size)
                * (self.input_size[1] // self.patch_size))


def _make_mlp(cfg: MLPMixerConfig, in_features: int, hidden: int,
              generator: Optional[torch.Generator], seq_len=None):
    kw = dict(act_layer=cfg.act_layer, drop_rate=cfg.drop_rate,
              generator=generator)
    if cfg.mlp_layer == "mlp":
        return MLP(in_features, hidden, **kw)
    if cfg.mlp_layer == "glu_mlp":
        return GluMLP(in_features, hidden, **kw)
    if cfg.mlp_layer == "gated_mlp":
        return GatedMLP(in_features, hidden, seq_len, **kw)
    raise ValueError(f"Unknown mlp layer: {cfg.mlp_layer}")


def _mix_tokens(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``layer`` over the token axis of (B, N, C) tokens."""
    return layer(x.transpose(1, 2)).transpose(1, 2)


def _drop_path(x: torch.Tensor, rate: float) -> torch.Tensor:
    ctx = current_context()
    return drop_path(x, rate, ctx.training, ctx.generator)


class MixerBlock(nn.Module):
    def __init__(self, cfg: MLPMixerConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        norm = norm_layer_factory(cfg.norm_layer)
        tokens_dim, channels_dim = [int(x * cfg.embed_dim) for x in cfg.mlp_ratio]
        self.norm1 = norm(cfg.embed_dim)
        self.mlp_tokens = _make_mlp(cfg, cfg.nb_patches, tokens_dim, generator)
        self.norm2 = norm(cfg.embed_dim)
        self.mlp_channels = _make_mlp(cfg, cfg.embed_dim, channels_dim,
                                      generator)
        self.drop_path_rate = cfg.drop_path_rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _mix_tokens(self.mlp_tokens, self.norm1(x))
        x = x + _drop_path(y, self.drop_path_rate)
        y = self.mlp_channels(self.norm2(x))
        return x + _drop_path(y, self.drop_path_rate)


class ResBlock(nn.Module):
    """ResMLP's block. ``ls1`` and ``ls2`` are the JAX package's bare
    leaves of the same names, cast to x's dtype."""

    def __init__(self, cfg: MLPMixerConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        norm = norm_layer_factory(cfg.norm_layer)
        self.norm1 = norm(cfg.embed_dim)
        self.linear_tokens = Dense(cfg.nb_patches, cfg.nb_patches,
                                   generator=generator)
        self.norm2 = norm(cfg.embed_dim)
        self.mlp_channels = _make_mlp(
            cfg, cfg.embed_dim, int(cfg.embed_dim * cfg.mlp_ratio[1]),
            generator)
        self.ls1 = nn.Parameter(torch.full((cfg.embed_dim,), cfg.init_values))
        self.ls2 = nn.Parameter(torch.full((cfg.embed_dim,), cfg.init_values))
        self.drop_path_rate = cfg.drop_path_rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _mix_tokens(self.linear_tokens, self.norm1(x))
        y = y * self.ls1.to(y.dtype)
        x = x + _drop_path(y, self.drop_path_rate)
        y = self.mlp_channels(self.norm2(x))
        y = y * self.ls2.to(y.dtype)
        return x + _drop_path(y, self.drop_path_rate)


class SpatialGatingBlock(nn.Module):
    def __init__(self, cfg: MLPMixerConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.norm = norm_layer_factory(cfg.norm_layer)(cfg.embed_dim)
        self.mlp_channels = _make_mlp(
            cfg, cfg.embed_dim, int(cfg.embed_dim * cfg.mlp_ratio[1]),
            generator, seq_len=cfg.nb_patches)
        self.drop_path_rate = cfg.drop_path_rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.mlp_channels(self.norm(x))
        return x + _drop_path(y, self.drop_path_rate)


_BLOCKS = {"mixer_block": MixerBlock, "res_block": ResBlock,
           "spatial_gating_block": SpatialGatingBlock}


class MLPMixer(Model):
    cfg_class = MLPMixerConfig

    def __init__(self, cfg: MLPMixerConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg)
        g = generator
        self.nb_features = cfg.embed_dim
        self.stem = PatchEmbeddings(
            cfg.patch_size, cfg.embed_dim, in_channels=cfg.in_channels,
            norm_layer=cfg.norm_layer if cfg.stem_norm else None, generator=g)
        self.blocks = nn.ModuleList(_BLOCKS[cfg.block_layer](cfg, generator=g)
                                    for _ in range(cfg.nb_blocks))
        self.norm = norm_layer_factory(cfg.norm_layer)(cfg.embed_dim)
        self.head = (Dense(cfg.embed_dim, cfg.nb_classes, generator=g)
                     if cfg.nb_classes > 0 else None)

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        x, _ = self.stem(x)
        capture_feature("stem", x)
        for j, block in enumerate(self.blocks):
            x = block(x)
            capture_feature(f"block_{j}", x)
        x = self.norm(x)
        capture_feature("features_all", x)
        x = x.mean(dim=1)
        capture_feature("features", x)
        return x

    def forward_head(self, x: torch.Tensor) -> torch.Tensor:
        if self.head is not None:
            x = self.head(x)
        capture_feature("logits", x)
        return x

    @property
    def feature_names(self):
        return tuple(["stem"] + [f"block_{j}" for j in range(self.cfg.nb_blocks)]
                     + ["features_all", "features", "logits"])


# -- variant registrations ---------------------------------------------------
# The same variants, with the same configs, as
# tfimm_tpu/architectures/mlp_mixer.py.

def _register(name, **kwargs):
    def fn():
        return MLPMixer, MLPMixerConfig(name=name, url="[timm]", **kwargs)

    fn.__name__ = name
    fn.__qualname__ = name
    fn.__module__ = __name__
    globals()[name] = fn
    register_model(fn)


_register("mixer_s32_224", patch_size=32, embed_dim=512, nb_blocks=8)
_register("mixer_s16_224", patch_size=16, embed_dim=512, nb_blocks=8)
_register("mixer_b32_224", patch_size=32, embed_dim=768, nb_blocks=12)
_register("mixer_b16_224", patch_size=16, embed_dim=768, nb_blocks=12)
_register("mixer_b16_224_in21k", nb_classes=21843, patch_size=16,
          embed_dim=768, nb_blocks=12)
_register("mixer_l32_224", patch_size=32, embed_dim=1024, nb_blocks=24)
_register("mixer_l16_224", patch_size=16, embed_dim=1024, nb_blocks=24)
_register("mixer_l16_224_in21k", nb_classes=21843, patch_size=16,
          embed_dim=1024, nb_blocks=24)
_register("mixer_b16_224_miil", patch_size=16, embed_dim=768, nb_blocks=12,
          interpolation="bilinear", mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0))
_register("mixer_b16_224_miil_in21k", nb_classes=11221, patch_size=16,
          embed_dim=768, nb_blocks=12, interpolation="bilinear",
          mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0))
_register("gmixer_12_224", patch_size=16, embed_dim=384, nb_blocks=12,
          mlp_ratio=(1.0, 4.0), mlp_layer="glu_mlp", act_layer="swish",
          mean=IMAGENET_DEFAULT_MEAN, std=IMAGENET_DEFAULT_STD)
_register("gmixer_24_224", patch_size=16, embed_dim=384, nb_blocks=24,
          mlp_ratio=(1.0, 4.0), mlp_layer="glu_mlp", act_layer="swish",
          mean=IMAGENET_DEFAULT_MEAN, std=IMAGENET_DEFAULT_STD)

_RESMLP = dict(mlp_ratio=(4.0, 4.0), block_layer="res_block",
               norm_layer="affine", mean=IMAGENET_DEFAULT_MEAN,
               std=IMAGENET_DEFAULT_STD)
_register("resmlp_12_224", patch_size=16, embed_dim=384, nb_blocks=12, **_RESMLP)
_register("resmlp_24_224", patch_size=16, embed_dim=384, nb_blocks=24,
          init_values=1e-5, **_RESMLP)
_register("resmlp_36_224", patch_size=16, embed_dim=384, nb_blocks=36,
          init_values=1e-6, **_RESMLP)
_register("resmlp_big_24_224", patch_size=8, embed_dim=768, nb_blocks=24,
          init_values=1e-6, **_RESMLP)
_register("resmlp_12_distilled_224", patch_size=16, embed_dim=384,
          nb_blocks=12, **_RESMLP)
_register("resmlp_24_distilled_224", patch_size=16, embed_dim=384,
          nb_blocks=24, init_values=1e-5, **_RESMLP)
_register("resmlp_36_distilled_224", patch_size=16, embed_dim=384,
          nb_blocks=36, init_values=1e-6, **_RESMLP)
_register("resmlp_big_24_distilled_224", patch_size=8, embed_dim=768,
          nb_blocks=24, init_values=1e-6, **_RESMLP)
_register("resmlp_big_24_224_in22ft1k", patch_size=8, embed_dim=768,
          nb_blocks=24, init_values=1e-6, **_RESMLP)
_register("resmlp_12_224_dino", patch_size=16, embed_dim=384, nb_blocks=12,
          **_RESMLP)
_register("resmlp_24_224_dino", patch_size=16, embed_dim=384, nb_blocks=24,
          init_values=1e-5, **_RESMLP)

_register("gmlp_ti16_224", patch_size=16, embed_dim=128, nb_blocks=30,
          mlp_ratio=(6.0, 6.0), block_layer="spatial_gating_block",
          mlp_layer="gated_mlp")
_register("gmlp_s16_224", patch_size=16, embed_dim=256, nb_blocks=30,
          mlp_ratio=(6.0, 6.0), block_layer="spatial_gating_block",
          mlp_layer="gated_mlp")
_register("gmlp_b16_224", patch_size=16, embed_dim=512, nb_blocks=30,
          mlp_ratio=(6.0, 6.0), block_layer="spatial_gating_block",
          mlp_layer="gated_mlp")
