"""ResNetV2 (Big Transfer / BiT); mirror of
tfimm_tpu/architectures/resnetv2.py.

Pre-activation bottlenecks of weight-standardised convs (``StdConv2d``)
and GroupNorm, scaled by ``width_factor``; the non-preact form (a ReLU
after the residual add) is the hybrid ViTs' backbone
(``vit_hybrid.py``). Parameter names are timm's (``stem.conv``,
``stages.0.blocks.0.conv1``, ``stages.0.blocks.0.downsample.conv``,
``norm``, ``head.fc``), so a timm state dict loads with
``load_state_dict``. The convs that are not a reshape of the image (3x3,
7x7, strided) run on cuDNN (``ops/conv.py``); no TPU kernel is on this
path.

Paper: Big Transfer (BiT), https://arxiv.org/abs/1912.11370.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from tfimm_tpu_torch.core import capture_feature, current_context
from tfimm_tpu_torch.models.base import Model
from tfimm_tpu_torch.models.config import ModelConfig
from tfimm_tpu_torch.models.registry import register_model
from tfimm_tpu_torch.ops.basic import Dense, act_layer_factory
from tfimm_tpu_torch.ops.classifier import global_pool_2d
from tfimm_tpu_torch.ops.conv import StdConv2d
from tfimm_tpu_torch.ops.norm import norm_layer_factory
from tfimm_tpu_torch.ops.pool import max_pool_2d
from tfimm_tpu_torch.ops.stochastic import drop_path, dropout
from tfimm_tpu_torch.utils.constants import (
    IMAGENET_INCEPTION_MEAN,
    IMAGENET_INCEPTION_STD,
)

__all__ = ["ResNetV2", "ResNetV2Config", "ResNetV2Stem"]


@dataclass
class ResNetV2Config(ModelConfig):
    nb_classes: int = 1000
    in_channels: int = 3
    input_size: Tuple[int, int] = (224, 224)
    nb_blocks: Tuple = (2, 2, 2, 2)
    nb_channels: Tuple = (256, 512, 1024, 2048)
    width_factor: int = 1
    preact: bool = True
    stem_width: int = 64
    stem_type: str = "fixed"
    global_pool: str = "avg"
    conv_padding: str = "symmetric"
    act_layer: str = "relu"
    norm_layer: str = "group_norm"
    drop_rate: float = 0.0
    drop_path_rate: float = 0.0
    pool_size: int = 7
    crop_pct: float = 0.875
    interpolation: str = "bilinear"
    mean: Tuple[float, float, float] = IMAGENET_INCEPTION_MEAN
    std: Tuple[float, float, float] = IMAGENET_INCEPTION_STD
    first_conv: str = "stem.conv"
    classifier: str = "head.fc"


def _make_divisible(v, divisor=8):
    """This module's own rounding (not ``utils/etc.py · make_divisible``,
    which takes a minimum and a round limit)."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def _conv_padding(cfg_padding: str) -> str:
    """XLA's SAME for ``"same"``, else timm's symmetric padding."""
    return "same" if cfg_padding == "same" else "symmetric"


def _std_conv(in_ch: int, out_ch: int, kernel: int, stride: int,
              conv_padding: str, generator) -> StdConv2d:
    return StdConv2d(in_ch, out_ch, kernel, stride=stride,
                     padding=_conv_padding(conv_padding), use_bias=False,
                     generator=generator)


class _Downsample(nn.Module):
    """The shortcut's 1x1 standardised conv, with a norm after it in the
    non-preact form."""

    def __init__(self, in_ch: int, nb_channels: int, stride: int,
                 preact: bool, conv_padding: str, norm_layer: str, generator):
        super().__init__()
        self.conv = _std_conv(in_ch, nb_channels, 1, stride, conv_padding,
                              generator)
        self.norm = (None if preact
                     else norm_layer_factory(norm_layer)(nb_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        return x if self.norm is None else self.norm(x)


class PreActBottleneck(nn.Module):
    """Pre-activation bottleneck, the stride on the 3x3 conv; the shortcut
    is taken from the pre-activated input."""

    def __init__(self, in_ch: int, nb_channels: int, stride: int,
                 downsample: bool, conv_padding: str, act_layer: str,
                 norm_layer: str, drop_path_rate: float,
                 bottleneck_ratio: float = 0.25, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.act = act_layer_factory(act_layer)
        norm = norm_layer_factory(norm_layer)
        mid = _make_divisible(nb_channels * bottleneck_ratio)
        self.downsample = (_Downsample(in_ch, nb_channels, stride, True,
                                       conv_padding, norm_layer, g)
                           if downsample else None)
        self.norm1 = norm(in_ch)
        self.conv1 = _std_conv(in_ch, mid, 1, 1, conv_padding, g)
        self.norm2 = norm(mid)
        self.conv2 = _std_conv(mid, mid, 3, stride, conv_padding, g)
        self.norm3 = norm(mid)
        self.conv3 = _std_conv(mid, nb_channels, 1, 1, conv_padding, g)
        self.drop_path_rate = drop_path_rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ctx = current_context()
        y = self.act(self.norm1(x))
        shortcut = self.downsample(y) if self.downsample is not None else x
        x = self.conv1(y)
        x = self.conv2(self.act(self.norm2(x)))
        x = self.conv3(self.act(self.norm3(x)))
        x = drop_path(x, self.drop_path_rate, ctx.training, ctx.generator)
        return x + shortcut


class Bottleneck(nn.Module):
    """Non-preact bottleneck: conv -> norm (-> ReLU) three times, the
    residual add, then a ReLU; the hybrid ViTs' backbone block."""

    def __init__(self, in_ch: int, nb_channels: int, stride: int,
                 downsample: bool, conv_padding: str, act_layer: str,
                 norm_layer: str, drop_path_rate: float,
                 bottleneck_ratio: float = 0.25, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.act = act_layer_factory(act_layer)
        norm = norm_layer_factory(norm_layer)
        mid = _make_divisible(nb_channels * bottleneck_ratio)
        self.downsample = (_Downsample(in_ch, nb_channels, stride, False,
                                       conv_padding, norm_layer, g)
                           if downsample else None)
        self.conv1 = _std_conv(in_ch, mid, 1, 1, conv_padding, g)
        self.norm1 = norm(mid)
        self.conv2 = _std_conv(mid, mid, 3, stride, conv_padding, g)
        self.norm2 = norm(mid)
        self.conv3 = _std_conv(mid, nb_channels, 1, 1, conv_padding, g)
        self.norm3 = norm(nb_channels)
        self.drop_path_rate = drop_path_rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ctx = current_context()
        shortcut = self.downsample(x) if self.downsample is not None else x
        x = self.act(self.norm1(self.conv1(x)))
        x = self.act(self.norm2(self.conv2(x)))
        x = self.norm3(self.conv3(x))
        x = drop_path(x, self.drop_path_rate, ctx.training, ctx.generator)
        return self.act(x + shortcut)


class ResNetV2Stem(nn.Module):
    """7x7/2 standardised conv (then norm and ReLU in the non-preact form)
    and a 3x3/2 max pool.

    The "fixed" stem (BiT's) pads with zeros, not -inf, before a VALID pool,
    as timm's ``ConstantPad2d(1, 0.)`` does: a border window whose values are
    all negative maxes to 0 there. The "same" stem (the hybrids') pools
    under XLA SAME with -inf pads."""

    def __init__(self, in_channels: int, stem_type: str, stem_width: int,
                 conv_padding: str, preact: bool, act_layer: str,
                 norm_layer: str, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if stem_type not in ("fixed", "same"):
            raise ValueError(f"Unknown stem_type: {stem_type}")
        self.preact = preact
        self.stem_type = stem_type
        self.conv = _std_conv(in_channels, stem_width, 7, 2, conv_padding,
                              generator)
        self.norm = (None if preact
                     else norm_layer_factory(norm_layer)(stem_width))
        self.act = act_layer_factory(act_layer)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if not self.preact:
            x = self.act(self.norm(x))
        if self.stem_type == "fixed":
            x = F.pad(x, (0, 0, 1, 1, 1, 1))   # zeros around H and W of NHWC
            return max_pool_2d(x, 3, 2, padding="VALID")
        return max_pool_2d(x, 3, 2, padding="SAME")


class _Stage(nn.Module):
    def __init__(self, blocks):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)


class ResNetV2(Model):
    cfg_class = ResNetV2Config

    def __init__(self, cfg: ResNetV2Config, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg)
        g = generator
        stem_width = _make_divisible(cfg.stem_width * cfg.width_factor)
        self.stem = ResNetV2Stem(cfg.in_channels, cfg.stem_type, stem_width,
                                 cfg.conv_padding, cfg.preact, cfg.act_layer,
                                 cfg.norm_layer, generator=g)
        dpr = np.linspace(0.0, cfg.drop_path_rate, sum(cfg.nb_blocks))
        block_cls = PreActBottleneck if cfg.preact else Bottleneck
        stages = []
        in_ch, idx = stem_width, 0
        for j, depth in enumerate(cfg.nb_blocks):
            nb_channels = _make_divisible(cfg.nb_channels[j] * cfg.width_factor)
            blocks = []
            for k in range(depth):
                blocks.append(block_cls(
                    in_ch, nb_channels, stride=2 if (j > 0 and k == 0) else 1,
                    downsample=(k == 0), conv_padding=cfg.conv_padding,
                    act_layer=cfg.act_layer, norm_layer=cfg.norm_layer,
                    drop_path_rate=float(dpr[idx]), generator=g))
                in_ch = nb_channels
                idx += 1
            stages.append(_Stage(blocks))
        self.stages = nn.ModuleList(stages)
        self.nb_features = in_ch
        self.norm = (norm_layer_factory(cfg.norm_layer)(in_ch) if cfg.preact
                     else None)
        self.act = act_layer_factory(cfg.act_layer)
        self.head = (nn.ModuleDict({"fc": Dense(in_ch, cfg.nb_classes,
                                                generator=g)})
                     if cfg.nb_classes > 0 else None)

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x)
        capture_feature("stem", x)
        j = 0
        for stage in self.stages:
            for block in stage.blocks:
                x = block(x)
                capture_feature(f"block_{j}", x)
                j += 1
        if self.norm is not None:
            x = self.act(self.norm(x))
        capture_feature("features", x)
        return x

    def forward_head(self, x: torch.Tensor) -> torch.Tensor:
        ctx = current_context()
        x = global_pool_2d(x, self.cfg.global_pool)
        x = dropout(x, self.cfg.drop_rate, ctx.training, ctx.generator)
        if self.head is not None:
            x = self.head["fc"](x)
        capture_feature("logits", x)
        return x

    @property
    def feature_names(self):
        return tuple(["stem"]
                     + [f"block_{j}" for j in range(sum(self.cfg.nb_blocks))]
                     + ["features", "logits"])


# -- variant registrations ---------------------------------------------------
# The same variants, with the same configs, as
# tfimm_tpu/architectures/resnetv2.py.

def _register(name, **kwargs):
    def fn():
        return ResNetV2, ResNetV2Config(name=name, url="[timm]", **kwargs)

    fn.__name__ = name
    fn.__qualname__ = name
    fn.__module__ = __name__
    globals()[name] = fn
    register_model(fn)


for _blocks, _tag in [((3, 4, 6, 3), "50"), ((3, 4, 23, 3), "101"),
                      ((3, 8, 36, 3), "152")]:
    for _wf in (1, 2, 3, 4):
        _name = f"resnetv2_{_tag}x{_wf}_bitm"
        if _name in ("resnetv2_50x1_bitm", "resnetv2_50x3_bitm",
                     "resnetv2_101x1_bitm", "resnetv2_101x3_bitm",
                     "resnetv2_152x2_bitm", "resnetv2_152x4_bitm"):
            _size = (480, 480) if _name == "resnetv2_152x4_bitm" else (448, 448)
            _register(_name, input_size=_size, nb_blocks=_blocks,
                      width_factor=_wf, pool_size=_size[0] // 32, crop_pct=1.0)
            _register(f"{_name}_in21k", nb_classes=21843, nb_blocks=_blocks,
                      width_factor=_wf)
_register("resnetv2_50x1_bit_distilled", nb_blocks=(3, 4, 6, 3),
          width_factor=1, interpolation="bicubic")
_register("resnetv2_152x2_bit_teacher", nb_blocks=(3, 8, 36, 3),
          width_factor=2, interpolation="bicubic")
_register("resnetv2_152x2_bit_teacher_384", input_size=(384, 384),
          nb_blocks=(3, 8, 36, 3), width_factor=2, pool_size=12, crop_pct=1.0,
          interpolation="bicubic")
