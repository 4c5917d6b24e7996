"""EfficientNet family: MobileNetV2, EfficientNet B0-B8 and L2 (with
AdvProp and NoisyStudent), Edge-TPU, Lite and V2 (B0-B3, S/M/L/XL, 21k);
mirror of tfimm_tpu/architectures/efficientnet.py.

A generic trunk built from architecture strings with channel and depth
multipliers (``efficientnet_builder.py``) on NHWC maps. The "tf" variants
(``efficientnet_*``, the Edge-TPU ``es``/``em``/``el``, ``lite*`` and
``v2_*``) take XLA's SAME padding and BatchNorm eps 1e-3: a strided conv
on an even map pads (0, 1), which ``Conv2d`` does with ``F.pad`` before
cuDNN. The "pt" variants (``pt_efficientnet_*``, ``mobilenet_v2_*``)
take symmetric padding and eps 1e-5. Parameter names are timm's
(``conv_stem``, ``blocks.{i}.{j}.conv_pw``, ``conv_head``,
``classifier``). No TPU kernel is on this path.

Papers: EfficientNet https://arxiv.org/abs/1905.11946,
V2 2104.00298, MobileNetV2 1801.04381.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional, Tuple

import torch
import torch.nn as nn

from tfimm_tpu_torch.architectures.efficientnet_blocks import create_conv2d
from tfimm_tpu_torch.architectures.efficientnet_builder import (
    EfficientNetBuilder,
    decode_architecture,
    round_channels,
)
from tfimm_tpu_torch.core import capture_feature, current_context
from tfimm_tpu_torch.models.base import Model
from tfimm_tpu_torch.models.config import ModelConfig
from tfimm_tpu_torch.models.registry import register_model
from tfimm_tpu_torch.ops.basic import Dense, act_layer_factory
from tfimm_tpu_torch.ops.norm import norm_layer_factory
from tfimm_tpu_torch.ops.stochastic import dropout
from tfimm_tpu_torch.utils.constants import (
    IMAGENET_DEFAULT_MEAN,
    IMAGENET_DEFAULT_STD,
    IMAGENET_INCEPTION_MEAN,
    IMAGENET_INCEPTION_STD,
)

__all__ = ["EfficientNet", "EfficientNetConfig"]


@dataclass
class EfficientNetConfig(ModelConfig):
    nb_classes: int = 1000
    in_channels: int = 3
    input_size: Tuple[int, int] = (224, 224)
    stem_size: int = 32
    architecture: Tuple[Tuple[str, ...], ...] = ()
    channel_multiplier: float = 1.0
    depth_multiplier: float = 1.0
    fix_first_last: bool = False
    nb_features: int = 1280
    drop_rate: float = 0.0
    drop_path_rate: float = 0.0
    norm_layer: str = "batch_norm"
    act_layer: str = "swish"
    padding: str = "symmetric"  # "symmetric" (PT), "same" (TF), or "valid"
    crop_pct: float = 0.875
    interpolation: str = "bicubic"
    mean: Tuple[float, float, float] = IMAGENET_DEFAULT_MEAN
    std: Tuple[float, float, float] = IMAGENET_DEFAULT_STD
    first_conv: str = "conv_stem"
    classifier: str = "classifier"


class EfficientNet(Model):
    cfg_class = EfficientNetConfig

    def __init__(self, cfg: EfficientNetConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg)
        g = generator
        norm = norm_layer_factory(cfg.norm_layer)
        self.act = act_layer_factory(cfg.act_layer)

        self.conv_stem = create_conv2d(cfg.in_channels, cfg.stem_size, 3,
                                       strides=2, padding=cfg.padding,
                                       generator=g)
        self.bn1 = norm(cfg.stem_size)

        builder = EfficientNetBuilder(
            output_stride=32,
            channel_multiplier=cfg.channel_multiplier,
            padding=cfg.padding,
            act_layer=cfg.act_layer,
            norm_layer=cfg.norm_layer,
            drop_path_rate=cfg.drop_path_rate,
        )
        architecture = decode_architecture(
            architecture=cfg.architecture,
            depth_multiplier=cfg.depth_multiplier,
            depth_truncation="ceil",
            experts_multiplier=1,
            fix_first_last=cfg.fix_first_last,
            group_size=None,
        )
        blocks, trunk_channels = builder(architecture, cfg.stem_size,
                                         generator=g)
        # timm's blocks.{stage}.{block}; the features keep the JAX keys.
        self.block_names = tuple(blocks)
        self.blocks = nn.ModuleList(
            nn.ModuleList(blocks[f"stage_{i}/block_{j}"]
                          for j in range(len(stage)))
            for i, stage in enumerate(architecture))

        self.conv_head = create_conv2d(trunk_channels, cfg.nb_features, 1,
                                       padding=cfg.padding, generator=g)
        self.bn2 = norm(cfg.nb_features)
        self.nb_features = cfg.nb_features
        self.classifier = (Dense(cfg.nb_features, cfg.nb_classes, generator=g)
                           if cfg.nb_classes > 0 else None)

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        x = self.act(self.bn1(self.conv_stem(x)))
        capture_feature("stem", x)
        blocks = (block for stage in self.blocks for block in stage)
        for name, block in zip(self.block_names, blocks):
            x = block(x)
            capture_feature(name, x)
        x = self.act(self.bn2(self.conv_head(x)))
        capture_feature("conv_features", x)
        return x

    def forward_head(self, x: torch.Tensor) -> torch.Tensor:
        ctx = current_context()
        x = x.mean(dim=(1, 2))
        capture_feature("features", x)
        x = dropout(x, self.cfg.drop_rate, ctx.training, ctx.generator)
        if self.classifier is not None:
            x = self.classifier(x)
        capture_feature("logits", x)
        return x

    @property
    def feature_names(self):
        return tuple(["stem"] + list(self.block_names)
                     + ["conv_features", "features", "logits"])


# -- variant registrations ---------------------------------------------------
# The same variants, with the same configs, as
# tfimm_tpu/architectures/efficientnet.py.

def _register(name, cfg_fn):
    def fn():
        return EfficientNet, cfg_fn()

    fn.__name__ = name
    fn.__qualname__ = name
    fn.__module__ = __name__
    globals()[name] = fn
    register_model(fn)


_MBV2_ARCH = (
    ("ds_r1_k3_s1_c16",),
    ("ir_r2_k3_s2_e6_c24",),
    ("ir_r3_k3_s2_e6_c32",),
    ("ir_r4_k3_s2_e6_c64",),
    ("ir_r3_k3_s1_e6_c96",),
    ("ir_r3_k3_s2_e6_c160",),
    ("ir_r1_k3_s1_e6_c320",),
)

_ENET_ARCH = (
    ("ds_r1_k3_s1_e1_c16_se0.25",),
    ("ir_r2_k3_s2_e6_c24_se0.25",),
    ("ir_r2_k5_s2_e6_c40_se0.25",),
    ("ir_r3_k3_s2_e6_c80_se0.25",),
    ("ir_r3_k5_s1_e6_c112_se0.25",),
    ("ir_r4_k5_s2_e6_c192_se0.25",),
    ("ir_r1_k3_s1_e6_c320_se0.25",),
)

_LITE_ARCH = (
    ("ds_r1_k3_s1_e1_c16",),
    ("ir_r2_k3_s2_e6_c24",),
    ("ir_r2_k5_s2_e6_c40",),
    ("ir_r3_k3_s2_e6_c80",),
    ("ir_r3_k5_s1_e6_c112",),
    ("ir_r4_k5_s2_e6_c192",),
    ("ir_r1_k3_s1_e6_c320",),
)

_EDGE_ARCH = (
    ("er_r1_k3_s1_e4_c24_fc24_noskip",),
    ("er_r2_k3_s2_e8_c32",),
    ("er_r4_k3_s2_e8_c48",),
    ("ir_r5_k5_s2_e8_c96",),
    ("ir_r4_k5_s1_e8_c144",),
    ("ir_r2_k5_s2_e8_c192",),
)

_ENET_PARAMS = {  # (channel_mult, depth_mult, drop_rate)
    "b0": (1.0, 1.0, 0.2), "b1": (1.0, 1.1, 0.2), "b2": (1.1, 1.2, 0.3),
    "b3": (1.2, 1.4, 0.3), "b4": (1.4, 1.8, 0.4), "b5": (1.6, 2.2, 0.4),
    "b6": (1.8, 2.6, 0.5), "b7": (2.0, 3.1, 0.5), "b8": (2.2, 3.6, 0.5),
    "l2": (4.3, 5.3, 0.5),
}


def _mobilenet_v2_cfg(name, timm_name, channel_multiplier=1.0,
                      depth_multiplier=1.0, fix_stem_head=False,
                      crop_pct=0.875):
    rc = partial(round_channels, multiplier=channel_multiplier)
    return EfficientNetConfig(
        name=name, url="[timm]" + timm_name,
        stem_size=32 if fix_stem_head else rc(32),
        architecture=_MBV2_ARCH,
        channel_multiplier=channel_multiplier,
        depth_multiplier=depth_multiplier,
        fix_first_last=fix_stem_head,
        nb_features=1280 if fix_stem_head else max(1280, rc(1280)),
        norm_layer="batch_norm", act_layer="relu6", crop_pct=crop_pct,
    )


def _efficientnet_cfg(name, timm_name, variant, input_size, framework,
                      crop_pct, mean=IMAGENET_DEFAULT_MEAN,
                      std=IMAGENET_DEFAULT_STD):
    cm, dm, drop = _ENET_PARAMS[variant]
    return EfficientNetConfig(
        name=name, url="[timm]" + timm_name, input_size=input_size,
        stem_size=round_channels(32, multiplier=cm),
        architecture=_ENET_ARCH, channel_multiplier=cm, depth_multiplier=dm,
        nb_features=round_channels(1280, multiplier=cm),
        drop_rate=drop, drop_path_rate=drop,
        norm_layer="batch_norm_tf" if framework == "tf" else "batch_norm",
        act_layer="swish",
        padding="same" if framework == "tf" else "symmetric",
        crop_pct=crop_pct, mean=mean, std=std,
    )


def _efficientnet_edge_cfg(name, timm_name, variant, input_size, crop_pct):
    params = {"es": (1.0, 1.0, 0.2), "em": (1.0, 1.1, 0.2), "el": (1.2, 1.4, 0.3)}
    cm, dm, drop = params[variant]
    return EfficientNetConfig(
        name=name, url="[timm]" + timm_name, input_size=input_size,
        stem_size=round_channels(32, multiplier=cm),
        architecture=_EDGE_ARCH, channel_multiplier=cm, depth_multiplier=dm,
        nb_features=round_channels(1280, multiplier=cm),
        drop_rate=drop, drop_path_rate=drop, norm_layer="batch_norm_tf",
        act_layer="relu", padding="same", crop_pct=crop_pct,
        mean=IMAGENET_INCEPTION_MEAN, std=IMAGENET_INCEPTION_STD,
    )


def _efficientnet_lite_cfg(name, timm_name, variant, crop_pct):
    params = {"lite0": (1.0, 1.0, 224, 0.2), "lite1": (1.0, 1.1, 240, 0.2),
              "lite2": (1.1, 1.2, 260, 0.3), "lite3": (1.2, 1.4, 280, 0.3),
              "lite4": (1.4, 1.8, 300, 0.3)}
    cm, dm, size, drop = params[variant]
    return EfficientNetConfig(
        name=name, url="[timm]" + timm_name, input_size=(size, size),
        stem_size=32, architecture=_LITE_ARCH, channel_multiplier=cm,
        depth_multiplier=dm, fix_first_last=True, nb_features=1280,
        drop_rate=drop, drop_path_rate=drop, norm_layer="batch_norm_tf",
        act_layer="relu6", padding="same", crop_pct=crop_pct,
        mean=IMAGENET_INCEPTION_MEAN, std=IMAGENET_INCEPTION_STD,
    )


def _efficientnet_v2_base_cfg(name, timm_name, variant, input_size, crop_pct):
    params = {"b0": (1.0, 1.0, 0.2), "b1": (1.0, 1.1, 0.2),
              "b2": (1.1, 1.2, 0.3), "b3": (1.2, 1.4, 0.3)}
    cm, dm, drop = params[variant]
    rc = partial(round_channels, multiplier=cm, round_limit=0.0)
    return EfficientNetConfig(
        name=name, url="[timm]" + timm_name, input_size=input_size,
        stem_size=rc(32),
        architecture=(
            ("cn_r1_k3_s1_e1_c16_skip",),
            ("er_r2_k3_s2_e4_c32",),
            ("er_r2_k3_s2_e4_c48",),
            ("ir_r3_k3_s2_e4_c96_se0.25",),
            ("ir_r5_k3_s1_e6_c112_se0.25",),
            ("ir_r8_k3_s2_e6_c192_se0.25",),
        ),
        channel_multiplier=cm, depth_multiplier=dm, nb_features=rc(1280),
        drop_rate=drop, drop_path_rate=drop, norm_layer="batch_norm_tf",
        act_layer="swish", padding="same", crop_pct=crop_pct,
    )


_V2_ARCHS = {
    "s": (24, 0.3, (300, 300), (
        ("cn_r2_k3_s1_e1_c24_skip",),
        ("er_r4_k3_s2_e4_c48",),
        ("er_r4_k3_s2_e4_c64",),
        ("ir_r6_k3_s2_e4_c128_se0.25",),
        ("ir_r9_k3_s1_e6_c160_se0.25",),
        ("ir_r15_k3_s2_e6_c256_se0.25",),
    )),
    "m": (24, 0.4, (384, 384), (
        ("cn_r3_k3_s1_e1_c24_skip",),
        ("er_r5_k3_s2_e4_c48",),
        ("er_r5_k3_s2_e4_c80",),
        ("ir_r7_k3_s2_e4_c160_se0.25",),
        ("ir_r14_k3_s1_e6_c176_se0.25",),
        ("ir_r18_k3_s2_e6_c304_se0.25",),
        ("ir_r5_k3_s1_e6_c512_se0.25",),
    )),
    "l": (32, 0.5, (384, 384), (
        ("cn_r4_k3_s1_e1_c32_skip",),
        ("er_r7_k3_s2_e4_c64",),
        ("er_r7_k3_s2_e4_c96",),
        ("ir_r10_k3_s2_e4_c192_se0.25",),
        ("ir_r19_k3_s1_e6_c224_se0.25",),
        ("ir_r25_k3_s2_e6_c384_se0.25",),
        ("ir_r7_k3_s1_e6_c640_se0.25",),
    )),
    "xl": (32, 0.5, (384, 384), (
        ("cn_r4_k3_s1_e1_c32_skip",),
        ("er_r8_k3_s2_e4_c64",),
        ("er_r8_k3_s2_e4_c96",),
        ("ir_r16_k3_s2_e4_c192_se0.25",),
        ("ir_r24_k3_s1_e6_c256_se0.25",),
        ("ir_r32_k3_s2_e6_c512_se0.25",),
        ("ir_r8_k3_s1_e6_c640_se0.25",),
    )),
}


def _efficientnet_v2_cfg(name, timm_name, variant, nb_classes=1000):
    stem, drop, input_size, arch = _V2_ARCHS[variant]
    return EfficientNetConfig(
        name=name, url="[timm]" + timm_name, nb_classes=nb_classes,
        input_size=input_size, stem_size=stem, architecture=arch,
        nb_features=1280, drop_rate=drop, drop_path_rate=drop,
        norm_layer="batch_norm_tf", act_layer="swish", padding="same",
        crop_pct=1.0, mean=IMAGENET_INCEPTION_MEAN, std=IMAGENET_INCEPTION_STD,
    )


# MobileNetV2
for _n, _kw in [("mobilenet_v2_050", dict(channel_multiplier=0.5)),
                ("mobilenet_v2_100", dict(channel_multiplier=1.0)),
                ("mobilenet_v2_140", dict(channel_multiplier=1.4)),
                ("mobilenet_v2_110d", dict(channel_multiplier=1.1,
                                           depth_multiplier=1.2,
                                           fix_stem_head=True)),
                ("mobilenet_v2_120d", dict(channel_multiplier=1.2,
                                           depth_multiplier=1.4,
                                           fix_stem_head=True))]:
    _register(_n, partial(_mobilenet_v2_cfg, _n,
                          _n.replace("mobilenet_v2", "mobilenetv2"), **_kw))

# EfficientNet B0-B8 (tf), AdvProp, NoisyStudent, L2, pt variants
_B_SIZES = {"b0": (224, 0.875), "b1": (240, 0.882), "b2": (260, 0.890),
            "b3": (300, 0.904), "b4": (380, 0.922), "b5": (456, 0.934),
            "b6": (528, 0.942), "b7": (600, 0.949), "b8": (672, 0.954)}
for _v, (_s, _c) in _B_SIZES.items():
    _register(f"efficientnet_{_v}",
              partial(_efficientnet_cfg, f"efficientnet_{_v}",
                      f"tf_efficientnet_{_v}", _v, (_s, _s), "tf", _c))
    _register(f"efficientnet_{_v}_ap",
              partial(_efficientnet_cfg, f"efficientnet_{_v}_ap",
                      f"tf_efficientnet_{_v}_ap", _v, (_s, _s), "tf", _c,
                      mean=IMAGENET_INCEPTION_MEAN, std=IMAGENET_INCEPTION_STD))
    if _v != "b8":
        _register(f"efficientnet_{_v}_ns",
                  partial(_efficientnet_cfg, f"efficientnet_{_v}_ns",
                          f"tf_efficientnet_{_v}_ns", _v, (_s, _s), "tf", _c))
_register("efficientnet_l2_ns_475",
          partial(_efficientnet_cfg, "efficientnet_l2_ns_475",
                  "tf_efficientnet_l2_ns_475", "l2", (475, 475), "tf", 0.936))
_register("efficientnet_l2_ns",
          partial(_efficientnet_cfg, "efficientnet_l2_ns",
                  "tf_efficientnet_l2_ns", "l2", (800, 800), "tf", 0.96))
for _v, _s, _c in [("b0", 224, 0.875), ("b1", 256, 1.0), ("b2", 256, 1.0),
                   ("b3", 288, 1.0), ("b4", 320, 1.0)]:
    _register(f"pt_efficientnet_{_v}",
              partial(_efficientnet_cfg, f"pt_efficientnet_{_v}",
                      f"efficientnet_{_v}", _v, (_s, _s), "pytorch", _c))

# Edge-TPU
for _v, _s, _c in [("es", 224, 0.875), ("em", 240, 0.882), ("el", 300, 0.904)]:
    _register(f"efficientnet_{_v}",
              partial(_efficientnet_edge_cfg, f"efficientnet_{_v}",
                      f"tf_efficientnet_{_v}", _v, (_s, _s), _c))

# Lite
for _v, _c in [("lite0", 0.875), ("lite1", 0.882), ("lite2", 0.890),
               ("lite3", 0.904), ("lite4", 0.920)]:
    _register(f"efficientnet_{_v}",
              partial(_efficientnet_lite_cfg, f"efficientnet_{_v}",
                      f"tf_efficientnet_{_v}", _v, _c))

# V2
for _v, _s, _c in [("b0", 192, 0.875), ("b1", 192, 0.882), ("b2", 208, 0.890),
                   ("b3", 240, 0.904)]:
    _register(f"efficientnet_v2_{_v}",
              partial(_efficientnet_v2_base_cfg, f"efficientnet_v2_{_v}",
                      f"tf_efficientnetv2_{_v}", _v, (_s, _s), _c))
for _v in ("s", "m", "l"):
    _register(f"efficientnet_v2_{_v}",
              partial(_efficientnet_v2_cfg, f"efficientnet_v2_{_v}",
                      f"tf_efficientnetv2_{_v}", _v))
    _register(f"efficientnet_v2_{_v}_in21ft1k",
              partial(_efficientnet_v2_cfg, f"efficientnet_v2_{_v}_in21ft1k",
                      f"tf_efficientnetv2_{_v}_in21ft1k", _v))
    _register(f"efficientnet_v2_{_v}_in21k",
              partial(_efficientnet_v2_cfg, f"efficientnet_v2_{_v}_in21k",
                      f"tf_efficientnetv2_{_v}_in21k", _v, nb_classes=21843))
_register("efficientnet_v2_xl_in21ft1k",
          partial(_efficientnet_v2_cfg, "efficientnet_v2_xl_in21ft1k",
                  "tf_efficientnetv2_xl_in21ft1k", "xl"))
_register("efficientnet_v2_xl_in21k",
          partial(_efficientnet_v2_cfg, "efficientnet_v2_xl_in21k",
                  "tf_efficientnetv2_xl_in21k", "xl", nb_classes=21843))
