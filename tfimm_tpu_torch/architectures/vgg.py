"""VGG; mirror of tfimm_tpu/architectures/vgg.py.

A layer-spec tuple of 3x3 convs (with or without BatchNorm) and 2x2 max
pools, then timm's ConvMlp pre-logits head (a 7x7 valid conv, then a 1x1
conv) and a pooled classifier. Parameter names are timm's
(``features.{n}``, ``pre_logits.fc1``, ``head.fc``). The 3x3 and 7x7 convs
run on cuDNN (``ops/conv.py``); no TPU kernel is on this path.

Paper: https://arxiv.org/abs/1409.1556.
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
from tfimm_tpu_torch.ops.basic import act_layer_factory
from tfimm_tpu_torch.ops.classifier import ClassifierHead
from tfimm_tpu_torch.ops.conv import Conv2d
from tfimm_tpu_torch.ops.norm import norm_layer_factory
from tfimm_tpu_torch.ops.pool import max_pool_2d
from tfimm_tpu_torch.ops.stochastic import dropout
from tfimm_tpu_torch.utils.constants import (
    IMAGENET_DEFAULT_MEAN,
    IMAGENET_DEFAULT_STD,
)

__all__ = ["VGG", "VGGConfig"]


@dataclass
class VGGConfig(ModelConfig):
    nb_classes: int = 1000
    in_channels: int = 3
    input_size: Tuple[int, int] = (224, 224)
    layers: Tuple = ()
    nb_features: int = 4096
    mlp_ratio: float = 1.0
    global_pool: str = "avg"
    drop_rate: float = 0.0
    norm_layer: str = ""
    act_layer: str = "relu"
    crop_pct: float = 0.875
    interpolation: str = "bilinear"
    mean: Tuple[float, float, float] = IMAGENET_DEFAULT_MEAN
    std: Tuple[float, float, float] = IMAGENET_DEFAULT_STD
    first_conv: str = "features.0"
    classifier: str = "head.fc"


class VGG(Model):
    cfg_class = VGGConfig

    def __init__(self, cfg: VGGConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg)
        g = generator
        self.act = act_layer_factory(cfg.act_layer)
        norm = norm_layer_factory(cfg.norm_layer)
        # features.{n} as timm numbers its Sequential: a conv, its norm (with
        # a norm layer), its activation; or a pool. ``self.layers``: one
        # (kind, conv key, norm key) a layer of the spec.
        self.features = nn.ModuleDict()
        self.layers = []
        in_ch, idx = cfg.in_channels, 0
        for v in cfg.layers:
            if v == "M":
                self.layers.append(("pool", None, None))
                idx += 1
                continue
            self.features[str(idx)] = Conv2d(in_ch, v, 3, stride=1, padding=1,
                                             generator=g)
            norm_key = None
            if cfg.norm_layer:
                norm_key = str(idx + 1)
                self.features[norm_key] = norm(v)
            self.layers.append(("conv", str(idx), norm_key))
            idx += 3 if cfg.norm_layer else 2
            in_ch = v
        hidden = int(cfg.nb_features * cfg.mlp_ratio)
        self.pre_logits = nn.ModuleDict({
            "fc1": Conv2d(in_ch, hidden, 7, stride=1, padding="valid",
                          generator=g),
            "fc2": Conv2d(hidden, cfg.nb_features, 1, generator=g)})
        self.head = ClassifierHead(cfg.nb_classes, cfg.nb_features,
                                   pool_type=cfg.global_pool,
                                   drop_rate=cfg.drop_rate, generator=g)

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        ctx = current_context()
        for j, (kind, conv_key, norm_key) in enumerate(self.layers):
            if kind == "pool":
                x = max_pool_2d(x, 2, 2)
            else:
                x = self.features[conv_key](x)
                if norm_key is not None:
                    x = self.features[norm_key](x)
                x = self.act(x)
            capture_feature(f"layer_{j}", x)
        x = self.act(self.pre_logits["fc1"](x))
        x = dropout(x, self.cfg.drop_rate, ctx.training, ctx.generator)
        x = self.act(self.pre_logits["fc2"](x))
        capture_feature("features", x)
        return x

    def forward_head(self, x: torch.Tensor) -> torch.Tensor:
        x = self.head(x)
        capture_feature("logits", x)
        return x

    @property
    def feature_names(self):
        return tuple([f"layer_{j}" for j in range(len(self.cfg.layers))]
                     + ["features", "logits"])


# -- variant registrations ---------------------------------------------------
# The same variants, with the same configs, as tfimm_tpu/architectures/vgg.py.

def _register(name, **kwargs):
    def fn():
        return VGG, VGGConfig(name=name, url="[timm]", **kwargs)

    fn.__name__ = name
    fn.__qualname__ = name
    fn.__module__ = __name__
    globals()[name] = fn
    register_model(fn)


_LAYERS = {
    "vgg11": (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "vgg13": (64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
              512, 512, "M"),
    "vgg16": (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
              "M", 512, 512, 512, "M"),
    "vgg19": (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M"),
}

for _n, _l in _LAYERS.items():
    _register(_n, layers=_l)
    _register(f"{_n}_bn", layers=_l, norm_layer="batch_norm")
