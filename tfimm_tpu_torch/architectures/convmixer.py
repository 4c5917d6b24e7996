"""ConvMixer; mirror of tfimm_tpu/architectures/convmixer.py.

A patchify stem, then blocks of a depthwise conv (with its activation and
BatchNorm) inside a residual, and a pointwise conv with its activation and
BatchNorm, on NHWC maps. Parameter names are timm's (``stem.0``,
``blocks.{j}.0.fn.0`` the depthwise conv, ``.0.fn.2`` its norm, ``.1`` the
pointwise conv, ``.3`` its norm, ``head``). The depthwise conv is the
grouped ``Conv2d`` with XLA's SAME padding on cuDNN; the stem and the
pointwise convs are reshapes into ``F.linear``. No TPU kernel is on this
path.

Paper: Patches Are All You Need?, https://arxiv.org/abs/2201.09792.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn as nn

from tfimm_tpu_torch.core import capture_feature
from tfimm_tpu_torch.models.base import Model
from tfimm_tpu_torch.models.config import ModelConfig
from tfimm_tpu_torch.models.registry import register_model
from tfimm_tpu_torch.ops.basic import Dense, act_layer_factory
from tfimm_tpu_torch.ops.conv import Conv2d
from tfimm_tpu_torch.ops.norm import norm_layer_factory
from tfimm_tpu_torch.utils.constants import (
    IMAGENET_DEFAULT_MEAN,
    IMAGENET_DEFAULT_STD,
)

__all__ = ["ConvMixer", "ConvMixerConfig"]


@dataclass
class ConvMixerConfig(ModelConfig):
    nb_classes: int = 1000
    in_channels: int = 3
    input_size: Tuple[int, int] = (224, 224)
    patch_size: Tuple[int, int] = (7, 7)
    embed_dim: int = 768
    depth: int = 32
    kernel_size: int = 9
    norm_layer: str = "batch_norm"
    act_layer: str = "gelu"
    crop_pct: float = 0.96
    interpolation: str = "bicubic"
    mean: Tuple[float, float, float] = IMAGENET_DEFAULT_MEAN
    std: Tuple[float, float, float] = IMAGENET_DEFAULT_STD
    first_conv: str = "stem.0"
    classifier: str = "head"


class ConvMixerBlock(nn.ModuleDict):
    """timm's ``Sequential(Residual(Sequential(dw, act, norm)), pw, act,
    norm)``: keys ``0.fn.0``, ``0.fn.2``, ``1``, ``3``."""

    def __init__(self, cfg: ConvMixerConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        norm = norm_layer_factory(cfg.norm_layer)
        dim = cfg.embed_dim
        self.act = act_layer_factory(cfg.act_layer)
        self["0"] = nn.ModuleDict({"fn": nn.ModuleDict({
            "0": Conv2d(dim, dim, cfg.kernel_size, stride=1, padding="same",
                        groups=dim, generator=generator),
            "2": norm(dim)})})
        self["1"] = Conv2d(dim, dim, 1, generator=generator)
        self["3"] = norm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fn = self["0"]["fn"]
        x = fn["2"](self.act(fn["0"](x))) + x
        return self["3"](self.act(self["1"](x)))


class ConvMixer(Model):
    cfg_class = ConvMixerConfig

    def __init__(self, cfg: ConvMixerConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg)
        g = generator
        self.nb_features = cfg.embed_dim
        self.act = act_layer_factory(cfg.act_layer)
        self.stem = nn.ModuleDict({
            "0": Conv2d(cfg.in_channels, cfg.embed_dim, cfg.patch_size,
                        stride=cfg.patch_size, padding="valid", generator=g),
            "2": norm_layer_factory(cfg.norm_layer)(cfg.embed_dim)})
        self.blocks = nn.ModuleList(ConvMixerBlock(cfg, generator=g)
                                    for _ in range(cfg.depth))
        self.head = (Dense(cfg.embed_dim, cfg.nb_classes, generator=g)
                     if cfg.nb_classes > 0 else None)

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem["2"](self.act(self.stem["0"](x)))
        capture_feature("stem", x)
        for j, block in enumerate(self.blocks):
            x = block(x)
            capture_feature(f"block_{j}", x)
        capture_feature("features_all", x)
        x = x.mean(dim=(1, 2))
        capture_feature("features", x)
        return x

    def forward_head(self, x: torch.Tensor) -> torch.Tensor:
        if self.head is not None:
            x = self.head(x)
        capture_feature("logits", x)
        return x

    @property
    def feature_names(self):
        return tuple(["stem"] + [f"block_{j}" for j in range(self.cfg.depth)]
                     + ["features_all", "features", "logits"])


# -- variant registrations ---------------------------------------------------
# The same variants, with the same configs, as
# tfimm_tpu/architectures/convmixer.py.

def _register(name, **kwargs):
    def fn():
        return ConvMixer, ConvMixerConfig(name=name, url="[timm]", **kwargs)

    fn.__name__ = name
    fn.__qualname__ = name
    fn.__module__ = __name__
    globals()[name] = fn
    register_model(fn)


_register("convmixer_768_32", patch_size=(7, 7), embed_dim=768, depth=32,
          kernel_size=7, act_layer="relu")
_register("convmixer_1024_20_ks9_p14", patch_size=(14, 14), embed_dim=1024,
          depth=20, kernel_size=9)
_register("convmixer_1536_20", patch_size=(7, 7), embed_dim=1536, depth=20,
          kernel_size=9)
