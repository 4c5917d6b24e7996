"""ResNet, ResNeXt, SE-ResNeXt, ECA-ResNet, ResNet-RS and Wide-ResNet;
mirror of tfimm_tpu/architectures/resnet.py.

Basic and bottleneck blocks on NHWC maps, with cardinality and base width
(ResNeXt, Wide), squeeze-excite or ECA channel attention, blur-pool
anti-aliasing, deep and deep-tiered stems, conv or average-pool
downsampling and ResNet-RS's conv stem pool. Parameter names are timm's
(``conv1``, ``layer1.0.conv1``, ``layer1.0.downsample.0``, ``fc``), so a
timm state dict loads with ``load_state_dict``. The convs that are not a
reshape of the image (3x3, 7x7, strided, grouped) run on cuDNN
(``ops/conv.py``); no TPU kernel is on this path, and none on the port's.

Papers: ResNet https://arxiv.org/abs/1512.03385, ResNeXt 1611.05431,
SE 1709.01507, ECA 1910.03151, ResNet-RS 2103.07579.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from tfimm_tpu_torch.core import capture_feature, current_context
from tfimm_tpu_torch.models.base import Model
from tfimm_tpu_torch.models.config import ModelConfig
from tfimm_tpu_torch.models.registry import register_model
from tfimm_tpu_torch.ops.basic import Dense, act_layer_factory
from tfimm_tpu_torch.ops.classifier import global_pool_2d
from tfimm_tpu_torch.ops.conv import Conv2d
from tfimm_tpu_torch.ops.norm import norm_layer_factory
from tfimm_tpu_torch.ops.pool import BlurPool2d, avg_pool_2d
from tfimm_tpu_torch.ops.se import attn_layer_factory
from tfimm_tpu_torch.ops.stochastic import drop_path, dropout
from tfimm_tpu_torch.utils.constants import (
    IMAGENET_DEFAULT_MEAN,
    IMAGENET_DEFAULT_STD,
)

__all__ = ["ResNet", "ResNetConfig", "BasicBlock", "Bottleneck"]


@dataclass
class ResNetConfig(ModelConfig):
    nb_classes: int = 1000
    in_channels: int = 3
    input_size: Tuple[int, int] = (224, 224)
    # Residual blocks
    block: str = "basic_block"
    nb_blocks: Tuple = (2, 2, 2, 2)
    nb_channels: Tuple = (64, 128, 256, 512)
    cardinality: int = 1  # Number of groups in bottleneck conv
    base_width: int = 64  # Determines number of channels in block
    downsample_mode: str = "conv"
    zero_init_last_bn: bool = True
    # Stem
    stem_width: int = 64
    stem_type: str = ""
    replace_stem_pool: bool = False
    # Other params
    block_reduce_first: int = 1
    down_kernel_size: int = 1
    act_layer: str = "relu"
    norm_layer: str = "batch_norm"
    aa_layer: str = ""
    attn_layer: str = ""
    se_ratio: float = 0.0625
    # Regularization
    drop_rate: float = 0.0
    drop_path_rate: float = 0.0
    # Head
    global_pool: str = "avg"
    # Parameters for inference
    test_input_size: Optional[Tuple[int, int]] = None
    pool_size: int = 7
    crop_pct: float = 0.875
    interpolation: str = "bilinear"
    # Preprocessing
    mean: Tuple[float, float, float] = IMAGENET_DEFAULT_MEAN
    std: Tuple[float, float, float] = IMAGENET_DEFAULT_STD
    # Weight transfer
    first_conv: str = "conv1"
    classifier: str = "fc"

    def __post_init__(self):
        if self.test_input_size is None:
            self.test_input_size = self.input_size


def _max_pool_pt(x: torch.Tensor, pool_size: int, stride: int,
                 padding: int) -> torch.Tensor:
    """PyTorch's max pool of (B, H, W, C), -inf padding on both sides."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), pool_size, stride, padding)
    return y.permute(0, 2, 3, 1)


def _zero_last_norm(norm: nn.Module) -> None:
    """``zero_init_last_bn``: the block's last norm scale starts at zero."""
    if getattr(norm, "weight", None) is not None:
        with torch.no_grad():
            norm.weight.zero_()


class _Downsample(nn.ModuleDict):
    """Shortcut projection, timm's keys: conv mode {"0": conv, "1": norm};
    avg mode {"1": conv, "2": norm} after a 2x2 SAME average pool (no
    parameters, timm's index 0)."""

    def __init__(self, cfg: ResNetConfig, in_channels: int, out_channels: int,
                 stride: int, generator: Optional[torch.Generator]):
        super().__init__()
        norm = norm_layer_factory(cfg.norm_layer)
        self.mode = cfg.downsample_mode
        self.stride = stride
        if self.mode == "avg":
            self["1"] = Conv2d(in_channels, out_channels, 1, use_bias=False,
                               generator=generator)
            self["2"] = norm(out_channels)
        elif self.mode == "conv":
            k = cfg.down_kernel_size
            self["0"] = Conv2d(in_channels, out_channels, k, stride=stride,
                               padding=(stride + k) // 2 - 1, use_bias=False,
                               generator=generator)
            self["1"] = norm(out_channels)
        else:
            raise ValueError(f"Unknown downsample mode: {self.mode}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "avg":
            if self.stride != 1:
                x = avg_pool_2d(x, 2, self.stride, padding="SAME")
            return self["2"](self["1"](x))
        return self["1"](self["0"](x))


class _Block(nn.Module):
    """What both blocks share: the attention, drop path, shortcut and the
    residual's activation."""

    def _attention(self, cfg: ResNetConfig, out_planes: int, in_channels: int,
                   stride: int, drop_path_rate: float,
                   generator: Optional[torch.Generator]) -> None:
        attn = attn_layer_factory(cfg.attn_layer)
        kw = {"rd_ratio": cfg.se_ratio} if cfg.attn_layer == "se" else {}
        self.se = attn(out_planes, generator=generator, **kw)
        self.drop_path_rate = drop_path_rate
        self.downsample = (
            _Downsample(cfg, in_channels, out_planes, stride, generator)
            if stride != 1 or in_channels != out_planes else None)

    def _residual(self, x: torch.Tensor, shortcut: torch.Tensor) -> torch.Tensor:
        ctx = current_context()
        if self.se is not None:
            x = self.se(x)
        x = drop_path(x, self.drop_path_rate, ctx.training, ctx.generator)
        if self.downsample is not None:
            shortcut = self.downsample(shortcut)
        return self.act(x + shortcut)


class BasicBlock(_Block):
    expansion = 1

    def __init__(self, cfg: ResNetConfig, in_channels: int, nb_channels: int,
                 stride: int, drop_path_rate: float, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        assert cfg.cardinality == 1, "BasicBlock only supports cardinality 1"
        assert cfg.base_width == 64, "BasicBlock does not support base_width"
        g = generator
        self.act = act_layer_factory(cfg.act_layer)
        norm = norm_layer_factory(cfg.norm_layer)
        first_planes = nb_channels // cfg.block_reduce_first
        out_planes = nb_channels * self.expansion
        use_aa = bool(cfg.aa_layer) and stride == 2
        self.conv1 = Conv2d(in_channels, first_planes, 3,
                            stride=1 if use_aa else stride, padding=1,
                            use_bias=False, generator=g)
        self.bn1 = norm(first_planes)
        self.aa = BlurPool2d(first_planes, stride=stride) if use_aa else None
        self.conv2 = Conv2d(first_planes, out_planes, 3, stride=1, padding=1,
                            use_bias=False, generator=g)
        self.bn2 = norm(out_planes)
        if cfg.zero_init_last_bn:
            _zero_last_norm(self.bn2)
        self._attention(cfg, out_planes, in_channels, stride, drop_path_rate, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        x = self.act(self.bn1(self.conv1(x)))
        if self.aa is not None:
            x = self.aa(x)
        x = self.bn2(self.conv2(x))
        return self._residual(x, shortcut)


class Bottleneck(_Block):
    expansion = 4

    def __init__(self, cfg: ResNetConfig, in_channels: int, nb_channels: int,
                 stride: int, drop_path_rate: float, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.act = act_layer_factory(cfg.act_layer)
        norm = norm_layer_factory(cfg.norm_layer)
        width = int(math.floor(nb_channels * (cfg.base_width / 64))
                    * cfg.cardinality)
        first_planes = width // cfg.block_reduce_first
        out_planes = nb_channels * self.expansion
        use_aa = bool(cfg.aa_layer) and stride == 2
        self.conv1 = Conv2d(in_channels, first_planes, 1, use_bias=False,
                            generator=g)
        self.bn1 = norm(first_planes)
        self.conv2 = Conv2d(first_planes, width, 3,
                            stride=1 if use_aa else stride, padding=1,
                            groups=cfg.cardinality, use_bias=False, generator=g)
        self.bn2 = norm(width)
        self.aa = BlurPool2d(width, stride=stride) if use_aa else None
        self.conv3 = Conv2d(width, out_planes, 1, use_bias=False, generator=g)
        self.bn3 = norm(out_planes)
        if cfg.zero_init_last_bn:
            _zero_last_norm(self.bn3)
        self._attention(cfg, out_planes, in_channels, stride, drop_path_rate, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        x = self.act(self.bn1(self.conv1(x)))
        x = self.act(self.bn2(self.conv2(x)))
        if self.aa is not None:
            x = self.aa(x)
        x = self.bn3(self.conv3(x))
        return self._residual(x, shortcut)


class ResNet(Model):
    cfg_class = ResNetConfig

    def __init__(self, cfg: ResNetConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg)
        g = generator
        self.act = act_layer_factory(cfg.act_layer)
        norm = norm_layer_factory(cfg.norm_layer)

        # Stem: one 7x7 conv, or timm's Sequential of three 3x3 convs with
        # norms and activations between them (keys 0, 1, 3, 4, 6).
        self.deep_stem = cfg.stem_type in {"deep", "deep_tiered"}
        if self.deep_stem:
            stem_out = cfg.stem_width * 2
            if cfg.stem_type == "deep_tiered":
                chns = (3 * (cfg.stem_width // 4), cfg.stem_width)
            else:
                chns = (cfg.stem_width, cfg.stem_width)
            self.conv1 = nn.ModuleDict({
                "0": Conv2d(cfg.in_channels, chns[0], 3, stride=2, padding=1,
                            use_bias=False, generator=g),
                "1": norm(chns[0]),
                "3": Conv2d(chns[0], chns[1], 3, stride=1, padding=1,
                            use_bias=False, generator=g),
                "4": norm(chns[1]),
                "6": Conv2d(chns[1], stem_out, 3, stride=1, padding=1,
                            use_bias=False, generator=g)})
        else:
            stem_out = 64
            self.conv1 = Conv2d(cfg.in_channels, stem_out, 7, stride=2,
                                padding=3, use_bias=False, generator=g)
        self.bn1 = norm(stem_out)
        # Stem pool: ResNet-RS's strided conv, or a max pool (blurred with
        # ``aa_layer``).
        self.maxpool = (
            nn.ModuleDict({"0": Conv2d(stem_out, stem_out, 3, stride=2,
                                       padding=1, use_bias=False, generator=g),
                           "1": norm(stem_out)})
            if cfg.replace_stem_pool else None)
        self.stem_aa = (BlurPool2d(stem_out, stride=2)
                        if cfg.aa_layer and not cfg.replace_stem_pool else None)

        block_cls = BasicBlock if cfg.block == "basic_block" else Bottleneck
        total = sum(cfg.nb_blocks)
        in_ch, block_idx = stem_out, 0
        for idx in range(4):
            blocks = []
            for j in range(cfg.nb_blocks[idx]):
                stride = 1 if idx == 0 or j > 0 else 2
                dpr = cfg.drop_path_rate * block_idx / max(total - 1, 1)
                blocks.append(block_cls(cfg, in_ch, cfg.nb_channels[idx],
                                        stride, dpr, generator=g))
                in_ch = cfg.nb_channels[idx] * block_cls.expansion
                block_idx += 1
            self.add_module(f"layer{idx + 1}", nn.ModuleList(blocks))
        self.nb_features = in_ch
        self.fc = (Dense(in_ch, cfg.nb_classes, generator=g)
                   if cfg.nb_classes > 0 else None)

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        if self.deep_stem:
            c = self.conv1
            x = self.act(c["1"](c["0"](x)))
            x = self.act(c["4"](c["3"](x)))
            x = c["6"](x)
        else:
            x = self.conv1(x)
        x = self.act(self.bn1(x))
        if self.maxpool is not None:
            return self.act(self.maxpool["1"](self.maxpool["0"](x)))
        if self.stem_aa is not None:
            return self.stem_aa(_max_pool_pt(x, 3, stride=1, padding=1))
        return _max_pool_pt(x, 3, stride=2, padding=1)

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x)
        capture_feature("stem", x)
        j = 0
        for idx in range(4):
            for block in getattr(self, f"layer{idx + 1}"):
                x = block(x)
                capture_feature(f"block_{j}", x)
                j += 1
        capture_feature("features", x)
        return x

    def forward_head(self, x: torch.Tensor) -> torch.Tensor:
        ctx = current_context()
        x = global_pool_2d(x, self.cfg.global_pool)
        x = dropout(x, self.cfg.drop_rate, ctx.training, ctx.generator)
        if self.fc is not None:
            x = self.fc(x)
        capture_feature("logits", x)
        return x

    @property
    def feature_names(self):
        return tuple(["stem"]
                     + [f"block_{j}" for j in range(sum(self.cfg.nb_blocks))]
                     + ["features", "logits"])


# -- variant registrations ---------------------------------------------------
# The same variants, with the same configs, as
# tfimm_tpu/architectures/resnet.py.

def _register(name, **kwargs):
    def fn():
        return ResNet, ResNetConfig(name=name, url="[timm]", **kwargs)

    fn.__name__ = name
    fn.__qualname__ = name
    fn.__module__ = __name__
    globals()[name] = fn
    register_model(fn)


_DEEP = dict(stem_width=32, stem_type="deep", downsample_mode="avg",
             interpolation="bicubic", first_conv="conv1.0")
_TIERED = dict(stem_width=32, stem_type="deep_tiered", downsample_mode="avg",
               interpolation="bicubic", first_conv="conv1.0")
_RS = dict(stem_type="deep", stem_width=32, replace_stem_pool=True,
           downsample_mode="avg", attn_layer="se", se_ratio=0.25,
           interpolation="bicubic", first_conv="conv1.0")

_register("resnet18", block="basic_block", nb_blocks=(2, 2, 2, 2))
_register("resnet18d", block="basic_block", nb_blocks=(2, 2, 2, 2), **_DEEP)
_register("resnet26", block="bottleneck", nb_blocks=(2, 2, 2, 2),
          interpolation="bicubic")
_register("resnet26d", block="bottleneck", nb_blocks=(2, 2, 2, 2), **_DEEP)
_register("resnet26t", block="bottleneck", nb_blocks=(2, 2, 2, 2),
          input_size=(256, 256), pool_size=8, crop_pct=0.94, **_TIERED)
_register("resnet34", block="basic_block", nb_blocks=(3, 4, 6, 3))
_register("resnet34d", block="basic_block", nb_blocks=(3, 4, 6, 3), **_DEEP)
_register("resnet50", block="bottleneck", nb_blocks=(3, 4, 6, 3),
          interpolation="bicubic", crop_pct=0.95)
_register("resnet50d", block="bottleneck", nb_blocks=(3, 4, 6, 3), **_DEEP)
_register("resnet101", block="bottleneck", nb_blocks=(3, 4, 23, 3),
          interpolation="bicubic", crop_pct=0.95)
_register("resnet101d", block="bottleneck", nb_blocks=(3, 4, 23, 3),
          input_size=(256, 256), pool_size=8, test_input_size=(320, 320),
          crop_pct=1.0, **_DEEP)
_register("resnet152", block="bottleneck", nb_blocks=(3, 8, 36, 3),
          interpolation="bicubic", crop_pct=0.95)
_register("resnet152d", block="bottleneck", nb_blocks=(3, 8, 36, 3),
          input_size=(256, 256), pool_size=8, test_input_size=(320, 320),
          crop_pct=1.0, **_DEEP)
_register("resnet200d", block="bottleneck", nb_blocks=(3, 24, 36, 3),
          input_size=(256, 256), pool_size=8, test_input_size=(320, 320),
          crop_pct=1.0, **_DEEP)
_register("tv_resnet34", block="basic_block", nb_blocks=(3, 4, 6, 3))
_register("tv_resnet50", block="bottleneck", nb_blocks=(3, 4, 6, 3))
_register("tv_resnet101", block="bottleneck", nb_blocks=(3, 4, 23, 3))
_register("tv_resnet152", block="bottleneck", nb_blocks=(3, 8, 36, 3))
_register("wide_resnet50_2", block="bottleneck", nb_blocks=(3, 4, 6, 3),
          base_width=128, interpolation="bicubic")
_register("wide_resnet101_2", block="bottleneck", nb_blocks=(3, 4, 23, 3),
          base_width=128)
_register("resnet50_gn", block="bottleneck", nb_blocks=(3, 4, 6, 3),
          norm_layer="group_norm", crop_pct=0.94, interpolation="bicubic")
_register("resnext50_32x4d", block="bottleneck", nb_blocks=(3, 4, 6, 3),
          cardinality=32, base_width=4, crop_pct=0.95, interpolation="bicubic")
_register("resnext50d_32x4d", block="bottleneck", nb_blocks=(3, 4, 6, 3),
          cardinality=32, base_width=4, **_DEEP)
_register("resnext101_32x8d", block="bottleneck", nb_blocks=(3, 4, 23, 3),
          cardinality=32, base_width=8)
_register("tv_resnext50_32x4d", block="bottleneck", nb_blocks=(3, 4, 6, 3),
          cardinality=32, base_width=4)
for _w in (8, 16, 32, 48):
    _register(f"ig_resnext101_32x{_w}d", block="bottleneck",
              nb_blocks=(3, 4, 23, 3), cardinality=32, base_width=_w)
for _prefix in ("ssl", "swsl"):
    _register(f"{_prefix}_resnet18", block="basic_block", nb_blocks=(2, 2, 2, 2))
    _register(f"{_prefix}_resnet50", block="bottleneck", nb_blocks=(3, 4, 6, 3))
    _register(f"{_prefix}_resnext50_32x4d", block="bottleneck",
              nb_blocks=(3, 4, 6, 3), cardinality=32, base_width=4)
    for _w in (4, 8, 16):
        _register(f"{_prefix}_resnext101_32x{_w}d", block="bottleneck",
                  nb_blocks=(3, 4, 23, 3), cardinality=32, base_width=_w)
_register("ecaresnet26t", block="bottleneck", nb_blocks=(2, 2, 2, 2),
          input_size=(256, 256), attn_layer="eca", test_input_size=(320, 320),
          pool_size=8, crop_pct=0.95, **_TIERED)
_register("ecaresnet50d", block="bottleneck", nb_blocks=(3, 4, 6, 3),
          attn_layer="eca", **_DEEP)
_register("ecaresnet50t", block="bottleneck", nb_blocks=(3, 4, 6, 3),
          attn_layer="eca", test_input_size=(320, 320), pool_size=8,
          crop_pct=0.95, **_TIERED)
_register("ecaresnetlight", block="bottleneck", nb_blocks=(1, 1, 11, 3),
          stem_width=32, downsample_mode="avg", attn_layer="eca",
          interpolation="bicubic")
_register("ecaresnet101d", block="bottleneck", nb_blocks=(3, 4, 23, 3),
          attn_layer="eca", **_DEEP)
_register("ecaresnet269d", block="bottleneck", nb_blocks=(3, 30, 48, 8),
          input_size=(320, 320), attn_layer="eca", test_input_size=(352, 352),
          pool_size=10, crop_pct=1.0, **_DEEP)
_register("resnetblur50", block="bottleneck", nb_blocks=(3, 4, 6, 3),
          aa_layer="blur_pool", interpolation="bicubic")
_register("resnetrs50", block="bottleneck", nb_blocks=(3, 4, 6, 3),
          input_size=(160, 160), test_input_size=(224, 224), pool_size=5,
          crop_pct=0.91, **_RS)
_register("resnetrs101", block="bottleneck", nb_blocks=(3, 4, 23, 3),
          input_size=(192, 192), test_input_size=(288, 288), pool_size=6,
          crop_pct=0.94, **_RS)
_register("resnetrs152", block="bottleneck", nb_blocks=(3, 8, 36, 3),
          input_size=(256, 256), test_input_size=(320, 320), pool_size=8,
          crop_pct=1.0, **_RS)
_register("resnetrs200", block="bottleneck", nb_blocks=(3, 24, 36, 3),
          input_size=(256, 256), test_input_size=(320, 320), pool_size=8,
          crop_pct=1.0, **_RS)
_register("resnetrs270", block="bottleneck", nb_blocks=(4, 29, 53, 4),
          input_size=(256, 256), test_input_size=(352, 352), pool_size=8,
          crop_pct=1.0, **_RS)
_register("resnetrs350", block="bottleneck", nb_blocks=(4, 36, 72, 4),
          input_size=(288, 288), test_input_size=(384, 384), pool_size=9,
          crop_pct=1.0, **_RS)
_register("resnetrs420", block="bottleneck", nb_blocks=(4, 44, 87, 4),
          input_size=(320, 320), test_input_size=(416, 416), pool_size=10,
          crop_pct=1.0, **_RS)
_register("seresnet50", block="bottleneck", nb_blocks=(3, 4, 6, 3),
          attn_layer="se", interpolation="bicubic")
_register("seresnet152d", block="bottleneck", nb_blocks=(3, 8, 36, 3),
          input_size=(256, 256), attn_layer="se", test_input_size=(320, 320),
          pool_size=8, crop_pct=1.0, **_DEEP)
_register("seresnext26d_32x4d", block="bottleneck", nb_blocks=(2, 2, 2, 2),
          cardinality=32, base_width=4, attn_layer="se", **_DEEP)
_register("seresnext26t_32x4d", block="bottleneck", nb_blocks=(2, 2, 2, 2),
          cardinality=32, base_width=4, attn_layer="se", **_TIERED)
_register("seresnext50_32x4d", block="bottleneck", nb_blocks=(3, 4, 6, 3),
          cardinality=32, base_width=4, attn_layer="se", interpolation="bicubic")
