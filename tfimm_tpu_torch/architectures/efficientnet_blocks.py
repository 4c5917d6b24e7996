"""EfficientNet-family blocks and the block-definition string DSL; mirror
of tfimm_tpu/architectures/efficientnet_blocks.py.

Block strings such as ``"ir_r2_k3_s2_e6_c24_se0.25"`` decode into
``BlockArgs`` (type, repeats, kernel, stride, expansion, channels, SE
ratio, activation, skip), which build ``ConvBnAct``,
``DepthwiseSeparableConv``, ``InvertedResidual`` (MBConv) or
``EdgeResidual`` (FusedMBConv) on NHWC maps. Parameter names are timm's
(``conv_pw``, ``conv_dw``, ``conv_pwl``, ``conv_exp``,
``se.conv_reduce``, ``se.conv_expand``, ``bn1``-``bn3``). Every conv is
``ops/conv.py · Conv2d`` with the fan-out initialiser: the depthwise ones
(``groups`` = channels) and the strided or k > 1 ones on cuDNN, the 1x1
ones a reshape into ``F.linear``. No TPU kernel is on this path.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn as nn

from tfimm_tpu_torch.core import current_context
from tfimm_tpu_torch.ops.basic import act_layer_factory
from tfimm_tpu_torch.ops.conv import Conv2d
from tfimm_tpu_torch.ops.norm import norm_layer_factory
from tfimm_tpu_torch.ops.stochastic import drop_path
from tfimm_tpu_torch.utils.etc import make_divisible

__all__ = ["BlockArgs", "SqueezeExcite", "ConvBnAct", "DepthwiseSeparableConv",
           "InvertedResidual", "EdgeResidual", "create_conv2d"]


def create_conv2d(in_channels, filters=None, kernel_size=3, strides=1,
                  padding="symmetric", dilation_rate=1, nb_groups=1,
                  depthwise=False, *,
                  generator: Optional[torch.Generator] = None) -> Conv2d:
    """The family's conv: fan-out init, no bias; ``depthwise`` gives one
    filter per input channel."""
    if depthwise:
        filters, nb_groups = in_channels, in_channels
    return Conv2d(in_channels, filters, kernel_size, stride=strides,
                  padding=padding or "symmetric", dilation=dilation_rate,
                  groups=nb_groups, use_bias=False, fanout_init=True,
                  generator=generator)


@dataclass
class BlockArgs:
    """Arguments for one residual block, decoded from the string DSL."""

    block_type: str
    nb_repeats: int
    nb_experts: Optional[int]
    filters: int
    force_in_channels: Optional[int]
    exp_kernel_size: Tuple[int, int]
    dw_kernel_size: Tuple[int, int]
    pw_kernel_size: Tuple[int, int]
    stride: int
    padding: Optional[str]
    dilation_rate: int
    group_size: Optional[int]
    exp_ratio: float
    pw_act: bool
    use_se: bool
    se_ratio: float
    norm_layer: Optional[str]
    act_layer: Optional[str]
    skip_connection: bool
    drop_path_rate: float

    @staticmethod
    def decode(block_string: str) -> "BlockArgs":
        """Decode e.g. ``"ir_r2_k3_s2_e1_i32_o16_se0.25_noskip"``."""
        ops = block_string.split("_")
        options = {"block_type": ops[0]}
        for op in ops[1:]:
            if op == "noskip":
                options["skip"] = False
            elif op == "skip":
                options["skip"] = True
            elif op.startswith("n"):
                act_dict = {"re": "relu", "r6": "relu6", "hs": "hard_swish",
                            "sw": "swish", "mi": "mish"}
                options["n"] = act_dict[op[1:]]
            else:
                splits = re.split(r"(\d.*)", op)
                if len(splits) >= 2:
                    key, value = splits[:2]
                    options[key] = value

        skip = False if options["block_type"] == "dsa" else options.get("skip", True)
        if options["block_type"] != "er":
            exp_kernel_size = BlockArgs._parse_ksize(options.get("a", "1"))
            dw_kernel_size = BlockArgs._parse_ksize(options.get("k"))
        else:
            exp_kernel_size = BlockArgs._parse_ksize(options.get("k"))
            dw_kernel_size = (1, 1)

        return BlockArgs(
            block_type=options["block_type"],
            nb_repeats=int(options.get("r")),
            nb_experts=int(options.get("cc", 0)) or None,
            filters=int(options.get("c")),
            force_in_channels=int(options.get("fc", 0)) or None,
            exp_kernel_size=exp_kernel_size,
            dw_kernel_size=dw_kernel_size,
            pw_kernel_size=BlockArgs._parse_ksize(options.get("p", "1")),
            stride=int(options.get("s")),
            padding=None,
            dilation_rate=1,
            group_size=int(options["gs"]) if "gs" in options else None,
            exp_ratio=float(options.get("e", 1.0)),
            pw_act=options["block_type"] == "dsa",
            use_se=True,
            se_ratio=float(options.get("se", 0.0)),
            norm_layer=None,
            act_layer=options.get("n", None),
            skip_connection=skip,
            drop_path_rate=0.0,
        )

    @staticmethod
    def _parse_ksize(ss: str) -> Tuple[int, int]:
        if ss.isdigit():
            return int(ss), int(ss)
        a, b = ss.split(".")
        return int(a), int(b)

    @property
    def nb_groups(self):
        if not self.group_size:
            return 1
        assert self.filters % self.group_size == 0
        return self.filters // self.group_size


class SqueezeExcite(nn.Module):
    """SE of (B, H, W, C) maps with timm's EfficientNet names
    (``conv_reduce``, ``conv_expand``); the reduced width is Python's
    ``round(channels * rd_ratio)``, not ``ops/se.py``'s divisible one."""

    def __init__(self, channels: int, rd_ratio: float = 0.25,
                 act_layer: str = "relu", *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        rd_channels = round(channels * rd_ratio)
        self.conv_reduce = Conv2d(channels, rd_channels, 1, fanout_init=True,
                                  generator=generator)
        self.conv_expand = Conv2d(rd_channels, channels, 1, fanout_init=True,
                                  generator=generator)
        self.act = act_layer_factory(act_layer)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(1, 2), keepdim=True)
        s = self.act(self.conv_reduce(s))
        return x * torch.sigmoid(self.conv_expand(s))


class _Block(nn.Module):
    """What the four blocks share: the activation, the skip rule and the
    residual with drop path."""

    def _common(self, cfg: BlockArgs, in_channels: int) -> None:
        self.act = act_layer_factory(cfg.act_layer)
        self.skip = (cfg.stride == 1 and cfg.filters == in_channels
                     and cfg.skip_connection)
        self.drop_path_rate = cfg.drop_path_rate
        self.out_channels = cfg.filters

    def _se(self, cfg: BlockArgs, channels: int,
            generator: Optional[torch.Generator]):
        if cfg.use_se and cfg.se_ratio > 0.0:
            return SqueezeExcite(channels, rd_ratio=cfg.se_ratio,
                                 act_layer=cfg.act_layer, generator=generator)
        return None

    def _residual(self, x: torch.Tensor, shortcut: torch.Tensor) -> torch.Tensor:
        if not self.skip:
            return x
        ctx = current_context()
        return drop_path(x, self.drop_path_rate, ctx.training,
                         ctx.generator) + shortcut


class ConvBnAct(_Block):
    def __init__(self, cfg: BlockArgs, in_channels: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self._common(cfg, in_channels)
        self.conv = create_conv2d(in_channels, cfg.filters, cfg.dw_kernel_size,
                                  strides=cfg.stride, padding=cfg.padding,
                                  dilation_rate=cfg.dilation_rate,
                                  generator=generator)
        self.bn1 = norm_layer_factory(cfg.norm_layer)(cfg.filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._residual(self.act(self.bn1(self.conv(x))), x)


class DepthwiseSeparableConv(_Block):
    def __init__(self, cfg: BlockArgs, in_channels: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        norm = norm_layer_factory(cfg.norm_layer)
        self._common(cfg, in_channels)
        self.conv_dw = create_conv2d(in_channels, kernel_size=cfg.dw_kernel_size,
                                     strides=cfg.stride, padding=cfg.padding,
                                     dilation_rate=cfg.dilation_rate,
                                     depthwise=True, generator=g)
        self.bn1 = norm(in_channels)
        self.se = self._se(cfg, in_channels, g)
        self.conv_pw = create_conv2d(in_channels, cfg.filters,
                                     cfg.pw_kernel_size, padding=cfg.padding,
                                     nb_groups=cfg.nb_groups, generator=g)
        self.bn2 = norm(cfg.filters)
        self.pw_act = cfg.pw_act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        x = self.act(self.bn1(self.conv_dw(x)))
        if self.se is not None:
            x = self.se(x)
        x = self.bn2(self.conv_pw(x))
        if self.pw_act:
            x = self.act(x)
        return self._residual(x, shortcut)


class InvertedResidual(_Block):
    """MBConv: pointwise expand -> depthwise -> SE -> pointwise-linear."""

    def __init__(self, cfg: BlockArgs, in_channels: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        norm = norm_layer_factory(cfg.norm_layer)
        self._common(cfg, in_channels)
        mid = make_divisible(in_channels * cfg.exp_ratio, 8)
        self.conv_pw = create_conv2d(in_channels, mid, cfg.exp_kernel_size,
                                     padding=cfg.padding,
                                     nb_groups=cfg.nb_groups, generator=g)
        self.bn1 = norm(mid)
        self.conv_dw = create_conv2d(mid, kernel_size=cfg.dw_kernel_size,
                                     strides=cfg.stride, padding=cfg.padding,
                                     dilation_rate=cfg.dilation_rate,
                                     depthwise=True, generator=g)
        self.bn2 = norm(mid)
        self.se = self._se(cfg, mid, g)
        self.conv_pwl = create_conv2d(mid, cfg.filters, cfg.pw_kernel_size,
                                      padding=cfg.padding, generator=g)
        self.bn3 = norm(cfg.filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        x = self.act(self.bn1(self.conv_pw(x)))
        x = self.act(self.bn2(self.conv_dw(x)))
        if self.se is not None:
            x = self.se(x)
        x = self.bn3(self.conv_pwl(x))
        return self._residual(x, shortcut)


class EdgeResidual(_Block):
    """FusedMBConv: full conv expand (with the stride) -> SE ->
    pointwise-linear."""

    def __init__(self, cfg: BlockArgs, in_channels: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        norm = norm_layer_factory(cfg.norm_layer)
        self._common(cfg, in_channels)
        force_in = cfg.force_in_channels or in_channels
        mid = make_divisible(force_in * cfg.exp_ratio, 8)
        self.conv_exp = create_conv2d(in_channels, mid, cfg.exp_kernel_size,
                                      strides=cfg.stride, padding=cfg.padding,
                                      nb_groups=cfg.nb_groups, generator=g)
        self.bn1 = norm(mid)
        self.se = self._se(cfg, mid, g)
        self.conv_pwl = create_conv2d(mid, cfg.filters, cfg.pw_kernel_size,
                                      padding=cfg.padding, generator=g)
        self.bn2 = norm(cfg.filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        x = self.act(self.bn1(self.conv_exp(x)))
        if self.se is not None:
            x = self.se(x)
        x = self.bn2(self.conv_pwl(x))
        return self._residual(x, shortcut)
