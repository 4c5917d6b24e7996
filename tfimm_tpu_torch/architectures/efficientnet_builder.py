"""EfficientNet trunk assembly from string definitions; mirror of
tfimm_tpu/architectures/efficientnet_builder.py.

Depth scaling with ceil or round truncation and the repeats handed out in
reverse block order, the stride -> dilation walk that honours
``output_stride``, the per-block stochastic-depth ramp, and channel
rounding with the 10% round-down guard. The arithmetic is Python's, as in
the JAX package (``round`` is banker's rounding), so both packages build
the same widths and depths.
"""

from __future__ import annotations

import math
from copy import deepcopy
from typing import Dict, List, Optional, Tuple, Union

import torch

from tfimm_tpu_torch.architectures.efficientnet_blocks import (
    BlockArgs,
    ConvBnAct,
    DepthwiseSeparableConv,
    EdgeResidual,
    InvertedResidual,
)
from tfimm_tpu_torch.utils.etc import make_divisible

__all__ = ["round_channels", "decode_architecture", "EfficientNetBuilder"]


def round_channels(channels, multiplier=1.0, divisor=8, min_channels=None,
                   round_limit=0.9):
    return make_divisible(channels * multiplier, divisor,
                          min_value=min_channels, round_limit=round_limit)


def _scale_stage_depth(stack_args: List[BlockArgs], depth_multiplier=1.0,
                       depth_trunc="ceil") -> List[BlockArgs]:
    """Scale a stage's repeats, handing them out in reverse block order so
    that the later (wider) blocks grow first."""
    repeats = [ba.nb_repeats for ba in stack_args]
    nb_repeats = sum(repeats)
    if depth_trunc == "round":
        nb_repeats_scaled = max(1, round(nb_repeats * depth_multiplier))
    else:
        nb_repeats_scaled = int(math.ceil(nb_repeats * depth_multiplier))

    repeats_scaled = []
    for r in repeats[::-1]:
        rs = max(1, round(r / nb_repeats * nb_repeats_scaled))
        repeats_scaled.append(rs)
        nb_repeats -= r
        nb_repeats_scaled -= rs
    repeats_scaled = repeats_scaled[::-1]

    out: List[BlockArgs] = []
    for ba, rep in zip(stack_args, repeats_scaled):
        out.extend(deepcopy(ba) for _ in range(rep))
    return out


def decode_architecture(
    architecture: Tuple[Tuple[str, ...], ...],
    depth_multiplier: Union[float, Tuple[float, ...]] = 1.0,
    depth_truncation: str = "ceil",
    experts_multiplier: int = 1,
    fix_first_last: bool = False,
    group_size: Optional[int] = None,
) -> List[List[BlockArgs]]:
    if isinstance(depth_multiplier, tuple):
        assert len(depth_multiplier) == len(architecture)
    else:
        depth_multiplier = (depth_multiplier,) * len(architecture)

    arch_args = []
    for stack_idx, (block_strings, multiplier) in enumerate(
        zip(architecture, depth_multiplier)
    ):
        stack_args = []
        for block_str in block_strings:
            ba = BlockArgs.decode(block_str)
            if ba.nb_experts is not None:
                ba.nb_experts *= experts_multiplier
            if group_size is not None:
                ba.group_size = group_size
            stack_args.append(ba)
        fix_depths = fix_first_last and stack_idx in {0, len(architecture) - 1}
        mod_multiplier = 1.0 if fix_depths else multiplier
        arch_args.append(_scale_stage_depth(stack_args, mod_multiplier,
                                            depth_truncation))
    return arch_args


class EfficientNetBuilder:
    """Build the trunk's blocks from decoded ``BlockArgs``, tracking the
    channels, the output stride and the stochastic-depth rates."""

    def __init__(self, output_stride=32, channel_multiplier=1.0, padding="",
                 act_layer=None, norm_layer=None, drop_path_rate=0.0):
        self.output_stride = output_stride
        self.channel_multiplier = channel_multiplier
        self.padding = padding
        self.norm_layer = norm_layer
        self.act_layer = act_layer
        self.drop_path_rate = drop_path_rate

    def _make_block(self, ba: BlockArgs, in_channels: int, total_idx: int,
                    nb_blocks: int, generator: Optional[torch.Generator]):
        ba.filters = round_channels(ba.filters, self.channel_multiplier)
        if ba.force_in_channels is not None:
            ba.force_in_channels = round_channels(ba.force_in_channels,
                                                  self.channel_multiplier)
        ba.padding = self.padding
        ba.norm_layer = self.norm_layer
        ba.act_layer = ba.act_layer or self.act_layer
        assert ba.act_layer is not None
        ba.drop_path_rate = self.drop_path_rate * total_idx / nb_blocks
        if ba.block_type != "cn":
            ba.se_ratio /= ba.exp_ratio

        kw = {"generator": generator}
        if ba.block_type == "ir":
            if ba.nb_experts is not None:
                raise NotImplementedError(
                    "CondConv experts (nb_experts) are not supported")
            return InvertedResidual(ba, in_channels, **kw)
        if ba.block_type in {"ds", "dsa"}:
            return DepthwiseSeparableConv(ba, in_channels, **kw)
        if ba.block_type == "er":
            return EdgeResidual(ba, in_channels, **kw)
        if ba.block_type == "cn":
            return ConvBnAct(ba, in_channels, **kw)
        raise ValueError(f"Unknown block type {ba.block_type}")

    def __call__(self, architecture: List[List[BlockArgs]], in_channels: int,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[Dict[str, torch.nn.Module], int]:
        """The blocks, keyed "stage_i/block_j" in order, and the trunk's
        output channels."""
        total_block_count = sum(len(x) for x in architecture)
        total_block_idx = 0
        current_stride = 2
        current_dilation = 1
        blocks = {}

        for stack_idx, stack_args in enumerate(architecture):
            for block_idx, ba in enumerate(stack_args):
                assert ba.stride in {1, 2}
                if block_idx >= 1:
                    ba.stride = 1
                next_dilation = current_dilation
                if ba.stride > 1:
                    next_output_stride = current_stride * ba.stride
                    if next_output_stride > self.output_stride:
                        next_dilation = current_dilation * ba.stride
                        ba.stride = 1
                    else:
                        current_stride = next_output_stride
                ba.dilation_rate = current_dilation
                if next_dilation != current_dilation:
                    current_dilation = next_dilation

                block = self._make_block(ba, in_channels, total_block_idx,
                                         total_block_count, generator)
                blocks[f"stage_{stack_idx}/block_{block_idx}"] = block
                in_channels = block.out_channels
                total_block_idx += 1
        return blocks, in_channels
