"""PoolFormer; mirror of tfimm_tpu/architectures/poolformer.py.

A MetaFormer whose token mixer is an average pool minus its input, with
GroupNorm over one group, 1x1-conv MLPs and layer scales, on NHWC maps.
Parameter names are the official checkpoints' (``patch_embed.proj``,
``network.{2j}.{k}.norm1``, ``network.{2j+1}.proj``, ``head``), with
``layer_scale_1`` and ``layer_scale_2`` as bare leaves.

At inference a block with the default norm and activation
(``group_norm_1grp``, GELU) runs as one call of ``poolformer_block`` (the
hand-written kernels on the card, their plain version on the CPU) when
``TFIMM_TPU_FUSED_POOLFORMER=1``, the opt-in of the JAX package, which reads
the same variable (``PoolFormerBlock.kernel_ok``).

Paper: MetaFormer is Actually What You Need, https://arxiv.org/abs/2111.11418.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from tfimm_tpu_torch.core import capture_feature, current_context
from tfimm_tpu_torch.models.base import Model
from tfimm_tpu_torch.models.config import ModelConfig
from tfimm_tpu_torch.models.registry import register_model
from tfimm_tpu_torch.ops.basic import Dense
from tfimm_tpu_torch.ops.embed import PatchEmbeddings
from tfimm_tpu_torch.ops.kernels.dispatch import KERNEL_DTYPES, log_dispatch
from tfimm_tpu_torch.ops.kernels.poolformer_block import poolformer_block
from tfimm_tpu_torch.ops.mlp import ConvMLP
from tfimm_tpu_torch.ops.norm import norm_layer_factory
from tfimm_tpu_torch.ops.pool import avg_pool_2d_exclude_pad
from tfimm_tpu_torch.ops.stochastic import drop_path
from tfimm_tpu_torch.quant import any_quantized
from tfimm_tpu_torch.utils.constants import (
    IMAGENET_DEFAULT_MEAN,
    IMAGENET_DEFAULT_STD,
)

__all__ = ["PoolFormer", "PoolFormerConfig", "PoolFormerBlock"]


@dataclass
class PoolFormerConfig(ModelConfig):
    nb_classes: int = 1000
    in_channels: int = 3
    input_size: Tuple[int, int] = (224, 224)
    embed_dim: Tuple = (64, 128, 320, 512)
    nb_blocks: Tuple = (2, 2, 6, 2)
    mlp_ratio: Tuple = (4.0, 4.0, 4.0, 4.0)
    drop_rate: float = 0.0
    drop_path_rate: float = 0.0
    norm_layer: str = "group_norm_1grp"
    act_layer: str = "gelu"
    init_scale: float = 1e-5
    crop_pct: float = 0.95
    interpolation: str = "bicubic"
    mean: Tuple[float, float, float] = IMAGENET_DEFAULT_MEAN
    std: Tuple[float, float, float] = IMAGENET_DEFAULT_STD
    first_conv: str = "patch_embed.proj"
    classifier: str = "head"


class PoolFormerBlock(nn.Module):
    """norm1 -> pool(y) - y -> layer scale -> drop path -> residual ->
    norm2 -> conv MLP -> layer scale -> drop path -> residual."""

    def __init__(self, embed_dim, mlp_ratio, drop_rate, drop_path_rate,
                 norm_layer, act_layer, init_scale, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        norm = norm_layer_factory(norm_layer)
        self.norm1 = norm(embed_dim)
        self.norm2 = norm(embed_dim)
        self.mlp = ConvMLP(embed_dim, int(embed_dim * mlp_ratio),
                           act_layer=act_layer, drop_rate=drop_rate,
                           weight_std=0.02, generator=generator)
        self.layer_scale_1 = nn.Parameter(
            torch.full((embed_dim,), float(init_scale)))
        self.layer_scale_2 = nn.Parameter(
            torch.full((embed_dim,), float(init_scale)))
        self.drop_path_rate = drop_path_rate
        self.fusable = norm_layer == "group_norm_1grp" and act_layer == "gelu"

    def kernel_ok(self, x: torch.Tensor) -> bool:
        """Gate for ``poolformer_block``, as the JAX package's: the default
        norm and activation, inference and the opt-in, the JAX package's
        variable, off by default; x in a dtype the kernel takes; and
        neither fc1 nor fc2 int8 (the kernel reads both weights raw)."""
        return (self.fusable and not current_context().training
                and not any_quantized(self.mlp.fc1, self.mlp.fc2)
                and x.dtype in KERNEL_DTYPES
                and os.environ.get("TFIMM_TPU_FUSED_POOLFORMER", "0") == "1")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kernel_ok(x):
            log_dispatch("poolformer_block")
            fc1, fc2 = self.mlp.fc1, self.mlp.fc2
            return poolformer_block(
                x, self.norm1.weight, self.norm1.bias, self.layer_scale_1,
                self.norm2.weight, self.norm2.bias,
                fc1.weight.reshape(fc1.weight.shape[:2]), fc1.bias,
                fc2.weight.reshape(fc2.weight.shape[:2]), fc2.bias,
                self.layer_scale_2, self.norm1.eps)
        ctx = current_context()
        y = self.norm1(x)
        y = avg_pool_2d_exclude_pad(y, 3) - y
        y = y * self.layer_scale_1.to(y.dtype)
        x = x + drop_path(y, self.drop_path_rate, ctx.training, ctx.generator)
        y = self.mlp(self.norm2(x))
        y = y * self.layer_scale_2.to(y.dtype)
        return x + drop_path(y, self.drop_path_rate, ctx.training,
                             ctx.generator)


class PoolFormer(Model):
    cfg_class = PoolFormerConfig

    def __init__(self, cfg: PoolFormerConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg)
        g = generator
        self.nb_features = cfg.embed_dim[-1]
        self.patch_embed = PatchEmbeddings(
            7, cfg.embed_dim[0], in_channels=cfg.in_channels, stride=4,
            padding=2, flatten=False, generator=g)
        dpr = np.linspace(0.0, cfg.drop_path_rate, sum(cfg.nb_blocks))
        dpr = np.split(dpr, np.cumsum(cfg.nb_blocks))
        # network.{2j}: the blocks of stage j; network.{2j+1}: the
        # downsampling patch embedding after it.
        network = []
        for j, depth in enumerate(cfg.nb_blocks):
            network.append(nn.ModuleList(
                PoolFormerBlock(cfg.embed_dim[j], cfg.mlp_ratio[j],
                                cfg.drop_rate, float(dpr[j][k]),
                                cfg.norm_layer, cfg.act_layer, cfg.init_scale,
                                generator=g)
                for k in range(depth)))
            if j < len(cfg.nb_blocks) - 1:
                network.append(PatchEmbeddings(
                    3, cfg.embed_dim[j + 1], in_channels=cfg.embed_dim[j],
                    stride=2, padding=1, flatten=False, generator=g))
        self.network = nn.ModuleList(network)
        self.norm = norm_layer_factory(cfg.norm_layer)(self.nb_features)
        self.head = (Dense(self.nb_features, cfg.nb_classes, generator=g)
                     if cfg.nb_classes > 0 else None)

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        x, _ = self.patch_embed(x)
        capture_feature("patch_embedding", x)
        nb_stages = len(self.cfg.nb_blocks)
        for j in range(nb_stages):
            for k, block in enumerate(self.network[2 * j]):
                x = block(x)
                capture_feature(f"stage_{j}/block_{k}", x)
            if j < nb_stages - 1:
                x, _ = self.network[2 * j + 1](x)
                capture_feature(f"stage_{j}/downsample", x)
        x = self.norm(x)
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
        names = ["patch_embedding"]
        nb_stages = len(self.cfg.nb_blocks)
        for j, depth in enumerate(self.cfg.nb_blocks):
            names += [f"stage_{j}/block_{k}" for k in range(depth)]
            if j < nb_stages - 1:
                names.append(f"stage_{j}/downsample")
        return tuple(names + ["features_all", "features", "logits"])


# -- variant registrations ---------------------------------------------------
# The same variants, with the same configs, as
# tfimm_tpu/architectures/poolformer.py.

def _register(name, **kwargs):
    def fn():
        url = ("[pytorch]https://github.com/sail-sg/poolformer/releases/"
               f"download/v1.0/{name}.pth.tar")
        return PoolFormer, PoolFormerConfig(name=name, url=url, **kwargs)

    fn.__name__ = name
    fn.__qualname__ = name
    fn.__module__ = __name__
    globals()[name] = fn
    register_model(fn)


_register("poolformer_s12", embed_dim=(64, 128, 320, 512),
          nb_blocks=(2, 2, 6, 2), crop_pct=0.9)
_register("poolformer_s24", embed_dim=(64, 128, 320, 512),
          nb_blocks=(4, 4, 12, 4), crop_pct=0.9)
_register("poolformer_s36", embed_dim=(64, 128, 320, 512),
          nb_blocks=(6, 6, 18, 6), init_scale=1e-6, crop_pct=0.9)
_register("poolformer_m36", embed_dim=(96, 192, 384, 768),
          nb_blocks=(6, 6, 18, 6), init_scale=1e-6, crop_pct=0.95)
_register("poolformer_m48", embed_dim=(96, 192, 384, 768),
          nb_blocks=(8, 8, 24, 8), init_scale=1e-6, crop_pct=0.95)
