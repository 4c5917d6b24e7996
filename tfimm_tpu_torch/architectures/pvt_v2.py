"""Pyramid Vision Transformer V2; mirror of
tfimm_tpu/architectures/pvt_v2.py.

Overlapping patch embeddings, a 3x3 depthwise conv inside the MLP (the
position information, without position embeddings), conv or linear
(7x7 average pool + 1x1 conv + GELU) spatial-reduction attention, a norm
at the end of every stage and a mean-token head. Parameter names are the
official checkpoints'. The JAX package's ``SpatialReductionAttentionV2`` is
``pvt.SpatialReductionAttention`` with ``linear_sr``; its one-head stage-1
attention takes ``pvt_sra`` under the same opt-in
(``TFIMM_TPU_FUSED_PVT_SRA=1``).

Paper: PVTv2, https://arxiv.org/abs/2106.13797.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from tfimm_tpu_torch.architectures.pvt import SpatialReductionAttention
from tfimm_tpu_torch.core import capture_feature, current_context
from tfimm_tpu_torch.models.base import Model
from tfimm_tpu_torch.models.config import ModelConfig
from tfimm_tpu_torch.models.registry import register_model
from tfimm_tpu_torch.ops.basic import Dense, act_layer_factory
from tfimm_tpu_torch.ops.conv import DepthwiseConv2d
from tfimm_tpu_torch.ops.embed import PatchEmbeddings
from tfimm_tpu_torch.ops.norm import norm_layer_factory
from tfimm_tpu_torch.ops.stochastic import drop_path, dropout
from tfimm_tpu_torch.utils.constants import (
    IMAGENET_DEFAULT_MEAN,
    IMAGENET_DEFAULT_STD,
)

__all__ = ["PyramidVisionTransformerV2", "PyramidVisionTransformerV2Config",
           "PVTv2MLP", "PVTv2Block"]


@dataclass
class PyramidVisionTransformerV2Config(ModelConfig):
    nb_classes: int = 1000
    in_channels: int = 3
    input_size: Tuple[int, int] = (224, 224)
    embed_dim: Tuple = (64, 128, 256, 512)
    nb_blocks: Tuple = (3, 4, 6, 3)
    nb_heads: Tuple = (1, 2, 5, 8)
    mlp_ratio: Tuple = (8.0, 8.0, 4.0, 4.0)
    sr_ratio: Tuple = (8, 4, 2, 1)
    linear_sr: bool = False
    qkv_bias: bool = True
    drop_rate: float = 0.0
    drop_path_rate: float = 0.0
    attn_drop_rate: float = 0.0
    norm_layer: str = "layer_norm_eps_1e-6"
    act_layer: str = "gelu"
    crop_pct: float = 0.9
    interpolation: str = "bicubic"
    mean: Tuple[float, float, float] = IMAGENET_DEFAULT_MEAN
    std: Tuple[float, float, float] = IMAGENET_DEFAULT_STD
    first_conv: str = "patch_embed1.proj"
    classifier: str = "head"


class PVTv2MLP(nn.Module):
    """fc1 -> (ReLU with linear SRA) -> 3x3 depthwise conv on the token
    grid -> act -> fc2. Parameters: fc1, dwconv.dwconv, fc2."""

    def __init__(self, embed_dim: int, hidden_dim: int, linear_sr: bool,
                 drop_rate: float, act_layer: str, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc1 = Dense(embed_dim, hidden_dim, weight_std=0.02,
                         generator=generator)
        self.dwconv = nn.ModuleDict(
            {"dwconv": DepthwiseConv2d(hidden_dim, 3, generator=generator)})
        self.fc2 = Dense(hidden_dim, embed_dim, weight_std=0.02,
                         generator=generator)
        self.act = act_layer_factory(act_layer)
        self.relu = act_layer_factory("relu" if linear_sr else "linear")
        self.drop_rate = drop_rate

    def forward(self, x: torch.Tensor, grid: Tuple[int, int]) -> torch.Tensor:
        ctx = current_context()
        b, n, _ = x.shape
        x = self.relu(self.fc1(x))
        d = x.shape[-1]
        x = self.dwconv["dwconv"](x.reshape(b, *grid, d)).reshape(b, n, d)
        x = dropout(self.act(x), self.drop_rate, ctx.training, ctx.generator)
        x = self.fc2(x)
        return dropout(x, self.drop_rate, ctx.training, ctx.generator)


class PVTv2Block(nn.Module):
    def __init__(self, cfg: PyramidVisionTransformerV2Config, stage: int,
                 drop_path_rate: float, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        norm = norm_layer_factory(cfg.norm_layer)
        dim = cfg.embed_dim[stage]
        self.norm1 = norm(dim)
        self.attn = SpatialReductionAttention(
            dim, cfg.nb_heads[stage], cfg.sr_ratio[stage], cfg.qkv_bias,
            cfg.attn_drop_rate, cfg.drop_rate, linear_sr=cfg.linear_sr,
            act_layer=cfg.act_layer, generator=generator)
        self.norm2 = norm(dim)
        self.mlp = PVTv2MLP(dim, int(dim * cfg.mlp_ratio[stage]),
                            cfg.linear_sr, cfg.drop_rate, cfg.act_layer,
                            generator=generator)
        self.drop_path_rate = drop_path_rate

    def forward(self, x: torch.Tensor, grid: Tuple[int, int]) -> torch.Tensor:
        ctx = current_context()
        y = self.attn(self.norm1(x), grid)
        x = x + drop_path(y, self.drop_path_rate, ctx.training, ctx.generator)
        y = self.mlp(self.norm2(x), grid)
        return x + drop_path(y, self.drop_path_rate, ctx.training,
                             ctx.generator)


class PyramidVisionTransformerV2(Model):
    cfg_class = PyramidVisionTransformerV2Config

    def __init__(self, cfg: PyramidVisionTransformerV2Config, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg)
        g = generator
        self.nb_features = cfg.embed_dim[-1]
        dpr = np.linspace(0, cfg.drop_path_rate, sum(cfg.nb_blocks))
        in_ch, k = cfg.in_channels, 0
        for j, depth in enumerate(cfg.nb_blocks):
            patch_size = 7 if j == 0 else 3
            setattr(self, f"patch_embed{j + 1}", PatchEmbeddings(
                patch_size, cfg.embed_dim[j], in_channels=in_ch,
                norm_layer="layer_norm", stride=4 if j == 0 else 2,
                padding=patch_size // 2, generator=g))
            setattr(self, f"block{j + 1}", nn.ModuleList(
                PVTv2Block(cfg, j, float(dpr[k + i]), generator=g)
                for i in range(depth)))
            setattr(self, f"norm{j + 1}",
                    norm_layer_factory(cfg.norm_layer)(cfg.embed_dim[j]))
            k += depth
            in_ch = cfg.embed_dim[j]
        self.head = (Dense(self.nb_features, cfg.nb_classes, generator=g)
                     if cfg.nb_classes > 0 else None)

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        batch = x.shape[0]
        k = 0
        for j in range(len(self.cfg.nb_blocks)):
            x, grid = getattr(self, f"patch_embed{j + 1}")(x)
            capture_feature(f"patch_embedding_{j}", x)
            for block in getattr(self, f"block{j + 1}"):
                x = block(x, grid)
                capture_feature(f"block_{k}", x)
                k += 1
            x = getattr(self, f"norm{j + 1}")(x).reshape(batch, *grid, -1)
            capture_feature(f"stage_{j}", x)
        x = x.reshape(batch, -1, self.nb_features)
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
        names, k = [], 0
        for j, n in enumerate(self.cfg.nb_blocks):
            names.append(f"patch_embedding_{j}")
            names += [f"block_{k + i}" for i in range(n)]
            k += n
            names.append(f"stage_{j}")
        return tuple(names + ["features_all", "features", "logits"])


# -- variant registrations ---------------------------------------------------
# The same variants, with the same configs, as
# tfimm_tpu/architectures/pvt_v2.py.

def _register(name, **kwargs):
    def fn():
        url = (f"[pytorch]https://github.com/whai362/PVT/releases/download/"
               f"v2/{name}.pth")
        return PyramidVisionTransformerV2, PyramidVisionTransformerV2Config(
            name=name, url=url, **kwargs)

    fn.__name__ = name
    fn.__qualname__ = name
    fn.__module__ = __name__
    globals()[name] = fn
    register_model(fn)


_register("pvt_v2_b0", embed_dim=(32, 64, 160, 256), nb_blocks=(2, 2, 2, 2))
_register("pvt_v2_b1", embed_dim=(64, 128, 320, 512), nb_blocks=(2, 2, 2, 2))
_register("pvt_v2_b2", embed_dim=(64, 128, 320, 512), nb_blocks=(3, 4, 6, 3))
_register("pvt_v2_b3", embed_dim=(64, 128, 320, 512), nb_blocks=(3, 4, 18, 3))
_register("pvt_v2_b4", embed_dim=(64, 128, 320, 512), nb_blocks=(3, 8, 27, 3))
_register("pvt_v2_b5", embed_dim=(64, 128, 320, 512), nb_blocks=(3, 6, 40, 3),
          mlp_ratio=(4.0, 4.0, 4.0, 4.0))
_register("pvt_v2_b2_linear", embed_dim=(64, 128, 320, 512),
          nb_blocks=(3, 4, 6, 3), linear_sr=True)
