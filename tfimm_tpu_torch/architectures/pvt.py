"""Pyramid Vision Transformer (PVT); mirror of tfimm_tpu/architectures/pvt.py.

Per-stage patch embeddings and learned position embeddings,
spatial-reduction attention (keys and values from tokens reduced by a
strided conv), a class token in the last stage only. Parameter names are
the official checkpoints' (``patch_embed1.proj``, ``block1.0.attn.q``,
``pos_embed1``), so their state dicts load with ``load_state_dict``.

At inference a one-head attention (stage 1 of every registered PVT and
PVTv2) runs as one call of ``pvt_sra`` (the hand-written kernel on the
card, its plain version on the CPU) when ``TFIMM_TPU_FUSED_PVT_SRA=1``,
the opt-in of the JAX package, which reads the same variable
(``SpatialReductionAttention.kernel_ok``).

Paper: PVT, https://arxiv.org/abs/2102.12122.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import partial
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from tfimm_tpu_torch.core import capture_feature, current_context
from tfimm_tpu_torch.models.base import Model
from tfimm_tpu_torch.models.config import ModelConfig
from tfimm_tpu_torch.models.registry import register_model
from tfimm_tpu_torch.ops.basic import Dense, act_layer_factory, trunc_normal_
from tfimm_tpu_torch.ops.conv import Conv2d
from tfimm_tpu_torch.ops.embed import PatchEmbeddings, interpolate_pos_embeddings
from tfimm_tpu_torch.ops.kernels.dispatch import KERNEL_DTYPES, log_dispatch
from tfimm_tpu_torch.ops.kernels.pvt_sra import pvt_sra
from tfimm_tpu_torch.ops.mlp import MLP
from tfimm_tpu_torch.ops.norm import norm_layer_factory
from tfimm_tpu_torch.ops.pool import adaptive_avg_pool_2d
from tfimm_tpu_torch.ops.stochastic import drop_path, dropout
from tfimm_tpu_torch.quant import any_quantized
from tfimm_tpu_torch.utils.constants import (
    IMAGENET_DEFAULT_MEAN,
    IMAGENET_DEFAULT_STD,
)

__all__ = ["PyramidVisionTransformer", "PyramidVisionTransformerConfig",
           "SpatialReductionAttention", "PVTBlock"]

@dataclass
class PyramidVisionTransformerConfig(ModelConfig):
    nb_classes: int = 1000
    in_channels: int = 3
    input_size: Tuple[int, int] = (224, 224)
    patch_size: Tuple = (4, 2, 2, 2)
    embed_dim: Tuple = (64, 128, 256, 512)
    nb_blocks: Tuple = (3, 4, 6, 3)
    nb_heads: Tuple = (1, 2, 5, 8)
    mlp_ratio: Tuple = (8.0, 8.0, 4.0, 4.0)
    sr_ratio: Tuple = (8, 4, 2, 1)
    qkv_bias: bool = True
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.0
    norm_layer: str = "layer_norm_eps_1e-6"
    act_layer: str = "gelu"
    interpolate_input: bool = False
    crop_pct: float = 0.9
    interpolation: str = "bicubic"
    mean: Tuple[float, float, float] = IMAGENET_DEFAULT_MEAN
    std: Tuple[float, float, float] = IMAGENET_DEFAULT_STD
    first_conv: str = "patch_embed1.proj"
    classifier: str = "head"

    @property
    def nb_tokens(self) -> Tuple:
        return 0, 0, 0, 1

    @property
    def grid_size(self) -> Tuple:
        grids, size = [], self.input_size
        for p in self.patch_size:
            grids.append((size[0] // p, size[1] // p))
            size = grids[-1]
        return tuple(grids)

    @property
    def nb_patches(self) -> Tuple:
        return tuple(g[0] * g[1] for g in self.grid_size)

    @property
    def transform_weights(self):
        return {f"pos_embed{j + 1}": partial(
                    PyramidVisionTransformer.transform_pos_embed, stage=j)
                for j in range(len(self.nb_blocks))}


class SpatialReductionAttention(nn.Module):
    """Attention whose keys and values come from tokens reduced by a
    strided conv (``sr_ratio`` > 1) and a LayerNorm. With ``linear_sr``
    (PVTv2's linear SRA) the tokens are average-pooled to a 7x7 grid, then
    go through a 1x1 conv, the LayerNorm and the activation. Parameters:
    q, kv, proj, and sr, norm where the tokens are reduced."""

    def __init__(self, embed_dim: int, nb_heads: int, sr_ratio: int,
                 qkv_bias: bool, attn_drop_rate: float, proj_drop_rate: float,
                 *, linear_sr: bool = False, act_layer: str = "gelu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        assert embed_dim % nb_heads == 0
        self.nb_heads = nb_heads
        self.head_dim = embed_dim // nb_heads
        self.scale = self.head_dim ** -0.5
        self.linear_sr = linear_sr
        self.attn_drop_rate = attn_drop_rate
        self.proj_drop_rate = proj_drop_rate
        g = generator
        self.q = Dense(embed_dim, embed_dim, use_bias=qkv_bias,
                       weight_std=0.02, generator=g)
        self.kv = Dense(embed_dim, 2 * embed_dim, use_bias=qkv_bias,
                        weight_std=0.02, generator=g)
        self.proj = Dense(embed_dim, embed_dim, weight_std=0.02, generator=g)
        self.act = act_layer_factory(act_layer)
        self.sr = self.norm = None
        if linear_sr or sr_ratio > 1:
            k = 1 if linear_sr else sr_ratio
            self.sr = Conv2d(embed_dim, embed_dim, k, generator=g)
            self.norm = norm_layer_factory("layer_norm")(embed_dim)

    def kernel_ok(self, x: torch.Tensor) -> bool:
        """Gate for ``pvt_sra``, as the JAX package's: one head, inference
        and the opt-in, the JAX package's variable, off by default; and x in
        a dtype the kernel takes; and neither q nor proj int8 (the kernel
        reads both weights raw; the JAX gate's ``kernel_q`` checks)."""
        return (self.nb_heads == 1 and not current_context().training
                and not any_quantized(self.q, self.proj)
                and x.dtype in KERNEL_DTYPES
                and os.environ.get("TFIMM_TPU_FUSED_PVT_SRA", "0") == "1")

    def forward(self, x: torch.Tensor, grid: Tuple[int, int]) -> torch.Tensor:
        ctx = current_context()
        b, n, d = x.shape
        h, hd = self.nb_heads, self.head_dim
        kv_in = x
        if self.sr is not None:
            kv_in = x.reshape(b, *grid, d)
            if self.linear_sr:
                kv_in = adaptive_avg_pool_2d(kv_in, 7)
            kv_in = self.norm(self.sr(kv_in).reshape(b, -1, d))
            if self.linear_sr:
                kv_in = self.act(kv_in)
        kv = self.kv(kv_in)

        if self.kernel_ok(x):
            log_dispatch("pvt_sra")
            out = pvt_sra(x, kv, self.q.weight, self.q.bias, self.proj.weight,
                          self.proj.bias, self.scale)
            return dropout(out, self.proj_drop_rate, ctx.training,
                           ctx.generator)

        q = self.q(x).reshape(b, n, h, hd).transpose(1, 2)
        k, v = kv.reshape(b, -1, 2, h, hd).permute(2, 0, 3, 1, 4)
        # The JAX package rounds the scale to the dtype.
        scale = torch.tensor(self.scale, dtype=q.dtype).item()
        attn = torch.matmul(q * scale, k.transpose(-1, -2))
        attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
        attn = dropout(attn, self.attn_drop_rate, ctx.training, ctx.generator)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, d)
        out = self.proj(out)
        return dropout(out, self.proj_drop_rate, ctx.training, ctx.generator)


class PVTBlock(nn.Module):
    def __init__(self, embed_dim, nb_heads, mlp_ratio, sr_ratio, qkv_bias,
                 drop_rate, attn_drop_rate, drop_path_rate, norm_layer,
                 act_layer, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        norm = norm_layer_factory(norm_layer)
        self.norm1 = norm(embed_dim)
        self.attn = SpatialReductionAttention(
            embed_dim, nb_heads, sr_ratio, qkv_bias, attn_drop_rate,
            drop_rate, generator=generator)
        self.norm2 = norm(embed_dim)
        self.mlp = MLP(embed_dim, int(embed_dim * mlp_ratio),
                       act_layer=act_layer, drop_rate=drop_rate,
                       weight_std=0.02, generator=generator)
        self.drop_path_rate = drop_path_rate

    def forward(self, x: torch.Tensor, grid: Tuple[int, int]) -> torch.Tensor:
        ctx = current_context()
        y = self.attn(self.norm1(x), grid)
        x = x + drop_path(y, self.drop_path_rate, ctx.training, ctx.generator)
        y = self.mlp(self.norm2(x))
        return x + drop_path(y, self.drop_path_rate, ctx.training,
                             ctx.generator)


class PyramidVisionTransformer(Model):
    cfg_class = PyramidVisionTransformerConfig

    def __init__(self, cfg: PyramidVisionTransformerConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg)
        g = generator
        self.nb_features = cfg.embed_dim[-1]
        nb_stages = len(cfg.nb_blocks)
        dpr = np.linspace(0, cfg.drop_path_rate, sum(cfg.nb_blocks))
        in_ch, k = cfg.in_channels, 0
        for j in range(nb_stages):
            dim = cfg.embed_dim[j]
            setattr(self, f"patch_embed{j + 1}", PatchEmbeddings(
                cfg.patch_size[j], dim, in_channels=in_ch,
                norm_layer="layer_norm", generator=g))
            pos = torch.empty(1, cfg.nb_patches[j] + cfg.nb_tokens[j], dim)
            setattr(self, f"pos_embed{j + 1}",
                    nn.Parameter(trunc_normal_(pos, 0.02, g)))
            setattr(self, f"block{j + 1}", nn.ModuleList(
                PVTBlock(dim, cfg.nb_heads[j], cfg.mlp_ratio[j],
                         cfg.sr_ratio[j], cfg.qkv_bias, cfg.drop_rate,
                         cfg.attn_drop_rate, float(dpr[k + i]), cfg.norm_layer,
                         cfg.act_layer, generator=g)
                for i in range(cfg.nb_blocks[j])))
            k += cfg.nb_blocks[j]
            in_ch = dim
        self.cls_token = nn.Parameter(
            trunc_normal_(torch.empty(1, 1, self.nb_features), 0.02, g))
        self.norm = norm_layer_factory(cfg.norm_layer)(self.nb_features)
        self.head = (Dense(self.nb_features, cfg.nb_classes, generator=g)
                     if cfg.nb_classes > 0 else None)

    def transform_pos_embed(self, weight: torch.Tensor,
                            target_cfg: PyramidVisionTransformerConfig,
                            stage: int) -> torch.Tensor:
        """The weight-transfer hook of stage ``stage``'s position table."""
        return interpolate_pos_embeddings(
            weight, src_grid=self.cfg.grid_size[stage],
            dst_grid=target_cfg.grid_size[stage],
            nb_tokens=self.cfg.nb_tokens[stage])

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        ctx = current_context()
        nb_stages = len(cfg.nb_blocks)
        batch = x.shape[0]
        k = 0
        for j in range(nb_stages):
            x, grid = getattr(self, f"patch_embed{j + 1}")(x)
            capture_feature(f"patch_embedding_{j}", x)
            if j == nb_stages - 1:
                cls = self.cls_token.to(x.dtype).expand(batch, -1, -1)
                x = torch.cat([cls, x], dim=1)
            pos_embed = getattr(self, f"pos_embed{j + 1}")
            if cfg.interpolate_input and grid != cfg.grid_size[j]:
                pos_embed = interpolate_pos_embeddings(
                    pos_embed, src_grid=cfg.grid_size[j], dst_grid=grid,
                    nb_tokens=cfg.nb_tokens[j])
            x = x + pos_embed.to(x.dtype)
            x = dropout(x, cfg.drop_rate, ctx.training, ctx.generator)
            capture_feature(f"pos_embedding_{j}", x)
            for block in getattr(self, f"block{j + 1}"):
                x = block(x, grid)
                capture_feature(f"block_{k}", x)
                k += 1
            if j != nb_stages - 1:
                x = x.reshape(batch, *grid, -1)
            capture_feature(f"stage_{j}", x)
        x = self.norm(x)
        capture_feature("features_all", x)
        x = x[:, 0]
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
            names += [f"patch_embedding_{j}", f"pos_embedding_{j}"]
            names += [f"block_{k + i}" for i in range(n)]
            k += n
            names.append(f"stage_{j}")
        return tuple(names + ["features_all", "features", "logits"])


# -- variant registrations ---------------------------------------------------
# The same variants, with the same configs, as tfimm_tpu/architectures/pvt.py.

def _register(name, **kwargs):
    def fn():
        url = (f"[pytorch]https://github.com/whai362/PVT/releases/download/"
               f"v2/{name}.pth")
        return PyramidVisionTransformer, PyramidVisionTransformerConfig(
            name=name, url=url, **kwargs)

    fn.__name__ = name
    fn.__qualname__ = name
    fn.__module__ = __name__
    globals()[name] = fn
    register_model(fn)


_register("pvt_tiny", embed_dim=(64, 128, 320, 512), nb_blocks=(2, 2, 2, 2))
_register("pvt_small", embed_dim=(64, 128, 320, 512), nb_blocks=(3, 4, 6, 3))
_register("pvt_medium", embed_dim=(64, 128, 320, 512), nb_blocks=(3, 4, 18, 3))
_register("pvt_large", embed_dim=(64, 128, 320, 512), nb_blocks=(3, 8, 27, 3))
