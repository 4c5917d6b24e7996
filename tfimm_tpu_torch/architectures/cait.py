"""CaiT (Class-Attention in Image Transformers); mirror of
tfimm_tpu/architectures/cait.py.

Two stages: patch self-attention blocks with talking-head attention and
layer scale, then two class-attention blocks that update only the class
token, which joins the tokens only before them (the position embedding has
no class token). Parameter names are timm's (``blocks.0.attn.proj_l``,
``blocks_token_only.1.attn.q``, ``gamma_1``), so timm checkpoints load with
``load_state_dict``.

``TalkingHeadAttention`` sends its packed qkv projection to the
talking-head kernel (``ops/kernels/cait_attention.py``: the hand-written
kernel on the card, its plain version on the CPU; differentiable through
the backward kernel) unless attention dropout is live in training, as the
JAX package's gate does; that case, and a shape the kernels do not take,
runs ``forward_eager``, the JAX package's XLA path. The class-attention
blocks have no kernel in either package. With ``interpolate_input`` another
input size resizes the position table (no class token in it) bicubically.

Paper: Going deeper with Image Transformers, https://arxiv.org/abs/2103.17239.
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
from tfimm_tpu_torch.ops.basic import Dense, trunc_normal_
from tfimm_tpu_torch.ops.embed import PatchEmbeddings, interpolate_pos_embeddings
from tfimm_tpu_torch.ops.kernels.cait_attention import (
    talking_head_attention_packed,
    talking_head_attention_supports,
)
from tfimm_tpu_torch.ops.kernels.dispatch import KERNEL_DTYPES, log_dispatch
from tfimm_tpu_torch.ops.mlp import MLP
from tfimm_tpu_torch.ops.norm import norm_layer_factory
from tfimm_tpu_torch.ops.stochastic import drop_path, dropout
from tfimm_tpu_torch.quant import any_quantized
from tfimm_tpu_torch.utils.constants import (
    IMAGENET_DEFAULT_MEAN,
    IMAGENET_DEFAULT_STD,
)

__all__ = ["CaiT", "CaiTConfig", "ClassAttention", "TalkingHeadAttention",
           "LayerScaleBlock", "LayerScaleBlockClassAttention"]


@dataclass
class CaiTConfig(ModelConfig):
    nb_classes: int = 1000
    in_channels: int = 3
    input_size: Tuple[int, int] = (224, 224)
    patch_size: int = 16
    embed_dim: int = 768
    nb_blocks: int = 12
    nb_heads: int = 12
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    drop_rate: float = 0.0
    drop_path_rate: float = 0.0
    attn_drop_rate: float = 0.0
    norm_layer: str = "layer_norm_eps_1e-6"
    act_layer: str = "gelu"
    init_scale: float = 1e-4
    interpolate_input: bool = False
    crop_pct: float = 1.0
    interpolation: str = "bicubic"
    mean: Tuple[float, float, float] = IMAGENET_DEFAULT_MEAN
    std: Tuple[float, float, float] = IMAGENET_DEFAULT_STD
    first_conv: str = "patch_embed.proj"
    classifier: str = "head"

    @property
    def grid_size(self) -> Tuple[int, int]:
        return (self.input_size[0] // self.patch_size,
                self.input_size[1] // self.patch_size)

    @property
    def nb_patches(self) -> int:
        return self.grid_size[0] * self.grid_size[1]

    @property
    def transform_weights(self):
        return {"pos_embed": CaiT.transform_pos_embed}


def _dtype_scale(scale: float, dtype: torch.dtype) -> float:
    """The scale rounded to ``dtype``, as JAX rounds a Python float that
    multiplies an array of that dtype."""
    return torch.tensor(scale, dtype=dtype).item()


class ClassAttention(nn.Module):
    """Attention in which only the class token queries the sequence.
    Parameters: q.*, k.*, v.*, proj.*."""

    def __init__(self, embed_dim: int, nb_heads: int, qkv_bias: bool, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.nb_heads = nb_heads
        self.head_dim = embed_dim // nb_heads
        self.scale = self.head_dim ** -0.5
        g = generator
        self.q = Dense(embed_dim, embed_dim, use_bias=qkv_bias,
                       weight_std=0.02, generator=g)
        self.k = Dense(embed_dim, embed_dim, use_bias=qkv_bias,
                       weight_std=0.02, generator=g)
        self.v = Dense(embed_dim, embed_dim, use_bias=qkv_bias,
                       weight_std=0.02, generator=g)
        self.proj = Dense(embed_dim, embed_dim, weight_std=0.02, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        h, hd = self.nb_heads, self.head_dim
        q = self.q(x[:, :1]).reshape(b, 1, h, hd).transpose(1, 2)
        q = q * _dtype_scale(self.scale, q.dtype)
        k = self.k(x).reshape(b, n, h, hd).transpose(1, 2)
        v = self.v(x).reshape(b, n, h, hd).transpose(1, 2)
        attn = torch.matmul(q, k.transpose(-1, -2)).float()
        attn = torch.softmax(attn, dim=-1).to(x.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, 1, d)
        return self.proj(out)


class TalkingHeadAttention(nn.Module):
    """Self-attention with linear (H, H) head mixes before and after the
    softmax. Parameters: qkv.*, proj.*, proj_l.*, proj_w.* (the mixes are
    Dense layers over the head axis: their ``weight`` is the transpose of
    the JAX package's (in, out) ``kernel``)."""

    def __init__(self, embed_dim: int, nb_heads: int, qkv_bias: bool,
                 attn_drop_rate: float, proj_drop_rate: float, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.nb_heads = nb_heads
        self.head_dim = embed_dim // nb_heads
        self.scale = self.head_dim ** -0.5
        self.attn_drop_rate = attn_drop_rate
        self.proj_drop_rate = proj_drop_rate
        g = generator
        self.qkv = Dense(embed_dim, 3 * embed_dim, use_bias=qkv_bias,
                         weight_std=0.02, generator=g)
        self.proj = Dense(embed_dim, embed_dim, weight_std=0.02, generator=g)
        self.proj_l = Dense(nb_heads, nb_heads, weight_std=0.02, generator=g)
        self.proj_w = Dense(nb_heads, nb_heads, weight_std=0.02, generator=g)

    def kernel_ok(self, x: torch.Tensor) -> bool:
        """The JAX package's gate: the talking-head kernel (differentiable,
        through its backward kernel) unless attention dropout is live in
        training; a shape the kernels take; and neither head mix int8
        (the kernel reads both raw)."""
        _, n, d = x.shape
        if current_context().training and self.attn_drop_rate > 0.0:
            return False
        if any_quantized(self.proj_l, self.proj_w):
            return False
        return x.dtype in KERNEL_DTYPES and talking_head_attention_supports(
            n, d, self.nb_heads)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.kernel_ok(x):
            return self.forward_eager(x)
        log_dispatch("talking_head_attention")
        out = talking_head_attention_packed(
            self.qkv(x), self.proj_l.weight.t(), self.proj_l.bias,
            self.proj_w.weight.t(), self.proj_w.bias, nb_heads=self.nb_heads,
            scale=self.scale)
        return self._project(out)

    def forward_eager(self, x: torch.Tensor) -> torch.Tensor:
        """The JAX package's XLA path: the scale rounded to q's dtype, the
        scores and both head mixes (Dense layers over the head axis moved
        last) in the dtype, the softmax in f32, attention dropout."""
        b, n, d = x.shape
        h = self.nb_heads
        ctx = current_context()
        qkv = self.qkv(x).reshape(b, n, 3, h, self.head_dim)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        attn = torch.matmul(q * _dtype_scale(self.scale, q.dtype),
                            k.transpose(-1, -2))
        attn = self.proj_l(attn.permute(0, 2, 3, 1))
        attn = torch.softmax(attn.permute(0, 3, 1, 2).float(), dim=-1)
        attn = self.proj_w(attn.to(x.dtype).permute(0, 2, 3, 1))
        attn = dropout(attn.permute(0, 3, 1, 2), self.attn_drop_rate,
                       ctx.training, ctx.generator)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, d)
        return self._project(out)

    def _project(self, out: torch.Tensor) -> torch.Tensor:
        ctx = current_context()
        return dropout(self.proj(out), self.proj_drop_rate, ctx.training,
                       ctx.generator)


class LayerScaleBlock(nn.Module):
    """Pre-norm talking-head attention block with layer scale. Parameters:
    norm1.*, attn.*, norm2.*, mlp.*, gamma_1, gamma_2."""

    def __init__(self, cfg: CaiTConfig, drop_path_rate: float, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        norm = norm_layer_factory(cfg.norm_layer)
        d = cfg.embed_dim
        self.norm1 = norm(d)
        self.attn = TalkingHeadAttention(d, cfg.nb_heads, cfg.qkv_bias,
                                         cfg.attn_drop_rate, cfg.drop_rate,
                                         generator=generator)
        self.norm2 = norm(d)
        self.mlp = MLP(d, int(d * cfg.mlp_ratio), act_layer=cfg.act_layer,
                       drop_rate=cfg.drop_rate, weight_std=0.02,
                       generator=generator)
        self.gamma_1 = nn.Parameter(torch.full((d,), float(cfg.init_scale)))
        self.gamma_2 = nn.Parameter(torch.full((d,), float(cfg.init_scale)))
        self.drop_path_rate = drop_path_rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ctx = current_context()
        y = self.attn(self.norm1(x))
        x = x + drop_path(y * self.gamma_1.to(y.dtype), self.drop_path_rate,
                          ctx.training, ctx.generator)
        y = self.mlp(self.norm2(x))
        return x + drop_path(y * self.gamma_2.to(y.dtype), self.drop_path_rate,
                             ctx.training, ctx.generator)


class LayerScaleBlockClassAttention(nn.Module):
    """Class-attention block: updates only the class token. Parameters:
    norm1.*, attn.* (q, k, v, proj), norm2.*, mlp.*, gamma_1, gamma_2."""

    def __init__(self, cfg: CaiTConfig, drop_path_rate: float, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        norm = norm_layer_factory(cfg.norm_layer)
        d = cfg.embed_dim
        self.norm1 = norm(d)
        self.attn = ClassAttention(d, cfg.nb_heads, cfg.qkv_bias,
                                   generator=generator)
        self.norm2 = norm(d)
        self.mlp = MLP(d, int(d * cfg.mlp_ratio), act_layer=cfg.act_layer,
                       weight_std=0.02, generator=generator)
        self.gamma_1 = nn.Parameter(torch.full((d,), float(cfg.init_scale)))
        self.gamma_2 = nn.Parameter(torch.full((d,), float(cfg.init_scale)))
        self.drop_path_rate = drop_path_rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ctx = current_context()
        x_cls = x[:, :1]
        u = self.attn(self.norm1(x)) * self.gamma_1.to(x.dtype)
        x_cls = x_cls + drop_path(u, self.drop_path_rate, ctx.training,
                                  ctx.generator)
        y = self.mlp(self.norm2(x_cls))
        x_cls = x_cls + drop_path(y * self.gamma_2.to(y.dtype),
                                  self.drop_path_rate, ctx.training,
                                  ctx.generator)
        return torch.cat([x_cls, x[:, 1:]], dim=1)


class CaiT(Model):
    cfg_class = CaiTConfig

    def __init__(self, cfg: CaiTConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg)
        g = generator
        d = cfg.embed_dim
        self.nb_features = d
        self.patch_embed = PatchEmbeddings(cfg.patch_size, d,
                                           in_channels=cfg.in_channels,
                                           generator=g)
        self.cls_token = nn.Parameter(torch.empty(1, 1, d))
        self.pos_embed = nn.Parameter(torch.empty(1, cfg.nb_patches, d))
        with torch.no_grad():
            trunc_normal_(self.cls_token, 0.02, g)
            trunc_normal_(self.pos_embed, 0.02, g)
        # Every block gets the same drop-path rate (not a linear ramp); the
        # class-attention blocks get none.
        self.blocks = nn.ModuleList(
            LayerScaleBlock(cfg, cfg.drop_path_rate, generator=g)
            for _ in range(cfg.nb_blocks))
        self.blocks_token_only = nn.ModuleList(
            LayerScaleBlockClassAttention(cfg, 0.0, generator=g)
            for _ in range(2))
        self.norm = norm_layer_factory(cfg.norm_layer)(d)
        self.head = (Dense(d, cfg.nb_classes, generator=g)
                     if cfg.nb_classes > 0 else None)

    def transform_pos_embed(self, weight: torch.Tensor,
                            target_cfg: CaiTConfig) -> torch.Tensor:
        """The weight-transfer hook: the position table (no class token:
        CaiT adds it only before the class-attention stage) resized to
        ``target_cfg``'s grid."""
        return interpolate_pos_embeddings(
            weight, src_grid=self.cfg.grid_size, dst_grid=target_cfg.grid_size,
            nb_tokens=0)

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        ctx = current_context()
        x, grid = self.patch_embed(x)
        pos_embed = self.pos_embed
        if cfg.interpolate_input and grid != cfg.grid_size:
            pos_embed = interpolate_pos_embeddings(
                pos_embed, src_grid=cfg.grid_size, dst_grid=grid, nb_tokens=0)
        x = x + pos_embed.to(x.dtype)
        x = dropout(x, cfg.drop_rate, ctx.training, ctx.generator)
        capture_feature("patch_embedding", x)
        for j, block in enumerate(self.blocks):
            x = block(x)
            capture_feature(f"block_{j}", x)
        cls = self.cls_token.to(x.dtype).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1)
        capture_feature("features_cls_token", x)
        for j, block in enumerate(self.blocks_token_only):
            x = block(x)
            capture_feature(f"block_cls_token_{j}", x)
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
        return tuple(
            ["patch_embedding"]
            + [f"block_{j}" for j in range(self.cfg.nb_blocks)]
            + ["features_cls_token"]
            + [f"block_cls_token_{j}" for j in range(2)]
            + ["features_all", "features", "logits"])


# -- variant registrations ---------------------------------------------------
# The same variants, with the same configs, as tfimm_tpu/architectures/cait.py.

def _register(name, **kwargs):
    def fn():
        return CaiT, CaiTConfig(name=name, url="[timm]", **kwargs)

    fn.__name__ = name
    fn.__qualname__ = name
    fn.__module__ = __name__
    globals()[name] = fn
    register_model(fn)


_register("cait_xxs24_224", patch_size=16, embed_dim=192, nb_blocks=24,
          nb_heads=4, init_scale=1e-5)
_register("cait_xxs24_384", input_size=(384, 384), patch_size=16,
          embed_dim=192, nb_blocks=24, nb_heads=4, init_scale=1e-5)
_register("cait_xxs36_224", patch_size=16, embed_dim=192, nb_blocks=36,
          nb_heads=4, init_scale=1e-5)
_register("cait_xxs36_384", input_size=(384, 384), patch_size=16,
          embed_dim=192, nb_blocks=36, nb_heads=4, init_scale=1e-5)
_register("cait_xs24_384", input_size=(384, 384), patch_size=16,
          embed_dim=288, nb_blocks=24, nb_heads=6, init_scale=1e-5)
_register("cait_s24_224", patch_size=16, embed_dim=384, nb_blocks=24,
          nb_heads=8, init_scale=1e-5)
_register("cait_s24_384", input_size=(384, 384), patch_size=16, embed_dim=384,
          nb_blocks=24, nb_heads=8, init_scale=1e-5)
_register("cait_s36_384", input_size=(384, 384), patch_size=16, embed_dim=384,
          nb_blocks=36, nb_heads=8, init_scale=1e-6)
_register("cait_m36_384", input_size=(384, 384), patch_size=16, embed_dim=768,
          nb_blocks=36, nb_heads=16, init_scale=1e-6)
_register("cait_m48_448", input_size=(448, 448), patch_size=16, embed_dim=768,
          nb_blocks=48, nb_heads=16, init_scale=1e-6)
