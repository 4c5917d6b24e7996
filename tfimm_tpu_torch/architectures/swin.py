"""Swin Transformer; mirror of tfimm_tpu/architectures/swin.py.

Window partition and reverse, the cyclic shift, the shifted-window mask and
the relative-position index are built once per module in numpy; the mask
and the index are non-persistent buffers, since timm's state dicts carry
neither. Parameter names are timm's (``layers.0.blocks.1.attn.qkv``,
``layers.0.downsample.reduction``, ``head``), so timm checkpoints load with
``load_state_dict``.

At inference a Swin block runs as one call of ``swin_block`` (the
hand-written kernel on the card, its plain version on the CPU) where the
block's gate takes it, and a stage whose every block takes it keeps its
activation in the window layout from its first block to its last, with one
token gather between blocks (``ops/window_gather.py``). A block the gate
declines runs per op, with its attention through ``window_mha`` on the
packed qkv. The whole-block kernel has no backward, so in training and
where autograd records every block runs per op, as the JAX package's gates
and its stage-level custom VJP make it; the attention then trains through
``window_mha`` and its backward kernel ``window_mha_bwd``. Only live
attention dropout in training, or a shape the kernel does not take, sends
the attention to its eager composition (``WindowAttention.forward_eager``),
which keeps the JAX package's XLA roundings.

Paper: Swin Transformer, https://arxiv.org/abs/2103.14030.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from tfimm_tpu_torch.core import capture_feature, current_context
from tfimm_tpu_torch.models.base import Model
from tfimm_tpu_torch.models.config import ModelConfig
from tfimm_tpu_torch.models.registry import register_model
from tfimm_tpu_torch.ops.basic import Dense, trunc_normal_
from tfimm_tpu_torch.ops.embed import PatchEmbeddings
from tfimm_tpu_torch.ops.kernels.dispatch import KERNEL_DTYPES, log_dispatch
from tfimm_tpu_torch.ops.kernels.swin_block import SwinBlockParams, swin_block
from tfimm_tpu_torch.ops.kernels.window_mha import (
    window_mha_packed,
    window_mha_supports,
)
from tfimm_tpu_torch.ops.mlp import MLP
from tfimm_tpu_torch.ops.norm import norm_layer_factory
from tfimm_tpu_torch.ops.stochastic import drop_path, dropout
from tfimm_tpu_torch.ops.window_gather import (
    pack_windows,
    repack_windows,
    unpack_windows,
)
from tfimm_tpu_torch.quant import any_quantized
from tfimm_tpu_torch.utils.constants import (
    IMAGENET_DEFAULT_MEAN,
    IMAGENET_DEFAULT_STD,
)

__all__ = ["SwinTransformer", "SwinTransformerConfig", "WindowAttention",
           "SwinTransformerBlock", "PatchMerging", "SwinTransformerStage",
           "window_partition", "window_reverse"]

# The whole-block kernel takes a block whose matrices (qkv, proj, fc1, fc2:
# 12 C^2 values) weigh at most this much in the dtype. It is written for the
# window-resident regime, where the activation streams past small weights
# and a block run per op is held back by its passes over the activation:
# Swin-T's stages 1-3 (0.22, 0.88 and 3.5 MB in bf16; 7.1 MB at stage 3 in
# f32). A block with more weight (Swin-T's stage 4, 14.2 MB, over only 128
# windows at batch 128) is a set of large products, which cuBLAS runs near
# the card's peak; it runs per op, with its attention through window_mha.
# The line does not depend on the batch, and falls where the JAX package's
# VMEM plan puts it for Swin-T. On an H100 this first form of the kernel
# beats the per-op block at stages 1-2 and not yet at stage 3 (PERF.md,
# section 6).
SWIN_BLOCK_MAX_WEIGHT_BYTES = 8 * 2 ** 20


@dataclass
class SwinTransformerConfig(ModelConfig):
    nb_classes: int = 1000
    in_channels: int = 3
    input_size: Tuple[int, int] = (224, 224)
    patch_size: int = 4
    embed_dim: int = 96
    nb_blocks: Tuple = (2, 2, 6, 2)
    nb_heads: Tuple = (3, 6, 12, 24)
    window_size: int = 7
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.1
    norm_layer: str = "layer_norm"
    act_layer: str = "gelu"
    patch_norm: bool = True
    interpolate_input: bool = False
    crop_pct: float = 0.9
    interpolation: str = "bicubic"
    mean: Tuple[float, float, float] = IMAGENET_DEFAULT_MEAN
    std: Tuple[float, float, float] = IMAGENET_DEFAULT_STD
    first_conv: str = "patch_embed.proj"
    classifier: str = "head"

    @property
    def patch_resolution(self):
        return (self.input_size[0] // self.patch_size,
                self.input_size[1] // self.patch_size)

    @property
    def nb_patches(self):
        return self.patch_resolution[0] * self.patch_resolution[1]


def window_partition(x: torch.Tensor, window_size: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nb_windows, ws, ws, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // window_size, window_size, w // window_size,
                  window_size, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window_size, window_size, c)


def window_reverse(windows: torch.Tensor, window_size: int, h: int,
                   w: int) -> torch.Tensor:
    """(B * nb_windows, ws, ws, C) -> (B, H, W, C)."""
    c = windows.shape[-1]
    x = windows.reshape(-1, h // window_size, w // window_size, window_size,
                        window_size, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, h, w, c)


def _relative_position_index(window_size: int) -> np.ndarray:
    """(ws^2, ws^2) index into the (2 ws - 1)^2 rows of the bias table."""
    coords = np.stack(np.meshgrid(np.arange(window_size),
                                  np.arange(window_size), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += window_size - 1
    rel[:, :, 1] += window_size - 1
    rel[:, :, 0] *= 2 * window_size - 1
    return rel.sum(-1).astype(np.int64)


def _attention_mask(input_size, window_size: int,
                    shift_size: int) -> np.ndarray:
    """(nb_windows, ws^2, ws^2) mask of the 9 shifted regions: 0 within a
    region, -100 across (not -inf)."""
    h, w = input_size
    img_mask = np.zeros((h, w), dtype=np.float32)
    slices = (slice(0, -window_size), slice(-window_size, -shift_size),
              slice(-shift_size, None))
    cnt = 0
    for hs in slices:
        for ws in slices:
            img_mask[hs, ws] = cnt
            cnt += 1
    mw = img_mask.reshape(h // window_size, window_size, w // window_size,
                          window_size).transpose(0, 2, 1, 3)
    mask_windows = mw.reshape(-1, window_size ** 2)
    diff = mask_windows[:, None, :] - mask_windows[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def _autograd_records(x: torch.Tensor, module: nn.Module) -> bool:
    return torch.is_grad_enabled() and (
        x.requires_grad or any(p.requires_grad for p in module.parameters()))


class WindowAttention(nn.Module):
    """Window MHA with a learned relative-position bias. Parameters: qkv.*,
    proj.*, relative_position_bias_table ((2 ws - 1)^2, H)."""

    def __init__(self, embed_dim: int, nb_heads: int, window_size: int,
                 qkv_bias: bool = True, attn_drop_rate: float = 0.0,
                 proj_drop_rate: float = 0.0, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.nb_heads = nb_heads
        self.head_dim = embed_dim // nb_heads
        self.scale = self.head_dim ** -0.5
        self.window_size = window_size
        self.attn_drop_rate = attn_drop_rate
        self.proj_drop_rate = proj_drop_rate
        self.qkv = Dense(embed_dim, 3 * embed_dim, use_bias=qkv_bias,
                         weight_std=0.02, generator=generator)
        self.proj = Dense(embed_dim, embed_dim, weight_std=0.02,
                          generator=generator)
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * window_size - 1) ** 2, nb_heads))
        with torch.no_grad():
            trunc_normal_(self.relative_position_bias_table, 0.02, generator)
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(_relative_position_index(window_size)),
            persistent=False)

    def relative_position_bias(self) -> torch.Tensor:
        """(H, N, N) in the table's dtype."""
        n = self.window_size ** 2
        table = self.relative_position_bias_table
        bias = table[self.relative_position_index.reshape(-1)]
        return bias.reshape(n, n, self.nb_heads).permute(2, 0, 1)

    def _kernel_ok(self, x: torch.Tensor) -> bool:
        """The JAX package's gate: the window_mha kernel (differentiable,
        through its backward kernel) unless attention dropout is live in
        training; a shape the kernel takes; and qkv not int8 (the JAX gate
        checks qkv alone)."""
        _, n, c = x.shape
        if current_context().training and self.attn_drop_rate > 0.0:
            return False
        if any_quantized(self.qkv):
            return False
        return x.dtype in KERNEL_DTYPES and window_mha_supports(
            n, c, self.nb_heads)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if not self._kernel_ok(x):
            return self.forward_eager(x, mask)
        log_dispatch("window_mha")
        out = window_mha_packed(self.qkv(x), self.relative_position_bias(),
                                mask, nb_heads=self.nb_heads, scale=self.scale)
        return self._project(out)

    def forward_eager(self, x: torch.Tensor,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The JAX package's XLA path: the scale rounded to q's dtype, the
        scores and the bias and mask adds in the dtype, the softmax in f32,
        attention dropout."""
        bw, n, c = x.shape  # (B * nb_windows, ws^2, C)
        h = self.nb_heads
        ctx = current_context()
        qkv = self.qkv(x).reshape(bw, n, 3, h, self.head_dim)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        scale = torch.tensor(self.scale, dtype=q.dtype).item()
        attn = torch.matmul(q * scale, k.transpose(-1, -2))
        attn = attn + self.relative_position_bias().to(attn.dtype)[None]
        if mask is not None:
            nb_win = mask.shape[0]
            attn = (attn.reshape(-1, nb_win, h, n, n)
                    + mask.to(attn.dtype)[None, :, None])
            attn = attn.reshape(-1, h, n, n)
        attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
        attn = dropout(attn, self.attn_drop_rate, ctx.training, ctx.generator)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(bw, n, c)
        return self._project(out)

    def _project(self, out: torch.Tensor) -> torch.Tensor:
        ctx = current_context()
        return dropout(self.proj(out), self.proj_drop_rate, ctx.training,
                       ctx.generator)


class SwinTransformerBlock(nn.Module):
    def __init__(self, cfg: SwinTransformerConfig, input_size, embed_dim: int,
                 nb_heads: int, drop_path_rate: float, shift_size: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_size = tuple(input_size)
        self.shift_size = shift_size
        self.window_size = cfg.window_size
        if min(input_size) <= self.window_size:
            self.shift_size = 0
            self.window_size = min(input_size)
        norm = norm_layer_factory(cfg.norm_layer)
        self.norm1 = norm(embed_dim)
        self.attn = WindowAttention(embed_dim, nb_heads, self.window_size,
                                    qkv_bias=cfg.qkv_bias,
                                    attn_drop_rate=cfg.attn_drop_rate,
                                    proj_drop_rate=cfg.drop_rate,
                                    generator=generator)
        self.norm2 = norm(embed_dim)
        self.mlp = MLP(embed_dim, int(embed_dim * cfg.mlp_ratio),
                       act_layer=cfg.act_layer, drop_rate=cfg.drop_rate,
                       weight_std=0.02, generator=generator)
        self.drop_path_rate = drop_path_rate
        # The block kernel hard-codes LayerNorm (eps 1e-5) and the GELU
        # policy: any other norm or activation declines it.
        self.fused_block_ok = (cfg.norm_layer == "layer_norm"
                               and cfg.act_layer == "gelu")
        mask = None
        if self.shift_size > 0:
            mask = torch.from_numpy(_attention_mask(
                self.input_size, self.window_size, self.shift_size))
        self.register_buffer("attn_mask", mask, persistent=False)

    def block_kernel_ok(self, x: torch.Tensor) -> bool:
        """Gate for ``swin_block``: inference, as in the JAX package (drop
        path and dropout are the identity), LayerNorm + GELU, windows that
        tile the map, shapes the attention takes, matrices within
        ``SWIN_BLOCK_MAX_WEIGHT_BYTES`` in x's dtype, autograd not
        recording (the kernel has no backward), and none of the four
        weights the kernel reads raw int8 (qkv, proj, fc1, fc2: the JAX
        block's and stage's ``any_quantized`` checks)."""
        h, w = self.input_size
        ws, c = self.window_size, x.shape[-1]
        if current_context().training or not self.fused_block_ok or h % ws \
                or w % ws or x.dtype not in KERNEL_DTYPES:
            return False
        if any_quantized(self.attn.qkv, self.attn.proj, self.mlp.fc1,
                         self.mlp.fc2):
            return False
        if not window_mha_supports(ws * ws, c, self.attn.nb_heads):
            return False
        weights = (self.attn.qkv.weight, self.attn.proj.weight,
                   self.mlp.fc1.weight, self.mlp.fc2.weight)
        nbytes = sum(t.numel() for t in weights) * x.element_size()
        if nbytes > SWIN_BLOCK_MAX_WEIGHT_BYTES:
            return False
        return not _autograd_records(x, self)

    def block_kernel(self, windows: torch.Tensor) -> torch.Tensor:
        """The whole block on (B * nb_windows, ws^2, C) windows of the
        rolled map; callers check ``block_kernel_ok`` first."""
        log_dispatch("swin_block")
        attn, mlp = self.attn, self.mlp
        qkv_bias = attn.qkv.bias
        if qkv_bias is None:
            qkv_bias = torch.zeros(attn.qkv.out_features,
                                   device=windows.device)
        params = SwinBlockParams(
            self.norm1.weight, self.norm1.bias, attn.qkv.weight, qkv_bias,
            attn.proj.weight, attn.proj.bias, self.norm2.weight,
            self.norm2.bias, mlp.fc1.weight, mlp.fc1.bias, mlp.fc2.weight,
            mlp.fc2.bias)
        return swin_block(windows, params, attn.relative_position_bias(),
                          self.attn_mask, nb_heads=attn.nb_heads,
                          scale=attn.scale, eps=self.norm1.eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = self.input_size
        b, _, c = x.shape
        ws, ss = self.window_size, self.shift_size
        if self.block_kernel_ok(x):
            wins = pack_windows(x, h, w, ws, ss).reshape(-1, ws * ws, c)
            out = self.block_kernel(wins).reshape(b, -1, c)
            return unpack_windows(out, h, w, ws, ss)

        ctx = current_context()
        shortcut = x
        x = self.norm1(x).reshape(b, h, w, c)
        if ss > 0:
            x = torch.roll(x, shifts=(-ss, -ss), dims=(1, 2))
        windows = window_partition(x, ws).reshape(-1, ws * ws, c)
        attn_out = self.attn(windows, mask=self.attn_mask)
        x = window_reverse(attn_out.reshape(-1, ws, ws, c), ws, h, w)
        if ss > 0:
            x = torch.roll(x, shifts=(ss, ss), dims=(1, 2))
        x = shortcut + drop_path(x.reshape(b, h * w, c), self.drop_path_rate,
                                 ctx.training, ctx.generator)
        y = self.mlp(self.norm2(x))
        return x + drop_path(y, self.drop_path_rate, ctx.training,
                             ctx.generator)


class PatchMerging(nn.Module):
    """2x2 neighbours concatenated, LayerNorm, Dense 4C -> 2C without bias.
    Parameters: norm.*, reduction.weight."""

    def __init__(self, cfg: SwinTransformerConfig, input_size, embed_dim: int,
                 *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_size = tuple(input_size)
        self.norm = norm_layer_factory(cfg.norm_layer)(4 * embed_dim)
        self.reduction = Dense(4 * embed_dim, 2 * embed_dim, use_bias=False,
                               weight_std=0.02, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = self.input_size
        b, _, c = x.shape
        x = x.reshape(b, h, w, c)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1)
        x = x.reshape(b, (h // 2) * (w // 2), 4 * c)
        return self.reduction(self.norm(x))


class SwinTransformerStage(nn.Module):
    def __init__(self, cfg: SwinTransformerConfig, input_size, embed_dim: int,
                 nb_blocks: int, nb_heads: int, drop_path_rates,
                 downsample: bool, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinTransformerBlock(
                cfg, input_size, embed_dim, nb_heads,
                float(drop_path_rates[i]),
                shift_size=0 if i % 2 == 0 else cfg.window_size // 2,
                generator=generator)
            for i in range(nb_blocks))
        self.downsample = (PatchMerging(cfg, input_size, embed_dim,
                                        generator=generator)
                           if downsample else None)

    def _resident_applies(self, x: torch.Tensor) -> bool:
        """Every block takes the block kernel."""
        return len(self.blocks) > 0 and all(blk.block_kernel_ok(x)
                                            for blk in self.blocks)

    def _window_resident(self, x: torch.Tensor) -> torch.Tensor:
        """Every block through the block kernel while the activation stays
        in the window layout: one gather into it, one between consecutive
        blocks (un-window at one shift and re-window at the next, composed)
        and one out of it. Callers check ``_resident_applies`` first."""
        b, _, c = x.shape
        blk0 = self.blocks[0]
        h, w = blk0.input_size
        ws = blk0.window_size
        flat = pack_windows(x, h, w, ws, blk0.shift_size)
        for i, blk in enumerate(self.blocks):
            if i > 0:
                flat = repack_windows(flat, h, w, ws,
                                      self.blocks[i - 1].shift_size,
                                      blk.shift_size)
            flat = blk.block_kernel(flat.reshape(-1, ws * ws, c)).reshape(
                b, -1, c)
        return unpack_windows(flat, h, w, ws, self.blocks[-1].shift_size)

    def forward(self, x: torch.Tensor, stage_idx: int) -> torch.Tensor:
        # Where autograd records, a block declines the block kernel and the
        # stage runs per block, as the JAX package's custom VJP of the
        # window-resident stage does under differentiation.
        if not current_context().capture_features and self._resident_applies(x):
            log_dispatch("swin_window_resident_stage")
            x = self._window_resident(x)
            return self.downsample(x) if self.downsample is not None else x
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            capture_feature(f"stage_{stage_idx}/block_{i}", x)
        if self.downsample is not None:
            x = self.downsample(x)
        capture_feature(f"stage_{stage_idx}/features", x)
        return x


class SwinTransformer(Model):
    cfg_class = SwinTransformerConfig

    def __init__(self, cfg: SwinTransformerConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg)
        g = generator
        norm = norm_layer_factory(cfg.norm_layer)
        self.patch_embed = PatchEmbeddings(
            cfg.patch_size, cfg.embed_dim, in_channels=cfg.in_channels,
            norm_layer=cfg.norm_layer if cfg.patch_norm else None,
            generator=g)
        dpr = np.linspace(0.0, cfg.drop_path_rate, sum(cfg.nb_blocks))
        dpr = np.split(dpr, np.cumsum(cfg.nb_blocks))
        nb_stages = len(cfg.nb_blocks)
        self.layers = nn.ModuleList(
            SwinTransformerStage(
                cfg,
                input_size=(cfg.patch_resolution[0] // (2 ** j),
                            cfg.patch_resolution[1] // (2 ** j)),
                embed_dim=int(cfg.embed_dim * 2 ** j),
                nb_blocks=cfg.nb_blocks[j], nb_heads=cfg.nb_heads[j],
                drop_path_rates=dpr[j], downsample=j < nb_stages - 1,
                generator=g)
            for j in range(nb_stages))
        self.nb_features = int(cfg.embed_dim * 2 ** (nb_stages - 1))
        self.norm = norm(self.nb_features)
        self.head = (Dense(self.nb_features, cfg.nb_classes, generator=g)
                     if cfg.nb_classes > 0 else None)

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        ctx = current_context()
        x, _ = self.patch_embed(x)
        x = dropout(x, self.cfg.drop_rate, ctx.training, ctx.generator)
        capture_feature("patch_embedding", x)
        for j, stage in enumerate(self.layers):
            x = stage(x, j)
        x = self.norm(x)
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
        names = ["patch_embedding"]
        for j, n in enumerate(self.cfg.nb_blocks):
            names += [f"stage_{j}/block_{i}" for i in range(n)]
            names.append(f"stage_{j}/features")
        return tuple(names + ["features_all", "features", "logits"])


# -- variant registrations ---------------------------------------------------
# The same variants, with the same configs, as tfimm_tpu/architectures/swin.py.

def _register(name, **kwargs):
    def fn():
        return SwinTransformer, SwinTransformerConfig(name=name, url="[timm]",
                                                      **kwargs)

    fn.__name__ = name
    fn.__qualname__ = name
    fn.__module__ = __name__
    globals()[name] = fn
    register_model(fn)


_TINY = dict(embed_dim=96, nb_heads=(3, 6, 12, 24))
_BASE = dict(embed_dim=128, nb_heads=(4, 8, 16, 32))
_LARGE = dict(embed_dim=192, nb_heads=(6, 12, 24, 48))
_DEEP = dict(nb_blocks=(2, 2, 18, 2))
_384 = dict(input_size=(384, 384), window_size=12, crop_pct=1.0)
_IN22K = dict(nb_classes=21841)

_register("swin_tiny_patch4_window7_224", **_TINY, nb_blocks=(2, 2, 6, 2))
_register("swin_small_patch4_window7_224", **_TINY, **_DEEP)
_register("swin_base_patch4_window7_224", **_BASE, **_DEEP)
_register("swin_base_patch4_window12_384", **_BASE, **_DEEP, **_384)
_register("swin_base_patch4_window7_224_in22k", **_BASE, **_DEEP, **_IN22K)
_register("swin_base_patch4_window12_384_in22k", **_BASE, **_DEEP, **_384,
          **_IN22K)
_register("swin_large_patch4_window7_224", **_LARGE, **_DEEP)
_register("swin_large_patch4_window12_384", **_LARGE, **_DEEP, **_384)
_register("swin_large_patch4_window7_224_in22k", **_LARGE, **_DEEP, **_IN22K)
_register("swin_large_patch4_window12_384_in22k", **_LARGE, **_DEEP, **_384,
          **_IN22K)
