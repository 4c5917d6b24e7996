"""SAM image encoder (ViT-Det style); mirror of
tfimm_tpu/architectures/segment_anything/image_encoder.py.

Windowed attention blocks with a few global-attention blocks, decomposed
relative-position embeddings (MViTv2) and a conv neck, on NHWC grids.
Parameter names are Meta's (``blocks.0.attn.rel_pos_h``, ``neck.2.weight``),
so the JAX package's parameters carry over through ``state_dict_from_jax``.

``RelPosAttention`` sends its attention to ``flash_attention_relpos``
(``ops/kernels/flash_attention_relpos.py``: the hand-written forward and
backward kernels on the card, their plain versions on the CPU) as the JAX
package's gate decides it, by the training flag of the forward's context
and not by whether autograd records:

- a global block (``GLOBAL_MIN_TOKENS`` tokens or more) takes the kernel,
  in training too, with no attention dropout, as the JAX kernel path;
- a windowed block takes the kernel unless ``current_context().training``
  is set, with or without autograd; in training it takes the eager
  composition, the JAX package's XLA path;
- without the rel-pos bias, or at a head dim or grid the kernel does not
  take, the eager composition.

The JAX package also sends only the TPU (or forced interpret mode) to its
kernel, global blocks only when N tiles into 512-key blocks, and windows
only from 128 tokens; the port's kernel takes every N, and its plain
version runs on the CPU.

Papers: SAM https://arxiv.org/abs/2304.02643, ViT-Det 2203.16527,
MViTv2 2112.01526.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from tfimm_tpu_torch.architectures.segment_anything.common import MLPBlock
from tfimm_tpu_torch.core import capture_feature, current_context
from tfimm_tpu_torch.ops.basic import Dense
from tfimm_tpu_torch.ops.conv import Conv2d
from tfimm_tpu_torch.ops.embed import PatchEmbeddings
from tfimm_tpu_torch.ops.kernels.dispatch import KERNEL_DTYPES, log_dispatch
from tfimm_tpu_torch.ops.kernels.flash_attention_relpos import (
    flash_attention_relpos,
    flash_attention_relpos_supports,
    scale_query,
)
from tfimm_tpu_torch.ops.norm import norm_layer_factory
from tfimm_tpu_torch.ops.resize import resize_linear
from tfimm_tpu_torch.ops.stochastic import drop_path, dropout

__all__ = ["ImageEncoder", "ImageEncoderBlock", "RelPosAttention",
           "window_partition", "window_unpartition", "get_rel_pos",
           "add_decomposed_rel_pos"]

# Blocks of at least this many tokens are global and take the kernel in
# training too, as in the JAX package's gate.
GLOBAL_MIN_TOKENS = 1024


def window_partition(x: torch.Tensor, window_size: int):
    """Pad (B, H, W, C) with zeros to window multiples and split it into
    windows. Returns (B * nw, ws, ws, C) and the padded (Hp, Wp)."""
    b, h, w, c = x.shape
    pad_h = (window_size - h % window_size) % window_size
    pad_w = (window_size - w % window_size) % window_size
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.reshape(b, hp // window_size, window_size, wp // window_size,
                  window_size, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, window_size, window_size, c), (hp, wp)


def window_unpartition(windows: torch.Tensor, window_size: int, pad_hw, hw):
    """Inverse of ``window_partition``, with the padding cut off."""
    hp, wp = pad_hw
    h, w = hw
    c = windows.shape[-1]
    b = windows.shape[0] // ((hp // window_size) * (wp // window_size))
    x = windows.reshape(b, hp // window_size, wp // window_size, window_size,
                        window_size, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)
    if hp > h or wp > w:
        x = x[:, :h, :w]
    return x


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor,
                interpolate_pos: bool) -> torch.Tensor:
    """Relative positional embeddings for given query and key sizes:
    (q_size, k_size, C). With ``interpolate_pos`` a table of another length
    is first resized in f32 (``resize_linear``, as ``jax.image.resize``)."""
    max_rel_dist = 2 * max(q_size, k_size) - 1
    if interpolate_pos and rel_pos.shape[0] != max_rel_dist:
        rel_pos = resize_linear(rel_pos.float(), (max_rel_dist, rel_pos.shape[1]))
    return rel_pos[_relative_index(q_size, k_size, rel_pos.device)]


@functools.lru_cache(maxsize=64)
def _relative_index(q_size: int, k_size: int,
                    device: torch.device) -> torch.Tensor:
    """(q_size, k_size) int64 rows of the rel-pos table, computed on the host
    as the JAX package computes them and copied to ``device`` once: a copy
    from host memory at every call would wait for the device each time."""
    q_coords = np.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k_coords = np.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    relative = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    with torch.inference_mode(False):   # a cached tensor may meet autograd
        return torch.as_tensor(relative.astype(np.int64), device=device)


def add_decomposed_rel_pos(attn, q, rel_pos_h, rel_pos_w, q_size, k_size,
                           interpolate_pos: bool) -> torch.Tensor:
    """Add the decomposed rel-pos bias (MViTv2) to the attention map, in its
    dtype. attn (B*, qh*qw, kh*kw), q (B*, qh*qw, C)."""
    q_h, q_w = q_size
    k_h, k_w = k_size
    n, _, c = q.shape
    r_h = get_rel_pos(q_h, k_h, rel_pos_h, interpolate_pos)
    r_w = get_rel_pos(q_w, k_w, rel_pos_w, interpolate_pos)
    q_grid = q.reshape(n, q_h, q_w, c)
    rel_h = torch.einsum("nhwc,hkc->nhwk", q_grid, r_h.to(q.dtype))
    rel_w = torch.einsum("nhwc,wkc->nhwk", q_grid, r_w.to(q.dtype))
    attn = attn.reshape(n, q_h, q_w, k_h, k_w)
    attn = attn + (rel_h[..., :, None] + rel_w[..., None, :]).to(attn.dtype)
    return attn.reshape(n, q_h * q_w, k_h * k_w)


class RelPosAttention(nn.Module):
    """Multi-head attention over a (B, H, W, C) grid with decomposed rel-pos
    embeddings. Parameters: qkv.*, proj.*, and with ``use_rel_pos``
    rel_pos_h (2H - 1, d) and rel_pos_w (2W - 1, d), zero at init."""

    def __init__(self, fixed_input_size: bool, embed_dim: int, nb_heads: int,
                 qkv_bias: bool, use_rel_pos: bool, drop_rate: float,
                 attn_drop_rate: float, rel_pos_size: Tuple[int, int], *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fixed_input_size = fixed_input_size
        self.nb_heads = nb_heads
        self.head_dim = embed_dim // nb_heads
        self.scale = self.head_dim ** -0.5
        self.use_rel_pos = use_rel_pos
        self.drop_rate = drop_rate
        self.attn_drop_rate = attn_drop_rate
        self.rel_pos_size = tuple(rel_pos_size)
        self.qkv = Dense(embed_dim, 3 * embed_dim, use_bias=qkv_bias,
                         generator=generator)
        self.proj = Dense(embed_dim, embed_dim, generator=generator)
        if use_rel_pos:
            h, w = self.rel_pos_size
            self.rel_pos_h = nn.Parameter(torch.zeros(2 * h - 1, self.head_dim))
            self.rel_pos_w = nn.Parameter(torch.zeros(2 * w - 1, self.head_dim))

    def kernel_ok(self, grid: Tuple[int, int], dtype: torch.dtype) -> bool:
        """The gate (see the module's note) for a ``grid`` of tokens in
        ``dtype``."""
        if not (self.use_rel_pos and dtype in KERNEL_DTYPES
                and flash_attention_relpos_supports(self.head_dim, grid)):
            return False
        return (grid[0] * grid[1] >= GLOBAL_MIN_TOKENS
                or not current_context().training)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, c = x.shape
        qkv = self.qkv(x).reshape(n, h * w, 3, self.nb_heads, self.head_dim)
        qkv = qkv.permute(2, 0, 3, 1, 4).reshape(3, n * self.nb_heads, h * w,
                                                 self.head_dim)
        q, k, v = qkv.unbind(0)
        if self.kernel_ok((h, w), q.dtype):
            log_dispatch("flash_attention_relpos")
            interpolate = not self.fixed_input_size
            r_h = get_rel_pos(h, h, self.rel_pos_h, interpolate).to(q.dtype)
            r_w = get_rel_pos(w, w, self.rel_pos_w, interpolate).to(q.dtype)
            qg = q.reshape(-1, h, w, self.head_dim)
            rh_term = torch.einsum("bhwc,hkc->bhwk", qg, r_h).reshape(-1, h * w, h)
            rw_term = torch.einsum("bhwc,wkc->bhwk", qg, r_w).reshape(-1, h * w, w)
            out = flash_attention_relpos(q, k, v, rh_term, rw_term,
                                         grid_size=(h, w), scale=self.scale)
        else:
            out = self.attention_eager(q, k, v, (h, w))
        out = out.reshape(n, self.nb_heads, h, w, self.head_dim)
        out = out.permute(0, 2, 3, 1, 4).reshape(n, h, w, c)
        ctx = current_context()
        return dropout(self.proj(out), self.drop_rate, ctx.training,
                       ctx.generator)

    def attention_eager(self, q, k, v, grid: Tuple[int, int]) -> torch.Tensor:
        """The JAX package's XLA path: the scale rounded to q's dtype, the
        scores and the bias in the dtype, the softmax in f32, attention
        dropout."""
        ctx = current_context()
        attn = torch.matmul(scale_query(q, self.scale), k.transpose(-1, -2))
        if self.use_rel_pos:
            attn = add_decomposed_rel_pos(
                attn, q, self.rel_pos_h, self.rel_pos_w, grid, grid,
                interpolate_pos=not self.fixed_input_size)
        attn = torch.softmax(attn.float(), dim=-1).to(q.dtype)
        attn = dropout(attn, self.attn_drop_rate, ctx.training, ctx.generator)
        return torch.matmul(attn, v)


class ImageEncoderBlock(nn.Module):
    """Pre-norm block, windowed (``window_size`` > 0) or global. Parameters:
    norm1.*, attn.*, norm2.*, mlp.* (lin1, lin2)."""

    def __init__(self, fixed_input_size: bool, embed_dim: int, nb_heads: int,
                 mlp_ratio: float, qkv_bias: bool, norm_layer: str,
                 act_layer: str, use_rel_pos: bool, window_size: int,
                 grid_size: Tuple[int, int], drop_rate: float,
                 attn_drop_rate: float, drop_path_rate: float, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        norm = norm_layer_factory(norm_layer)
        self.window_size = window_size
        rel_size = ((window_size, window_size) if window_size > 0
                    else tuple(grid_size))
        self.norm1 = norm(embed_dim)
        self.attn = RelPosAttention(fixed_input_size, embed_dim, nb_heads,
                                    qkv_bias, use_rel_pos, drop_rate,
                                    attn_drop_rate, rel_size,
                                    generator=generator)
        self.norm2 = norm(embed_dim)
        self.mlp = MLPBlock(embed_dim, int(embed_dim * mlp_ratio), act_layer,
                            drop_rate, generator=generator)
        self.drop_path_rate = drop_path_rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ctx = current_context()
        shortcut = x
        x = self.norm1(x)
        if self.window_size > 0:
            hw = (x.shape[1], x.shape[2])
            x, pad_hw = window_partition(x, self.window_size)
        x = self.attn(x)
        if self.window_size > 0:
            x = window_unpartition(x, self.window_size, pad_hw, hw)
        x = shortcut + drop_path(x, self.drop_path_rate, ctx.training,
                                 ctx.generator)
        y = self.mlp(self.norm2(x))
        return x + drop_path(y, self.drop_path_rate, ctx.training,
                             ctx.generator)


class ImageEncoder(nn.Module):
    """Patch embedding, absolute position embedding, the blocks and the
    neck. (B, H, W, C) images -> (B, H / p, W / p, out_channels).
    Parameters: patch_embed.proj.*, pos_embed (1, H / p, W / p, D),
    blocks.*, neck.0 (1x1 conv), neck.1 (LayerNorm), neck.2 (3x3 conv),
    neck.3 (LayerNorm)."""

    def __init__(self, input_size=(1024, 1024), fixed_input_size=True,
                 patch_size=16, in_channels=3, embed_dim=768, nb_blocks=12,
                 nb_heads=12, mlp_ratio=4.0, out_channels=256, qkv_bias=True,
                 norm_layer="layer_norm", act_layer="gelu", use_abs_pos=True,
                 use_rel_pos=False, global_attn_indices=(), window_size=0,
                 drop_rate=0.0, attn_drop_rate=0.0, drop_path_rate=0.0, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.input_size = tuple(input_size)
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.use_abs_pos = use_abs_pos
        self.fixed_input_size = fixed_input_size
        self.patch_embed = PatchEmbeddings(patch_size, embed_dim,
                                           in_channels=in_channels, generator=g)
        if use_abs_pos:
            self.pos_embed = nn.Parameter(torch.zeros(1, *self.grid_size,
                                                      embed_dim))
        self.blocks = nn.ModuleList(
            ImageEncoderBlock(
                fixed_input_size, embed_dim, nb_heads, mlp_ratio, qkv_bias,
                norm_layer, act_layer, use_rel_pos,
                window_size=window_size if j not in global_attn_indices else 0,
                grid_size=self.grid_size, drop_rate=drop_rate,
                attn_drop_rate=attn_drop_rate, drop_path_rate=drop_path_rate,
                generator=g)
            for j in range(nb_blocks))
        neck_norm = norm_layer_factory("layer_norm_eps_1e-6")
        self.neck = nn.ModuleList([
            Conv2d(embed_dim, out_channels, 1, use_bias=False, generator=g),
            neck_norm(out_channels),
            Conv2d(out_channels, out_channels, 3, stride=1, padding=1,
                   use_bias=False, generator=g),
            neck_norm(out_channels),
        ])

    @property
    def grid_size(self) -> Tuple[int, int]:
        return (self.input_size[0] // self.patch_size,
                self.input_size[1] // self.patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, grid = self.patch_embed(x)
        x = x.reshape(x.shape[0], *grid, x.shape[-1])
        if self.use_abs_pos:
            pos_embed = self.pos_embed
            if tuple(pos_embed.shape[1:3]) != grid:
                pos_embed = resize_linear(pos_embed.float(),
                                          (1, *grid, pos_embed.shape[-1]))
            x = x + pos_embed.to(x.dtype)
        capture_feature("patch_embedding", x)
        for j, block in enumerate(self.blocks):
            x = block(x)
            capture_feature(f"block_{j}", x)
        for layer in self.neck:
            x = layer(x)
        capture_feature("neck", x)
        return x
