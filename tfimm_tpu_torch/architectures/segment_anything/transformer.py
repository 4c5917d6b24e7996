"""SAM two-way transformer; mirror of
tfimm_tpu/architectures/segment_anything/transformer.py.

Token <-> image cross attention with optional head-dim downsampling. Plain
PyTorch ops: the JAX package runs no kernel here either.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from tfimm_tpu_torch.architectures.segment_anything.common import MLPBlock
from tfimm_tpu_torch.ops.basic import Dense
from tfimm_tpu_torch.ops.norm import norm_layer_factory

__all__ = ["TwoWayTransformer", "TwoWayAttentionBlock", "DownsampleAttention"]


class DownsampleAttention(nn.Module):
    """Attention with internal dim ``embed_dim / downsample_rate``.
    Parameters: q_proj.*, k_proj.*, v_proj.*, out_proj.*."""

    def __init__(self, embed_dim: int, nb_heads: int, downsample_rate: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.nb_heads = nb_heads
        self.internal_dim = embed_dim // downsample_rate
        self.q_proj = Dense(embed_dim, self.internal_dim, generator=g)
        self.k_proj = Dense(embed_dim, self.internal_dim, generator=g)
        self.v_proj = Dense(embed_dim, self.internal_dim, generator=g)
        self.out_proj = Dense(self.internal_dim, embed_dim, generator=g)

    def forward(self, q, k, v) -> torch.Tensor:
        """The JAX package's roundings: the scores in the dtype, then in f32
        divided by the f32 sqrt of the head dim, a max-subtracted softmax,
        and a cast back to the dtype."""
        b = q.shape[0]
        h = self.nb_heads
        hd = self.internal_dim // h
        q = self.q_proj(q).reshape(b, -1, h, hd).transpose(1, 2)
        k = self.k_proj(k).reshape(b, -1, h, hd).transpose(1, 2)
        v = self.v_proj(v).reshape(b, -1, h, hd).transpose(1, 2)
        attn = torch.matmul(q, k.transpose(-1, -2)).float()
        attn = attn / float(np.sqrt(np.float32(hd)))
        attn = torch.softmax(attn, dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, -1,
                                                            self.internal_dim)
        return self.out_proj(out)


class TwoWayAttentionBlock(nn.Module):
    """(1) token self-attention, (2) token -> image cross-attention, (3) token
    MLP, (4) image -> token cross-attention. Parameters: self_attn.*,
    norm1.*, cross_attn_token_to_image.*, norm2.*, mlp.*, norm3.*,
    cross_attn_image_to_token.*, norm4.*."""

    def __init__(self, embed_dim: int, nb_heads: int, mlp_dim: int,
                 attention_downsample_rate: int, skip_first_layer_pe: bool,
                 act_layer: str, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        norm = norm_layer_factory("layer_norm")
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = DownsampleAttention(embed_dim, nb_heads, 1, generator=g)
        self.norm1 = norm(embed_dim)
        self.cross_attn_token_to_image = DownsampleAttention(
            embed_dim, nb_heads, attention_downsample_rate, generator=g)
        self.norm2 = norm(embed_dim)
        self.mlp = MLPBlock(embed_dim, mlp_dim, act_layer, generator=g)
        self.norm3 = norm(embed_dim)
        self.cross_attn_image_to_token = DownsampleAttention(
            embed_dim, nb_heads, attention_downsample_rate, generator=g)
        self.norm4 = norm(embed_dim)

    def forward(self, q, k, q_pe, k_pe):
        if self.skip_first_layer_pe:
            q = self.self_attn(q, q, q)
        else:
            q = q + self.self_attn(q + q_pe, q + q_pe, q)
        q = self.norm1(q)
        q = q + self.cross_attn_token_to_image(q + q_pe, k + k_pe, k)
        q = self.norm2(q)
        q = q + self.mlp(q)
        q = self.norm3(q)
        k = k + self.cross_attn_image_to_token(k + k_pe, q + q_pe, q)
        k = self.norm4(k)
        return q, k


class TwoWayTransformer(nn.Module):
    """Parameters: layers.*, final_attn_token_to_image.*, norm_final_attn.*."""

    def __init__(self, embed_dim: int, nb_blocks: int, nb_heads: int,
                 mlp_dim: int, attention_downsample_rate: int, act_layer: str,
                 *, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(embed_dim, nb_heads, mlp_dim,
                                 attention_downsample_rate,
                                 skip_first_layer_pe=(j == 0),
                                 act_layer=act_layer, generator=g)
            for j in range(nb_blocks))
        self.final_attn_token_to_image = DownsampleAttention(
            embed_dim, nb_heads, attention_downsample_rate, generator=g)
        self.norm_final_attn = norm_layer_factory("layer_norm")(embed_dim)

    def forward(self, point_embeddings, image_embeddings, image_pe):
        """point_embeddings (B, N, C); image_embeddings and image_pe
        (B, H, W, C). Returns (queries (B, N, C), keys (B, H, W, C))."""
        b, h, w, c = image_embeddings.shape
        keys = image_embeddings.reshape(b, h * w, c)
        key_pe = image_pe.reshape(b, h * w, c)
        queries = point_embeddings
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embeddings, key_pe)
        attn = self.final_attn_token_to_image(queries + point_embeddings,
                                              keys + key_pe, keys)
        queries = self.norm_final_attn(queries + attn)
        return queries, keys.reshape(b, h, w, c)
