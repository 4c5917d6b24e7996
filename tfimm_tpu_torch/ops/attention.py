"""Multi-head attention; mirror of tfimm_tpu/ops/attention.py.

``MultiHeadAttention`` sends its packed qkv projection to the fused kernel
(``ops/kernels/fused_mha.py``) unless attention weights are being captured
or attention dropout is active in training. Otherwise, and for shapes the
kernel does not take, it runs the plain attention: scores stored in the
compute dtype, softmax in float32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from tfimm_tpu_torch.core import capture_feature, current_context
from tfimm_tpu_torch.ops.basic import Dense
from tfimm_tpu_torch.ops.kernels.dispatch import log_dispatch
from tfimm_tpu_torch.ops.kernels.fused_mha import fused_mha_or_none
from tfimm_tpu_torch.ops.stochastic import dropout

__all__ = ["MultiHeadAttention"]


def _attention_weights(q: torch.Tensor, k: torch.Tensor,
                       scale: float) -> torch.Tensor:
    """Softmax attention weights (f32). q, k: (..., N, d).

    The score matrix is stored in the compute dtype; the softmax runs in
    float32 whatever that dtype is.
    """
    scores = torch.matmul(q * scale, k.transpose(-1, -2))
    return torch.softmax(scores.float(), dim=-1)


def _reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain attention. q, k, v: (..., N, d). Returns (out, weights)."""
    weights = _attention_weights(q, k, scale)
    return torch.matmul(weights.to(q.dtype), v), weights


class MultiHeadAttention(nn.Module):
    """ViT-style MHA with a fused qkv projection. Parameters: qkv.*, proj.*
    (timm's ``attn.qkv`` / ``attn.proj``)."""

    def __init__(self, dim: int, nb_heads: int, qkv_bias: bool = True,
                 attn_drop_rate: float = 0.0, proj_drop_rate: float = 0.0,
                 *, generator: Optional[torch.Generator] = None):
        super().__init__()
        if dim % nb_heads:
            raise ValueError(f"dim {dim} is not a multiple of {nb_heads} heads")
        self.dim = dim
        self.nb_heads = nb_heads
        self.head_dim = dim // nb_heads
        self.scale = self.head_dim ** -0.5
        self.attn_drop_rate = attn_drop_rate
        self.proj_drop_rate = proj_drop_rate
        self.qkv = Dense(dim, dim * 3, use_bias=qkv_bias, weight_std=0.02,
                         generator=generator)
        self.proj = Dense(dim, dim, weight_std=0.02, generator=generator)

    def forward(self, x: torch.Tensor,
                feature_name: Optional[str] = None) -> torch.Tensor:
        b, n, _ = x.shape
        ctx = current_context()
        qkv = self.qkv(x)

        want_weights = ctx.capture_features and feature_name is not None
        attn_drop = ctx.training and self.attn_drop_rate > 0.0
        if not (want_weights or attn_drop):
            out = fused_mha_or_none(qkv, self.nb_heads, self.scale)
            if out is not None:
                out = self.proj(out)
                return dropout(out, self.proj_drop_rate, ctx.training,
                               ctx.generator)

        log_dispatch("attention[plain]")
        qkv = qkv.reshape(b, n, 3, self.nb_heads, self.head_dim)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)  # (B, H, N, d) each
        if want_weights or attn_drop:
            weights = _attention_weights(q, k, self.scale)
            if want_weights:
                capture_feature(feature_name, weights)
            if attn_drop:
                weights = dropout(weights, self.attn_drop_rate, ctx.training,
                                  ctx.generator)
            out = torch.matmul(weights.to(v.dtype), v)
        else:
            out, _ = _reference_attention(q, k, v, self.scale)

        out = out.transpose(1, 2).reshape(b, n, self.dim)
        out = self.proj(out)
        return dropout(out, self.proj_drop_rate, ctx.training, ctx.generator)
