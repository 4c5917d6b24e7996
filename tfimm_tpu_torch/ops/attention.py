"""Multi-head attention; mirror of tfimm_tpu/ops/attention.py.

``scaled_dot_product_attention`` follows the JAX dispatch: the flash kernel
(``ops/kernels/flash_attention.py``) unless weights are returned or a bias
is given, for q, k, v of one shape with N >= 1024 and a head dim and dtype
the kernel takes; else the plain attention.

``MultiHeadAttention``, unless attention weights are being captured or
attention dropout is active in training, sends its packed qkv projection
by the sequence length alone: at N >= 1024 to the flash kernel (q, k and v
read from the packed qkv through strides), below it to the fused kernel
(``ops/kernels/fused_mha.py``). The JAX package tries ``fused_mha`` first
and declines it by its VMEM plan, TPU layout that the port does not keep;
so the port's ``fused_mha``, with its clamped softmax, never sees N >= 1024.
Otherwise, and for shapes the kernels do not take (float16 among them), it
runs the plain attention: scores stored in the compute dtype, softmax in
float32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from tfimm_tpu_torch.core import capture_feature, current_context
from tfimm_tpu_torch.ops.basic import Dense
from tfimm_tpu_torch.ops.kernels.dispatch import log_dispatch
from tfimm_tpu_torch.ops.kernels.flash_attention import (
    FLASH_MIN_TOKENS,
    flash_attention_or_none,
    flash_attention_packed,
    flash_attention_supports,
)
from tfimm_tpu_torch.ops.kernels.fused_mha import fused_mha_or_none
from tfimm_tpu_torch.ops.stochastic import dropout

__all__ = ["scaled_dot_product_attention", "MultiHeadAttention"]


def _attention_weights(q: torch.Tensor, k: torch.Tensor,
                       scale: Optional[float] = None,
                       bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax attention weights (f32). q, k: (..., N, d); bias
    broadcastable to the scores.

    The score matrix is stored in the compute dtype, the bias added in it;
    the softmax runs in float32 whatever that dtype is. The scale (default
    d ** -0.5) is rounded to q's dtype before the product, as in the JAX
    package (``q * jnp.asarray(scale, q.dtype)``); this matters where
    ``d ** -0.5`` is not a bf16 number (d = 80).
    """
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    scale = torch.tensor(scale, dtype=q.dtype).item()
    scores = torch.matmul(q * scale, k.transpose(-1, -2))
    if bias is not None:
        scores = scores + bias.to(scores.dtype)
    return torch.softmax(scores.float(), dim=-1)


def _reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: Optional[float] = None,
                         bias: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain attention. q, k, v: (..., N, d). Returns (out, weights)."""
    weights = _attention_weights(q, k, scale, bias)
    return torch.matmul(weights.to(q.dtype), v), weights


def scaled_dot_product_attention(q, k, v, bias=None,
                                 scale: Optional[float] = None,
                                 return_weights: bool = False):
    """Attention over (..., N, d) tensors; the leading dims are batch and
    heads. Takes the flash kernel when the JAX dispatch would (no weights
    returned, no bias, one shape, N >= 1024) and the kernel takes the head
    dim and dtype; else the plain attention. Returns out, or (out, weights)
    with ``return_weights``."""
    if not return_weights:
        out = flash_attention_or_none(q, k, v, bias=bias, scale=scale)
        if out is not None:
            return out
    log_dispatch("attention[plain]")
    out, weights = _reference_attention(q, k, v, scale, bias)
    return (out, weights) if return_weights else out


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
            if n < FLASH_MIN_TOKENS:
                out = fused_mha_or_none(qkv, self.nb_heads, self.scale)
            elif flash_attention_supports(self.head_dim, qkv.dtype):
                log_dispatch("flash_attention")
                out = flash_attention_packed(qkv, self.nb_heads, self.scale)
            else:
                out = None
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
