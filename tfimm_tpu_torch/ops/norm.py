"""LayerNorm and the norm factory; mirror of tfimm_tpu/ops/norm.py.

Statistics and the affine transform run in float32 whatever the input
dtype, and the variance is the one-pass ``max(E[x^2] - E[x]^2, 0)`` of the
JAX layer, so both packages round alike.
"""

from __future__ import annotations

import torch
import torch.nn as nn

__all__ = ["LayerNorm", "norm_layer_factory"]


class LayerNorm(nn.Module):
    """Normalise over the trailing channel axis. Parameters: weight, bias."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.dim = dim
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        mean2 = x32.square().mean(dim=-1, keepdim=True)
        var = torch.clamp(mean2 - mean.square(), min=0.0)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        y = y * self.weight.float() + self.bias.float()
        return y.to(x.dtype)


def norm_layer_factory(norm_layer: str):
    """String -> norm layer constructor taking ``dim``."""
    if norm_layer == "layer_norm":
        return lambda dim: LayerNorm(dim, eps=1e-5)
    if norm_layer == "layer_norm_eps_1e-6":
        return lambda dim: LayerNorm(dim, eps=1e-6)
    raise NotImplementedError(
        f"Normalization layer {norm_layer!r} is not ported yet; it comes "
        f"with the families that use it (ROADMAP.md, queue A, items 4-9)")
