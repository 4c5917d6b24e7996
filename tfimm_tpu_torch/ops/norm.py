"""LayerNorm, GroupNorm, BatchNorm and the norm factory; mirror of
tfimm_tpu/ops/norm.py.

Statistics and the affine transform run in float32 whatever the input
dtype. LayerNorm's variance is the one-pass ``max(E[x^2] - E[x]^2, 0)`` of
the JAX layer, GroupNorm's and BatchNorm's the two-pass
``mean((x - mean)^2)`` of their JAX layers, so both packages round alike.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from tfimm_tpu_torch.core import current_context

__all__ = ["LayerNorm", "GroupNorm", "BatchNorm", "norm_layer_factory"]


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


class GroupNorm(nn.Module):
    """Normalise NHWC maps over the spatial axes and each group of channels
    (PoolFormer's ``group_norm_1grp``: one group, the whole map of an
    image). Parameters: weight, bias (the JAX layer's scale, bias)."""

    def __init__(self, dim: int, nb_groups: int = 32, eps: float = 1e-5):
        super().__init__()
        if dim % nb_groups != 0:
            raise ValueError(f"Channels {dim} not divisible by groups {nb_groups}")
        self.dim = dim
        self.nb_groups = nb_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = x.shape
        xg = x.float().reshape(shape[0], -1, self.nb_groups,
                               self.dim // self.nb_groups)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
        y = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(shape)
        y = y * self.weight.float() + self.bias.float()
        return y.to(x.dtype)


class BatchNorm(nn.Module):
    """Batch norm over all axes but the last (NHWC / NC). Parameters:
    weight (the JAX scale, with ``use_scale``) and bias (``use_bias``);
    buffers running_mean and running_var (the JAX mean and var).

    When the forward's context trains, the batch's f32 statistics
    normalise, and the running statistics are updated in place:
    ``momentum * running + (1 - momentum) * batch``, the variance by its
    unbiased estimator (the JAX layer records the same update on its
    context, PyTorch's semantics). Otherwise the running statistics
    normalise.
    """

    def __init__(self, dim: int, eps: float = 1e-5, momentum: float = 0.9,
                 use_scale: bool = True, use_bias: bool = True):
        super().__init__()
        self.dim = dim
        self.eps = eps
        self.momentum = momentum  # decay of the running statistic
        self.weight = nn.Parameter(torch.ones(dim)) if use_scale else None
        self.bias = nn.Parameter(torch.zeros(dim)) if use_bias else None
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        if current_context().training:
            axes = tuple(range(x.dim() - 1))
            mean = x32.mean(dim=axes)
            var = (x32 - mean).square().mean(dim=axes)
            n = x32.numel() // self.dim
            unbiased = var * (n / max(n - 1, 1))
            m = self.momentum
            with torch.no_grad():
                for buf, stat in ((self.running_mean, mean),
                                  (self.running_var, unbiased)):
                    buf.copy_(m * buf + (1 - m) * stat.to(buf.dtype))
        else:
            mean, var = self.running_mean.float(), self.running_var.float()
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        if self.weight is not None:
            y = y * self.weight.float()
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(x.dtype)


def norm_layer_factory(norm_layer: str):
    """String -> norm layer constructor taking ``dim``."""
    if norm_layer == "layer_norm":
        return lambda dim: LayerNorm(dim, eps=1e-5)
    if norm_layer == "layer_norm_eps_1e-6":
        return lambda dim: LayerNorm(dim, eps=1e-6)
    if norm_layer == "group_norm":
        return lambda dim: GroupNorm(dim)
    if norm_layer == "group_norm_1grp":
        return lambda dim: GroupNorm(dim, nb_groups=1)
    if norm_layer == "batch_norm":
        return lambda dim: BatchNorm(dim, eps=1e-5, momentum=0.9)
    if norm_layer == "batch_norm_tf":
        return lambda dim: BatchNorm(dim, eps=1e-3, momentum=0.9)
    raise NotImplementedError(
        f"Normalization layer {norm_layer!r} is not ported yet; it comes "
        f"with the families that use it (ROADMAP.md, queue A)")
