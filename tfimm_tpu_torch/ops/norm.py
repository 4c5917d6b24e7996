"""LayerNorm, GroupNorm, BatchNorm, Affine and the norm factory; mirror of
tfimm_tpu/ops/norm.py.

Statistics and the affine transform run in float32 whatever the input
dtype. LayerNorm's variance is the one-pass ``max(E[x^2] - E[x]^2, 0)`` of
the JAX layer, GroupNorm's the two-pass ``mean((x - mean)^2)`` of its JAX
layer, so both packages round alike; BatchNorm's training form is its
JAX layer's two-pass formula, its inference form one ``F.batch_norm``
call, which keeps its arithmetic in float32 too.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from tfimm_tpu_torch.core import current_context

__all__ = ["LayerNorm", "GroupNorm", "BatchNorm", "Affine", "Identity",
           "norm_layer_factory"]


class Identity(nn.Module):
    """The factory's ``""`` norm: no parameters, x unchanged."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


class Affine(nn.Module):
    """Per-channel ``weight * x + bias`` in x's dtype (ResMLP's norm).
    Parameters: weight (the JAX scale), bias."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.weight.to(x.dtype) + self.bias.to(x.dtype)


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
    normalise (the JAX layer's formula, so that autograd differentiates
    what the JAX package does), and the running statistics are updated in
    place: ``momentum * running + (1 - momentum) * batch``, the variance by
    its unbiased estimator (the JAX layer records the same update on its
    context, PyTorch's semantics). Otherwise the running statistics
    normalise in one ``F.batch_norm`` on the channels-first view, one pass
    over x with its arithmetic in f32 (eager, the JAX layer's formula
    would take six passes, which XLA fuses into one). A timm state dict's
    ``num_batches_tracked`` is dropped on load, as the JAX package's
    conversion drops it.
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

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.pop(prefix + "num_batches_tracked", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not current_context().training:
            channels_first = x.movedim(-1, 1) if x.dim() > 2 else x
            y = F.batch_norm(channels_first, self.running_mean,
                             self.running_var, self.weight, self.bias,
                             training=False, eps=self.eps)
            return y.movedim(1, -1) if x.dim() > 2 else y
        x32 = x.float()
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
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        if self.weight is not None:
            y = y * self.weight.float()
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(x.dtype)


def norm_layer_factory(norm_layer: str):
    """String -> norm layer constructor taking ``dim``."""
    if norm_layer == "":
        return lambda dim=None: Identity()
    if norm_layer == "affine":
        return lambda dim: Affine(dim)
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
    raise ValueError(f"Unknown normalization layer: {norm_layer}")
