"""Linear and cubic image resize with antialiasing; the port's copy of what
``jax.image.resize(x, shape, method="linear")`` (or ``"bilinear"``, the
same method, ``antialias=True`` by default) and ``method="bicubic"``
compute.

Each axis whose size changes is contracted with a weight matrix (in, out)
built as ``jax._src.image.scale.compute_weight_mat`` builds it: output
sample j sits at ``(j + 0.5) * in / out - 0.5`` in input coordinates (half-
pixel centres); the triangle kernel ``max(0, 1 - |x|)`` is widened by
``in / out`` when the axis shrinks (the antialias filter) and not when it
grows; each column is divided by its sum (edge renormalisation) and a
sample outside ``[-0.5, in - 0.5]`` gets no weight. The weights are
computed in float32 and used in the input's dtype. The port builds them
itself, from the JAX package's definition, rather than rely on
``F.interpolate(mode="bilinear", antialias=True)``, which agreed at the
sizes the tests hold it to but defines its weights on its own.

The cubic weights are built the same way with the Keys cubic kernel at
a = -0.5 (``_fill_keys_cubic_kernel`` of the same JAX module) in place of
the triangle, its support of 2 widened by ``in / out`` when the axis
shrinks. ``F.interpolate(mode="bicubic")`` takes a = -0.75 and does not
compute this function.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

__all__ = ["resize_linear", "linear_weights", "resize_cubic", "cubic_weights"]

_EPS32 = float(torch.finfo(torch.float32).eps)


@functools.lru_cache(maxsize=64)
def linear_weights(in_size: int, out_size: int,
                   device: torch.device = torch.device("cpu")) -> torch.Tensor:
    """The (in_size, out_size) float32 weight matrix of one axis, built on
    ``device`` (no host copy) and kept for later calls: do not modify it.
    The scale is rounded to float32 first, as JAX rounds a Python float
    that multiplies a float32 array."""
    with torch.inference_mode(False):   # a cached tensor may meet autograd
        return _linear_weights(in_size, out_size, device)


def _linear_weights(in_size, out_size, device):
    f32 = torch.float32
    inv_scale = float(np.float32(1.0 / (out_size / in_size)))
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(out_size, dtype=f32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample[None, :]
         - torch.arange(in_size, dtype=f32, device=device)[:, None]).abs()
    w = torch.clamp(1.0 - x / kernel_scale, min=0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * _EPS32,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


@functools.lru_cache(maxsize=64)
def cubic_weights(in_size: int, out_size: int,
                  device: torch.device = torch.device("cpu")) -> torch.Tensor:
    """The (in_size, out_size) float32 bicubic weight matrix of one axis,
    built on ``device`` and kept for later calls: do not modify it. Scale,
    inverse scale and sample positions are rounded to float32 in the order
    ``compute_weight_mat`` rounds them."""
    with torch.inference_mode(False):   # a cached tensor may meet autograd
        return _cubic_weights(in_size, out_size, device)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """The Keys cubic kernel at a = -0.5 on |distance| ``x``."""
    near = ((1.5 * x - 2.5) * x) * x + 1.0
    far = ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0
    out = torch.where(x >= 1.0, far, near)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _cubic_weights(in_size, out_size, device):
    f32 = torch.float32
    inv_scale = float(np.float32(1.0) / np.float32(out_size / in_size))
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(out_size, dtype=f32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample[None, :]
         - torch.arange(in_size, dtype=f32, device=device)[:, None]).abs()
    w = _keys_cubic(x / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * _EPS32,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _resize(name, weights, x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``x`` contracted along each axis whose size changes with that axis's
    ``weights(in, out, device)`` matrix."""
    shape = tuple(int(s) for s in shape)
    if len(shape) != x.dim():
        raise ValueError(f"{name}: shape {shape} does not match the "
                         f"{x.dim()} axes of the input")
    if not x.is_floating_point():
        x = x.float()
    for axis, (old, new) in enumerate(zip(x.shape, shape)):
        if old == new:
            continue
        w = weights(old, new, x.device).to(x.dtype)  # a copy if cast
        x = torch.movedim(torch.matmul(torch.movedim(x, axis, -1), w), -1, axis)
    return x


def resize_linear(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``x`` resized to ``shape`` (one size per axis) by the antialiased
    linear filter of ``jax.image.resize``. Integer inputs compute in
    float32, as JAX promotes them; the result keeps a float input's dtype."""
    return _resize("resize_linear", linear_weights, x, shape)


def resize_cubic(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``x`` resized to ``shape`` by ``jax.image.resize``'s antialiased
    bicubic filter (Keys, a = -0.5). Dtypes as ``resize_linear``."""
    return _resize("resize_cubic", cubic_weights, x, shape)
