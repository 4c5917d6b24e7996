"""LoRA layers; mirror of tfimm_tpu/architectures/lora/layers.py.

A LoRA layer computes with the effective weight ``W + scaling * B @ A``,
merged at every call in ``_kernel``, the hook through which ``Dense`` and
``Conv2d`` take their weight; there is no merged/unmerged state. Merging
for export is ``factory.merge_lora_weights``.

The factors sit in the layouts the JAX factors take under the ``kernel``
-> ``weight`` transposes (``utils/convert.py``):

    Dense   weight_lora_a (r, in)             weight_lora_b (out, r)
    Conv2d  weight_lora_a (r, in / g, kh, kw)  weight_lora_b (out, r, kh, kw)

for the JAX ``kernel_lora_a`` (in, r) / (kh, kw, in / g, r) and
``kernel_lora_b`` (r, out) / (kh, kw, r, out). A conv's product is taken
per tap, as the JAX ``matmul`` batches over the spatial axes. A starts
glorot-uniform (the JAX fans, from the JAX shapes), drawn from the layer's
generator, and B at zero, so a fresh LoRA layer is its base layer.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from tfimm_tpu_torch.ops.basic import Dense
from tfimm_tpu_torch.ops.conv import Conv2d

__all__ = ["LoRADense", "LoRAConv2d", "convert_to_lora_layer",
           "LORA_WEIGHT_NAMES", "merge_kernel"]

# Names of the parameters holding low-rank factors (absent from a base
# model's weights, so ``transfer_weights`` leaves them at their init).
LORA_WEIGHT_NAMES = ["weight_lora_a", "weight_lora_b"]


def merge_kernel(weight: torch.Tensor, lora_a: torch.Tensor,
                 lora_b: torch.Tensor, scaling: float) -> torch.Tensor:
    """Effective full-rank weight ``weight + scaling * B @ A``, in the
    weight's dtype: (out, in) for a Dense, in one ``addmm`` (one launch
    where the layer runs every call), and (out, in / g, kh, kw) for a conv,
    whose product is taken per tap."""
    dt = weight.dtype
    if weight.dim() == 2:
        return torch.addmm(weight, lora_b.to(dt), lora_a.to(dt), alpha=scaling)
    # (kh, kw, out, r) @ (kh, kw, r, in / g) -> (out, in / g, kh, kw)
    update = (lora_b.permute(2, 3, 0, 1)
              @ lora_a.permute(2, 3, 0, 1)).permute(2, 3, 0, 1)
    return weight + scaling * update.to(dt)


def _glorot_uniform_(t: torch.Tensor, fan_in: int, fan_out: int,
                     generator: Optional[torch.Generator]) -> None:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        t.uniform_(-limit, limit, generator=generator)


class LoRADense(Dense):
    is_lora_layer = True

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True, *, lora_rank: int = 4,
                 lora_alpha: float = 1.0,
                 generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__(in_features, out_features, use_bias=use_bias,
                         generator=generator, **kwargs)
        self.lora_rank = lora_rank
        self.lora_alpha = lora_alpha
        self.scaling = lora_alpha / lora_rank
        self.weight_lora_a = nn.Parameter(torch.empty(lora_rank, in_features))
        self.weight_lora_b = nn.Parameter(torch.zeros(out_features, lora_rank))
        _glorot_uniform_(self.weight_lora_a, in_features, lora_rank, generator)

    def _kernel(self, dtype: torch.dtype) -> torch.Tensor:
        return merge_kernel(self.weight, self.weight_lora_a,
                            self.weight_lora_b, self.scaling).to(dtype)


class LoRAConv2d(Conv2d):
    is_lora_layer = True

    def __init__(self, *args, lora_rank: int = 4, lora_alpha: float = 1.0,
                 generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__(*args, generator=generator, **kwargs)
        self.lora_rank = lora_rank
        self.lora_alpha = lora_alpha
        self.scaling = lora_alpha / lora_rank
        kh, kw = self.kernel_size
        in_ch = self.in_channels // self.groups
        self.weight_lora_a = nn.Parameter(torch.empty(lora_rank, in_ch, kh, kw))
        self.weight_lora_b = nn.Parameter(
            torch.zeros(self.out_channels, lora_rank, kh, kw))
        _glorot_uniform_(self.weight_lora_a, in_ch * kh * kw,
                         lora_rank * kh * kw, generator)

    def _kernel(self, dtype: torch.dtype) -> torch.Tensor:
        return merge_kernel(self.weight, self.weight_lora_a,
                            self.weight_lora_b, self.scaling).to(dtype)


def convert_to_lora_layer(layer, lora_rank: int = 4, lora_alpha: float = 1.0,
                          *, generator: Optional[torch.Generator] = None):
    """Dense or Conv2d -> its LoRA variant with the same hyper-parameters
    and the same weight and bias (copied), A drawn from ``generator`` and B
    zero. A conv keeps the source's resolved padding and its patchify
    route."""
    if isinstance(layer, Dense):
        lora = LoRADense(layer.in_features, layer.out_features,
                         use_bias=layer.bias is not None, zero_init=True,
                         lora_rank=lora_rank, lora_alpha=lora_alpha,
                         generator=generator)
    elif isinstance(layer, Conv2d):
        lora = LoRAConv2d(
            layer.in_channels, layer.out_channels, layer.kernel_size,
            stride=layer.stride, padding="valid", dilation=layer.dilation,
            groups=layer.groups, use_bias=layer.bias is not None,
            lora_rank=lora_rank, lora_alpha=lora_alpha, generator=generator)
        lora.padding = layer.padding   # the resolved padding spec
        lora.patchify = layer.patchify
    else:
        raise ValueError(f"Cannot convert layer of type {type(layer)} to LoRA.")
    lora = lora.to(device=layer.weight.device, dtype=layer.weight.dtype)
    with torch.no_grad():
        lora.weight.copy_(layer.weight)
        if layer.bias is not None:
            lora.bias.copy_(layer.bias)
    return lora
