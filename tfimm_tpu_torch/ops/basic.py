"""Dense layer and activation factory; mirror of tfimm_tpu/ops/basic.py.

``Dense`` keeps timm's ``weight`` (out, in) / ``bias`` (out,) names and casts
both to the input dtype before the product, as the JAX layer does.

``Int8Layer`` is the base of the layers that ``quantize_int8``
(``tfimm_tpu_torch/quant.py``) converts: a converted layer holds an int8
``weight_q`` and a float32 ``weight_scale`` (one per output channel) in
place of its ``weight`` parameter, the JAX package's ``kernel_q`` and
``kernel_scale`` leaves, and ``weight_scale`` stays float32 whatever dtype
the model is cast to, as ``tfimm_tpu/utils/tree.py · tree_cast`` keeps it.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["Dense", "Int8Layer", "act_layer_factory", "dequantize",
           "trunc_normal_"]


def trunc_normal_(t: torch.Tensor, std: float,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """Normal(0, std) truncated at two standard deviations."""
    return nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                                 generator=generator)


def dequantize(weight_q: torch.Tensor,
               weight_scale: torch.Tensor) -> torch.Tensor:
    """float32 ``weight_q * weight_scale``, one scale per output channel
    (the first axis)."""
    scale = weight_scale.float().reshape(-1, *[1] * (weight_q.dim() - 1))
    return weight_q.float() * scale


class Int8Layer(nn.Module):
    """A layer ``quantize_int8`` may convert. Converted, it has persistent
    buffers ``weight_q`` (int8: ``weight``'s layout, a 1x1 conv's as
    (out, in)) and ``weight_scale`` (float32, (out,)), and no ``weight``
    parameter (``tfimm_tpu_torch.quant.set_int8``)."""

    @property
    def quantized(self) -> bool:
        return "weight_q" in self._buffers

    def _dequantized(self, dtype: torch.dtype) -> torch.Tensor:
        """The weight dequantized, in ``weight``'s shape, then ``dtype``:
        the JAX conv's ``_kernel`` of a quantized kernel."""
        w = dequantize(self.weight_q, self.weight_scale)
        return w.reshape(self.int8_weight_shape).to(dtype)

    def _apply(self, fn, recurse=True):
        # ``.to(dtype)``, ``.half()`` and the like cast floating buffers:
        # ``weight_scale`` only moves, exact, as tree_cast leaves it.
        scale = self._buffers.get("weight_scale")
        out = super()._apply(fn, recurse)
        moved = self._buffers.get("weight_scale")
        if scale is not None and moved.dtype != torch.float32:
            self._buffers["weight_scale"] = scale.to(moved.device)
        return out


class Dense(Int8Layer):
    """Linear layer. Parameters: ``weight`` (out, in), ``bias`` (out,).

    Default initialisation is PyTorch's ``nn.Linear`` one (uniform in
    +-1/sqrt(in)); ``weight_std`` selects a truncated normal instead and
    ``zero_init`` zeros both (ViT's classifier heads). Quantized
    (``Int8Layer``), it multiplies through ``quant.int8_dense_matmul`` and
    adds the bias after, as the JAX layer does.
    """

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True, *, weight_std: Optional[float] = None,
                 zero_init: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = (nn.Parameter(torch.empty(out_features)) if use_bias
                     else None)
        with torch.no_grad():
            bound = 1.0 / math.sqrt(in_features)
            if zero_init:
                self.weight.zero_()
            elif weight_std is not None:
                trunc_normal_(self.weight, weight_std, generator)
            else:
                self.weight.uniform_(-bound, bound, generator=generator)
            if self.bias is not None:
                if zero_init:
                    self.bias.zero_()
                else:
                    self.bias.uniform_(-bound, bound, generator=generator)

    def _kernel(self, dtype: torch.dtype) -> torch.Tensor:
        """The weight the layer multiplies by, in ``dtype`` (LoRA's
        ``LoRADense`` merges its factors here)."""
        return self.weight.to(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = self.bias.to(x.dtype) if self.bias is not None else None
        if self.quantized:
            from tfimm_tpu_torch.quant import int8_dense_matmul

            y = int8_dense_matmul(self, x)
            return y if bias is None else y + bias
        return F.linear(x, self._kernel(x.dtype), bias)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU with the JAX package's precision policy: exact erf in float32,
    the tanh form in bf16/f16 (it deviates from erf by under 3e-4 relative,
    below bf16's resolution). ``TFIMM_TPU_EXACT_GELU=1`` forces erf in every
    dtype; the one variable governs both packages."""
    if os.environ.get("TFIMM_TPU_EXACT_GELU", "0") == "1":
        return F.gelu(x)
    if x.dtype in (torch.bfloat16, torch.float16):
        return F.gelu(x, approximate="tanh")
    return F.gelu(x)


# Only what the ported families use; the other names of the JAX factory
# come with the families that need them.
_ACTS = {"gelu": _gelu, "relu": F.relu, "linear": lambda x: x,
         "sigmoid": torch.sigmoid, "swish": F.silu, "silu": F.silu,
         "relu6": F.relu6}   # min(relu(x), 6) in one pass


def act_layer_factory(act_layer: str) -> Callable:
    """String -> activation function."""
    try:
        return _ACTS[act_layer]
    except KeyError:
        raise ValueError(f"Unknown activation: {act_layer}.") from None
