"""Dense layer and activation factory; mirror of tfimm_tpu/ops/basic.py.

``Dense`` keeps timm's ``weight`` (out, in) / ``bias`` (out,) names and casts
both to the input dtype before the product, as the JAX layer does.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["Dense", "act_layer_factory", "trunc_normal_"]


def trunc_normal_(t: torch.Tensor, std: float,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """Normal(0, std) truncated at two standard deviations."""
    return nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                                 generator=generator)


class Dense(nn.Module):
    """Linear layer. Parameters: ``weight`` (out, in), ``bias`` (out,).

    Default initialisation is PyTorch's ``nn.Linear`` one (uniform in
    +-1/sqrt(in)); ``weight_std`` selects a truncated normal instead and
    ``zero_init`` zeros both (ViT's classifier heads).
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
