"""Shared SAM pieces; mirror of tfimm_tpu/architectures/segment_anything/common.py."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from tfimm_tpu_torch.core import current_context
from tfimm_tpu_torch.ops.basic import Dense, act_layer_factory
from tfimm_tpu_torch.ops.stochastic import dropout

__all__ = ["MLPBlock", "Embedding"]


class MLPBlock(nn.Module):
    """MLP with Meta-SAM layer naming. Parameters: lin1.*, lin2.*."""

    def __init__(self, embed_dim: int, hidden_dim: int, act_layer: str = "gelu",
                 drop_rate: float = 0.0, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lin1 = Dense(embed_dim, hidden_dim, generator=generator)
        self.lin2 = Dense(hidden_dim, embed_dim, generator=generator)
        self.act = act_layer_factory(act_layer)
        self.drop_rate = drop_rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ctx = current_context()
        x = self.act(self.lin1(x))
        x = dropout(x, self.drop_rate, ctx.training, ctx.generator)
        x = self.lin2(x)
        return dropout(x, self.drop_rate, ctx.training, ctx.generator)


class Embedding(nn.Module):
    """A learned (rows, D) table drawn from a standard normal, as the JAX
    package draws it. Parameter: weight."""

    def __init__(self, rows: int, dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(rows, dim, generator=generator))
