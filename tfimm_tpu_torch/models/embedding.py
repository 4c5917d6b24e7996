"""EmbeddingModel: a backbone with a Dense + BatchNorm embedding head, for
metric learning; counterpart of tfimm_tpu/models/embedding.py."""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
import torch.nn as nn

from tfimm_tpu_torch.core import Context, capture_feature
from tfimm_tpu_torch.models.serialization import (
    _build,
    _load_into,
    _read_config,
    _save,
)
from tfimm_tpu_torch.ops.basic import Dense
from tfimm_tpu_torch.ops.norm import BatchNorm

__all__ = ["EmbeddingModel"]


class EmbeddingModel(nn.Module):
    """Wraps any backbone with Dense(embed_dim) -> BatchNorm(no scale).

    Parameters: ``backbone.*``, ``fc.*`` and ``bn.*`` (bias and running
    statistics). In training mode the BatchNorm normalises with the batch's
    statistics and updates its running ones."""

    def __init__(self, backbone: nn.Module, embed_dim: int):
        super().__init__()
        self.backbone = backbone
        self.embed_dim = embed_dim
        in_features = getattr(backbone, "nb_features", None)
        if in_features is None:
            in_features = backbone.cfg.embed_dim
        self.fc = Dense(in_features, embed_dim)
        self.bn = BatchNorm(embed_dim, use_scale=False)

    def forward(self, x: torch.Tensor, *, return_features: bool = False,
                generator: Optional[torch.Generator] = None):
        """(B, embed_dim) embeddings of NHWC input; ``(embeddings,
        features)`` with ``return_features=True``."""
        ctx = Context(training=self.training, generator=generator,
                      capture_features=return_features)
        with ctx:
            x = self.backbone.forward_features(x)
            if x.dim() == 4:  # CNN feature maps: global-pool before the head
                x = x.mean(dim=(1, 2))
            x = self.bn(self.fc(x))
            capture_feature("embeddings", x)
        return (x, ctx.features) if return_features else x

    def save(self, path: str) -> None:
        """The JAX package's format, with the backbone's config nested."""
        _save(self, path, {
            "class_name": "EmbeddingModel", "embed_dim": self.embed_dim,
            "backbone_class": type(self.backbone).__name__,
            "backbone_config": dataclasses.asdict(self.backbone.cfg)})

    @classmethod
    def load(cls, path: str, *, device: Union[str, torch.device],
             dtype: Optional[torch.dtype] = None) -> "EmbeddingModel":
        """An EmbeddingModel saved by either package, on ``device`` in
        ``dtype`` (default: the dtype it was saved in), in eval mode."""
        payload = _read_config(path)
        backbone = _build(payload["backbone_class"], payload["backbone_config"])
        return _load_into(cls(backbone, payload["embed_dim"]), path, payload,
                          device, dtype)
