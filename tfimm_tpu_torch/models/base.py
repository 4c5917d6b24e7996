"""Model base class; counterpart of tfimm_tpu/models/base.py.

A model is an ``nn.Module`` whose parameters carry timm's names, so
``load_state_dict`` takes a timm state dict as it is. Subclasses define
``forward_features`` (input -> pooled features) and ``forward_head``
(features -> logits); ``forward`` runs both inside a ``Context`` that
carries the training flag, the generator for stochastic layers and the
feature capture.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from tfimm_tpu_torch.core import Context

__all__ = ["Model"]


class Model(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward_head(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    @property
    def feature_names(self) -> Tuple[str, ...]:
        return ()

    def forward(self, x: torch.Tensor, *, return_features: bool = False,
                features_only: bool = False,
                generator: Optional[torch.Generator] = None):
        """Forward pass on NHWC input.

        Returns ``out``, or ``(out, features)`` with ``return_features=True``
        (a dict keyed by ``feature_names``). ``features_only`` stops after
        ``forward_features``. ``generator`` drives dropout and drop-path
        when the module is in training mode.
        """
        ctx = Context(training=self.training, generator=generator,
                      capture_features=return_features)
        with ctx:
            out = self.forward_features(x)
            if not features_only:
                out = self.forward_head(out)
        return (out, ctx.features) if return_features else out

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        """Inference forward: eval mode, under ``torch.inference_mode()``."""
        was_training = self.training
        self.eval()
        try:
            with torch.inference_mode():
                return self(x)
        finally:
            self.train(was_training)
