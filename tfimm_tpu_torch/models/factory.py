"""Model factory; counterpart of tfimm_tpu/models/factory.py.

``create_model`` builds a registered model with seeded random weights on a
given device and dtype, with config overrides validated as in the JAX
package. Pretrained weights are not ported yet: load a timm state dict with
``model.load_state_dict`` instead.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import numpy as np
import torch

from tfimm_tpu_torch.models.registry import is_model, model_class, model_config

__all__ = ["create_model", "create_preprocessing"]


def create_model(model_name: str, *, device: Union[str, torch.device],
                 dtype: Optional[torch.dtype] = None, seed: int = 0,
                 pretrained: Union[bool, str] = False, model_path: str = "",
                 **cfg_overrides):
    """Create a registered model with random weights drawn from ``seed``.

    The weights are drawn on the CPU in float32, so one seed gives the same
    weights on every device, then moved to ``device`` and cast to ``dtype``
    (all parameters, as the JAX package's ``Model.cast`` does).
    ``cfg_overrides`` replace config fields (e.g. ``nb_classes=10``).
    """
    if pretrained or model_path:
        raise NotImplementedError(
            "pretrained weights and saved models are not ported yet; load a "
            "timm state dict with model.load_state_dict")
    if not is_model(model_name):
        raise ValueError(f"Unknown model: {model_name}")
    cls = model_class(model_name)
    cfg = model_config(model_name)
    field_names = {f.name for f in dataclasses.fields(cfg)}
    for key in cfg_overrides:
        if key not in field_names:
            raise ValueError(
                f"{type(cfg).__name__} has no field {key!r}; valid fields: "
                f"{sorted(field_names)}")
    cfg = dataclasses.replace(cfg, **cfg_overrides)

    generator = torch.Generator().manual_seed(seed)
    model = cls(cfg, generator=generator)
    return model.to(device=device, dtype=dtype).eval()


def create_preprocessing(model_name: str, *,
                         device: Union[str, torch.device],
                         in_channels: Optional[int] = None,
                         dtype: Optional[torch.dtype] = None) -> Callable:
    """Return ``img -> (img / 255 - mean) / std`` for the given model.

    Input values are in [0, 255] (e.g. uint8 NHWC); mean and std are tiled
    to ``in_channels``. The result is on ``device`` in ``dtype`` (default
    float32).
    """
    if not is_model(model_name):
        raise ValueError(f"Unknown model: {model_name}")
    cfg = model_config(model_name)
    dtype = dtype or torch.float32

    def _adapt_vector(v, n):
        v = np.asarray(v, dtype=np.float32)
        reps = n // len(v) + 1
        return torch.as_tensor(np.tile(v, reps)[:n], device=device).to(dtype)

    n = in_channels or cfg.in_channels
    mean = _adapt_vector(getattr(cfg, "mean", (0.485, 0.456, 0.406)), n)
    std = _adapt_vector(getattr(cfg, "std", (0.229, 0.224, 0.225)), n)

    def _preprocess(img) -> torch.Tensor:
        img = torch.as_tensor(img, device=device).to(dtype) / 255.0
        return (img - mean) / std

    return _preprocess
