"""Model factory; counterpart of tfimm_tpu/models/factory.py.

``create_model`` builds a registered model on a given device and dtype:
with seeded random weights, or with the weights of a saved model
(``model_path``, or the model cache with ``pretrained=True``), with config
overrides validated as in the JAX package. When the overrides change the
saved config, the model is rebuilt and ``transfer_weights`` carries the
weights across, with the classifier, first-conv and ``transform_weights``
surgery of the JAX package. Converting a timm or PyTorch checkpoint needs a
download and is not ported: load a timm state dict with
``model.load_state_dict`` instead.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Union

import numpy as np
import torch

from tfimm_tpu_torch.models.registry import is_model, model_class, model_config
from tfimm_tpu_torch.utils.cache import cached_model_path

__all__ = ["create_model", "create_preprocessing", "transfer_weights"]


def create_model(model_name: str, *, device: Union[str, torch.device],
                 dtype: Optional[torch.dtype] = None, seed: int = 0,
                 pretrained: Union[bool, str] = False, model_path: str = "",
                 **cfg_overrides):
    """Create a registered model, with random weights drawn from ``seed`` or
    with saved ones.

    Random weights are drawn on the CPU in float32, so one seed gives the
    same weights on every device, then moved to ``device`` and cast to
    ``dtype`` (all parameters, as the JAX package's ``Model.cast`` does).
    ``model_path`` loads a model saved by ``save_model`` of either package
    (it takes precedence over ``pretrained``); ``pretrained=True`` loads the
    model cache's copy (``utils/cache.py``) and raises where there is none,
    since converting a checkpoint needs a download. ``cfg_overrides``
    replace config fields (e.g. ``nb_classes=10``); where they change a
    loaded model's config, the model is rebuilt and the weights carried
    across by ``transfer_weights``. Without ``dtype`` a loaded model keeps
    the dtype it was saved in.
    """
    from tfimm_tpu_torch.models.serialization import load_model

    if not is_model(model_name):
        raise ValueError(f"Unknown model: {model_name}")
    cls = model_class(model_name)
    cfg = model_config(model_name)

    loaded = None
    if model_path:
        loaded = load_model(model_path, device="cpu")
    elif pretrained:
        cache_path = None if pretrained == "timm" else cached_model_path(model_name)
        if cache_path is None:
            raise NotImplementedError(
                f"no saved copy of {model_name} in the model cache "
                f"(tfimm_tpu_torch.get_dir()); converting a timm or PyTorch "
                f"checkpoint needs a download and is not ported")
        loaded = load_model(cache_path, device="cpu")

    field_names = {f.name for f in dataclasses.fields(cfg)}
    for key in cfg_overrides:
        if key not in field_names:
            raise ValueError(
                f"{type(cfg).__name__} has no field {key!r}; valid fields: "
                f"{sorted(field_names)}")
    cfg = dataclasses.replace(cfg, **cfg_overrides)

    if loaded is not None and loaded.cfg == cfg:
        model = loaded
    else:
        generator = torch.Generator().manual_seed(seed)
        model = cls(cfg, generator=generator)
        if loaded is not None:
            transfer_weights(loaded, model)
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


def transfer_weights(src_model, dst_model,
                     weights_to_ignore: Optional[List[str]] = None) -> None:
    """Copy ``src_model``'s weights into ``dst_model`` by state-dict key.

    As in the JAX package:
    - classifier weights (keys under ``cfg.classifier``) are copied only
      when ``nb_classes`` match; otherwise dst keeps its own;
    - ``cfg.first_conv``'s weight is adapted when ``in_channels`` differ
      (summed to 1 channel; tiled and rescaled above the source's count);
    - ``cfg.transform_weights`` hooks ``fn(src_model, weight, dst_cfg)``
      carry shape-dependent weights (position embeddings, rel-pos tables);
    - any other shape mismatch raises.
    Keys missing from the source, or listed in ``weights_to_ignore``, keep
    dst's values. An int8-quantized source raises ``ValueError``: transfer
    the float weights, then quantize the destination.
    """
    from tfimm_tpu_torch.quant import is_quantized

    if is_quantized(src_model):
        # The source holds weight_q / weight_scale, not weight: a copy by
        # key would leave every such destination weight at its init.
        raise ValueError(
            "transfer_weights does not support int8-quantized source "
            "models; transfer the float weights, then quantize_int8 the "
            "destination.")
    src = src_model.state_dict()
    dst = dst_model.state_dict()
    ignore = set(weights_to_ignore or [])

    cfg = dst_model.cfg
    classifier = getattr(cfg, "classifier", None) or ()
    if isinstance(classifier, str):
        classifier = (classifier,)
    first_conv = getattr(cfg, "first_conv", None)
    transforms = cfg.transform_weights
    same_classes = (getattr(src_model.cfg, "nb_classes", None)
                    == getattr(cfg, "nb_classes", None))

    def under(key, prefix):
        return key == prefix or key.startswith(prefix + ".")

    new = {}
    for key, dst_val in dst.items():
        if key in ignore or key not in src:
            new[key] = dst_val
            continue
        src_val = src[key]
        if any(under(key, c) for c in classifier):
            val = src_val if same_classes else dst_val
        elif key in transforms:
            val = transforms[key](src_model, src_val, cfg)
        elif (first_conv and under(key, first_conv)
              and src_val.shape != dst_val.shape):
            val = _transform_first_conv(src_val, cfg.in_channels)
        else:
            if src_val.shape != dst_val.shape:
                raise ValueError(
                    f"Shape mismatch transferring {key}: src "
                    f"{tuple(src_val.shape)} vs dst {tuple(dst_val.shape)} and "
                    f"no transform hook registered.")
            val = src_val
        new[key] = val.to(device=dst_val.device, dtype=dst_val.dtype)
    dst_model.load_state_dict(new)


def _transform_first_conv(weight: torch.Tensor, in_channels: int) -> torch.Tensor:
    """Adapt an OIHW conv weight to a new input-channel count."""
    if weight.dim() != 4:  # biases don't depend on input channels
        return weight
    src_channels = weight.shape[1]
    if in_channels == src_channels:
        return weight
    if in_channels == 1:
        # Sum (not average) to preserve activation statistics.
        return weight.sum(dim=1, keepdim=True)
    reps = in_channels // src_channels + 1
    weight = weight.repeat(1, reps, 1, 1)[:, :in_channels]
    return weight * (src_channels / in_channels)
