"""LoRA factory; mirror of tfimm_tpu/architectures/lora/factory.py.

Merging folds ``scaling * B @ A`` into the weights of a state dict and
leaves the model as it is, as the JAX function is pure. Trainability is
decided over the port's parameter names (the JAX paths under the
``kernel`` -> ``weight`` renames); ``lora_optimizer`` builds a
``torch.optim`` optimizer over the trainable parameters alone and freezes
the rest, as the JAX package's ``optax.multi_transform`` sends them to
``set_to_zero``: no update and no weight decay.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Union

import torch

from tfimm_tpu_torch.architectures.lora.layers import (
    LORA_WEIGHT_NAMES,
    merge_kernel,
)
from tfimm_tpu_torch.architectures.lora.registry import (
    lora_architecture,
    lora_base_architecture,
    lora_config,
)
from tfimm_tpu_torch.models.factory import create_model as create_full_model
from tfimm_tpu_torch.models.factory import transfer_weights
from tfimm_tpu_torch.models.registry import model_class

__all__ = ["create_model", "convert_to_lora_model", "convert_to_regular_model",
           "merge_lora_weights", "lora_trainable_weights",
           "lora_non_trainable_weights", "lora_trainable_mask"]


def create_model(model_name: str, *, device: Union[str, torch.device],
                 dtype: Optional[torch.dtype] = None, seed: int = 0,
                 pretrained: Union[bool, str] = False, model_path: str = "",
                 **kwargs):
    """Create a LoRA model from a registered model name. ``lora_*``
    keywords go into the LoRA config, the rest configure the base model,
    which ``tfimm_tpu_torch.create_model`` builds on the CPU (seeded, or
    loaded); its weights are carried across by ``transfer_weights``. The
    LoRA factors are absent from the base, so they keep their init (A
    random from ``seed``, B zero: the model computes its base's function).
    """
    cls = model_class(model_name)
    lora_cls = lora_architecture(cls)
    lora_cfg_cls = lora_config(cls)

    full_kwargs = {k: v for k, v in kwargs.items() if not k.startswith("lora_")}
    lora_kwargs = {k: v for k, v in kwargs.items() if k.startswith("lora_")}
    full_model = create_full_model(model_name, device="cpu", seed=seed,
                                   pretrained=pretrained,
                                   model_path=model_path, **full_kwargs)
    lora_cfg = lora_cfg_cls(**dataclasses.asdict(full_model.cfg), **lora_kwargs)
    model = lora_cls(lora_cfg, generator=torch.Generator().manual_seed(seed))
    transfer_weights(full_model, model)
    return model.to(device=device, dtype=dtype).eval()


def convert_to_lora_model(model, **kwargs):
    """The LoRA version of an existing model, on its device and in its
    dtype, with its weights (A drawn from seed 0, B zero); ``kwargs``
    override config fields."""
    lora_cls = lora_architecture(type(model))
    lora_cfg_cls = lora_config(type(model))
    cfg_dict = dataclasses.asdict(model.cfg)
    cfg_dict.update(kwargs)
    lora_model = lora_cls(lora_cfg_cls(**cfg_dict),
                          generator=torch.Generator().manual_seed(0))
    p = next(model.parameters())
    lora_model = lora_model.to(device=p.device, dtype=p.dtype)
    transfer_weights(model, lora_model)
    return lora_model.train(model.training)


def _lora_scaling(model) -> float:
    return model.cfg.lora_alpha / model.cfg.lora_rank


def merge_lora_weights(model) -> Dict[str, torch.Tensor]:
    """The model's state dict with each low-rank update folded into its
    ``weight`` (in the weight's dtype); the factors stay in it. The model
    is unchanged."""
    scaling = _lora_scaling(model)
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    out = dict(sd)
    for key in sd:
        if key.endswith("weight_lora_a"):
            prefix = key[: -len("weight_lora_a")]
            out[prefix + "weight"] = merge_kernel(
                sd[prefix + "weight"], sd[key], sd[prefix + "weight_lora_b"],
                scaling)
    return out


def convert_to_regular_model(model):
    """LoRA model -> its base model with the merged weights, on the same
    device, in the same dtype and mode."""
    base_cls = lora_base_architecture(type(model))
    base_cfg_cls = base_cls.cfg_class
    base_fields = {f.name for f in dataclasses.fields(base_cfg_cls)}
    base_cfg = base_cfg_cls(**{k: v for k, v in dataclasses.asdict(model.cfg).items()
                               if k in base_fields and not k.startswith("lora_")})
    with torch.device("meta"):   # every tensor is assigned below
        base_model = base_cls(base_cfg)
    merged = merge_lora_weights(model)
    base_model.load_state_dict(
        {k: merged[k].clone() for k in base_model.state_dict()}, assign=True)
    return base_model.train(model.training)


def _classify_names(model, train_bias: str = "none",
                    trainable_layers: Optional[List[str]] = None):
    if train_bias not in {"none", "all", "lora_only"}:
        raise ValueError(f"Unknown value for train_bias: {train_bias}.")
    trainable_layers = trainable_layers or []
    names = [name for name, _ in model.named_parameters()]
    lora_dirs = {n[: -len("weight_lora_a")] for n in names
                 if n.endswith("weight_lora_a")}

    def is_trainable(name: str) -> bool:
        head, _, leaf = name.rpartition(".")
        if leaf in LORA_WEIGHT_NAMES:
            return True
        if leaf == "bias":
            if train_bias == "all":
                return True
            if train_bias == "lora_only" and (head + ".") in lora_dirs:
                return True
        return any(name == layer or name.startswith(layer + ".")
                   for layer in trainable_layers)

    return {name: is_trainable(name) for name in names}


def lora_trainable_weights(model, train_bias: str = "none",
                           trainable_layers: Optional[List[str]] = None):
    """Sorted names of the parameters LoRA fine-tuning trains."""
    cls = _classify_names(model, train_bias, trainable_layers)
    return sorted(n for n, t in cls.items() if t)


def lora_non_trainable_weights(model, train_bias: str = "none",
                               trainable_layers: Optional[List[str]] = None):
    cls = _classify_names(model, train_bias, trainable_layers)
    return sorted(n for n, t in cls.items() if not t)


def lora_trainable_mask(model, train_bias: str = "none",
                        trainable_layers: Optional[List[str]] = None):
    """Parameter name -> whether LoRA fine-tuning trains it."""
    return _classify_names(model, train_bias, trainable_layers)


def lora_optimizer(optimizer_factory: Callable, model,
                   train_bias: str = "none",
                   trainable_layers: Optional[List[str]] = None):
    """``optimizer_factory(params)`` (e.g. ``functools.partial(
    torch.optim.AdamW, lr=1e-3)``) over the trainable parameters alone; the
    others get ``requires_grad_(False)`` and so neither an update nor
    weight decay, nor a gradient."""
    mask = lora_trainable_mask(model, train_bias, trainable_layers)
    params = []
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
        if mask[name]:
            params.append(p)
    return optimizer_factory(params)
