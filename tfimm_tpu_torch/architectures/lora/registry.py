"""LoRA architecture registry; mirror of
tfimm_tpu/architectures/lora/registry.py.

Maps base model class <-> LoRA model class <-> LoRA config class. A model
may be registered as its own LoRA variant.
"""

from __future__ import annotations

import warnings
from functools import partial

__all__ = ["register_lora_architecture", "lora_architecture",
           "lora_base_architecture", "lora_config"]

_lora_model_class = {}
_lora_model_base_class = {}
_lora_model_config = {}


def register_lora_architecture(lora_cls=None, *, base_cls=None):
    """Class decorator registering a LoRA variant; base inferred from
    ``__base__`` unless given explicitly."""
    if lora_cls is None:
        return partial(register_lora_architecture, base_cls=base_cls)
    if base_cls is None:
        base_cls = lora_cls.__base__
    if base_cls in _lora_model_class:
        warnings.warn(
            f"Model class {base_cls} already has LoRA version "
            f"{_lora_model_class[base_cls]}; overwriting with {lora_cls}."
        )
    _lora_model_class[base_cls] = lora_cls
    _lora_model_base_class[lora_cls] = base_cls
    _lora_model_config[base_cls] = lora_cls.cfg_class
    return lora_cls


def lora_architecture(model_cls):
    if model_cls not in _lora_model_class:
        raise ValueError(f"No LoRA variant registered for {model_cls}.")
    return _lora_model_class[model_cls]


def lora_base_architecture(lora_cls):
    if lora_cls not in _lora_model_base_class:
        raise ValueError(f"{lora_cls} is not a registered LoRA variant.")
    return _lora_model_base_class[lora_cls]


def lora_config(model_cls):
    if model_cls not in _lora_model_config:
        raise ValueError(f"No LoRA variant registered for {model_cls}.")
    return _lora_model_config[model_cls]
