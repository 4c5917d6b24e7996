"""Model save/load; counterpart of tfimm_tpu/models/serialization.py.

A saved model is the JAX package's directory: ``config.json`` (the class
name, the config's class name, its fields and ``format_version`` 1) and
``params.npz`` (the flattened JAX parameter paths in the JAX layouts,
``utils/convert.py · jax_from_state_dict``). So a directory written by
either package loads in the other, with the same outputs.

numpy has no bfloat16: the port writes a bf16 model's parameters as
float32 (exact) and notes the model's dtype under ``dtype`` in
``config.json``, a key the JAX loader ignores. A bf16 model saved by the
JAX package holds ml_dtypes bfloat16 arrays, which numpy reads back as
two-byte voids (``|V2``); they are read here as their bits, exactly.

An int8-quantized model (``quant.quantize_int8``) is saved as the JAX
package saves one: int8 ``kernel_q`` and float32 ``kernel_scale`` leaves.
``load_model`` converts the layers that the file holds as quantized before
it loads their tensors; the scales never set the model's dtype.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Union

import numpy as np
import torch

from tfimm_tpu_torch.utils.convert import jax_from_state_dict, state_dict_from_jax

__all__ = ["save_model", "load_model"]

_CONFIG_FILE = "config.json"
_PARAMS_FILE = "params.npz"


def _float_dtype(model: torch.nn.Module) -> torch.dtype:
    dtypes = {p.dtype for p in model.parameters() if p.is_floating_point()}
    return dtypes.pop() if len(dtypes) == 1 else torch.float32


def _save(model: torch.nn.Module, path: str, payload: dict) -> None:
    """``config.json`` (``payload``, the format version and the model's
    dtype) and ``params.npz`` under ``path``."""
    os.makedirs(path, exist_ok=True)
    payload = {**payload, "format_version": 1,
               "dtype": str(_float_dtype(model)).replace("torch.", "")}
    with open(os.path.join(path, _CONFIG_FILE), "w") as f:
        json.dump(payload, f, indent=2, default=str)
    np.savez(os.path.join(path, _PARAMS_FILE), **jax_from_state_dict(model))


def save_model(model, path: str) -> None:
    cfg = model.cfg
    _save(model, path, {"class_name": type(model).__name__,
                        "config_class": type(cfg).__name__,
                        "config": dataclasses.asdict(cfg)})


def _tuplify(x):
    if isinstance(x, list):
        return tuple(_tuplify(v) for v in x)
    return x


def _read_config(path: str) -> dict:
    with open(os.path.join(path, _CONFIG_FILE)) as f:
        return json.load(f)


def _build(class_name: str, config: dict):
    """A fresh model of the registered architecture ``class_name`` with the
    config fields of ``config`` that its config class has."""
    import tfimm_tpu_torch.architectures  # noqa: F401  (fills the registry)
    from tfimm_tpu_torch.models.registry import architecture_class

    cls = architecture_class(class_name)
    if cls is None:
        raise ValueError(f"Unknown architecture class: {class_name}")
    fields = {f.name for f in dataclasses.fields(cls.cfg_class)}
    return cls(cls.cfg_class(**{k: _tuplify(v) for k, v in config.items()
                                if k in fields}))


def _is_bfloat16(a: np.ndarray) -> bool:
    return a.dtype.name == "bfloat16" or (a.dtype.kind == "V"
                                          and a.dtype.itemsize == 2)


def _read_params(path: str):
    """(the state dict of ``params.npz`` under ``path``, in float32, and
    the dtype its floating arrays were saved in)."""
    flat: Dict[str, np.ndarray] = {}
    saved = set()
    with np.load(os.path.join(path, _PARAMS_FILE)) as data:
        for key in data.files:
            a = data[key]
            if key.endswith(".kernel_scale"):
                pass   # float32 whatever the model's dtype
            elif _is_bfloat16(a):
                saved.add(torch.bfloat16)
                a = (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
            elif a.dtype.kind == "f":
                saved.add(torch.float16 if a.dtype == np.float16
                          else torch.float32)
            flat[key] = a
    dtype = saved.pop() if len(saved) == 1 else torch.float32
    return state_dict_from_jax(flat), dtype


def _load_into(model: torch.nn.Module, path: str, payload: dict, device,
               dtype: Optional[torch.dtype]):
    """``model`` with the parameters under ``path``, on ``device`` in
    ``dtype``, or else the dtype the payload names, or else the saved
    arrays' dtype; in eval mode."""
    from tfimm_tpu_torch.quant import set_int8

    state, saved = _read_params(path)
    for key, weight_q in state.items():
        if key.endswith(".weight_q"):
            prefix = key[:-len(".weight_q")]
            set_int8(model.get_submodule(prefix), weight_q,
                     state[f"{prefix}.weight_scale"])
    model.load_state_dict(state)
    name = payload.get("dtype")
    dtype = dtype or (getattr(torch, name) if isinstance(name, str) else saved)
    return model.to(device=device, dtype=dtype).eval()


def load_model(path: str, *, device: Union[str, torch.device],
               dtype: Optional[torch.dtype] = None):
    """The model saved under ``path`` (by either package), on ``device`` in
    ``dtype`` (default: the dtype it was saved in), in eval mode."""
    payload = _read_config(path)
    model = _build(payload["class_name"], payload["config"])
    return _load_into(model, path, payload, device, dtype)
