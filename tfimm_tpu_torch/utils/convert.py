"""Parameter-tree conversion from the JAX package to this package.

``state_dict_from_jax`` is the inverse of the JAX package's timm conversion
(``tfimm_tpu/utils/pt_convert.py``): both packages name parameters after
timm's module paths, so a flattened JAX path maps to a state-dict key by a
leaf rename, plus a layout transpose for ``kernel`` leaves:

    kernel -> weight    2-D (in, out) -> (out, in); 4-D HWIO -> OIHW;
                        3-D WIO -> OIW
    scale  -> weight
    mean   -> running_mean
    var    -> running_var

Leaves may be numpy arrays or anything ``numpy.asarray`` accepts, so this
module needs no JAX.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["state_dict_from_jax"]

_LEAF_RENAMES = {
    "kernel": "weight",
    "scale": "weight",
    "mean": "running_mean",
    "var": "running_var",
}

_KERNEL_TRANSPOSES = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1)}


def _flatten(tree: Mapping, prefix: str = ""):
    for key, value in tree.items():
        path = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value


def state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX parameter tree (nested dicts of arrays) -> timm-keyed state dict
    of float32 CPU tensors."""
    out = {}
    for path, value in _flatten(params):
        head, _, leaf = path.rpartition(".")
        arr = np.array(value, dtype=np.float32)  # a writable copy
        if leaf == "kernel":
            if arr.ndim not in _KERNEL_TRANSPOSES:
                raise ValueError(f"{path}: no layout rule for a {arr.ndim}-D kernel")
            arr = arr.transpose(_KERNEL_TRANSPOSES[arr.ndim])
        leaf = _LEAF_RENAMES.get(leaf, leaf)
        key = f"{head}.{leaf}" if head else leaf
        out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out
