"""Parameter-tree conversion between the JAX package and this package.

``state_dict_from_jax`` is the inverse of the JAX package's timm conversion
(``tfimm_tpu/utils/pt_convert.py``): both packages name parameters after
timm's module paths, so a flattened JAX path maps to a state-dict key by a
leaf rename, plus a layout transpose for ``kernel`` leaves:

    kernel -> weight    2-D (in, out) -> (out, in); 4-D HWIO -> OIHW
                        (a grouped (kh, kw, in / groups, out) -> (out,
                        in / groups, kh, kw), a depthwise (kh, kw, 1, C)
                        -> (C, 1, kh, kw)); 3-D WIO -> OIW (ECA's
                        (k, 1, 1) -> (1, 1, k)); SAM's transposed convs
                        (``output_upscaling``, (kh, kw, I, O) in PyTorch's
                        tap order) -> (I, O, kh, kw), with no flip
    scale  -> weight
    mean   -> running_mean
    var    -> running_var
    kernel_lora_a -> weight_lora_a, kernel_lora_b -> weight_lora_b (LoRA's
                        factors, by the kernel transposes: Dense (in, r)
                        -> (r, in) and (r, out) -> (out, r); conv
                        (kh, kw, in / g, r) -> (r, in / g, kh, kw) and
                        (kh, kw, r, out) -> (out, r, kh, kw))
    kernel_q -> weight_q   int8, by the kernel transposes (a 1x1 conv's is
                        stored 2-D, (in, out) -> (out, in)); ``quant.py``
    kernel_scale -> weight_scale   float32, (out,)

Leaves may be numpy arrays or anything ``numpy.asarray`` accepts, so this
module needs no JAX. ``jax_from_state_dict`` goes the other way, naming
each leaf by the module that holds it. Every leaf is float32 but the
int8 ``kernel_q``. A timm state dict's
``num_batches_tracked`` has no JAX leaf: ``BatchNorm`` drops it on load.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["state_dict_from_jax", "jax_from_state_dict"]

_LEAF_RENAMES = {
    "kernel": "weight",
    "kernel_lora_a": "weight_lora_a",
    "kernel_lora_b": "weight_lora_b",
    "kernel_q": "weight_q",
    "kernel_scale": "weight_scale",
    "scale": "weight",
    "mean": "running_mean",
    "var": "running_var",
}

_KERNEL_TRANSPOSES = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1)}
_CONV_TRANSPOSE_KERNEL = (2, 3, 0, 1)


def _flatten(tree: Mapping, prefix: str = ""):
    for key, value in tree.items():
        path = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value


def state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX parameter tree (nested dicts of arrays) -> timm-keyed state dict
    of float32 CPU tensors (int8 for ``kernel_q``)."""
    out = {}
    for path, value in _flatten(params):
        head, _, leaf = path.rpartition(".")
        # A writable copy.
        arr = np.array(value, dtype=np.int8 if leaf == "kernel_q"
                       else np.float32)
        if leaf in ("kernel", "kernel_q", "kernel_lora_a", "kernel_lora_b"):
            if arr.ndim not in _KERNEL_TRANSPOSES:
                raise ValueError(f"{path}: no layout rule for a {arr.ndim}-D kernel")
            if arr.ndim == 4 and "output_upscaling" in path:
                arr = arr.transpose(_CONV_TRANSPOSE_KERNEL)
            else:
                arr = arr.transpose(_KERNEL_TRANSPOSES[arr.ndim])
        leaf = _LEAF_RENAMES.get(leaf, leaf)
        key = f"{head}.{leaf}" if head else leaf
        out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def _jax_leaf(module, name: str):
    """(JAX leaf name, layout permutation or None) of ``module``'s tensor
    ``name``: the inverse of ``state_dict_from_jax``'s rules, decided by the
    module's type."""
    from tfimm_tpu_torch.ops.basic import Dense
    from tfimm_tpu_torch.ops.conv import (
        Conv1d,
        Conv2d,
        ConvTranspose2d,
        DepthwiseConv2d,
    )
    from tfimm_tpu_torch.ops.norm import Affine, BatchNorm, GroupNorm, LayerNorm

    if name in ("weight_lora_a", "weight_lora_b"):   # LoRA's factors
        leaf = "kernel" + name[len("weight"):]
        if isinstance(module, Dense):
            return leaf, (1, 0)
        if isinstance(module, Conv2d):
            return leaf, (2, 3, 1, 0)
    if name == "weight_q":   # quantize_int8's
        if isinstance(module, ConvTranspose2d):
            return "kernel_q", _CONV_TRANSPOSE_KERNEL
        return "kernel_q", (1, 0) if module.weight_q.dim() == 2 else (2, 3, 1, 0)
    if name == "weight_scale":
        return "kernel_scale", None
    if name == "weight":
        if isinstance(module, Dense):
            return "kernel", (1, 0)
        if isinstance(module, (Conv2d, DepthwiseConv2d)):
            return "kernel", (2, 3, 1, 0)   # OIHW -> HWIO
        if isinstance(module, Conv1d):
            return "kernel", _KERNEL_TRANSPOSES[3]   # OIW -> WIO
        if isinstance(module, ConvTranspose2d):
            return "kernel", _CONV_TRANSPOSE_KERNEL   # (I, O, kh, kw) -> (kh, kw, I, O)
        if isinstance(module, (LayerNorm, GroupNorm, BatchNorm, Affine)):
            return "scale", None
    if isinstance(module, BatchNorm) and name in ("running_mean", "running_var"):
        return name[len("running_"):], None
    return name, None


def jax_from_state_dict(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    """The model's parameters and persistent buffers as the JAX package's
    flattened parameter paths, in the JAX layouts, as numpy arrays (bf16 as
    float32, which numpy holds exactly)."""
    persistent = model.state_dict(keep_vars=True)
    out = {}
    for prefix, module in model.named_modules():
        tensors = dict(module.named_parameters(recurse=False))
        tensors.update(module.named_buffers(recurse=False))
        for name, value in tensors.items():
            key = f"{prefix}.{name}" if prefix else name
            if key not in persistent:
                continue   # a non-persistent buffer
            leaf, perm = _jax_leaf(module, name)
            t = value.detach().cpu()
            if t.dtype == torch.bfloat16:
                t = t.float()
            arr = t.numpy()
            if perm is not None:
                arr = arr.transpose(perm)
            out[f"{prefix}.{leaf}" if prefix else leaf] = np.ascontiguousarray(arr)
    return out
