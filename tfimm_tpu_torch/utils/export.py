"""Deployment export; counterpart of tfimm_tpu/utils/export.py.

The JAX package closes preprocessing, the forward and the optional softmax
over the trained parameters and serializes them as one StableHLO function
(``model.stablehlo``). The port exports the same function with
``torch.export`` and saves it with ``torch.export.save`` (``model.pt2``):
an image batch (float32, NHWC, values in [0, 255]) in, float32 logits out.

The exported graph holds the hand-written kernels as custom ops; today
that is ``fused_mha`` (``torch.ops.tfimm_tpu_torch.fused_mha``, run without
grad). A model whose path on the card reaches another kernel's wrapper does
not export there, since those wrappers read device pointers that the
tracer's fake tensors lack (ROADMAP.md, queue A, item 15). On the CPU every
wrapper runs its plain version, which traces into the graph as it is.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional

import torch
import torch.nn as nn

__all__ = ["export_model", "load_exported", "ExportedModel"]

_META_FILE = "tfimm_tpu_torch.json"


class _Inference(nn.Module):
    """preprocessing -> cast -> model (eval) -> f32 -> optional log-softmax,
    the JAX package's ``infer``."""

    def __init__(self, model: nn.Module, preprocessing: Callable,
                 dtype: torch.dtype, normalize_logits: bool):
        super().__init__()
        self.model = model
        self.preprocessing = preprocessing
        self.dtype = dtype
        self.normalize_logits = normalize_logits

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        out = self.model(self.preprocessing(images).to(self.dtype))
        out = (out[0] if isinstance(out, tuple) else out).float()
        if self.normalize_logits:
            out = torch.log_softmax(out, dim=-1)
        return out


def export_model(model: nn.Module, path: str, *,
                 batch_size: Optional[int] = None, preprocessing=None,
                 normalize_logits: bool = False,
                 dtype: torch.dtype = torch.float32) -> None:
    """Export an inference function ``image batch -> logits`` to ``path``
    on the device the model lies on. ``batch_size=None`` exports with a
    symbolic batch dimension."""
    from tfimm_tpu_torch.models.factory import create_preprocessing

    device = next(model.parameters()).device
    if preprocessing is None:
        preprocessing = create_preprocessing(model.cfg.name, device=device)
    h, w = model.cfg.input_size
    example = torch.zeros((batch_size or 2, h, w, model.cfg.in_channels),
                          dtype=torch.float32, device=device)
    dynamic = None
    if batch_size is None:
        dynamic = {"images": {0: torch.export.Dim("batch", min=1)}}
    was_training = model.training
    model.eval()
    try:
        # Without grad every kernel wrapper takes its no-grad path, which
        # for fused_mha is the custom op the graph records.
        with torch.no_grad():
            program = torch.export.export(
                _Inference(model, preprocessing, dtype, normalize_logits),
                (example,), dynamic_shapes=dynamic)
    finally:
        model.train(was_training)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.export.save(program, path, extra_files={
        _META_FILE: json.dumps({"device": str(device)})})


class ExportedModel:
    """A callable around a loaded export: images -> logits, on the device
    the artifact was exported on."""

    def __init__(self, program, device: torch.device):
        self.program = program
        self.device = device
        self._module = program.module()

    def __call__(self, images) -> torch.Tensor:
        images = torch.as_tensor(images, device=self.device).float()
        with torch.no_grad():
            return self._module(images)


def load_exported(path: str) -> ExportedModel:
    # Registers the port's custom ops, which the saved graph names.
    import tfimm_tpu_torch.ops.kernels  # noqa: F401

    extra = {_META_FILE: ""}
    program = torch.export.load(path, extra_files=extra)
    return ExportedModel(program, torch.device(json.loads(extra[_META_FILE])
                                               ["device"]))
