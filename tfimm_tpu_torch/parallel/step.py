"""Training and eval steps and the loss; mirror of tfimm_tpu/parallel/step.py.

``make_train_step`` returns one eager step: forward in training mode,
softmax cross-entropy in float32 (plus optional L2 weight decay), backward,
optimizer update. The JAX package compiles the same step with ``jax.jit``
and can shard it over a device mesh; meshes, parameter shardings and
rematerialisation are not ported yet (ROADMAP.md, queue A, item 14).

BatchNorm's running statistics need no ``merge_state_updates``: the layer
writes them in place during the training forward, and the JAX step
overwrites the same leaves with the same values after the optimizer's
update (which leaves them as they were: their gradient is zero, and the
L2 penalty covers only ``kernel`` leaves).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from tfimm_tpu_torch.ops.basic import Dense
from tfimm_tpu_torch.ops.conv import (
    Conv1d,
    Conv2d,
    ConvTranspose2d,
    DepthwiseConv2d,
)

__all__ = ["cross_entropy_loss", "make_train_step", "make_eval_step",
           "l2_weights"]

_NO_MESH = "device meshes and sharded steps are not ported yet (ROADMAP.md, queue A, item 14)"


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean softmax cross-entropy. Integer labels, or soft labels of the
    logits' shape; distilled logits (B, 2, C) are averaged over the heads
    first."""
    if logits.dim() == 3:
        logits = logits.mean(dim=1)
    if labels.dim() == logits.dim():  # soft targets
        return -(labels * F.log_softmax(logits, dim=-1)).sum(dim=-1).mean()
    if label_smoothing:
        nb_classes = logits.shape[-1]
        onehot = F.one_hot(labels, nb_classes).to(logits.dtype)
        onehot = onehot * (1 - label_smoothing) + label_smoothing / nb_classes
        return -(onehot * F.log_softmax(logits, dim=-1)).sum(dim=-1).mean()
    return F.cross_entropy(logits, labels)


# The port's modules whose JAX counterparts hold a ``kernel`` leaf.
_KERNEL_MODULES = (Dense, Conv2d, DepthwiseConv2d, ConvTranspose2d, Conv1d)


def l2_weights(model: nn.Module) -> List[torch.Tensor]:
    """The weights the L2 penalty covers: the JAX package's ``kernel``
    leaves, i.e. the weights of Dense, Conv2d, DepthwiseConv2d,
    ConvTranspose2d (SAM) and Conv1d (ECA) layers (CaiT's head mixes
    ``proj_l`` and ``proj_w`` are Dense). Norm
    parameters, biases, layer scales, tokens and position embeddings are
    left out (LayerNorm's parameter is also called ``weight``), and so are
    int8-quantized layers, whose frozen ``weight_q`` is no ``kernel``
    leaf."""
    return [m.weight for m in model.modules()
            if isinstance(m, _KERNEL_MODULES) and "weight" in m._parameters]


def make_train_step(
    model: nn.Module,
    optimizer,
    mesh=None,
    *,
    loss_fn: Optional[Callable] = None,
    weight_decay: float = 0.0,
    param_sharding=None,
    remat: bool = False,
):
    """Build a training step.

    Returns ``step(batch, generator) -> metrics`` with ``batch = (images,
    labels)`` on the model's device, ``generator`` the ``torch.Generator``
    of dropout and drop-path, and ``metrics`` the loss and the accuracy as
    0-d tensors. ``model(images, generator=...)`` gives the logits;
    ``optimizer`` has ``zero_grad()`` and ``step()``.
    """
    if mesh is not None or param_sharding is not None:
        raise NotImplementedError(_NO_MESH)
    if remat:
        raise NotImplementedError(f"remat: {_NO_MESH}")
    loss_fn = loss_fn or cross_entropy_loss
    decayed = l2_weights(model) if weight_decay else []

    def step(batch, generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        images, labels = batch
        model.train()
        optimizer.zero_grad()
        logits = model(images, generator=generator)
        loss = loss_fn(logits.float(), labels)
        if weight_decay:
            loss = loss + weight_decay * sum(w.square().sum() for w in decayed)
        loss.backward()
        optimizer.step()
        with torch.no_grad():
            preds = (logits.mean(dim=1) if logits.dim() == 3
                     else logits).argmax(-1)
            hard = labels.argmax(-1) if labels.dim() == preds.dim() + 1 else labels
            accuracy = (preds == hard).float().mean()
        return {"loss": loss.detach(), "accuracy": accuracy}

    return step


def make_eval_step(model: nn.Module, mesh=None):
    """Build an eval step: ``step(images) -> logits``, the model in eval
    mode (BatchNorm normalises with its running statistics) under
    ``torch.no_grad``."""
    if mesh is not None:
        raise NotImplementedError(_NO_MESH)

    def step(images):
        model.eval()
        with torch.no_grad():
            return model(images)

    return step
