"""Classification problem; mirror of tfimm_tpu/train/problems/classification.py.

The step: preprocess in float32, cast to bf16 when ``mixed_precision`` (the
parameters and the optimizer state stay float32; ``Dense`` and ``Conv2d``
cast their weights to the input dtype), forward in training mode, float32
softmax cross-entropy (or the binary loss) plus optional L2 weight decay,
backward, optimizer update, and the optional EMA of the parameters and of
the persistent floating buffers (BatchNorm's running statistics, which the
JAX package keeps as parameter leaves and averages with the rest). No loss
scaling is needed for bf16.

Mixup and cutmix (``train/transforms.py``) blend the raw images in f32
before the preprocessing, as the JAX package does, and hand soft labels to
the loss; their per-batch draws come from a seeded ``numpy`` generator the
problem owns (the JAX package draws them with ``jax.random`` in its step).

The problem runs on the device it is given; a CUDA device without a card
raises, there is no CPU fallback. ``save_model`` writes the parameters in
the JAX package's format and a ``torch.export`` artifact (``model.pt2``,
where the JAX package writes ``model.stablehlo``). Meshes are not ported
yet (ROADMAP.md, queue A, item 14).
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Any, Callable, Optional, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call

from tfimm_tpu_torch.parallel.step import cross_entropy_loss, make_train_step
from tfimm_tpu_torch.train.interface import ProblemBase
from tfimm_tpu_torch.train.registry import cfg_serializable, get_class
from tfimm_tpu_torch.train.transforms import Mixup

__all__ = ["ClassificationConfig", "ClassificationProblem"]


@dataclass
class ClassificationConfig:
    model: Any = None
    model_class: str = ""
    optimizer: Any = None
    optimizer_class: str = ""
    # Whether to use binary crossentropy (single-logit sigmoid) for 2 classes
    binary_loss: bool = False
    weight_decay: float = 0.0
    label_smoothing: float = 0.0
    mixed_precision: bool = False  # bf16 compute, f32 parameters
    # Weight averaging: keep an EMA of the params, validate with it.
    ema_decay: float = 0.0  # 0 = disabled; typical 0.9998
    # Mixup/cutmix on the device (train/transforms.py); 0/0 = disabled.
    mixup_alpha: float = 0.0
    cutmix_alpha: float = 0.0
    mixup_prob: float = 1.0
    # Parameter layout over a mesh (not ported yet; kept so that configs of
    # the JAX package parse unchanged).
    param_sharding: str = "tp"
    fsdp_min_leaf_size: int = 2 ** 14
    # Set by the experiment runner
    timekeeping: Any = None
    timekeeping_class: str = ""


class _Preprocessed(nn.Module):
    """The model with the problem's preprocessing and the cast to the
    compute dtype in front (the JAX package's ``_ModelShim``)."""

    def __init__(self, model: nn.Module, preprocessing: Callable,
                 compute_dtype: Optional[torch.dtype]):
        super().__init__()
        self.model = model
        self.preprocessing = preprocessing
        self.compute_dtype = compute_dtype

    def forward(self, images, generator: Optional[torch.Generator] = None):
        x = self.preprocessing(images)
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        return self.model(x, generator=generator)


@cfg_serializable
class ClassificationProblem(ProblemBase):
    cfg_class = ClassificationConfig

    def __init__(self, cfg: ClassificationConfig, timekeeping=None, mesh=None,
                 *, device: Union[str, torch.device]):
        if mesh is not None:
            raise NotImplementedError(
                "meshes are not ported yet (ROADMAP.md, queue A, item 14)")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"ClassificationProblem: device {self.device} asked for, but "
                f"torch.cuda.is_available() is False")
        self.cfg = cfg
        self.timekeeping = timekeeping or cfg.timekeeping

        factory = get_class(cfg.model_class)(cfg=cfg.model)
        self.model, self.preprocessing = factory(device=self.device)
        opt_factory = get_class(cfg.optimizer_class)(
            cfg=cfg.optimizer, timekeeping=self.timekeeping,
            mixed_precision=cfg.mixed_precision,
        )
        self.optimizer, self.lr_schedule = opt_factory(self.model.parameters())
        self.epoch = 0
        self._generator = torch.Generator(device=self.device).manual_seed(0)

        self._mixup = None
        if cfg.mixup_alpha or cfg.cutmix_alpha:
            self._mixup = Mixup(
                nb_classes=self.model.cfg.nb_classes,
                mixup_alpha=cfg.mixup_alpha, cutmix_alpha=cfg.cutmix_alpha,
                prob=cfg.mixup_prob, label_smoothing=cfg.label_smoothing)
            self._mixup_rng = np.random.default_rng(0)

        self.ema_params = None
        if cfg.ema_decay:
            self.ema_params = self._param_copy()

        def loss_fn(logits, labels):
            if cfg.binary_loss:
                return F.binary_cross_entropy_with_logits(
                    logits[..., 0].float(), labels.float())
            return cross_entropy_loss(logits, labels,
                                      label_smoothing=cfg.label_smoothing)

        compute_dtype = torch.bfloat16 if cfg.mixed_precision else None
        self._train_step = make_train_step(
            _Preprocessed(self.model, self.preprocessing, compute_dtype),
            self.optimizer, loss_fn=loss_fn, weight_decay=cfg.weight_decay)

    def _averaged(self):
        """What the EMA averages: the parameters and the persistent
        floating buffers, by state-dict name."""
        return {name: t for name, t in
                self.model.state_dict(keep_vars=True).items()
                if t.is_floating_point()}

    def _param_copy(self):
        return {name: t.detach().clone()
                for name, t in self._averaged().items()}

    # -- ProblemBase ------------------------------------------------------------
    def train_step(self, data, it: int):
        images, labels = data
        images = torch.as_tensor(images, device=self.device)
        labels = torch.as_tensor(labels, device=self.device)
        if self._mixup is not None:
            # On the raw images: blending commutes with the affine
            # (img - mean) / std preprocessing of the step.
            images, labels = self._mixup(self._mixup_rng, images.float(),
                                         labels)
        metrics = self._train_step((images, labels), self._generator)
        if self.ema_params is not None:
            d = self.cfg.ema_decay
            with torch.no_grad():
                for name, t in self._averaged().items():
                    self.ema_params[name].mul_(d).add_(t, alpha=1.0 - d)
        loss = float(metrics["loss"])
        logs = {"train/loss": loss,
                "train/accuracy": float(metrics["accuracy"])}
        return loss, logs

    def validation(self, dataset):
        # Validate the EMA weights when enabled (they are what gets
        # deployed), BatchNorm's running statistics with them.
        self.model.eval()
        correct, total = 0, 0
        with torch.no_grad():
            for images, labels in dataset:
                x = self.preprocessing(images)
                if self.ema_params is not None:
                    logits = functional_call(self.model, self.ema_params, (x,))
                else:
                    logits = self.model(x)
                if logits.dim() == 3:
                    logits = logits.mean(dim=1)
                preds = logits.argmax(-1).cpu().numpy()
                correct += int((preds == np.asarray(labels)).sum())
                total += len(labels)
        return {"val/accuracy": correct / max(total, 1)}

    @property
    def state(self):
        state = {"params": self.model.state_dict(),
                 "opt_state": self.optimizer.state_dict(),
                 "epoch": self.epoch}
        if self.ema_params is not None:
            state["ema_params"] = self.ema_params
        return state

    def set_state(self, state, model_only: bool = False):
        self.model.load_state_dict(state["params"])
        if self.ema_params is not None:
            # Warm starts reset the average to the restored weights.
            ema = state.get("ema_params") if not model_only else None
            self.ema_params = ({k: v.to(self.device).clone()
                                for k, v in ema.items()} if ema is not None
                               else self._param_copy())
        if not model_only:
            self.optimizer.load_state_dict(state["opt_state"])
            self.epoch = int(state["epoch"])

    def start_epoch(self):
        pass

    def save_model(self, save_dir: str):
        """The parameter checkpoint and a deployment artifact
        (preprocessing + forward + log-softmax, f32), from the EMA weights
        when averaging is on, BatchNorm's statistics included. As in the
        JAX package a failed export is logged and the parameters stand."""
        from tfimm_tpu_torch.models.serialization import save_model
        from tfimm_tpu_torch.utils.export import export_model

        live = None
        if self.ema_params is not None:
            live = self._param_copy()
            self._load_averaged(self.ema_params)
        try:
            save_model(self.model, save_dir)
            try:
                export_model(self.model, os.path.join(save_dir, "model.pt2"),
                             preprocessing=self.preprocessing,
                             normalize_logits=True)
            except Exception as e:  # the parameters stand without it
                logging.warning(f"torch.export deployment artifact failed: {e}")
        finally:
            if live is not None:
                self._load_averaged(live)

    def _load_averaged(self, values):
        with torch.no_grad():
            for name, t in self._averaged().items():
                t.copy_(values[name])
