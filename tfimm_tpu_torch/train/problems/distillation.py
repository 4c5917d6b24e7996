"""Distillation problem; mirror of tfimm_tpu/train/problems/distillation.py.

A frozen teacher and a student embed the same images; the loss is the mean
squared difference of their embeddings (``forward(..., features_only=True)``
in float32, optionally L2-normalised), and only the student learns. The
teacher runs in eval mode under ``torch.no_grad``, so its attention takes
the kernels' no-grad path; the student runs in training mode with the
problem's generator. With ``mixed_precision`` both take their input in
bf16 (the parameters and the optimizer state stay float32).

As in the JAX package, whose step applies the student without ``mutable``,
the student's BatchNorm running statistics are not updated by training,
and an ``EmbeddingModel`` (which has no ``features_only``) raises
``TypeError`` at the first step. Meshes are not ported yet (ROADMAP.md,
queue A, item 14).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Union

import torch

from tfimm_tpu_torch.train.interface import ProblemBase
from tfimm_tpu_torch.train.registry import cfg_serializable, get_class

__all__ = ["DistillationConfig", "DistillationProblem"]


@dataclass
class DistillationConfig:
    teacher: Any = None
    teacher_class: str = ""
    student: Any = None
    student_class: str = ""
    optimizer: Any = None
    optimizer_class: str = ""
    normalize_embeddings: bool = True
    mixed_precision: bool = False
    timekeeping: Any = None
    timekeeping_class: str = ""


@cfg_serializable
class DistillationProblem(ProblemBase):
    cfg_class = DistillationConfig

    def __init__(self, cfg: DistillationConfig, timekeeping=None, mesh=None,
                 *, device: Union[str, torch.device]):
        if mesh is not None:
            raise NotImplementedError(
                "meshes are not ported yet (ROADMAP.md, queue A, item 14)")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"DistillationProblem: device {self.device} asked for, but "
                f"torch.cuda.is_available() is False")
        self.cfg = cfg
        self.timekeeping = timekeeping or cfg.timekeeping

        self.teacher, self.teacher_preprocessing = get_class(
            cfg.teacher_class)(cfg=cfg.teacher)(device=self.device)
        self.student, self.student_preprocessing = get_class(
            cfg.student_class)(cfg=cfg.student)(device=self.device)
        opt_factory = get_class(cfg.optimizer_class)(
            cfg=cfg.optimizer, timekeeping=self.timekeeping,
            mixed_precision=cfg.mixed_precision,
        )
        self.optimizer, self.lr_schedule = opt_factory(
            self.student.parameters())
        self.epoch = 0
        self._generator = torch.Generator(device=self.device).manual_seed(0)
        self._compute_dtype = torch.bfloat16 if cfg.mixed_precision else None

    def _embeddings(self, model, preprocessing, images, generator=None):
        x = preprocessing(images)
        if self._compute_dtype is not None:
            x = x.to(self._compute_dtype)
        emb = model(x, features_only=True, generator=generator).float()
        if self.cfg.normalize_embeddings:
            emb = emb / (torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
                         + 1e-8)
        return emb

    def train_step(self, data, it: int):
        images = data[0] if isinstance(data, (tuple, list)) else data
        images = torch.as_tensor(images, device=self.device)
        self.teacher.eval()
        with torch.no_grad():
            target = self._embeddings(self.teacher,
                                      self.teacher_preprocessing, images)
        self.student.train()
        # The JAX step drops the student's batch-statistics updates.
        stats = {name: b.clone() for name, b in self.student.named_buffers()
                 if b.is_floating_point()}
        self.optimizer.zero_grad()
        emb = self._embeddings(self.student, self.student_preprocessing,
                               images, self._generator)
        loss = torch.mean(torch.square(emb - target))
        loss.backward()
        self.optimizer.step()
        with torch.no_grad():
            for name, b in self.student.named_buffers():
                if name in stats:
                    b.copy_(stats[name])
        loss = float(loss.detach())
        return loss, {"train/loss": loss}

    def validation(self, dataset):
        # Delegate to the dataset if it knows how to evaluate embeddings.
        if hasattr(dataset, "validation"):
            return dataset.validation(self.student)
        return {}

    @property
    def state(self):
        return {"params": self.student.state_dict(),
                "opt_state": self.optimizer.state_dict(),
                "epoch": self.epoch}

    def set_state(self, state, model_only: bool = False):
        self.student.load_state_dict(state["params"])
        if not model_only:
            self.optimizer.load_state_dict(state["opt_state"])
            self.epoch = int(state["epoch"])

    def save_model(self, save_dir: str):
        from tfimm_tpu_torch.models.serialization import save_model

        save_model(self.student, save_dir)
