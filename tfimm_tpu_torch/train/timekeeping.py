"""Shared training clock; mirror of tfimm_tpu/train/timekeeping.py."""

from __future__ import annotations

from dataclasses import dataclass

from tfimm_tpu_torch.train.registry import cfg_serializable

__all__ = ["Timekeeping"]


@cfg_serializable
@dataclass
class Timekeeping:
    nb_epochs: int
    batch_size: int
    nb_samples_per_epoch: int = -1  # -1: iterate dataset until exhaustion

    @property
    def nb_steps_per_epoch(self) -> int:
        if self.nb_samples_per_epoch == -1:
            raise ValueError("nb_steps_per_epoch requires nb_samples_per_epoch")
        return self.nb_samples_per_epoch // self.batch_size

    @property
    def nb_steps(self) -> int:
        return self.nb_epochs * self.nb_steps_per_epoch
