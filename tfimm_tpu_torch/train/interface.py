"""Problem interface; mirror of tfimm_tpu/train/interface.py.

A problem owns the model, optimizer state, and loss; the trainer owns the
loop, checkpoints and logging. Problem state is an explicit dictionary
(``state`` property) of state dicts and the epoch.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

__all__ = ["ProblemBase"]


class ProblemBase:
    cfg_class = None

    def train_step(self, data, it: int) -> Tuple[float, Dict[str, Any]]:
        """Run one training step; returns (loss, logs)."""
        raise NotImplementedError

    def start_epoch(self) -> None:
        """Called at the start of each epoch (e.g. to reset metrics)."""

    def validation(self, dataset) -> Dict[str, Any]:
        """Run validation over a dataset; returns metric logs."""
        return {}

    @property
    def state(self) -> Dict[str, Any]:
        """Checkpointable state (params, opt_state, ...)."""
        raise NotImplementedError

    def set_state(self, state: Dict[str, Any], model_only: bool = False) -> None:
        """Restore state from a checkpoint; ``model_only`` ignores optimizer."""
        raise NotImplementedError

    def save_model(self, save_dir: str) -> None:
        """Export the model for deployment."""
        raise NotImplementedError
