"""Trainer; mirror of tfimm_tpu/train/trainer.py.

The problem owns the training step; the trainer owns the epoch/step loop,
checkpoints, the validation cadence, throughput logging (img/s per epoch)
and metric forwarding. Checkpoints go through ``train/checkpoint.py``,
which keeps the rules of the orbax manager the JAX trainer uses; at the end
of a run with ``ckpt_dir`` the problem's ``save_model`` writes
``<ckpt_dir>/model``.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass

from tfimm_tpu_torch.train.checkpoint import CheckpointManager
from tfimm_tpu_torch.train.registry import cfg_serializable

__all__ = ["TrainerConfig", "Trainer", "SingleDeviceTrainer"]


@dataclass
class TrainerConfig:
    # Validation
    validation_before_training: bool = True
    validation_every_it: int = -1
    # Checkpointing
    ckpt_dir: str = ""
    init_ckpt: str = ""
    resume_from_ckpt: bool = True
    ckpt_every_it: int = -1
    ckpt_to_keep: int = 3
    # Display
    display_loss_every_it: int = 1000
    verbose: bool = True


@cfg_serializable
class Trainer:
    cfg_class = TrainerConfig

    def __init__(self, problem, train_ds, val_ds, timekeeping,
                 cfg: TrainerConfig, log_wandb: bool = False):
        self.problem = problem
        self.train_ds = train_ds
        self.val_ds = val_ds
        self.timekeeping = timekeeping
        self.cfg = cfg
        self.log_wandb = log_wandb
        self._ckpt_manager = None
        if cfg.ckpt_dir:
            self._ckpt_manager = CheckpointManager(
                cfg.ckpt_dir, max_to_keep=cfg.ckpt_to_keep)

    # -- checkpointing ---------------------------------------------------------
    def _save_ckpt(self, step: int):
        if self._ckpt_manager is None:
            return
        self._ckpt_manager.save(step, self.problem.state)

    def _load_ckpt(self):
        """``init_ckpt`` is a model-only warm start; ``resume_from_ckpt``
        restores the full state from ckpt_dir and takes precedence."""
        device = self.problem.device
        if self.cfg.init_ckpt:
            mgr = CheckpointManager(self.cfg.init_ckpt)
            step = mgr.latest_step()
            if step is None:
                raise ValueError(f"No checkpoint found in {self.cfg.init_ckpt}")
            self.problem.set_state(mgr.restore(step, map_location=device),
                                   model_only=True)
            logging.info(f"Warm start from {self.cfg.init_ckpt} step {step}.")

        if self.cfg.resume_from_ckpt and self._ckpt_manager is not None:
            step = self._ckpt_manager.latest_step()
            if step is not None:
                self.problem.set_state(
                    self._ckpt_manager.restore(step, map_location=device),
                    model_only=False)
                logging.info(f"Resumed from checkpoint step {step}.")

    # -- loop -------------------------------------------------------------------
    def train(self):
        cfg = self.cfg
        self._load_ckpt()
        first_epoch = getattr(self.problem, "epoch", 0)
        it = first_epoch * (self.timekeeping.nb_steps_per_epoch
                            if self.timekeeping.nb_samples_per_epoch != -1 else 0)

        if cfg.validation_before_training and self.val_ds is not None:
            logs = self.problem.validation(self.val_ds)
            self._log(logs, it)

        samples_per_epoch = self.timekeeping.nb_samples_per_epoch
        batch_size = self.timekeeping.batch_size
        for epoch in range(first_epoch, self.timekeeping.nb_epochs):
            self.problem.epoch = epoch
            self.problem.start_epoch()
            epoch_start, epoch_samples = time.perf_counter(), 0

            for data in self.train_ds:
                loss, logs = self.problem.train_step(data, it)
                epoch_samples += batch_size
                it += 1
                if cfg.verbose and cfg.display_loss_every_it > 0 \
                        and it % cfg.display_loss_every_it == 0:
                    logging.info(f"it={it} loss={loss:.4f}")
                self._log(logs, it)
                if cfg.validation_every_it > 0 \
                        and it % cfg.validation_every_it == 0 \
                        and self.val_ds is not None:
                    self._log(self.problem.validation(self.val_ds), it)
                if cfg.ckpt_every_it > 0 and it % cfg.ckpt_every_it == 0:
                    self._save_ckpt(it)
                if samples_per_epoch != -1 and epoch_samples >= samples_per_epoch:
                    break

            duration = time.perf_counter() - epoch_start
            if cfg.verbose:
                logging.info(
                    f"epoch={epoch} done: {epoch_samples} samples in "
                    f"{duration:.1f}s ({epoch_samples / duration:.1f} img/s)"
                )
            if self.val_ds is not None:
                self._log(self.problem.validation(self.val_ds), it)
            self.problem.epoch = epoch + 1
            self._save_ckpt(it if it > 0 else epoch + 1)

        if cfg.ckpt_dir:
            self.problem.save_model(f"{cfg.ckpt_dir}/model")

    def _log(self, logs, it):
        if not logs:
            return
        if self.log_wandb:
            try:
                import wandb

                wandb.log(logs, step=it)
            except ImportError:
                pass
        elif self.cfg.verbose:
            logging.info(f"it={it} " + " ".join(
                f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in logs.items()))


# Name kept for discoverability by users migrating from the reference.
SingleDeviceTrainer = Trainer
