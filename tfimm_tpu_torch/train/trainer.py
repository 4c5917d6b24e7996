"""Trainer; mirror of tfimm_tpu/train/trainer.py.

The problem owns the training step; the trainer owns the epoch/step loop,
the validation cadence, throughput logging (img/s per epoch) and metric
forwarding. Checkpoints (``ckpt_dir``, ``init_ckpt``; orbax in the JAX
package) raise until they are ported (ROADMAP.md, queue A, item 13).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass

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
        if cfg.ckpt_dir or cfg.init_ckpt:
            raise NotImplementedError(
                "ckpt_dir / init_ckpt: checkpoints are not ported yet "
                "(ROADMAP.md, queue A, item 13)")

    # -- loop -------------------------------------------------------------------
    def train(self):
        cfg = self.cfg
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
