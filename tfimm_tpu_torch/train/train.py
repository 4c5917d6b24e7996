"""Experiment runner; mirror of tfimm_tpu/train/train.py.

``run()``: parse args/YAML -> setup logging -> optional W&B -> instantiate
datasets/problem/trainer via the class registry -> train. The problem runs
on ``ExperimentConfig.device`` (default ``"cuda"``). Meshes wait for
ROADMAP.md, queue A, item 14.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any

from tfimm_tpu_torch.train.config import parse_args, pprint
from tfimm_tpu_torch.train.registry import get_class
from tfimm_tpu_torch.train.utils import setup_logging

__all__ = ["ExperimentConfig", "run"]


@dataclass
class ExperimentConfig:
    trainer: Any = None
    trainer_class: str = ""
    problem: Any = None
    problem_class: str = ""
    train_dataset: Any = None
    train_dataset_class: str = ""
    val_dataset: Any = None
    val_dataset_class: str = ""
    timekeeping: Any = None
    timekeeping_class: str = "Timekeeping"
    # Device mesh spec of the JAX package, e.g. "data:8". Only "" (one
    # device) runs here; meshes raise until ROADMAP.md, queue A, item 14.
    mesh: str = ""
    # The device the problem trains on, e.g. "cuda" or "cuda:1" ("cpu" runs
    # every kernel's plain PyTorch version).
    device: str = "cuda"
    log_level: str = "INFO"
    # Weights & Biases (optional)
    log_wandb: bool = False
    experiment_name: str = "default"
    project_name: str = "default"
    entity: str = ""
    # Config file support
    cfg_file: str = ""


def run(cfg=None, parse_cmdline_args: bool = True):
    """Run an experiment. ``cfg`` may be an ExperimentConfig, a dict of
    defaults, or None; command-line arguments override it."""
    import tfimm_tpu_torch.train  # noqa: F401  (registers classes)

    if not isinstance(cfg, ExperimentConfig) or parse_cmdline_args:
        cfg = parse_args(cfg or {}, cfg_class=ExperimentConfig,
                         args=None if parse_cmdline_args else [])
    setup_logging(cfg.log_level)
    logging.info("Experiment config:")
    pprint(cfg)

    if cfg.mesh:
        raise NotImplementedError(
            "meshes are not ported yet (ROADMAP.md, queue A, item 14)")

    wandb_run = None
    if cfg.log_wandb:
        try:
            import wandb

            wandb_run = wandb.init(
                project=cfg.project_name, entity=cfg.entity or None,
                name=cfg.experiment_name, config=None,
            )
        except ImportError:
            logging.warning("wandb not installed; disabling W&B logging.")
            cfg.log_wandb = False

    timekeeping = cfg.timekeeping
    train_ds = (get_class(cfg.train_dataset_class)(cfg=cfg.train_dataset)
                if cfg.train_dataset_class else None)
    val_ds = (get_class(cfg.val_dataset_class)(cfg=cfg.val_dataset)
              if cfg.val_dataset_class else None)
    problem = get_class(cfg.problem_class)(
        cfg=cfg.problem, timekeeping=timekeeping, device=cfg.device)
    trainer = get_class(cfg.trainer_class)(
        problem=problem, train_ds=train_ds, val_ds=val_ds,
        timekeeping=timekeeping, cfg=cfg.trainer, log_wandb=cfg.log_wandb,
    )
    trainer.train()
    if wandb_run is not None:
        wandb_run.finish()
    return trainer
