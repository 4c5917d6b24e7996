"""Datasets for the training framework; mirror of tfimm_tpu/train/datasets.py.

- ``ArrayDataset``: in-memory numpy dataset; shuffles and batches per epoch.
- ``SyntheticDataset``: seeded random batches made from the config alone.

Both yield host numpy batches that the problem moves to its device. The
TFDS, Grain and ImageFolder pipelines, and ``ArrayDataset``'s resize, are not
ported yet (ROADMAP.md, queue A, item 13).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from tfimm_tpu_torch.train.registry import cfg_serializable

__all__ = ["ArrayDatasetConfig", "ArrayDataset", "SyntheticDatasetConfig",
           "SyntheticDataset"]


@dataclass
class ArrayDatasetConfig:
    batch_size: int = 32
    shuffle: bool = True
    seed: int = 0
    input_size: tuple = ()


@cfg_serializable
class ArrayDataset:
    """In-memory (images, labels) dataset yielding numpy batches."""

    cfg_class = ArrayDatasetConfig

    def __init__(self, cfg: ArrayDatasetConfig,
                 data: Optional[Tuple[np.ndarray, np.ndarray]] = None):
        self.cfg = cfg
        if data is None:
            raise ValueError("ArrayDataset requires data=(images, labels)")
        self.images, self.labels = data
        self._rng = np.random.default_rng(cfg.seed)

    def __len__(self):
        return len(self.images) // self.cfg.batch_size

    def __iter__(self):
        idx = np.arange(len(self.images))
        if self.cfg.shuffle:
            self._rng.shuffle(idx)
        bs = self.cfg.batch_size
        for i in range(len(self.images) // bs):
            batch = idx[i * bs:(i + 1) * bs]
            images = self.images[batch]
            if self.cfg.input_size and images.shape[1:3] != tuple(
                    self.cfg.input_size):
                raise NotImplementedError(
                    "ArrayDataset's resize (bilinear, as jax.image.resize) is "
                    "not ported yet (ROADMAP.md, queue A, item 13)")
            yield images, self.labels[batch]


@dataclass
class SyntheticDatasetConfig:
    batch_size: int = 8
    nb_samples: int = 64
    input_size: tuple = (32, 32)
    in_channels: int = 3
    nb_classes: int = 10
    seed: int = 0


@cfg_serializable
class SyntheticDataset:
    """Random (image, label) batches generated from the config alone.

    Lets ``run_local.py`` exercise the full training path with zero
    user-authored Python: every field is reachable from the CLI / YAML
    config. The set is small and fixed (seeded), so smoke-training can
    memorize it."""

    cfg_class = SyntheticDatasetConfig

    def __init__(self, cfg: SyntheticDatasetConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        n = cfg.nb_samples
        self.images = rng.uniform(
            0.0, 255.0,
            size=(n, *tuple(cfg.input_size), cfg.in_channels),
        ).astype(np.float32)
        self.labels = rng.integers(0, cfg.nb_classes, size=(n,))

    def __len__(self):
        return self.cfg.nb_samples // self.cfg.batch_size

    def __iter__(self):
        bs = self.cfg.batch_size
        for i in range(len(self)):
            yield (self.images[i * bs:(i + 1) * bs],
                   self.labels[i * bs:(i + 1) * bs])
