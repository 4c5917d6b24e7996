"""Model factories for the training framework; mirror of tfimm_tpu/train/model.py.

``ModelFactory`` builds a registered model and its preprocessing on the
device it is given. ``SavedModel`` and ``EmbeddingModelFactory`` are not
ported yet (ROADMAP.md, queue A, item 13).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Union

import torch

from tfimm_tpu_torch.models.factory import create_model, create_preprocessing
from tfimm_tpu_torch.train.registry import cfg_serializable

__all__ = ["ModelConfig", "ModelFactory"]


@dataclass
class ModelConfig:
    model_name: str = ""
    pretrained: str = ""
    model_path: str = ""
    input_size: tuple = ()
    in_channels: int = -1
    nb_classes: int = -1
    drop_rate: float = 0.0
    drop_path_rate: float = 0.0
    attn_drop_rate: float = 0.0


@cfg_serializable
class ModelFactory:
    cfg_class = ModelConfig

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    def __call__(self, device: Union[str, torch.device]):
        """(model, preprocessing): f32 parameters on ``device``, and the
        preprocessing to f32 on the same device."""
        kwargs = {}
        for arg, default in [("input_size", ()), ("in_channels", -1),
                             ("nb_classes", -1), ("drop_rate", 0.0),
                             ("drop_path_rate", 0.0), ("attn_drop_rate", 0.0)]:
            if getattr(self.cfg, arg) != default:
                kwargs[arg] = getattr(self.cfg, arg)
        model = create_model(
            self.cfg.model_name,
            device=device,
            pretrained=self.cfg.pretrained,
            model_path=self.cfg.model_path,
            **kwargs,
        )
        preprocessing = create_preprocessing(self.cfg.model_name, device=device)
        return model, preprocessing
