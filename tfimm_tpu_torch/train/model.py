"""Model factories for the training framework; mirror of tfimm_tpu/train/model.py.

Each factory is called with the device and returns (model, preprocessing)
there: ``ModelFactory`` a registered model, ``SavedModel`` a model saved by
``save_model`` of either package (a distillation teacher, say), and
``EmbeddingModelFactory`` a backbone with an embedding head.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Union

import torch

from tfimm_tpu_torch.models.embedding import EmbeddingModel
from tfimm_tpu_torch.models.factory import create_model, create_preprocessing
from tfimm_tpu_torch.models.serialization import load_model
from tfimm_tpu_torch.train.registry import cfg_serializable

__all__ = ["ModelConfig", "ModelFactory", "SavedModelConfig", "SavedModel",
           "EmbeddingModelConfig", "EmbeddingModelFactory"]


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


@dataclass
class SavedModelConfig:
    path: str = ""
    dtype: str = ""
    mean: tuple = (0.0, 0.0, 0.0)
    std: tuple = (1.0, 1.0, 1.0)


@cfg_serializable
class SavedModel:
    cfg_class = SavedModelConfig

    def __init__(self, cfg: SavedModelConfig):
        self.cfg = cfg

    def __call__(self, device: Union[str, torch.device]):
        """(the saved model on ``device`` in the dtype it was saved in,
        ``img -> (img.to(dtype) - mean) / std``); ``dtype`` names a torch
        dtype ("bfloat16"), empty for float32."""
        model = load_model(self.cfg.path, device=device)
        dtype = getattr(torch, self.cfg.dtype) if self.cfg.dtype \
            else torch.float32
        if not isinstance(dtype, torch.dtype):
            raise ValueError(f"SavedModel: {self.cfg.dtype!r} is no dtype")
        mean = torch.tensor(self.cfg.mean, device=device).to(dtype)
        std = torch.tensor(self.cfg.std, device=device).to(dtype)

        def _preprocess(img) -> torch.Tensor:
            return (torch.as_tensor(img, device=device).to(dtype) - mean) / std

        return model, _preprocess


@dataclass
class EmbeddingModelConfig:
    backbone_name: str = ""
    embed_dim: int = 512
    pretrained: str = ""
    model_path: str = ""
    input_size: tuple = ()
    in_channels: int = -1
    drop_rate: float = 0.0
    drop_path_rate: float = 0.0


@cfg_serializable
class EmbeddingModelFactory:
    cfg_class = EmbeddingModelConfig

    def __init__(self, cfg: EmbeddingModelConfig):
        self.cfg = cfg

    def __call__(self, device: Union[str, torch.device]):
        """(an ``EmbeddingModel`` over the backbone built without its head,
        with f32 parameters on ``device``, the backbone's preprocessing).
        The embedding head is drawn from seed 0, as the JAX factory draws
        it from ``PRNGKey(0)`` (the two give different numbers)."""
        kwargs = {"nb_classes": 0}
        for arg, default in [("input_size", ()), ("in_channels", -1),
                             ("drop_rate", 0.0), ("drop_path_rate", 0.0)]:
            if getattr(self.cfg, arg) != default:
                kwargs[arg] = getattr(self.cfg, arg)
        backbone = create_model(
            self.cfg.backbone_name,
            device="cpu",
            pretrained=self.cfg.pretrained,
            model_path=self.cfg.model_path,
            **kwargs,
        )
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = EmbeddingModel(backbone, embed_dim=self.cfg.embed_dim)
        preprocessing = create_preprocessing(self.cfg.backbone_name,
                                             device=device)
        return model.to(device).eval(), preprocessing
