"""LoRA-ConvNeXt; mirror of tfimm_tpu/architectures/lora/convnext.py:
every block's MLP fc1 and fc2 become LoRA layers.

At inference each block still runs ``convnext_mlp`` (or ``convnext_block``
with ``TFIMM_TPU_FUSED_CONVNEXT=1``), fed the merged weights through the
layers' ``_kernel``; in training the gates decline both kernels, as for the
base model.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from tfimm_tpu_torch.architectures.convnext import ConvNeXt, ConvNeXtConfig
from tfimm_tpu_torch.architectures.lora.factory import (
    lora_non_trainable_weights,
    lora_trainable_mask,
    lora_trainable_weights,
)
from tfimm_tpu_torch.architectures.lora.layers import convert_to_lora_layer
from tfimm_tpu_torch.architectures.lora.registry import register_lora_architecture

__all__ = ["LoRAConvNeXt", "LoRAConvNeXtConfig"]


@dataclass
class LoRAConvNeXtConfig(ConvNeXtConfig):
    lora_rank: int = 4
    lora_alpha: float = 1.0
    lora_train_bias: str = "none"
    lora_train_classifier: bool = True


@register_lora_architecture
class LoRAConvNeXt(ConvNeXt):
    cfg_class = LoRAConvNeXtConfig

    def __init__(self, cfg: LoRAConvNeXtConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg, generator=generator)
        lora_kwargs = {"lora_rank": cfg.lora_rank, "lora_alpha": cfg.lora_alpha,
                       "generator": generator}
        for stage in self.stages:
            for block in stage.blocks:
                block.mlp.fc1 = convert_to_lora_layer(block.mlp.fc1, **lora_kwargs)
                block.mlp.fc2 = convert_to_lora_layer(block.mlp.fc2, **lora_kwargs)

    def _trainable_layers(self):
        return [self.cfg.classifier] if self.cfg.lora_train_classifier else []

    @property
    def trainable_weights(self):
        return lora_trainable_weights(self, train_bias=self.cfg.lora_train_bias,
                                      trainable_layers=self._trainable_layers())

    @property
    def non_trainable_weights(self):
        return lora_non_trainable_weights(
            self, train_bias=self.cfg.lora_train_bias,
            trainable_layers=self._trainable_layers())

    @property
    def trainable_mask(self):
        return lora_trainable_mask(self, train_bias=self.cfg.lora_train_bias,
                                   trainable_layers=self._trainable_layers())
