"""LoRA fine-tuning; mirror of tfimm_tpu/architectures/lora/__init__.py,
an opt-in import as there."""

from tfimm_tpu_torch.architectures.lora.convnext import (  # noqa: F401
    LoRAConvNeXt,
    LoRAConvNeXtConfig,
)
from tfimm_tpu_torch.architectures.lora.factory import (  # noqa: F401
    convert_to_lora_model,
    convert_to_regular_model,
    create_model,
    lora_non_trainable_weights,
    lora_optimizer,
    lora_trainable_mask,
    lora_trainable_weights,
    merge_lora_weights,
)
from tfimm_tpu_torch.architectures.lora.layers import (  # noqa: F401
    LORA_WEIGHT_NAMES,
    LoRAConv2d,
    LoRADense,
    convert_to_lora_layer,
)
from tfimm_tpu_torch.architectures.lora.registry import (  # noqa: F401
    lora_architecture,
    lora_base_architecture,
    lora_config,
    register_lora_architecture,
)
