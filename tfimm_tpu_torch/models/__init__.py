from tfimm_tpu_torch.models.base import Model  # noqa: F401
from tfimm_tpu_torch.models.config import ModelConfig  # noqa: F401
from tfimm_tpu_torch.models.factory import (  # noqa: F401
    create_model,
    create_preprocessing,
)
from tfimm_tpu_torch.models.registry import (  # noqa: F401
    is_model,
    list_models,
    model_class,
    model_config,
    register_model,
)
