from tfimm_tpu_torch.models.base import Model  # noqa: F401
from tfimm_tpu_torch.models.config import ModelConfig  # noqa: F401
from tfimm_tpu_torch.models.embedding import EmbeddingModel  # noqa: F401
from tfimm_tpu_torch.models.factory import (  # noqa: F401
    create_model,
    create_preprocessing,
    transfer_weights,
)
from tfimm_tpu_torch.models.registry import (  # noqa: F401
    is_model,
    list_models,
    list_modules,
    model_class,
    model_config,
    register_model,
)
from tfimm_tpu_torch.models.serialization import (  # noqa: F401
    load_model,
    save_model,
)
