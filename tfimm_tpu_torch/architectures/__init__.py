"""Architecture zoo. Importing this package fills the model registry."""

from tfimm_tpu_torch.architectures.vit import *  # noqa: F401,F403
