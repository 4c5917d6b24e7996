"""Architecture zoo. Importing this package fills the model registry."""

from tfimm_tpu_torch.architectures.convnext import *  # noqa: F401,F403
from tfimm_tpu_torch.architectures.vit import *  # noqa: F401,F403
from tfimm_tpu_torch.architectures.swin import *  # noqa: F401,F403
from tfimm_tpu_torch.architectures.cait import *  # noqa: F401,F403
from tfimm_tpu_torch.architectures.segment_anything import *  # noqa: F401,F403
from tfimm_tpu_torch.architectures.pvt import *  # noqa: F401,F403
from tfimm_tpu_torch.architectures.pvt_v2 import *  # noqa: F401,F403
from tfimm_tpu_torch.architectures.poolformer import *  # noqa: F401,F403
from tfimm_tpu_torch.architectures.resnet import *  # noqa: F401,F403
from tfimm_tpu_torch.architectures.vgg import *  # noqa: F401,F403
from tfimm_tpu_torch.architectures.convmixer import *  # noqa: F401,F403
from tfimm_tpu_torch.architectures.pit import *  # noqa: F401,F403
from tfimm_tpu_torch.architectures.efficientnet import *  # noqa: F401,F403
from tfimm_tpu_torch.architectures.mlp_mixer import *  # noqa: F401,F403
from tfimm_tpu_torch.architectures.resnetv2 import *  # noqa: F401,F403
from tfimm_tpu_torch.architectures.vit_hybrid import *  # noqa: F401,F403
