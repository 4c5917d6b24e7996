from tfimm_tpu_torch.ops.attention import MultiHeadAttention  # noqa: F401
from tfimm_tpu_torch.ops.basic import Dense, act_layer_factory  # noqa: F401
from tfimm_tpu_torch.ops.conv import Conv2d  # noqa: F401
from tfimm_tpu_torch.ops.embed import PatchEmbeddings  # noqa: F401
from tfimm_tpu_torch.ops.mlp import MLP  # noqa: F401
from tfimm_tpu_torch.ops.norm import LayerNorm, norm_layer_factory  # noqa: F401
