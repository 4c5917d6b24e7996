from tfimm_tpu_torch.ops.attention import (  # noqa: F401
    MultiHeadAttention,
    scaled_dot_product_attention,
)
from tfimm_tpu_torch.ops.basic import Dense, act_layer_factory  # noqa: F401
from tfimm_tpu_torch.ops.classifier import (  # noqa: F401
    ClassifierHead,
    global_pool_2d,
)
from tfimm_tpu_torch.ops.conv import (  # noqa: F401
    Conv2d,
    DepthwiseConv2d,
    StdConv2d,
)
from tfimm_tpu_torch.ops.embed import (  # noqa: F401
    PatchEmbeddings,
    interpolate_pos_embeddings,
    interpolate_pos_embeddings_grid,
)
from tfimm_tpu_torch.ops.kernels.ln_dense import (  # noqa: F401
    ln_dense,
    ln_dense_diff,
    ln_dense_or_none,
)
from tfimm_tpu_torch.ops.mlp import (  # noqa: F401
    MLP,
    ConvMLP,
    GatedMLP,
    GluMLP,
    SpatialGatingUnit,
)
from tfimm_tpu_torch.ops.norm import (  # noqa: F401
    Affine,
    BatchNorm,
    LayerNorm,
    norm_layer_factory,
)
from tfimm_tpu_torch.ops.pool import (  # noqa: F401
    BlurPool2d,
    avg_pool_2d,
    max_pool_2d,
)
from tfimm_tpu_torch.ops.se import (  # noqa: F401
    EcaModule,
    SEModule,
    attn_layer_factory,
)
