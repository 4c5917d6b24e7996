"""tfimm_tpu_torch: the PyTorch and CUDA port of tfimm_tpu.

A second package beside the JAX one, with the same module paths. Models are
``nn.Module``s whose parameters carry timm's names; the kernels the JAX
package wrote in Pallas for the TPU are written by hand for NVIDIA Hopper
(``csrc/``) and built with ``nvcc`` at their first CUDA call. On the CPU
each kernel wrapper runs its plain PyTorch version.

    import tfimm_tpu_torch as tfm
    model = tfm.create_model("vit_base_patch16_224", device="cuda",
                             dtype=torch.bfloat16, seed=0)
    pp = tfm.create_preprocessing("vit_base_patch16_224",
                                  dtype=torch.bfloat16, device="cuda")
    logits = model.predict(pp(images_uint8_nhwc))

This package imports ``torch`` and never ``jax`` or ``tfimm_tpu``.
"""

from tfimm_tpu_torch.models.config import ModelConfig  # noqa: F401
from tfimm_tpu_torch.models.registry import (  # noqa: F401
    is_model,
    list_models,
    model_class,
    model_config,
    register_model,
)
from tfimm_tpu_torch.models.factory import (  # noqa: F401
    create_model,
    create_preprocessing,
)
from tfimm_tpu_torch.models.base import Model  # noqa: F401
from tfimm_tpu_torch.utils.convert import state_dict_from_jax  # noqa: F401

# Architectures register themselves with the model registry at import time.
import tfimm_tpu_torch.architectures  # noqa: F401, E402
