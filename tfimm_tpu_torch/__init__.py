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

    q = tfm.quantize_int8(model)               # a copy with int8 Dense layers
    logits = q.predict(pp(images_uint8_nhwc))

    tfm.save_model(model, "vit_dir")           # the JAX package's format
    model = tfm.load_model("vit_dir", device="cuda")
    big = tfm.create_model("vit_base_patch16_224", model_path="vit_dir",
                           input_size=(384, 384), device="cuda")

This package imports ``torch`` and never ``jax`` or ``tfimm_tpu``.
"""

from tfimm_tpu_torch.models.config import ModelConfig  # noqa: F401
from tfimm_tpu_torch.models.registry import (  # noqa: F401
    is_model,
    list_models,
    list_modules,
    model_class,
    model_config,
    register_model,
)
from tfimm_tpu_torch.models.factory import (  # noqa: F401
    create_model,
    create_preprocessing,
    transfer_weights,
)
from tfimm_tpu_torch.models.base import Model  # noqa: F401
from tfimm_tpu_torch.models.serialization import (  # noqa: F401
    load_model,
    save_model,
)
from tfimm_tpu_torch.models.embedding import EmbeddingModel  # noqa: F401
from tfimm_tpu_torch.quant import quantize_int8  # noqa: F401
from tfimm_tpu_torch.utils.cache import (  # noqa: F401
    cached_model_path,
    clear_model_cache,
    get_dir,
    list_cached_models,
    set_dir,
    set_model_cache,
)
from tfimm_tpu_torch.utils.convert import (  # noqa: F401
    jax_from_state_dict,
    state_dict_from_jax,
)

# Architectures register themselves with the model registry at import time.
import tfimm_tpu_torch.architectures  # noqa: F401, E402
