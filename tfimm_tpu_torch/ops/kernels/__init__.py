"""Hand-written CUDA kernels (sources in ``tfimm_tpu_torch/csrc/``) with
their plain PyTorch twins; counterpart of ``tfimm_tpu/ops/pallas/``."""

from tfimm_tpu_torch.ops.kernels.fused_mha import (  # noqa: F401
    fused_mha,
    fused_mha_or_none,
    fused_mha_reference,
)
