"""Fused multi-head attention from the packed qkv projection.

Counterpart of ``tfimm_tpu/ops/pallas/fused_mha.py · fused_mha``. Takes
``qkv`` of shape (B, N, 3*D), last dim in timm's (3, H, d) order, and
returns (B, N, D) with the heads concatenated. The softmax is the clamped
no-max softmax (``dispatch.softmax_nomax``) in f32.

On a CUDA tensor ``fused_mha`` launches the hand-written kernel in
``tfimm_tpu_torch/csrc/fused_mha.cu`` (see the note at its top for the
design and what bounds it); on a CPU tensor it runs ``fused_mha_reference``.
The CUDA path is inference only for now: a ``qkv`` that requires grad
raises. The kernel takes bf16 and f32, any B, N and H, and head dims that
are multiples of 8 up to 128; ``fused_mha_or_none`` declines anything else
so that the attention layer can take its plain path.
"""

from __future__ import annotations

from typing import Optional

import torch

from tfimm_tpu_torch.ops.kernels.dispatch import (
    count_launch,
    log_dispatch,
    on_cuda,
    softmax_nomax,
)

__all__ = ["fused_mha", "fused_mha_reference", "fused_mha_or_none",
           "fused_mha_supports"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 128


def fused_mha_reference(qkv: torch.Tensor, nb_heads: int,
                        scale: float) -> torch.Tensor:
    """Plain PyTorch twin of the kernel (and of ``_reference_mha`` in the
    JAX package): f32 scores, clamped no-max softmax, f32 p @ v."""
    b, n, three_d = qkv.shape
    dim = three_d // 3
    d = dim // nb_heads
    q, k, v = (qkv[..., i * dim:(i + 1) * dim]
               .reshape(b, n, nb_heads, d).transpose(1, 2)
               for i in range(3))
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    p = softmax_nomax(s)
    o = torch.matmul(p, v.float())
    return o.transpose(1, 2).reshape(b, n, dim).to(qkv.dtype)


def fused_mha_supports(qkv: torch.Tensor, nb_heads: int) -> bool:
    """Whether the kernel takes this input's dtype and shape."""
    if qkv.dim() != 3 or qkv.dtype not in _DTYPE_CODES:
        return False
    three_d = qkv.shape[-1]
    if three_d % 3 or (three_d // 3) % nb_heads:
        return False
    d = three_d // 3 // nb_heads
    return d % 8 == 0 and d <= _MAX_HEAD_DIM


def fused_mha(qkv: torch.Tensor, nb_heads: int, scale: float) -> torch.Tensor:
    """qkv: (B, N, 3*D), last dim (3, H, d). Returns (B, N, D)."""
    if qkv.device.type == "cpu":
        return fused_mha_reference(qkv, nb_heads, scale)
    if not on_cuda(qkv):
        raise ValueError(f"fused_mha: unsupported device {qkv.device}")
    if not fused_mha_supports(qkv, nb_heads):
        raise ValueError(
            f"fused_mha: needs (B, N, 3*H*d) bf16/f32 with d a multiple of 8 "
            f"up to {_MAX_HEAD_DIM}; got {tuple(qkv.shape)} {qkv.dtype} "
            f"with {nb_heads} heads")
    if not qkv.is_contiguous():
        raise ValueError("fused_mha: qkv must be contiguous")
    if qkv.data_ptr() % 16:
        raise ValueError("fused_mha: qkv must be 16-byte aligned")
    if qkv.requires_grad:
        raise RuntimeError(
            "fused_mha: the CUDA kernel has no backward yet; run inference "
            "under torch.no_grad() or torch.inference_mode()")
    from tfimm_tpu_torch.ops.kernels.build import kernel_library

    lib = kernel_library()
    b, n, three_d = qkv.shape
    dim = three_d // 3
    out = torch.empty((b, n, dim), dtype=qkv.dtype, device=qkv.device)
    if b == 0 or n == 0:
        return out
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.tfimm_fused_mha_fwd(
            qkv.data_ptr(), out.data_ptr(), b, n, nb_heads, dim // nb_heads,
            float(scale), _DTYPE_CODES[qkv.dtype], stream)
    if err != 0:
        raise RuntimeError(f"fused_mha: kernel launch failed, cudaError {err}")
    count_launch("fused_mha")
    return out


def fused_mha_or_none(qkv: torch.Tensor, nb_heads: int,
                      scale: float) -> Optional[torch.Tensor]:
    """Run ``fused_mha`` when it takes the input, else return None."""
    if not fused_mha_supports(qkv, nb_heads):
        return None
    log_dispatch("fused_mha")
    return fused_mha(qkv, nb_heads, scale)
