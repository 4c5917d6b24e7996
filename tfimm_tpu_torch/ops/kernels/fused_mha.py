"""Fused multi-head attention from the packed qkv projection.

Counterpart of ``tfimm_tpu/ops/pallas/fused_mha.py · fused_mha``. Takes
``qkv`` of shape (B, N, 3*D), last dim in timm's (3, H, d) order, and
returns (B, N, D) with the heads concatenated. The softmax is the clamped
no-max softmax (``dispatch.softmax_nomax``) in f32.

On a CUDA tensor ``fused_mha`` launches the hand-written kernel in
``tfimm_tpu_torch/csrc/fused_mha.cu`` (see the note at its top for the
design and what bounds it); on a CPU tensor it runs ``fused_mha_reference``.
When ``qkv`` requires grad, the call goes through a ``torch.autograd.Function``
whose backward is ``fused_mha_bwd``: the kernel of
``tfimm_tpu_torch/csrc/fused_mha_bwd.cu`` on a CUDA tensor,
``fused_mha_bwd_reference`` on a CPU one. Every other call (no grad wanted)
goes through the custom op ``torch.ops.tfimm_tpu_torch.fused_mha``, whose
body is the same forward and whose fake function gives the (B, N, D) shape,
so that ``torch.export`` records the op rather than tracing into the kernel's
wrapper (``utils/export.py``). The kernels take bf16 and f32, any
B, N and H, and head dims that are multiples of 8 up to 128;
``fused_mha_or_none`` declines anything else so that the attention layer can
take its plain path.
"""

from __future__ import annotations

from typing import Optional

import torch

from torch.autograd.function import once_differentiable

from tfimm_tpu_torch.ops.kernels.dispatch import (
    launch,
    log_dispatch,
    on_cuda,
    softmax_clamp_grad_mask,
    softmax_nomax,
)
from tfimm_tpu_torch.ops.kernels.tma import TILE, packed_fused_mha_maps

__all__ = ["fused_mha", "fused_mha_reference", "fused_mha_or_none",
           "fused_mha_supports", "fused_mha_bwd", "fused_mha_bwd_reference"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 128


def _heads(x: torch.Tensor, nb_heads: int, dtype: torch.dtype):
    """(B, N, H * d) -> (B, H, N, d) in ``dtype``."""
    b, n, dim = x.shape
    return x.reshape(b, n, nb_heads, dim // nb_heads).transpose(1, 2).to(dtype)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, N, d) -> (B, N, H * d)."""
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


def _split_qkv(qkv: torch.Tensor, nb_heads: int):
    """q, k, v as (B, H, N, d), in float32 (float64 for a float64 qkv)."""
    dtype = torch.promote_types(qkv.dtype, torch.float32)
    return [_heads(part, nb_heads, dtype) for part in qkv.chunk(3, dim=-1)]


def fused_mha_reference(qkv: torch.Tensor, nb_heads: int,
                        scale: float) -> torch.Tensor:
    """Plain PyTorch twin of the kernel (and of ``_reference_mha`` in the
    JAX package): f32 scores, clamped no-max softmax, f32 p @ v."""
    q, k, v = _split_qkv(qkv, nb_heads)
    p = softmax_nomax(torch.matmul(q * scale, k.transpose(-1, -2)))
    return _merge_heads(torch.matmul(p, v)).to(qkv.dtype)


def fused_mha_bwd_reference(qkv: torch.Tensor, g: torch.Tensor,
                            nb_heads: int, scale: float) -> torch.Tensor:
    """Plain PyTorch twin of the backward kernel (``_pair_attention_bwd`` in
    the JAX package), in f32: the softmax recomputed, the clamp mask on the
    score cotangent. g = dL/dout (B, N, D); returns dL/dqkv (B, N, 3*D) in
    qkv's dtype and packed layout."""
    q, k, v = _split_qkv(qkv, nb_heads)
    g = _heads(g, nb_heads, q.dtype)
    s = torch.matmul(q * scale, k.transpose(-1, -2))
    p = softmax_nomax(s)
    dv = torch.matmul(p.transpose(-1, -2), g)
    dp = torch.matmul(g, v.transpose(-1, -2))
    ds = softmax_clamp_grad_mask(
        s, p * (dp - (dp * p).sum(dim=-1, keepdim=True)))
    dq = scale * torch.matmul(ds, k)
    dk = scale * torch.matmul(ds.transpose(-1, -2), q)
    return torch.cat([_merge_heads(t) for t in (dq, dk, dv)],
                     dim=-1).to(qkv.dtype)


def fused_mha_supports(qkv: torch.Tensor, nb_heads: int) -> bool:
    """Whether the kernel takes this input's dtype and shape."""
    if qkv.dim() != 3 or qkv.dtype not in _DTYPE_CODES:
        return False
    three_d = qkv.shape[-1]
    if three_d % 3 or (three_d // 3) % nb_heads:
        return False
    d = three_d // 3 // nb_heads
    return d % 8 == 0 and d <= _MAX_HEAD_DIM


def _check_kernel_input(name: str, qkv: torch.Tensor, nb_heads: int) -> None:
    """Raise on a CUDA qkv that the kernels do not take."""
    if not on_cuda(qkv):
        raise ValueError(f"{name}: unsupported device {qkv.device}")
    if not fused_mha_supports(qkv, nb_heads):
        raise ValueError(
            f"{name}: needs (B, N, 3*H*d) bf16/f32 with d a multiple of 8 "
            f"up to {_MAX_HEAD_DIM}; got {tuple(qkv.shape)} {qkv.dtype} "
            f"with {nb_heads} heads")
    if not qkv.is_contiguous():
        raise ValueError(f"{name}: qkv must be contiguous")
    if qkv.data_ptr() % 16:
        raise ValueError(f"{name}: qkv must be 16-byte aligned")


def _fused_mha_forward(qkv: torch.Tensor, nb_heads: int,
                       scale: float) -> torch.Tensor:
    # Logged here, where an exported program's forward runs too.
    log_dispatch("fused_mha")
    if qkv.device.type == "cpu":
        return fused_mha_reference(qkv, nb_heads, scale)
    _check_kernel_input("fused_mha", qkv, nb_heads)
    from tfimm_tpu_torch.ops.kernels.build import kernel_library

    b, n, three_d = qkv.shape
    dim = three_d // 3
    out = torch.empty((b, n, dim), dtype=qkv.dtype, device=qkv.device)
    if b == 0 or n == 0:
        return out
    d = dim // nb_heads
    maps = (packed_fused_mha_maps(b, n, nb_heads, d)
            if qkv.dtype == torch.bfloat16 else None)
    launch("fused_mha", kernel_library().tfimm_fused_mha_fwd, qkv, out, maps,
           b, n, nb_heads, d, float(scale), _DTYPE_CODES[qkv.dtype])
    return out


def fused_mha_bwd(qkv: torch.Tensor, g: torch.Tensor, nb_heads: int,
                  scale: float) -> torch.Tensor:
    """dL/dqkv (B, N, 3*D) of ``fused_mha`` from qkv and g = dL/dout
    (B, N, D). Runs ``fused_mha_bwd_reference`` on the CPU and the kernel on
    a CUDA device, where it raises on what the kernel does not take."""
    if qkv.device.type == "cpu" and g.device.type == "cpu":
        return fused_mha_bwd_reference(qkv, g, nb_heads, scale)
    _check_kernel_input("fused_mha_bwd", qkv, nb_heads)
    b, n, three_d = qkv.shape
    if g.shape != (b, n, three_d // 3) or g.dtype != qkv.dtype:
        raise ValueError(
            f"fused_mha_bwd: g must be {(b, n, three_d // 3)} {qkv.dtype}; "
            f"got {tuple(g.shape)} {g.dtype}")
    if g.device != qkv.device or not g.is_contiguous() or g.data_ptr() % 16:
        raise ValueError("fused_mha_bwd: g must be contiguous, 16-byte "
                         "aligned and on qkv's device")
    from tfimm_tpu_torch.ops.kernels.build import kernel_library

    dqkv = torch.empty_like(qkv)
    if b == 0 or n == 0:
        return dqkv.zero_()
    d = three_d // 3 // nb_heads
    maps, rows = None, n
    if qkv.dtype == torch.bfloat16:
        # The bf16 kernels keep log2 l and delta of every row of their
        # 64-row tiles, padded ones included.
        maps = packed_fused_mha_maps(b, n, nb_heads, d)
        rows = -(-n // TILE) * TILE
    row_sum = torch.empty((b, nb_heads, rows), dtype=torch.float32,
                          device=qkv.device)
    row_delta = torch.empty_like(row_sum)
    launch("fused_mha_bwd", kernel_library().tfimm_fused_mha_bwd, qkv, g,
           dqkv, row_sum, row_delta, maps, b, n, nb_heads, d, float(scale),
           _DTYPE_CODES[qkv.dtype])
    return dqkv


@torch.library.custom_op("tfimm_tpu_torch::fused_mha", mutates_args=())
def _fused_mha_op(qkv: torch.Tensor, nb_heads: int,
                  scale: float) -> torch.Tensor:
    """The no-grad forward as a dispatcher op: the plain version on the
    CPU, the kernel on the card, as ``_fused_mha_forward``. An exported
    program calls it, and its dispatch log and launches count, at run
    time."""
    return _fused_mha_forward(qkv, nb_heads, scale)


@_fused_mha_op.register_fake
def _fused_mha_fake(qkv, nb_heads, scale):
    b, n, three_d = qkv.shape
    return qkv.new_empty((b, n, three_d // 3))


class _FusedMHA(torch.autograd.Function):
    """fused_mha with ``fused_mha_bwd`` as its backward (the custom VJP of
    ``fused_mha_diff`` in the JAX package). Saves only qkv: the backward
    recomputes the softmax."""

    @staticmethod
    def forward(ctx, qkv, nb_heads, scale):
        ctx.save_for_backward(qkv)
        ctx.nb_heads, ctx.scale = nb_heads, scale
        return _fused_mha_forward(qkv, nb_heads, scale)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        return (fused_mha_bwd(qkv, g.contiguous(), ctx.nb_heads, ctx.scale),
                None, None)


def fused_mha(qkv: torch.Tensor, nb_heads: int, scale: float) -> torch.Tensor:
    """qkv: (B, N, 3*D), last dim (3, H, d). Returns (B, N, D);
    differentiable with respect to qkv (``_FusedMHA``); without grad through
    the op ``tfimm_tpu_torch::fused_mha``."""
    if qkv.requires_grad and torch.is_grad_enabled():
        return _FusedMHA.apply(qkv, nb_heads, scale)
    return _fused_mha_op(qkv, nb_heads, float(scale))


def fused_mha_or_none(qkv: torch.Tensor, nb_heads: int,
                      scale: float) -> Optional[torch.Tensor]:
    """Run ``fused_mha`` when it takes the input, else return None."""
    if not fused_mha_supports(qkv, nb_heads):
        return None
    return fused_mha(qkv, nb_heads, scale)
