"""Flash attention (exact online softmax), forward and backward.

Counterpart of ``tfimm_tpu/ops/pallas/flash_attention_kernel.py ·
flash_attention`` (its forward ``_flash_forward_call`` and its custom VJP
``_flash_backward_call``) and of ``tfimm_tpu/ops/pallas/flash_attention.py ·
flash_attention_or_none``. q, k, v (..., N, d); per row of the leading
dims:

    qs = q * scale                               (rounded to the dtype)
    s = qs k^T,  m = max_c s,  p = exp(s - m),  l = max(sum_c p, 1e-30)
    o = (p.astype(dtype) @ v) / l, summed in f32, rounded once
    lse = m + log(l)                                               (f32)

an exact softmax with a running max: no clamp (the ``SOFTMAX_CLAMP`` of
``fused_mha`` does not apply). The backward takes the cotangent do of o
and the forward's lse, all in f32:

    delta_i = sum_e do[i, e] * o[i, e]
    p = exp(s - lse),  dv = p^T do,  ds = p * (do v^T - delta)
    dqs = ds k,  dk = ds^T qs

with dqs, dk and dv in the dtype of q, k and v. As in the JAX package the
scale stays outside the autograd Function (``_FlashAttention``), so that
autograd chains ``scale_query``. The JAX package computes delta outside its
``pallas_call``s; the port's bf16 backward up to d = 128 forms it in its
first launch (``csrc/attention_bwd.cuh``), the other kernels take it from
a PyTorch reduction.

On CUDA tensors the wrappers launch the hand-written kernels of
``tfimm_tpu_torch/csrc/flash_attention.cu`` (forward) and
``flash_attention_bwd.cu`` (backward; see the notes at their tops for the
designs and what bounds them) and raise on what they do not take; on CPU
tensors they run ``flash_attention_reference`` and
``flash_attention_bwd_reference``. Both kernels take bf16 and f32, any N,
and d a multiple of 8 up to 256 (``flash_attention_supports``). A
(B, H, N, d) operand is read through its three strides: the attention
layer hands over q, k and v as views of its packed qkv projection
(``flash_attention_packed``) and takes o as (B, N, H * d), with no head
transpose and no copy.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from tfimm_tpu_torch.ops.kernels.dispatch import launch, log_dispatch
from tfimm_tpu_torch.ops.kernels.flash_attention_relpos import (
    scale_query,
    stats_scratch,
)
from tfimm_tpu_torch.ops.kernels.tma import TILE, packed_heads_maps

__all__ = ["flash_attention", "flash_attention_with_lse",
           "flash_attention_packed", "flash_attention_reference",
           "flash_attention_bwd", "flash_attention_bwd_reference",
           "flash_attention_supports", "flash_attention_or_none",
           "scale_query", "FLASH_MIN_TOKENS"]

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
# The bf16 forward reads its operands through TMA maps up to this head dim
# (two 64-column chunks) and through plain loads above.
TMA_MAX_HEAD_DIM = 2 * TILE
MIN_SUM = 1e-30
# The JAX dispatcher's switch (flash_attention.py:59): below it the score
# matrix fits on chip and the other attention paths serve.
FLASH_MIN_TOKENS = 1024


def _forward_reference(qs, k, v):
    dt = qs.dtype
    acc = torch.promote_types(dt, torch.float32)
    s = torch.matmul(qs.to(acc), k.to(acc).transpose(-1, -2))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=MIN_SUM)
    out = torch.matmul(p.to(dt).to(acc), v.to(acc)) / l
    return out.to(dt), (m + torch.log(l)).squeeze(-1)


def flash_attention_reference(q, k, v, *, scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the kernel on (..., N, d): (out in q's dtype,
    lse (..., N) in f32, f64 for f64 inputs)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return _forward_reference(scale_query(q, scale), k, v)


def flash_attention_bwd_reference(qs, k, v, out, lse, do):
    """Plain PyTorch twin of the backward kernel, from the scaled q, the
    forward's output and lse and the cotangent ``do``: (dqs, dk, dv) in the
    dtypes of qs, k and v. Every product and sum in f32 (f64 for f64
    inputs)."""
    acc = torch.promote_types(qs.dtype, torch.float32)
    do32 = do.to(acc)
    delta = (do32 * out.to(acc)).sum(dim=-1, keepdim=True)
    s = torch.matmul(qs.to(acc), k.to(acc).transpose(-1, -2))
    p = torch.exp(s - lse.to(acc)[..., None])
    dv = torch.matmul(p.transpose(-1, -2), do32)
    ds = p * (torch.matmul(do32, v.to(acc).transpose(-1, -2)) - delta)
    dqs = torch.matmul(ds, k.to(acc))
    dk = torch.matmul(ds.transpose(-1, -2), qs.to(acc))
    return dqs.to(qs.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_supports(d: int, dtype: torch.dtype) -> bool:
    """Whether the kernels take head dim ``d`` in ``dtype`` (any N)."""
    return dtype in DTYPE_CODES and d % 8 == 0 and 0 < d <= MAX_HEAD_DIM


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _rows(t: torch.Tensor) -> torch.Tensor:
    """(..., N, d) as (B, H, N, d): a 4-D tensor itself, else its leading
    dims as B with H = 1 (a view where they flatten)."""
    if t.dim() == 4:
        return t
    return t.reshape(-1, 1, *t.shape[-2:])


def _readable(t: torch.Tensor) -> torch.Tensor:
    """``t`` (B, H, N, d) itself when the kernels can read it through its
    strides (unit stride in d; in bf16 positive strides of 16-byte multiples,
    as TMA maps take them, and a 16-byte aligned start), else a contiguous
    copy."""
    if t.stride(-1) == 1 and (t.dtype != torch.bfloat16 or (
            all(s % 8 == 0 and s > 0 for s in t.stride()[:-1])
            and t.data_ptr() % 16 == 0)):
        return t
    return t.contiguous()


def _strides(*tensors) -> ctypes.Array:
    """The (B, H, N) strides of (B, H, N, d) tensors, in turn, as the
    int64 array the kernels take."""
    values = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_int64 * len(values))(*values)


def _check_kernel_inputs(name, *tensors):
    q = tensors[0]
    devices = {t.device for t in tensors}
    if len(devices) > 1 or q.device.type != "cuda":
        raise ValueError(f"{name}: all inputs must lie on one CUDA device; "
                         f"got {sorted(map(str, devices))}")
    if any(t.shape != q.shape for t in tensors):
        raise ValueError(f"{name}: the operands must share one (..., N, d) "
                         f"shape; got {[tuple(t.shape) for t in tensors]}")
    if q.dim() < 2 or any(t.dtype != q.dtype for t in tensors) \
            or not flash_attention_supports(q.shape[-1], q.dtype):
        raise ValueError(
            f"{name}: the kernels take bf16 or f32 (one dtype for all) and "
            f"d a multiple of 8 up to {MAX_HEAD_DIM}; got "
            f"{[t.dtype for t in tensors]}, shape {tuple(q.shape)}")


def _forward(qs, k, v):
    """(out, lse) from the scaled q: the plain version when every input
    lies on the CPU, the kernel otherwise. out keeps the layout of qs."""
    if _on_cpu(qs, k, v):
        return _forward_reference(qs, k, v)
    _check_kernel_inputs("flash_attention", qs, k, v)
    from tfimm_tpu_torch.ops.kernels.build import kernel_library

    lead, (n, d) = qs.shape[:-2], qs.shape[-2:]
    q4, k4, v4 = (_readable(_rows(t)) for t in (qs, k, v))
    out = torch.empty_like(q4)
    lse = torch.empty(q4.shape[:-1], dtype=torch.float32, device=qs.device)
    b, h = q4.shape[:2]
    if b * h > 0 and n > 0:
        maps = None
        if qs.dtype == torch.bfloat16 and d <= TMA_MAX_HEAD_DIM:
            maps = packed_heads_maps(tuple(q4.shape), *(
                t.stride() for t in (q4, k4, v4, out)))
        launch("flash_attention", kernel_library().tfimm_flash_attention_fwd,
               q4, k4, v4, out, lse, _strides(q4, k4, v4, out), maps, b * h,
               h, n, d, DTYPE_CODES[qs.dtype])
    return out.reshape(*lead, n, d), lse.reshape(*lead, n)


def flash_attention_bwd(qs, k, v, out, lse, do):
    """(dqs, dk, dv), as ``flash_attention_bwd_reference``. Runs the plain
    version when every input lies on the CPU and the backward kernel
    otherwise: two launches (dqs over query blocks; dk, dv over key
    blocks), counted as one. The bf16 kernels up to d = 128 form delta
    themselves (from o and do, into an f32 scratch padded to whole 64-row
    boxes); the others take it from a PyTorch reduction here."""
    if _on_cpu(qs, k, v, out, lse, do):
        return flash_attention_bwd_reference(qs, k, v, out, lse, do)
    name = "flash_attention_bwd"
    _check_kernel_inputs(name, qs, k, v, out, do)
    if lse.shape != qs.shape[:-1] or lse.dtype != torch.float32 \
            or lse.device != qs.device:
        raise ValueError(f"{name}: lse must be f32 {tuple(qs.shape[:-1])} on "
                         f"{qs.device}; got {lse.dtype} {tuple(lse.shape)} "
                         f"on {lse.device}")
    from tfimm_tpu_torch.ops.kernels.build import kernel_library

    lead, (n, d) = qs.shape[:-2], qs.shape[-2:]
    q4, k4, v4, do4, o4 = (_readable(_rows(t)) for t in (qs, k, v, do, out))
    grads = [torch.empty_like(q4) for _ in range(3)]
    b, h = q4.shape[:2]
    if b * h > 0 and n > 0:
        maps = stats = delta = None
        if qs.dtype == torch.bfloat16 and d <= TMA_MAX_HEAD_DIM:
            maps = packed_heads_maps(tuple(q4.shape), *(
                t.stride() for t in (q4, k4, v4, do4, o4, *grads)))
            stats = stats_scratch(b * h, n, qs.device)
        else:
            delta = (do4.float() * o4.float()).sum(dim=-1).contiguous()
        launch(name, kernel_library().tfimm_flash_attention_bwd, q4, k4, v4,
               do4, o4, lse.contiguous(), delta, *grads,
               _strides(q4, k4, v4, do4, *grads), maps, stats, b * h, h, n, d,
               DTYPE_CODES[qs.dtype])
    return tuple(g.reshape(*lead, n, d) for g in grads)


class _FlashAttention(torch.autograd.Function):
    """The attention from the scaled q, with ``flash_attention_bwd`` as its
    backward (the custom VJP ``_flash3`` of the JAX package). Saves qs, k,
    v, the output and the lse; the lse is a second output without a
    gradient."""

    @staticmethod
    def forward(ctx, qs, k, v):
        out, lse = _forward(qs, k, v)
        ctx.save_for_backward(qs, k, v, out, lse)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    @once_differentiable
    def backward(ctx, do, _dlse):
        return flash_attention_bwd(*ctx.saved_tensors, do)


def flash_attention_with_lse(q, k, v, *, scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out (..., N, d) in q's dtype, lse (..., N) in f32). Runs the plain
    version when every input lies on the CPU and the kernel otherwise;
    under autograd the output's gradient runs the backward kernel (its
    plain version on the CPU). ``scale`` defaults to d ** -0.5."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    qs = scale_query(q, scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(qs, k, v)
    return _forward(qs, k, v)


def flash_attention(q, k, v, *, scale: Optional[float] = None) -> torch.Tensor:
    """Self-attention over (..., N, d) tensors of one shape; returns
    (..., N, d) in q's dtype, differentiable with respect to q, k and v."""
    return flash_attention_with_lse(q, k, v, scale=scale)[0]


def flash_attention_packed(qkv: torch.Tensor, nb_heads: int,
                           scale: float) -> torch.Tensor:
    """qkv: (B, N, 3 * H * d), last dim in timm's (3, H, d) order. Returns
    (B, N, H * d): q, k and v go to the kernels as strided views of qkv and
    o comes back in the layout of the scaled q, (B, N, H, d)."""
    b, n, three_d = qkv.shape
    d = three_d // 3 // nb_heads
    parts = qkv.reshape(b, n, 3, nb_heads, d).permute(2, 0, 3, 1, 4)
    q, k, v = parts.unbind(0)
    out = flash_attention(q, k, v, scale=scale)
    return out.transpose(1, 2).reshape(b, n, nb_heads * d)


def flash_attention_or_none(q, k, v, bias=None,
                            scale: Optional[float] = None
                            ) -> Optional[torch.Tensor]:
    """Run ``flash_attention`` when the JAX dispatcher would take its kernel
    and the port's kernels take the input, else return None: no bias, q, k
    and v of one shape, N >= 1024, and a head dim and dtype the kernels
    take. The TPU's VMEM gate is not carried over."""
    if bias is not None or k.shape != q.shape or v.shape != q.shape:
        return None
    n, d = q.shape[-2:]
    if n < FLASH_MIN_TOKENS or not flash_attention_supports(d, q.dtype) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        return None
    log_dispatch("flash_attention")
    return flash_attention(q, k, v, scale=scale)
