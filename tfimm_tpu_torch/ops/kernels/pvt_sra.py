"""Single-head PVT spatial-reduction attention with its q and output
projections.

Counterpart of ``tfimm_tpu/ops/pallas/pvt_sra.py · sra_attention_or_none``.
x (B, N, C) are the normalised tokens, kv (B, S, 2C) the output of the kv
projection of the reduced tokens (k its first C columns, v its last C);
wq, wp (C, C) in the port's Dense layout (out, in), bq, bp (C,) or None.
Per image, with the Pallas kernel's roundings:

    q = ((x @ wq^T + bq) * scale)          in f32, rounded to the dtype
    p = softmax(q @ k^T)                   standard softmax with its max,
                                           f32, rounded to the dtype
    o = p @ v                              summed in f32, rounded
    y = o @ wp^T + bp                      in f32, rounded once

This is not the clamped no-max softmax of the other attention kernels:
``SOFTMAX_CLAMP`` does not apply.

On a CUDA tensor ``pvt_sra`` launches the hand-written kernel of
``tfimm_tpu_torch/csrc/pvt_sra.cu`` (see the note at its top for the design
and what bounds it) and raises on what it does not take; on CPU tensors it
runs ``pvt_sra_reference``. The kernel takes bf16 and f32, every C that is
a multiple of 8 up to 512, S up to 256 and any B and N; bf16 operands that
``tma.py · sra_route`` takes (C a multiple of 16 up to 64, S up to 64,
16-byte aligned: every registered PVT's stage 1) run its TMA + wgmma body,
the rest its first bodies. It has no backward,
as the Pallas kernel has none: on a CUDA tensor that autograd would need a
gradient for, it raises, and the caller's gate keeps training away.
"""

from __future__ import annotations

from typing import Optional

import torch

from tfimm_tpu_torch.ops.kernels.dispatch import launch
from tfimm_tpu_torch.ops.kernels.tma import packed_sra_maps, sm_count, sra_route

__all__ = ["pvt_sra", "pvt_sra_reference"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_DIM = 512
MAX_KEYS = 256


def _bias(b: Optional[torch.Tensor], c: int, like: torch.Tensor) -> torch.Tensor:
    return (torch.zeros(c, dtype=torch.float32, device=like.device)
            if b is None else b)


def pvt_sra_reference(x, k, v, wq, bq, wp, bp, scale: float) -> torch.Tensor:
    """Plain PyTorch twin of the kernel (the body of the Pallas kernel)
    on x (B, N, C), k and v (B, S, C)."""
    dt = x.dtype
    acc = torch.promote_types(dt, torch.float32)
    c = x.shape[-1]
    bq, bp = _bias(bq, c, x).to(acc), _bias(bp, c, x).to(acc)
    q = torch.matmul(x.to(acc), wq.to(dt).to(acc).t()) + bq
    q = (q * scale).to(dt)
    s = torch.matmul(q.to(acc), k.to(dt).to(acc).transpose(-1, -2))
    p = torch.softmax(s, dim=-1).to(dt)
    o = torch.matmul(p.to(acc), v.to(dt).to(acc)).to(dt)
    y = torch.matmul(o.to(acc), wp.to(dt).to(acc).t()) + bp
    return y.to(dt)


def _check_kernel_inputs(x, kv, wq, bq, wp, bp):
    """Raise on inputs the kernel does not take."""
    tensors = [t for t in (x, kv, wq, bq, wp, bp) if t is not None]
    devices = {t.device for t in tensors}
    if len(devices) > 1 or x.device.type != "cuda":
        raise ValueError(f"pvt_sra: all inputs must lie on one CUDA device; "
                         f"got {sorted(map(str, devices))}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "pvt_sra: the kernel has no backward (nor has the Pallas kernel); "
            "run the eager attention where autograd records")
    if x.dtype not in _DTYPE_CODES or kv.dtype != x.dtype:
        raise ValueError(f"pvt_sra: x and kv must both be bf16 or f32; got "
                         f"{x.dtype} and {kv.dtype}")
    if x.dim() != 3 or kv.dim() != 3 or kv.shape[0] != x.shape[0]:
        raise ValueError(f"pvt_sra: x (B, N, C) and kv (B, S, 2C); got "
                         f"{tuple(x.shape)} and {tuple(kv.shape)}")
    b, n, c = x.shape
    s = kv.shape[1]
    if kv.shape[2] != 2 * c:
        raise ValueError(f"pvt_sra: kv must have 2C = {2 * c} columns; got "
                         f"{kv.shape[2]}")
    if c % 8 or c > MAX_DIM:
        raise ValueError(f"pvt_sra: C must be a multiple of 8 up to "
                         f"{MAX_DIM}; got {c}")
    if not 1 <= s <= MAX_KEYS:
        raise ValueError(f"pvt_sra: S must lie in 1..{MAX_KEYS}; got {s}")
    for name, t, want in (("wq", wq, (c, c)), ("wp", wp, (c, c)),
                          ("bq", bq, (c,)), ("bp", bp, (c,))):
        if t is not None and tuple(t.shape) != want:
            raise ValueError(f"pvt_sra: {name} must be {want}; got "
                             f"{tuple(t.shape)}")
    if not x.is_contiguous() or kv.stride(2) != 1:
        raise ValueError("pvt_sra: x must be contiguous and kv's rows dense")


def pvt_sra(x, kv, wq, bq, wp, bp, scale: float) -> torch.Tensor:
    """x (B, N, C); kv (B, S, 2C); wq, wp (C, C); bq, bp (C,) or None.
    Returns (B, N, C) in x's dtype. Runs the plain version when every input
    lies on the CPU and the kernel otherwise."""
    tensors = [t for t in (x, kv, wq, bq, wp, bp) if t is not None]
    c = x.shape[-1]
    if all(t.device.type == "cpu" for t in tensors):
        return pvt_sra_reference(x, kv[..., :c], kv[..., c:], wq, bq, wp, bp,
                                 scale)
    _check_kernel_inputs(x, kv, wq, bq, wp, bp)
    from tfimm_tpu_torch.ops.kernels.build import kernel_library

    dt = x.dtype
    b, n, _ = x.shape
    out = torch.empty_like(x)
    if b * n == 0:
        return out
    # The kernel reads the weights in the dtype and the biases in f32; for
    # a model cast to the dtype the weights pass through unchanged.
    wq, wp = wq.to(dt).contiguous(), wp.to(dt).contiguous()
    bq = _bias(bq, c, x).float().contiguous()
    bp = _bias(bp, c, x).float().contiguous()
    s = kv.shape[1]
    maps = None
    if sra_route(x, kv, wq, wp, out):
        maps = packed_sra_maps(b, n, s, c, (kv.stride(0), kv.stride(1)),
                               sm_count(x.device.index))
    launch("pvt_sra", kernel_library().tfimm_pvt_sra, x, kv, kv.stride(0),
           kv.stride(1), wq, bq, wp, bp, out, b, n, s, c, float(scale),
           _DTYPE_CODES[dt], maps)
    return out
