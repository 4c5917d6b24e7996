"""Fused ConvNeXt LayerNorm + MLP + layer scale + residual.

Counterpart of ``tfimm_tpu/ops/pallas/convnext_mlp.py · convnext_mlp``.
On tokens flattened to rows, x and shortcut (M, C), it returns

    shortcut + gamma * fc2(gelu(fc1(LN(x))))

in x's dtype, with the JAX kernel's roundings: LN in f32 with the one-pass
variance, z and h rounded to the dtype, both products summed in f32, the
GELU of the kernel's dtype policy (tanh form in bf16/f16, exact erf in f32,
whatever ``TFIMM_TPU_EXACT_GELU`` says), the epilogue in f32 and one
rounding at the end. ``w1`` (H, C) and ``w2`` (C, H) are in the port's
Dense layout.

On a CUDA tensor ``convnext_mlp`` launches the hand-written kernel of
``tfimm_tpu_torch/csrc/convnext_mlp.cu`` (see the note at its top for the
design and what bounds it) and raises on what it does not take; on CPU
tensors it runs ``convnext_mlp_reference``. The kernel takes bf16 and f32
and any M, C and H. In bf16 its two products run the TMA + wgmma body
where ``tma.gemm_route`` takes every operand (C and H multiples of 8,
16-byte aligned bases, C up to 4096), else the mma.sync body. It has no backward: the ConvNeXt block calls it only
where autograd is not recording, as the JAX package runs its XLA twin under
differentiation.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tfimm_tpu_torch.ops.kernels.dispatch import launch
from tfimm_tpu_torch.ops.kernels.tma import (
    gemm_route,
    packed_gemm_maps,
    sm_count,
)

__all__ = ["convnext_mlp", "convnext_mlp_reference"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def convnext_mlp_reference(x, shortcut, ln_weight, ln_bias, w1, b1, w2, b2,
                           gamma, eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch twin of the kernel (``_reference_mlp`` in the JAX
    package)."""
    dt = x.dtype
    acc = torch.promote_types(dt, torch.float32)
    xf = x.to(acc)
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp(xf.square().mean(dim=-1, keepdim=True) - mean.square(),
                      min=0.0)
    z = ((xf - mean) * torch.rsqrt(var + eps) * ln_weight.to(acc)
         + ln_bias.to(acc)).to(dt)
    s = torch.matmul(z.to(acc), w1.to(dt).to(acc).t()) + b1.to(acc)
    approximate = "tanh" if dt in (torch.bfloat16, torch.float16) else "none"
    h = F.gelu(s, approximate=approximate).to(dt)
    o = torch.matmul(h.to(acc), w2.to(dt).to(acc).t()) + b2.to(acc)
    return (shortcut.to(acc) + gamma.to(acc) * o).to(dt)


def _check_kernel_inputs(x, shortcut, ln_weight, ln_bias, w1, b1, w2, b2,
                         gamma):
    """Raise on inputs the kernel does not take."""
    tensors = (x, shortcut, ln_weight, ln_bias, w1, b1, w2, b2, gamma)
    devices = {t.device for t in tensors}
    if len(devices) > 1 or x.device.type != "cuda":
        raise ValueError(f"convnext_mlp: all inputs must lie on one CUDA "
                         f"device; got {sorted(map(str, devices))}")
    if x.dtype not in _DTYPE_CODES or shortcut.dtype != x.dtype:
        raise ValueError(f"convnext_mlp: x and shortcut must both be bf16 or "
                         f"f32; got {x.dtype} and {shortcut.dtype}")
    if x.dim() != 2 or shortcut.shape != x.shape:
        raise ValueError(f"convnext_mlp: x and shortcut must be one (M, C) "
                         f"shape; got {tuple(x.shape)}, {tuple(shortcut.shape)}")
    m, c = x.shape
    hidden = w1.shape[0]
    shapes = {"w1": (w1.shape, (hidden, c)), "w2": (w2.shape, (c, hidden)),
              "b1": (b1.shape, (hidden,)), "b2": (b2.shape, (c,)),
              "ln_weight": (ln_weight.shape, (c,)),
              "ln_bias": (ln_bias.shape, (c,)), "gamma": (gamma.shape, (c,))}
    for name, (got, want) in shapes.items():
        if tuple(got) != want:
            raise ValueError(f"convnext_mlp: {name} must be {want}; got "
                             f"{tuple(got)}")
    if not (x.is_contiguous() and shortcut.is_contiguous()):
        raise ValueError("convnext_mlp: x and shortcut must be contiguous")


def convnext_mlp(x, shortcut, ln_weight, ln_bias, w1, b1, w2, b2, gamma,
                 eps: float = 1e-6) -> torch.Tensor:
    """x, shortcut (M, C); ln_weight, ln_bias, b2, gamma (C,); w1 (H, C);
    b1 (H,); w2 (C, H). Returns (M, C) in x's dtype. Runs the plain version
    when every input lies on the CPU and the kernel otherwise."""
    tensors = (x, shortcut, ln_weight, ln_bias, w1, b1, w2, b2, gamma)
    if all(t.device.type == "cpu" for t in tensors):
        return convnext_mlp_reference(*tensors, eps)
    _check_kernel_inputs(*tensors)
    from tfimm_tpu_torch.ops.kernels.build import kernel_library

    dt = x.dtype
    m, c = x.shape
    hidden = w1.shape[0]
    out = torch.empty_like(x)
    if m == 0:
        return out
    # The kernel reads the weights in the dtype and the vectors in f32;
    # for a model cast to the dtype the weights pass through unchanged.
    w1, w2 = w1.to(dt).contiguous(), w2.to(dt).contiguous()
    vecs = [v.float().contiguous() for v in (ln_weight, ln_bias, b1, b2, gamma)]
    h = torch.empty((m, hidden), dtype=dt, device=x.device)
    mean = torch.empty((m,), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    maps = None
    if gemm_route(x, shortcut, w1, w2, h, out, ln_depth=c):
        sms = sm_count(x.device.index)
        maps = packed_gemm_maps((m, hidden, c, True, False, sms),
                                (m, c, hidden, False, True, sms))
    launch("convnext_mlp", kernel_library().tfimm_convnext_mlp, x, shortcut,
           vecs[0], vecs[1], w1, vecs[2], w2, vecs[3], vecs[4], h, mean, rstd,
           out, m, c, hidden, float(eps), _DTYPE_CODES[dt], maps)
    return out
