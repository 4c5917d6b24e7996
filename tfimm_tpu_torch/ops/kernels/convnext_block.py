"""The whole ConvNeXt block at inference.

Counterpart of ``tfimm_tpu/ops/pallas/convnext_block.py ·
fused_convnext_block``. On the NHWC map x (B, H, W, C), with the Pallas
kernel's roundings:

    d   = dw7x7(x) + dw_b          depthwise 7x7 conv, zero padding 3, the
                                   products, sums and bias in f32
    z   = LN(d)                    f32 statistics of the unrounded d (one-pass
                                   variance), the affine in f32, rounded
                                   once to the dtype
    h   = gelu(z @ w1^T + b1)      summed in f32, the tanh GELU in f32 in
                                   every dtype, rounded to the dtype
    out = x + gamma * (h @ w2^T + b2)   in f32, rounded once

This is not the function of ConvNeXt's default path (the cuDNN depthwise
conv, then ``convnext_mlp``), which rounds d to the dtype before the
LayerNorm and takes the erf GELU in f32. ``dw_weight`` (C, 1, 7, 7), ``w1``
(hidden, C) and ``w2`` (C, hidden) are in the port's layouts.

On a CUDA tensor ``convnext_block`` launches the hand-written kernels of
``tfimm_tpu_torch/csrc/convnext_block.cu`` (see the note at its top for the
design and what bounds it), counted as one launch, and raises on what they
do not take; on CPU tensors it runs ``convnext_block_reference``. The
kernels take bf16 and f32, any B, H, W and hidden width, and C up to
58,112. In bf16, where ``tma.gemm_route`` takes x, z, h, the output and the
weights (C and hidden multiples of 8, 16-byte aligned bases), the products
run the TMA + wgmma body, else the mma.sync body; the depthwise launch
picks its own form from its operands (the note's step 1). They have no
backward, as the Pallas kernel has none: on a CUDA tensor that autograd
would need a gradient for, the wrapper raises.
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

__all__ = ["convnext_block", "convnext_block_reference", "MAX_CHANNELS"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHANNELS = 58112   # one pixel's f32 row in a block's shared memory


def convnext_block_reference(x, dw_weight, dw_bias, ln_weight, ln_bias, w1,
                             b1, w2, b2, gamma,
                             eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch twin of the kernels (the body of the Pallas kernel):
    the 49 taps as shifted products added in the kernel's order."""
    dt = x.dtype
    acc = torch.promote_types(dt, torch.float32)
    b, h, w, c = x.shape
    xf = x.to(acc)
    xp = F.pad(xf, (0, 0, 3, 3, 3, 3))
    taps = dw_weight.to(acc).reshape(c, 49)
    d = torch.zeros_like(xf)
    for i in range(7):
        for j in range(7):
            d = d + xp[:, i:i + h, j:j + w, :] * taps[:, i * 7 + j]
    d = d + dw_bias.to(acc)
    mean = d.mean(dim=-1, keepdim=True)
    var = torch.clamp(d.square().mean(dim=-1, keepdim=True) - mean.square(),
                      min=0.0)
    z = ((d - mean) * torch.rsqrt(var + eps) * ln_weight.to(acc)
         + ln_bias.to(acc)).to(dt)
    s = torch.matmul(z.to(acc), w1.to(dt).to(acc).t()) + b1.to(acc)
    hid = F.gelu(s, approximate="tanh").to(dt)
    o = torch.matmul(hid.to(acc), w2.to(dt).to(acc).t()) + b2.to(acc)
    return (o * gamma.to(acc) + xf).to(dt)


def _check_kernel_inputs(x, dw_weight, vectors, w1, w2):
    """Raise on inputs the kernels do not take. ``vectors``: name -> (C,)
    or (hidden,) tensor."""
    tensors = (x, dw_weight, *vectors.values(), w1, w2)
    devices = {t.device for t in tensors}
    if len(devices) > 1 or x.device.type != "cuda":
        raise ValueError(f"convnext_block: all inputs must lie on one CUDA "
                         f"device; got {sorted(map(str, devices))}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "convnext_block: the kernels have no backward (nor has the "
            "Pallas kernel); run the block per op where autograd records")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"convnext_block: x must be bf16 or f32; got "
                         f"{x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"convnext_block: x must be a contiguous (B, H, W, "
                         f"C) map; got {tuple(x.shape)}")
    c = x.shape[-1]
    if c > MAX_CHANNELS:
        raise ValueError(f"convnext_block: C = {c} is above the kernels' "
                         f"{MAX_CHANNELS} channels")
    hidden = w1.shape[0]
    shapes = {"dw_weight": (dw_weight, (c, 1, 7, 7)), "w1": (w1, (hidden, c)),
              "w2": (w2, (c, hidden))}
    shapes.update({name: (v, (hidden,) if name == "b1" else (c,))
                   for name, v in vectors.items()})
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"convnext_block: {name} must be {want}; got "
                             f"{tuple(t.shape)}")


def convnext_block(x, dw_weight, dw_bias, ln_weight, ln_bias, w1, b1, w2, b2,
                   gamma, eps: float = 1e-6) -> torch.Tensor:
    """x (B, H, W, C); dw_weight (C, 1, 7, 7); dw_bias, ln_weight, ln_bias,
    b2, gamma (C,); w1 (hidden, C), b1 (hidden,), w2 (C, hidden). Returns
    (B, H, W, C) in x's dtype. Runs the plain version when every input lies
    on the CPU and the kernels otherwise."""
    args = (x, dw_weight, dw_bias, ln_weight, ln_bias, w1, b1, w2, b2, gamma)
    if all(t.device.type == "cpu" for t in args):
        return convnext_block_reference(*args, eps)
    vectors = {"dw_bias": dw_bias, "ln_weight": ln_weight, "ln_bias": ln_bias,
               "b1": b1, "b2": b2, "gamma": gamma}   # the C entry point's order
    _check_kernel_inputs(x, dw_weight, vectors, w1, w2)
    from tfimm_tpu_torch.ops.kernels.build import kernel_library

    dt = x.dtype
    b, h, w, c = x.shape
    hidden = w1.shape[0]
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    # The kernels read the taps as an f32 (49, C) table, the vectors in f32
    # and the weights in the dtype; for a model cast to the dtype the
    # weights pass through unchanged.
    taps = dw_weight.reshape(c, 49).t().float().contiguous()
    w1, w2 = w1.to(dt).contiguous(), w2.to(dt).contiguous()
    vecs = [v.float().contiguous() for v in vectors.values()]
    dev = x.device
    m = b * h * w
    z = torch.empty((m, c), dtype=dt, device=dev)
    hid = torch.empty((m, hidden), dtype=dt, device=dev)
    maps = None
    if gemm_route(x.view(m, c), w1, w2, z, hid, out.view(m, c)):
        sms = sm_count(dev.index)
        maps = packed_gemm_maps((m, hidden, c, False, False, sms),
                                (m, c, hidden, False, True, sms))
    launch("convnext_block", kernel_library().tfimm_convnext_block, x, taps,
           *vecs[:3], w1, vecs[3], w2, vecs[4], vecs[5], z, hid, out, b, h, w,
           c, hidden, float(eps), _DTYPE_CODES[dt], maps)
    return out
