"""The whole PoolFormer block at inference.

Counterpart of ``tfimm_tpu/ops/pallas/poolformer_block.py ·
poolformer_block_or_none``. On x (B, H, W, C), per image, with the Pallas
kernel's roundings:

    y   = GN1(x)                       GroupNorm with one group over the
                                       whole (H, W, C) map: f32, two-pass
                                       variance mean((x - mean)^2), eps
    x1  = x + ls1 * (pool3x3(y) - y)   SAME 3x3 average of the normalised
                                       map over its in-bounds taps; f32
    z   = GN2(x1)                      f32, rounded to the dtype
    h   = gelu(z @ w1^T + b1)          summed in f32, GELU in the tanh form
                                       in every dtype, rounded to the dtype
    out = x1 + ls2 * (h @ w2^T + b2)   in f32, rounded once

x1 stays in f32, and the GELU is ``jax.nn.gelu``'s default tanh form
whatever ``TFIMM_TPU_EXACT_GELU`` says, as in the Pallas kernel; the
block's eager path rounds x1 to the dtype and takes the port's GELU policy.
w1 (4C, C) and w2 (C, 4C) are in the port's Dense layout (the 1x1 convs'
weights without their 1x1 axes).

On a CUDA tensor ``poolformer_block`` launches the hand-written kernels of
``tfimm_tpu_torch/csrc/poolformer_block.cu`` (see the note at its top for
the design and what bounds it), counted as one launch, and raises on what
they do not take; on CPU tensors it runs ``poolformer_block_reference``.
The kernels take bf16 and f32 and any B, H, W, C and hidden width. In bf16
the two products run ``csrc/mlp_gemm.cuh``'s TMA + wgmma body where
``tma.gemm_route`` takes x1, w1, w2, h and the output (C and hidden
multiples of 8, 16-byte aligned: every registered PoolFormer), with the
GELU as s / (1 + e^(-2u)), else the mma.sync body. They have no backward,
as the Pallas kernel has none: on a CUDA tensor that autograd would need a
gradient for, the wrapper raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tfimm_tpu_torch.ops.kernels.dispatch import launch
from tfimm_tpu_torch.ops.kernels.tma import (
    F32_BYTES,
    GemmProduct,
    gemm_route,
    packed_gemm_maps,
    sm_count,
)
from tfimm_tpu_torch.ops.pool import avg_pool_2d_exclude_pad

__all__ = ["poolformer_block", "poolformer_block_reference",
           "poolformer_gemm_products"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _group_norm1(x: torch.Tensor, weight, bias, eps: float) -> torch.Tensor:
    """GroupNorm with one group per image, two-pass variance, in x's f32."""
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(1, 2, 3), keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * weight + bias


def poolformer_block_reference(x, n1_weight, n1_bias, ls1, n2_weight,
                               n2_bias, w1, b1, w2, b2, ls2,
                               eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch twin of the kernels (the body of the Pallas kernel)."""
    dt = x.dtype
    acc = torch.promote_types(dt, torch.float32)
    xf = x.to(acc)
    y = _group_norm1(xf, n1_weight.to(acc), n1_bias.to(acc), eps)
    x1 = xf + (avg_pool_2d_exclude_pad(y, 3) - y) * ls1.to(acc)
    z = _group_norm1(x1, n2_weight.to(acc), n2_bias.to(acc), eps).to(dt)
    h = torch.matmul(z.to(acc), w1.to(dt).to(acc).t()) + b1.to(acc)
    h = F.gelu(h, approximate="tanh").to(dt)
    o = torch.matmul(h.to(acc), w2.to(dt).to(acc).t()) + b2.to(acc)
    return (x1 + o * ls2.to(acc)).to(dt)


def poolformer_gemm_products(m: int, c: int, hidden: int, sms: int):
    """The bf16 block's two products on ``sms`` SMs, as
    ``tma.packed_gemm_maps`` takes them: fc1 (the GN2 prologue on the f32
    x1) and fc2 (x1 the f32 shortcut)."""
    return (GemmProduct(m, hidden, c, True, False, sms, a_bytes=F32_BYTES),
            GemmProduct(m, c, hidden, False, True, sms, sc_bytes=F32_BYTES))


def _check_kernel_inputs(x, vectors, w1, w2):
    """Raise on inputs the kernels do not take. ``vectors``: name -> (C,)
    or (hidden,) tensor."""
    tensors = (x, *vectors.values(), w1, w2)
    devices = {t.device for t in tensors}
    if len(devices) > 1 or x.device.type != "cuda":
        raise ValueError(f"poolformer_block: all inputs must lie on one CUDA "
                         f"device; got {sorted(map(str, devices))}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "poolformer_block: the kernels have no backward (nor has the "
            "Pallas kernel); run the eager block where autograd records")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"poolformer_block: x must be bf16 or f32; got "
                         f"{x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"poolformer_block: x must be a contiguous (B, H, W, "
                         f"C) map; got {tuple(x.shape)}")
    c = x.shape[-1]
    hidden = w1.shape[0]
    shapes = {"w1": (w1, (hidden, c)), "w2": (w2, (c, hidden))}
    shapes.update({name: (v, (hidden,) if name == "b1" else (c,))
                   for name, v in vectors.items()})
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"poolformer_block: {name} must be {want}; got "
                             f"{tuple(t.shape)}")


def poolformer_block(x, n1_weight, n1_bias, ls1, n2_weight, n2_bias, w1, b1,
                     w2, b2, ls2, eps: float = 1e-5) -> torch.Tensor:
    """x (B, H, W, C); the norms' weights and biases, ls1, ls2, b2 (C,);
    w1 (4C, C), b1 (4C,), w2 (C, 4C). Returns (B, H, W, C) in x's dtype.
    Runs the plain version when every input lies on the CPU and the kernels
    otherwise."""
    args = (x, n1_weight, n1_bias, ls1, n2_weight, n2_bias, w1, b1, w2, b2,
            ls2)
    if all(t.device.type == "cpu" for t in args):
        return poolformer_block_reference(*args, eps)
    vectors = {"n1_weight": n1_weight, "n1_bias": n1_bias, "ls1": ls1,
               "n2_weight": n2_weight, "n2_bias": n2_bias, "b1": b1, "b2": b2,
               "ls2": ls2}   # the order of the C entry point
    _check_kernel_inputs(x, vectors, w1, w2)
    from tfimm_tpu_torch.ops.kernels.build import kernel_library

    dt = x.dtype
    b, h, w, c = x.shape
    hidden = w1.shape[0]
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    # The kernels read the weights in the dtype and the vectors in f32; for
    # a model cast to the dtype the weights pass through unchanged.
    w1, w2 = w1.to(dt).contiguous(), w2.to(dt).contiguous()
    vecs = [v.float().contiguous() for v in vectors.values()]
    dev = x.device
    x1 = torch.empty(x.shape, dtype=torch.float32, device=dev)
    hid = torch.empty((b * h * w, hidden), dtype=dt, device=dev)
    # The norms' mean and rstd, then the pool launch's partial sums of x1
    # (a block of 256 threads takes at least one channel a thread).
    stats = torch.empty((4 + -(-h * w * c // 256), b), dtype=torch.float32,
                        device=dev)
    m = b * h * w
    maps = None
    if gemm_route(w1, w2, hid, out.view(m, c), ln_depth=c,
                  f32=(x1.view(m, c),)):
        maps = packed_gemm_maps(*poolformer_gemm_products(
            m, c, hidden, sm_count(dev.index)))
    launch("poolformer_block", kernel_library().tfimm_poolformer_block, x,
           *vecs, w1, w2, x1, hid, stats, out, b, h, w, c, hidden, float(eps),
           _DTYPE_CODES[dt], maps)
    return out
