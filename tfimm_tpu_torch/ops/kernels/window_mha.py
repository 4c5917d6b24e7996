"""Windowed multi-head attention with the relative-position bias (Swin).

Counterpart of ``tfimm_tpu/ops/pallas/window_mha.py · window_mha``. q, k, v
(BW, N, C) with BW = batch * nb_windows (the window index inner), bias
(H, N, N), mask (nW, N, N) or None. Per window and head:

    s = (q_f32 * scale) @ k_f32^T + bias (+ mask[r % nW])     (f32)
    p = exp(min(s, 80)) / rowsum                   (clamped no-max softmax)
    o = p.astype(dtype) @ v, summed in f32, rounded once

which are the roundings of the Pallas kernel (its XLA twin
``_reference_window_mha`` keeps p in f32). The result is (BW, N, C) in q's
dtype, the heads concatenated.

On a CUDA tensor ``window_mha`` launches the hand-written kernel of
``tfimm_tpu_torch/csrc/window_mha.cu`` (see the note at its top for the
design and what bounds it) and raises on what it does not take; on CPU
tensors it runs ``window_mha_reference``. The kernel reads q, k and v
through their strides, so three slices of a packed qkv need no copy. It
takes bf16 and f32, N up to 144 and d a multiple of 8 up to 128. It has no
backward: Swin calls it only where autograd is not recording.
"""

from __future__ import annotations

from typing import Optional

import torch

from tfimm_tpu_torch.ops.kernels.dispatch import launch, softmax_nomax

__all__ = ["window_mha", "window_mha_reference", "window_mha_supports"]

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_TOKENS = 144          # window 12
MAX_HEAD_DIM = 128


def window_mha_reference(q, k, v, bias, mask=None, *, nb_heads: int,
                         scale: float) -> torch.Tensor:
    """Plain PyTorch twin of the kernel."""
    bw, n, c = q.shape
    d = c // nb_heads
    dt = q.dtype
    acc = torch.promote_types(dt, torch.float32)
    qh, kh, vh = (t.reshape(bw, n, nb_heads, d).transpose(1, 2).to(acc)
                  for t in (q, k, v))
    s = torch.matmul(qh * scale, kh.transpose(-1, -2)) + bias.to(acc)[None]
    if mask is not None:
        nb_win = mask.shape[0]
        # Row r of the (BW, ...) layout is window r % nb_win.
        s = (s.reshape(bw // nb_win, nb_win, nb_heads, n, n)
             + mask.to(acc)[None, :, None]).reshape(bw, nb_heads, n, n)
    p = softmax_nomax(s).to(dt).to(acc)
    o = torch.matmul(p, vh)
    return o.transpose(1, 2).reshape(bw, n, c).to(dt)


def window_mha_supports(n: int, c: int, nb_heads: int) -> bool:
    """Whether the kernel takes windows of ``n`` tokens, ``c`` channels and
    ``nb_heads`` heads."""
    if c % nb_heads:
        return False
    d = c // nb_heads
    return n <= MAX_TOKENS and d % 8 == 0 and d <= MAX_HEAD_DIM


def _check_kernel_inputs(q, k, v, bias, mask, nb_heads):
    """Raise on inputs the kernel does not take."""
    tensors = [t for t in (q, k, v, bias, mask) if t is not None]
    devices = {t.device for t in tensors}
    if len(devices) > 1 or q.device.type != "cuda":
        raise ValueError(f"window_mha: all inputs must lie on one CUDA "
                         f"device; got {sorted(map(str, devices))}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"window_mha: q, k, v must all be bf16 or f32; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"window_mha: q, k, v must be one (BW, N, C) shape; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    bw, n, c = q.shape
    if not window_mha_supports(n, c, nb_heads):
        raise ValueError(f"window_mha: the kernel takes N <= {MAX_TOKENS} and "
                         f"a head dim that is a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}; got N={n}, C={c}, H={nb_heads}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("window_mha: the last dimension of q, k, v must be "
                         "contiguous")
    if tuple(bias.shape) != (nb_heads, n, n):
        raise ValueError(f"window_mha: bias must be {(nb_heads, n, n)}; got "
                         f"{tuple(bias.shape)}")
    if mask is not None and (mask.dim() != 3 or tuple(mask.shape[1:]) != (n, n)
                             or bw % mask.shape[0]):
        raise ValueError(f"window_mha: mask must be (nW, {n}, {n}) with nW "
                         f"dividing BW={bw}; got {tuple(mask.shape)}")


def window_mha(q, k, v, bias, mask: Optional[torch.Tensor] = None, *,
               nb_heads: int, scale: float) -> torch.Tensor:
    """q, k, v (BW, N, C); bias (H, N, N); mask (nW, N, N) or None. Returns
    (BW, N, C) in q's dtype. Runs the plain version when every input lies on
    the CPU and the kernel otherwise."""
    tensors = [t for t in (q, k, v, bias, mask) if t is not None]
    if all(t.device.type == "cpu" for t in tensors):
        return window_mha_reference(q, k, v, bias, mask, nb_heads=nb_heads,
                                    scale=scale)
    _check_kernel_inputs(q, k, v, bias, mask, nb_heads)
    from tfimm_tpu_torch.ops.kernels.build import kernel_library

    bw, n, c = q.shape
    out = torch.empty((bw, n, c), dtype=q.dtype, device=q.device)
    if bw == 0:
        return out
    bias = bias.float().contiguous()
    nb_win = 1
    if mask is not None:
        mask = mask.float().contiguous()
        nb_win = mask.shape[0]
    launch("window_mha", kernel_library().tfimm_window_mha, q, k, v,
           q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
           v.stride(1), bias, mask, out, bw, n, nb_heads, c // nb_heads,
           nb_win, float(scale), DTYPE_CODES[q.dtype])
    return out
