"""Windowed multi-head attention with the relative-position bias (Swin).

Counterpart of ``tfimm_tpu/ops/pallas/window_mha.py · window_mha`` and its
custom VJP ``window_mha_diff``. q, k, v (BW, N, C) with BW = batch *
nb_windows (the window index inner), bias (H, N, N), mask (nW, N, N) or
None. Per window and head:

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
takes bf16 and f32, N up to 144 and d a multiple of 8 up to 128. Calls that
``tma.window_route`` takes (bf16, N <= 64, d <= 64, 16-byte aligned
operands: every registered Swin at window 7) run the TMA + wgmma bodies of
both kernels, with the tensor maps of ``tma.packed_window_maps`` and
``tma.packed_window_bwd_maps``; the others run the first bodies.

The backward, ``window_mha_bwd``, gives dqkv in the packed (BW, N, 3C)
layout and dbias (H, N, N) in f32, summed over the windows; the mask gets
no gradient. On a CUDA tensor it launches the kernel of
``tfimm_tpu_torch/csrc/window_mha_bwd.cu``, on CPU tensors it runs
``window_mha_bwd_reference``. ``window_mha_packed`` takes the packed qkv and
goes through the ``torch.autograd.Function`` ``_WindowMHA`` where autograd
records, so that a Swin block trains through both kernels.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from tfimm_tpu_torch.ops.kernels.dispatch import (
    launch,
    softmax_clamp_grad_mask,
    softmax_nomax,
)
from tfimm_tpu_torch.ops.kernels.tma import (
    packed_window_bwd_maps,
    packed_window_maps,
    sm_count,
    window_group,
    window_route,
)

__all__ = ["window_mha", "window_mha_reference", "window_mha_supports",
           "window_mha_bwd", "window_mha_bwd_reference", "window_mha_packed"]

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_TOKENS = 144          # window 12
MAX_HEAD_DIM = 128
# The backward's first bodies run one block per (group of windows, head)
# and sum each group's bias gradient in the block; the group size is chosen
# so that about this many blocks run (the Hopper body's by
# ``tma.window_group``).
BWD_BLOCKS = 1024


def _heads(t: torch.Tensor, nb_heads: int, dtype: torch.dtype):
    """(BW, N, H * d) -> (BW, H, N, d) in ``dtype``."""
    bw, n, c = t.shape
    return t.reshape(bw, n, nb_heads, c // nb_heads).transpose(1, 2).to(dtype)


def _merge_heads(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(BW, H, N, d) -> (BW, N, H * d) in ``dtype``."""
    bw, h, n, d = t.shape
    return t.transpose(1, 2).reshape(bw, n, h * d).to(dtype)


def _scores(qh, kh, bias, mask, scale: float) -> torch.Tensor:
    """s = (q * scale) @ k^T + bias (+ mask[r % nW]) over (BW, H, N, N), in
    qh's dtype."""
    bw, h, n, _ = qh.shape
    s = torch.matmul(qh * scale, kh.transpose(-1, -2)) + bias.to(qh.dtype)[None]
    if mask is not None:
        nb_win = mask.shape[0]
        # Row r of the (BW, ...) layout is window r % nb_win.
        s = (s.reshape(bw // nb_win, nb_win, h, n, n)
             + mask.to(qh.dtype)[None, :, None]).reshape(bw, h, n, n)
    return s


def window_mha_reference(q, k, v, bias, mask=None, *, nb_heads: int,
                         scale: float) -> torch.Tensor:
    """Plain PyTorch twin of the kernel."""
    dt = q.dtype
    acc = torch.promote_types(dt, torch.float32)
    qh, kh, vh = (_heads(t, nb_heads, acc) for t in (q, k, v))
    p = softmax_nomax(_scores(qh, kh, bias, mask, scale)).to(dt).to(acc)
    return _merge_heads(torch.matmul(p, vh), dt)


def window_mha_bwd_reference(q, k, v, bias, mask, g, *, nb_heads: int,
                             scale: float):
    """Plain PyTorch twin of the backward kernel (``_group_attention_bwd`` in
    the JAX package), in f32: the softmax recomputed, the clamp mask on the
    score cotangent. g = dL/dout (BW, N, C). Returns dq, dk, dv (BW, N, C) in
    q's dtype, each rounded once, and dbias (H, N, N) summed over the
    windows in f32 (f64 for f64 inputs)."""
    dt = q.dtype
    acc = torch.promote_types(dt, torch.float32)
    qh, kh, vh, gh = (_heads(t, nb_heads, acc) for t in (q, k, v, g))
    s = _scores(qh, kh, bias, mask, scale)
    p = softmax_nomax(s)
    dv = torch.matmul(p.transpose(-1, -2), gh)
    dp = torch.matmul(gh, vh.transpose(-1, -2))
    ds = softmax_clamp_grad_mask(
        s, p * (dp - (dp * p).sum(dim=-1, keepdim=True)))
    dq = scale * torch.matmul(ds, kh)
    dk = scale * torch.matmul(ds.transpose(-1, -2), qh)
    return (_merge_heads(dq, dt), _merge_heads(dk, dt), _merge_heads(dv, dt),
            ds.sum(dim=0))


def window_mha_supports(n: int, c: int, nb_heads: int) -> bool:
    """Whether the kernels take windows of ``n`` tokens, ``c`` channels and
    ``nb_heads`` heads."""
    if c % nb_heads:
        return False
    d = c // nb_heads
    return n <= MAX_TOKENS and d % 8 == 0 and d <= MAX_HEAD_DIM


def _check_kernel_inputs(q, k, v, bias, mask, nb_heads, name="window_mha"):
    """Raise on inputs the kernel does not take."""
    tensors = [t for t in (q, k, v, bias, mask) if t is not None]
    devices = {t.device for t in tensors}
    if len(devices) > 1 or q.device.type != "cuda":
        raise ValueError(f"{name}: all inputs must lie on one CUDA "
                         f"device; got {sorted(map(str, devices))}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q, k, v must all be bf16 or f32; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q, k, v must be one (BW, N, C) shape; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    bw, n, c = q.shape
    if not window_mha_supports(n, c, nb_heads):
        raise ValueError(f"{name}: the kernel takes N <= {MAX_TOKENS} and "
                         f"a head dim that is a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}; got N={n}, C={c}, H={nb_heads}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError(f"{name}: the last dimension of q, k, v must be "
                         "contiguous")
    if tuple(bias.shape) != (nb_heads, n, n):
        raise ValueError(f"{name}: bias must be {(nb_heads, n, n)}; got "
                         f"{tuple(bias.shape)}")
    if mask is not None and (mask.dim() != 3 or tuple(mask.shape[1:]) != (n, n)
                             or bw % mask.shape[0]):
        raise ValueError(f"{name}: mask must be (nW, {n}, {n}) with nW "
                         f"dividing BW={bw}; got {tuple(mask.shape)}")


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors if t is not None)


def _split(qkv: torch.Tensor):
    c = qkv.shape[-1] // 3
    return qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]


def window_mha(q, k, v, bias, mask: Optional[torch.Tensor] = None, *,
               nb_heads: int, scale: float) -> torch.Tensor:
    """q, k, v (BW, N, C); bias (H, N, N); mask (nW, N, N) or None. Returns
    (BW, N, C) in q's dtype. Runs the plain version when every input lies on
    the CPU and the kernel otherwise."""
    if _on_cpu(q, k, v, bias, mask):
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
    d = c // nb_heads
    maps = None
    if window_route(n, d, q, k, v):
        maps = packed_window_maps(bw, n, nb_heads, d, q.stride()[:2],
                                  k.stride()[:2], v.stride()[:2],
                                  sm_count(q.device.index))
    launch("window_mha", kernel_library().tfimm_window_mha, q, k, v,
           q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
           v.stride(1), bias, mask, out, bw, n, nb_heads, d, nb_win,
           float(scale), DTYPE_CODES[q.dtype], maps)
    return out


def window_mha_bwd(qkv, g, bias, mask: Optional[torch.Tensor] = None, *,
                   nb_heads: int, scale: float):
    """dL/dqkv (BW, N, 3C) in qkv's dtype and packed layout, and dL/dbias
    (H, N, N) in f32, of ``window_mha`` on the three slices of ``qkv``, from
    g = dL/dout (BW, N, C). Runs ``window_mha_bwd_reference`` when every
    input lies on the CPU and the kernel otherwise, where it raises on what
    the kernel does not take."""
    if _on_cpu(qkv, g, bias, mask):
        dq, dk, dv, dbias = window_mha_bwd_reference(
            *_split(qkv), bias, mask, g, nb_heads=nb_heads, scale=scale)
        return torch.cat([dq, dk, dv], dim=-1), dbias
    _check_kernel_inputs(*_split(qkv), bias, mask, nb_heads, "window_mha_bwd")
    bw, n, three_c = qkv.shape
    c = three_c // 3
    if (g.shape != (bw, n, c) or g.dtype != qkv.dtype or g.device != qkv.device
            or not g.is_contiguous()):
        raise ValueError(f"window_mha_bwd: g must be a contiguous "
                         f"{(bw, n, c)} {qkv.dtype} tensor on {qkv.device}; "
                         f"got {tuple(g.shape)} {g.dtype} on {g.device}")
    from tfimm_tpu_torch.ops.kernels.build import kernel_library

    dqkv = torch.empty((bw, n, three_c), dtype=qkv.dtype, device=qkv.device)
    dbias = torch.empty((nb_heads, n, n), dtype=torch.float32,
                        device=qkv.device)
    if bw == 0:
        return dqkv, dbias.zero_()
    d = c // nb_heads
    maps = None
    if window_route(n, d, qkv, g):
        group = window_group(bw, nb_heads, sm_count(qkv.device.index))
        maps = packed_window_bwd_maps(bw, n, nb_heads, d, qkv.stride()[:2])
    else:
        group = max(1, -(-bw * nb_heads // BWD_BLOCKS))   # windows per block
    partial = torch.empty((-(-bw // group), nb_heads, n, n),
                          dtype=torch.float32, device=qkv.device)
    bias = bias.float().contiguous()
    nb_win = 1
    if mask is not None:
        mask = mask.float().contiguous()
        nb_win = mask.shape[0]
    launch("window_mha_bwd", kernel_library().tfimm_window_mha_bwd, qkv,
           qkv.stride(0), qkv.stride(1), g, bias, mask, dqkv, partial, dbias,
           bw, n, nb_heads, d, nb_win, group, float(scale),
           DTYPE_CODES[qkv.dtype], maps)
    return dqkv, dbias


class _WindowMHA(torch.autograd.Function):
    """window_mha on the packed qkv with ``window_mha_bwd`` as its backward
    (the custom VJP of ``window_mha_diff`` in the JAX package). Saves only
    qkv, the bias and the mask: the backward recomputes the softmax. The
    bias gradient comes back in the bias's dtype; the mask gets none."""

    @staticmethod
    def forward(ctx, qkv, bias, mask, nb_heads, scale):
        ctx.save_for_backward(qkv, bias, mask)
        ctx.nb_heads, ctx.scale = nb_heads, scale
        return window_mha(*_split(qkv), bias, mask, nb_heads=nb_heads,
                          scale=scale)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        qkv, bias, mask = ctx.saved_tensors
        dqkv, dbias = window_mha_bwd(qkv, g.contiguous(), bias, mask,
                                     nb_heads=ctx.nb_heads, scale=ctx.scale)
        return dqkv, dbias.to(bias.dtype), None, None, None


def window_mha_packed(qkv, bias, mask: Optional[torch.Tensor] = None, *,
                      nb_heads: int, scale: float) -> torch.Tensor:
    """``window_mha`` on the three slices of a packed qkv (BW, N, 3C),
    differentiable with respect to qkv and the bias."""
    if torch.is_grad_enabled() and (qkv.requires_grad or bias.requires_grad):
        return _WindowMHA.apply(qkv, bias, mask, nb_heads, scale)
    return window_mha(*_split(qkv), bias, mask, nb_heads=nb_heads,
                      scale=scale)
