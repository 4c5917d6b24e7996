"""Flash attention with the decomposed relative-position bias (SAM, MViTv2),
forward and backward.

Counterpart of ``tfimm_tpu/ops/pallas/flash_attention_relpos.py ·
flash_attention_relpos``: its forward (``_relpos_forward_call`` and the
head-paired ``_relpos_forward_call_paired``) and its custom VJP
(``_relpos_backward_call`` and ``_relpos_backward_call_paired``); the paired
forms compute the same functions with two heads packed into 128 lanes. q,
k, v (B, N, d) with B = images * heads and N = gh * gw; ``rel_h_term``
(B, N, gh) and ``rel_w_term`` (B, N, gw) in the dtype. Per row b:

    qs = q * scale                               (rounded to the dtype)
    s[i, c] = qs_i . k_c + rh[i, c // gw] + rw[i, c % gw]          (f32)
    m = max_c s,  p = exp(s - m),  l = max(sum_c p, 1e-30)         (f32)
    o = (p.astype(dtype) @ v) / l, summed in f32, rounded once
    lse = m + log(l)                                               (f32)

which is an exact softmax with a running max: no clamp (the
``SOFTMAX_CLAMP`` of the other attention kernels does not apply here). The
backward takes the cotangent do of o and the forward's lse, all in f32:

    delta_i = sum_e do[i, e] * o[i, e]
    p = exp(s - lse),  dv = p^T do,  ds = p * (do v^T - delta)
    dqs = ds k,  dk = ds^T qs
    drh[i, h] = sum_{c // gw = h} ds[i, c],  drw[i, w] = sum_{c % gw = w} ds[i, c]

with dqs, dk and dv in the dtype of q, k and v, drh and drw in the rel
terms' dtype. As in the JAX package the scale stays outside the autograd
Function (``_RelposAttention``), so that autograd chains ``scale_query``.

On CUDA tensors the wrappers launch the hand-written kernels of
``tfimm_tpu_torch/csrc/flash_attention_relpos.cu`` (forward) and
``flash_attention_relpos_bwd.cu`` (backward; see the notes at their tops
for the designs and what bounds them) and raise on what they do not take;
on CPU tensors they run ``flash_attention_relpos_reference`` and
``flash_attention_relpos_bwd_reference``. Both kernels take bf16 and f32,
d a multiple of 8 up to 128, any gh and gw up to 128, and read q, k and v
through their batch and row strides. The JAX package computes delta
outside its ``pallas_call``; the port's bf16 backward forms it in its
first launch (``csrc/attention_bwd.cuh``), the f32 one takes it from a
PyTorch reduction.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from tfimm_tpu_torch.ops.kernels.dispatch import launch
from tfimm_tpu_torch.ops.kernels.tma import (
    TILE,
    packed_operand_maps,
    packed_rows_maps,
    padded_rows,
)

__all__ = ["flash_attention_relpos", "flash_attention_relpos_with_lse",
           "flash_attention_relpos_reference", "flash_attention_relpos_bwd",
           "flash_attention_relpos_bwd_reference",
           "flash_attention_relpos_supports", "scale_query"]

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
MAX_GRID_SIDE = 128       # gh and gw: a 2048-pixel SAM input at patch 16
MIN_SUM = 1e-30


def scale_query(q: torch.Tensor, scale: float) -> torch.Tensor:
    """``q * scale`` with the scale rounded to q's dtype first and the
    product rounded once, as ``q * jnp.asarray(scale, q.dtype)`` in JAX."""
    return q * torch.tensor(scale, dtype=q.dtype).item()


def _scores(qs, k, rel_h_term, rel_w_term, grid_size, acc):
    """s (B, N, N) in ``acc``: qs k^T plus the bias rebuilt from the terms."""
    gh, gw = grid_size
    b, n, _ = qs.shape
    s = torch.matmul(qs.to(acc), k.to(acc).transpose(-1, -2))
    return (s.reshape(b, n, gh, gw) + rel_h_term.to(acc)[..., :, None]
            + rel_w_term.to(acc)[..., None, :]).reshape(b, n, n)


def _forward_reference(qs, k, v, rel_h_term, rel_w_term, grid_size):
    dt = qs.dtype
    acc = torch.promote_types(dt, torch.float32)
    s = _scores(qs, k, rel_h_term, rel_w_term, grid_size, acc)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=MIN_SUM)
    out = torch.matmul(p.to(dt).to(acc), v.to(acc)) / l
    return out.to(dt), (m + torch.log(l)).squeeze(-1)


def flash_attention_relpos_reference(
        q, k, v, rel_h_term, rel_w_term, *, grid_size: Tuple[int, int],
        scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the kernel: (out (B, N, d) in q's dtype, lse
    (B, N) in f32, f64 for f64 inputs)."""
    return _forward_reference(scale_query(q, scale), k, v, rel_h_term,
                              rel_w_term, tuple(grid_size))


def flash_attention_relpos_bwd_reference(
        qs, k, v, rel_h_term, rel_w_term, out, lse, do, *,
        grid_size: Tuple[int, int]):
    """Plain PyTorch twin of the backward kernel, from the scaled q, the
    forward's output and lse and the cotangent ``do``: (dqs, dk, dv) in
    the dtypes of qs, k and v, (drh (B, N, gh), drw (B, N, gw)) in the rel
    terms' dtypes. Every product and sum in f32 (f64 for f64 inputs)."""
    gh, gw = grid_size
    b, n, _ = qs.shape
    acc = torch.promote_types(qs.dtype, torch.float32)
    do32 = do.to(acc)
    delta = (do32 * out.to(acc)).sum(dim=-1, keepdim=True)
    s = _scores(qs, k, rel_h_term, rel_w_term, grid_size, acc)
    p = torch.exp(s - lse.to(acc)[..., None])
    dv = torch.matmul(p.transpose(-1, -2), do32)
    ds = p * (torch.matmul(do32, v.to(acc).transpose(-1, -2)) - delta)
    dqs = torch.matmul(ds, k.to(acc))
    dk = torch.matmul(ds.transpose(-1, -2), qs.to(acc))
    ds = ds.reshape(b, n, gh, gw)
    return (dqs.to(qs.dtype), dk.to(k.dtype), dv.to(v.dtype),
            ds.sum(dim=-1).to(rel_h_term.dtype),
            ds.sum(dim=-2).to(rel_w_term.dtype))


def flash_attention_relpos_supports(d: int, grid_size: Tuple[int, int]) -> bool:
    """Whether the kernel takes head dim ``d`` on a ``grid_size`` token grid."""
    gh, gw = grid_size
    return (d % 8 == 0 and 0 < d <= MAX_HEAD_DIM and 0 < gh <= MAX_GRID_SIDE
            and 0 < gw <= MAX_GRID_SIDE)


def _strided(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the kernel can read it through its batch and row
    strides (16-byte rows and start), else a contiguous copy."""
    item = t.element_size()
    if (t.stride(-1) == 1 and (t.stride(0) * item) % 16 == 0
            and (t.stride(1) * item) % 16 == 0 and t.data_ptr() % 16 == 0):
        return t
    return t.contiguous()


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when it starts on a 16-byte boundary, else a copy."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _as_heads(t: torch.Tensor):
    """(shape, stride) of a (B, N, C) tensor as the (B, 1, N, C) operand of
    a 4-D tensor map (``tma.py · heads_map``)."""
    b, n, c = t.shape
    return (b, 1, n, c), (t.stride(0), t.stride(0), t.stride(1), t.stride(2))


def stats_scratch(rows: int, n: int, device) -> torch.Tensor:
    """The bf16 backward kernels' f32 scratch (2, rows, N rounded up to
    64): lse * log2(e), then delta. Their first launch writes all of it,
    the padded rows included (``csrc/attention_bwd.cuh``)."""
    return torch.empty((2, rows, padded_rows(n)), dtype=torch.float32,
                       device=device)


def _check_kernel_inputs(name, q, k, v, rel_h_term, rel_w_term, grid_size):
    tensors = (q, k, v, rel_h_term, rel_w_term)
    devices = {t.device for t in tensors}
    if len(devices) > 1 or q.device.type != "cuda":
        raise ValueError(f"{name}: all inputs must lie on one CUDA device; "
                         f"got {sorted(map(str, devices))}")
    if q.dtype not in DTYPE_CODES or any(t.dtype != q.dtype for t in tensors):
        raise ValueError(f"{name}: q, k, v and the rel terms must all be bf16 "
                         f"or all f32; got {[t.dtype for t in tensors]}")
    gh, gw = grid_size
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q, k, v must be one (B, N, d) shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, n, d = q.shape
    if n != gh * gw:
        raise ValueError(f"{name}: N={n} is not gh * gw for grid {grid_size}")
    if (tuple(rel_h_term.shape) != (b, n, gh)
            or tuple(rel_w_term.shape) != (b, n, gw)):
        raise ValueError(f"{name}: the rel terms must be {(b, n, gh)} and "
                         f"{(b, n, gw)}; got {tuple(rel_h_term.shape)}, "
                         f"{tuple(rel_w_term.shape)}")
    if not flash_attention_relpos_supports(d, grid_size):
        raise ValueError(f"{name}: the kernel takes d a multiple of 8 up to "
                         f"{MAX_HEAD_DIM} and gh, gw up to {MAX_GRID_SIDE}; "
                         f"got d={d}, grid {grid_size}")


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _forward(qs, k, v, rel_h_term, rel_w_term, grid_size):
    """(out, lse) from the scaled q: the plain version when every input
    lies on the CPU, the kernel otherwise."""
    if _on_cpu(qs, k, v, rel_h_term, rel_w_term):
        return _forward_reference(qs, k, v, rel_h_term, rel_w_term, grid_size)
    _check_kernel_inputs("flash_attention_relpos", qs, k, v, rel_h_term,
                         rel_w_term, grid_size)
    from tfimm_tpu_torch.ops.kernels.build import kernel_library

    b, n, d = qs.shape
    gh, gw = grid_size
    out = torch.empty((b, n, d), dtype=qs.dtype, device=qs.device)
    lse = torch.empty((b, n), dtype=torch.float32, device=qs.device)
    if b == 0:
        return out, lse
    qs, k, v = _strided(qs), _strided(k), _strided(v)
    rh, rw = rel_h_term.contiguous(), rel_w_term.contiguous()
    maps = (packed_rows_maps(qs.shape, qs.stride(), k.stride(), v.stride(),
                             out.stride())
            if qs.dtype == torch.bfloat16 else None)
    launch("flash_attention_relpos",
           kernel_library().tfimm_flash_attention_relpos_fwd, qs, k, v,
           qs.stride(0), qs.stride(1), k.stride(0), k.stride(1), v.stride(0),
           v.stride(1), rh, rw, out, lse, maps, b, n, d, gh, gw,
           DTYPE_CODES[qs.dtype])
    return out, lse


def flash_attention_relpos_bwd(qs, k, v, rel_h_term, rel_w_term, out, lse,
                               do, *, grid_size: Tuple[int, int]):
    """(dqs, dk, dv, drh, drw), as ``flash_attention_relpos_bwd_reference``.
    Runs the plain version when every input lies on the CPU and the
    backward kernel otherwise: two launches (dqs, drh, drw over query
    blocks; dk, dv over key blocks), counted as one."""
    grid_size = tuple(grid_size)
    if _on_cpu(qs, k, v, rel_h_term, rel_w_term, out, lse, do):
        return flash_attention_relpos_bwd_reference(
            qs, k, v, rel_h_term, rel_w_term, out, lse, do,
            grid_size=grid_size)
    name = "flash_attention_relpos_bwd"
    _check_kernel_inputs(name, qs, k, v, rel_h_term, rel_w_term, grid_size)
    b, n, d = qs.shape
    if (out.shape != qs.shape or do.shape != qs.shape
            or tuple(lse.shape) != (b, n) or out.dtype != qs.dtype
            or do.dtype != qs.dtype or lse.dtype != torch.float32
            or {out.device, lse.device, do.device} != {qs.device}):
        raise ValueError(f"{name}: out and do must be {tuple(qs.shape)} "
                         f"{qs.dtype} and lse ({b}, {n}) f32 on {qs.device}; "
                         f"got {tuple(out.shape)} {out.dtype}, {tuple(do.shape)} "
                         f"{do.dtype}, {tuple(lse.shape)} {lse.dtype}")
    from tfimm_tpu_torch.ops.kernels.build import kernel_library

    gh, gw = grid_size
    grads = [torch.empty((b, n, d), dtype=qs.dtype, device=qs.device)
             for _ in range(3)]
    drh = torch.empty((b, n, gh), dtype=qs.dtype, device=qs.device)
    drw = torch.empty((b, n, gw), dtype=qs.dtype, device=qs.device)
    if b == 0:
        return (*grads, drh, drw)
    qs, k, v = _strided(qs), _strided(k), _strided(v)
    do, out, rh, rw = (_aligned(t.contiguous())
                       for t in (do, out, rel_h_term, rel_w_term))
    maps = stats = delta = None
    if qs.dtype == torch.bfloat16:
        operands = [qs, k, v, do, out, *grads] + ([rw] if gw == TILE else [])
        maps = packed_operand_maps(*(_as_heads(t) for t in operands))
        stats = stats_scratch(b, n, qs.device)
    else:
        delta = (do * out).sum(dim=-1)
    launch(name, kernel_library().tfimm_flash_attention_relpos_bwd, qs, k, v,
           qs.stride(0), qs.stride(1), k.stride(0), k.stride(1), v.stride(0),
           v.stride(1), rh, rw, do, out, lse.contiguous(), delta, *grads, drh,
           drw, maps, stats, b, n, d, gh, gw, DTYPE_CODES[qs.dtype])
    return (*grads, drh, drw)


class _RelposAttention(torch.autograd.Function):
    """The attention from the scaled q, with ``flash_attention_relpos_bwd``
    as its backward (the custom VJP ``_relpos_core`` of the JAX package).
    Saves qs, k, v, the rel terms, the output and the lse; the lse is a
    second output without a gradient."""

    @staticmethod
    def forward(ctx, qs, k, v, rel_h_term, rel_w_term, grid_size):
        out, lse = _forward(qs, k, v, rel_h_term, rel_w_term, grid_size)
        ctx.save_for_backward(qs, k, v, rel_h_term, rel_w_term, out, lse)
        ctx.grid_size = grid_size
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    @once_differentiable
    def backward(ctx, do, _dlse):
        grads = flash_attention_relpos_bwd(*ctx.saved_tensors, do,
                                           grid_size=ctx.grid_size)
        return (*grads, None)


def flash_attention_relpos_with_lse(
        q, k, v, rel_h_term, rel_w_term, *, grid_size: Tuple[int, int],
        scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out (B, N, d) in q's dtype, lse (B, N) in f32). Runs the plain
    version when every input lies on the CPU and the kernel otherwise;
    under autograd the output's gradient runs the backward kernel (its
    plain version on the CPU)."""
    grid_size = tuple(grid_size)
    qs = scale_query(q, scale)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, rel_h_term, rel_w_term)):
        return _RelposAttention.apply(qs, k, v, rel_h_term, rel_w_term,
                                      grid_size)
    return _forward(qs, k, v, rel_h_term, rel_w_term, grid_size)


def flash_attention_relpos(q, k, v, rel_h_term, rel_w_term, *,
                           grid_size: Tuple[int, int],
                           scale: float) -> torch.Tensor:
    """q, k, v (B, N, d) with N = gh * gw; rel terms (B, N, gh) and
    (B, N, gw), computed from the unscaled q, as ``add_decomposed_rel_pos``
    adds them. Returns the attention output (B, N, d) in q's dtype;
    differentiable with respect to all five inputs."""
    return flash_attention_relpos_with_lse(
        q, k, v, rel_h_term, rel_w_term, grid_size=grid_size, scale=scale)[0]
