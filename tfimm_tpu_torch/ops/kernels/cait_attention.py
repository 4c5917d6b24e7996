"""Talking-head attention (CaiT) from the packed qkv projection.

Counterpart of ``tfimm_tpu/ops/pallas/cait_attention.py ·
talking_head_attention`` and its custom VJP ``talking_head_diff``. qkv
(B, N, 3D) in timm's (3, H, d) order; w_l, w_w (H, H) in the JAX package's
``kernel`` orientation (in, out): output head g of a mix reads column g;
b_l, b_w (H,). Per image, query q and key k, with raw_h = q_h . k_h:

    s'_g = sum_h scale * w_l[h, g] * raw_h + b_l[g]             (f32)
    p_g  = exp(min(s'_g, 80)) / rowsum                 (clamped no-max softmax)
    a_h  = sum_g w_w[g, h] * p_g                                (f32)
    out_h = a_h.astype(dtype) @ v_h + b_w[h] * colsum(v_h), summed in f32,
           rounded once

The post-softmax bias enters as the rank-1 term ``b_w[h] * colsum(v_h)``
(rows of p_g sum to 1), so it is never added to a probability before the
rounding. The mixed probabilities a_h are rounded once to the dtype before
their product with v, which is the rounding of the kernel; the Pallas
stacked body rounds each p_g and mixes ``w_w[g, h] * (p_g @ v)`` in f32.

On a CUDA tensor ``talking_head_attention`` launches the hand-written
kernel of ``tfimm_tpu_torch/csrc/cait_attention.cu`` (see the note at its
top for the design and what bounds it) and raises on what it does not take;
bf16 operands that ``tma.cait_route`` takes (contiguous, 16-byte aligned,
H <= 8 heads of d <= 64: every registered CaiT below cait_m36) run its
Hopper body (TMA-fed wgmma), the rest its first design's bodies;
on CPU tensors it runs ``talking_head_attention_reference``. The backward,
``talking_head_attention_bwd``, gives dqkv in the packed (B, N, 3D) layout
and dtype, and dw_l, db_l, dw_w, db_w in f32: db_l is exactly zero (the
softmax is shift-invariant), the others are summed over the batch. On a
CUDA tensor it launches the kernels of ``csrc/cait_attention_bwd.cu``
(the Hopper body on the same route, which writes a and draw in bf16 to a
scratch that ``ab_scratch`` allocates), on CPU tensors it runs
``talking_head_attention_bwd_reference`` (in f32; the bf16 kernels round
a_h and the score cotangent's head mix to bf16 before their three products
with q, k and g, where the plain version does not).
The kernels read the four mixes in place (f32 or bf16, w_l and w_w through
their strides, so the model's transposed Dense weights need no copy) and
need both biases. ``talking_head_attention_packed`` goes through the
``torch.autograd.Function`` ``_TalkingHead`` where autograd records, so
that a CaiT block trains through both kernels; with a mix bias missing it
runs the plain version, as ``_th_fwd`` sends that case to the XLA twin.
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
    TILE as WGMMA_TILE,
    cait_route,
    cait_scratch_cols,
    packed_cait_maps,
    padded_rows,
)

__all__ = ["talking_head_attention", "talking_head_attention_reference",
           "talking_head_attention_bwd", "talking_head_attention_bwd_reference",
           "talking_head_attention_supports", "talking_head_attention_packed",
           "ab_scratch", "stats_scratch"]

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEADS = 16
MAX_HEAD_DIM = 128
MAX_DIM = 768        # H * d: cait_m36 / cait_m48, the widest registered CaiT
# The first design's query and key tiles (csrc/cait_attention*.cu kTile);
# the Hopper bodies take 64 query rows a block (WGMMA_TILE).
TILE = 16


def _heads(t: torch.Tensor, nb_heads: int, dtype: torch.dtype):
    """(B, N, H * d) -> (B, H, N, d) in ``dtype``."""
    b, n, c = t.shape
    return t.reshape(b, n, nb_heads, c // nb_heads).transpose(1, 2).to(dtype)


def _merge_heads(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(B, H, N, d) -> (B, N, H * d) in ``dtype``."""
    b, h, n, d = t.shape
    return t.transpose(1, 2).reshape(b, n, h * d).to(dtype)


def _split(qkv: torch.Tensor):
    c = qkv.shape[-1] // 3
    return qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]


def _biases(b_l, b_w, nb_heads, like):
    """The plain versions' rule: a missing bias counts as zeros."""
    zeros = torch.zeros(nb_heads, dtype=like.dtype, device=like.device)
    return (zeros if b_l is None else b_l), (zeros if b_w is None else b_w)


def _probs(qkv, w_l, b_l, nb_heads, scale):
    """q, k, v (B, H, N, d), the raw scores q_h . k_h, the mixed scores s'
    and the probabilities p (B, H, N, N), all in f32 (f64 for f64)."""
    acc = torch.promote_types(qkv.dtype, torch.float32)
    q, k, v = (_heads(t, nb_heads, acc) for t in _split(qkv))
    raw = torch.matmul(q, k.transpose(-1, -2))
    s = torch.einsum("bhqk,hg->bgqk", raw, scale * w_l.to(acc))
    s = s + b_l.to(acc)[:, None, None]
    return q, k, v, raw, s, softmax_nomax(s)


def talking_head_attention_reference(qkv, w_l, b_l, w_w, b_w, *,
                                     nb_heads: int, scale: float):
    """Plain PyTorch twin of the kernel, with its roundings."""
    b_l, b_w = _biases(b_l, b_w, nb_heads, w_l)
    _, _, v, _, _, p = _probs(qkv, w_l, b_l, nb_heads, scale)
    a = torch.einsum("bgqk,gh->bhqk", p, w_w.to(p.dtype))
    a = a.to(qkv.dtype).to(p.dtype)
    out = torch.matmul(a, v) + b_w.to(p.dtype)[:, None, None] * v.sum(
        dim=-2, keepdim=True)
    return _merge_heads(out, qkv.dtype)


def talking_head_attention_bwd_reference(qkv, w_l, b_l, w_w, b_w, g, *,
                                         nb_heads: int, scale: float):
    """Plain PyTorch twin of the backward kernels, in f32 (f64 for f64)
    with the softmax recomputed and the clamp mask on the score cotangent.
    g = dL/dout (B, N, D). Returns dqkv (B, N, 3D) in qkv's dtype and
    packed layout, and dw_l, db_l, dw_w, db_w in f32 (f64), summed over the
    batch; db_l is exactly zero."""
    b_l, b_w = _biases(b_l, b_w, nb_heads, w_l)
    q, k, v, raw, s, p = _probs(qkv, w_l, b_l, nb_heads, scale)
    acc = p.dtype
    w_l, w_w, b_w = w_l.to(acc), w_w.to(acc), b_w.to(acc)
    gh = _heads(g, nb_heads, acc)
    a = torch.einsum("bgqk,gh->bhqk", p, w_w)
    docol = gh.sum(dim=-2, keepdim=True)                       # (B, H, 1, d)
    da = torch.matmul(gh, v.transpose(-1, -2))
    dv = torch.matmul(a.transpose(-1, -2), gh) + b_w[:, None, None] * docol
    dbw = (docol * v.sum(dim=-2, keepdim=True)).sum(dim=(0, 2, 3))
    dww = torch.einsum("bgqk,bhqk->gh", p, da)
    dp = torch.einsum("bhqk,gh->bgqk", da, w_w)
    ds = softmax_clamp_grad_mask(
        s, p * (dp - (dp * p).sum(dim=-1, keepdim=True)))
    dwl = scale * torch.einsum("bhqk,bgqk->hg", raw, ds)
    draw = scale * torch.einsum("bgqk,hg->bhqk", ds, w_l)
    dq = torch.matmul(draw, k)
    dk = torch.matmul(draw.transpose(-1, -2), q)
    dqkv = torch.cat([_merge_heads(t, qkv.dtype) for t in (dq, dk, dv)],
                     dim=-1)
    return dqkv, dwl, torch.zeros_like(dbw), dww, dbw


def talking_head_attention_supports(n: int, dim: int, nb_heads: int) -> bool:
    """Whether the kernels take ``n`` tokens, ``dim`` = H * d channels and
    ``nb_heads`` heads."""
    if n < 1 or nb_heads < 1 or dim % nb_heads:
        return False
    d = dim // nb_heads
    return (nb_heads <= MAX_HEADS and d % 8 == 0 and d <= MAX_HEAD_DIM
            and dim <= MAX_DIM)


def _check_kernel_inputs(name, qkv, mixes, nb_heads):
    """Raise on inputs the kernels do not take."""
    if any(t is None for t in mixes):
        raise ValueError(f"{name}: the kernel needs both mix biases (CaiT "
                         "always has them; talking_head_attention_packed "
                         "runs the plain version without)")
    devices = {t.device for t in (qkv, *mixes)}
    if len(devices) > 1 or qkv.device.type != "cuda":
        raise ValueError(f"{name}: all inputs must lie on one CUDA device; "
                         f"got {sorted(map(str, devices))}")
    if qkv.dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: qkv must be bf16 or f32; got {qkv.dtype}")
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"{name}: qkv must be (B, N, 3D); got "
                         f"{tuple(qkv.shape)}")
    _, n, three_d = qkv.shape
    if not talking_head_attention_supports(n, three_d // 3, nb_heads):
        raise ValueError(
            f"{name}: the kernel takes H <= {MAX_HEADS}, a head dim that is a "
            f"multiple of 8 up to {MAX_HEAD_DIM} and D = H * d <= {MAX_DIM}; "
            f"got D={three_d // 3}, H={nb_heads}")
    if qkv.stride(-1) != 1:
        raise ValueError(f"{name}: the last dimension of qkv must be "
                         "contiguous")
    w_l, b_l, w_w, b_w = mixes
    h = nb_heads
    if (tuple(w_l.shape) != (h, h) or tuple(w_w.shape) != (h, h)
            or tuple(b_l.shape) != (h,) or tuple(b_w.shape) != (h,)):
        raise ValueError(f"{name}: the mixes must be ({h}, {h}) and their "
                         f"biases ({h},); got {tuple(w_l.shape)}, "
                         f"{tuple(b_l.shape)}, {tuple(w_w.shape)}, "
                         f"{tuple(b_w.shape)}")


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors if t is not None)


def _mix_args(w_l, b_l, w_w, b_w):
    """The kernels' mix arguments: w_l and w_w with their strides (no copy
    of a transposed view), b_l, b_w and the mixes' dtype code. The four are
    passed as they are when they share a dtype the kernels read (f32 or
    bf16), and as f32 copies otherwise."""
    mixes = [t.detach() for t in (w_l, b_l, w_w, b_w)]
    if mixes[0].dtype not in DTYPE_CODES or any(
            t.dtype != mixes[0].dtype for t in mixes):
        mixes = [t.float() for t in mixes]
    w_l, b_l, w_w, b_w = mixes
    return (w_l, w_l.stride(0), w_l.stride(1), b_l.contiguous(), w_w,
            w_w.stride(0), w_w.stride(1), b_w.contiguous(),
            DTYPE_CODES[w_l.dtype])


def talking_head_attention(qkv, w_l, b_l, w_w, b_w, *, nb_heads: int,
                           scale: float) -> torch.Tensor:
    """(B, N, D) in qkv's dtype. Runs the plain version (where a missing
    bias counts as zeros) when every input lies on the CPU, and the kernel
    otherwise, which needs both biases."""
    return _forward(qkv, w_l, b_l, w_w, b_w, nb_heads, scale, False)[0]


def stats_scratch(b: int, nb_heads: int, n: int, device) -> torch.Tensor:
    """The Hopper forward's log2 l for the backward, f32 (B, H, N rounded
    up to 64): the forward writes every row of it, the padded ones too."""
    return torch.empty((b, nb_heads, padded_rows(n)), dtype=torch.float32,
                       device=device)


def _forward(qkv, w_l, b_l, w_w, b_w, nb_heads, scale, save_stats):
    """``talking_head_attention`` and, with ``save_stats`` where the Hopper
    body runs, the log2 l it kept for the backward (else None)."""
    if _on_cpu(qkv, w_l, b_l, w_w, b_w):
        return talking_head_attention_reference(
            qkv, w_l, b_l, w_w, b_w, nb_heads=nb_heads, scale=scale), None
    _check_kernel_inputs("talking_head_attention", qkv, (w_l, b_l, w_w, b_w),
                         nb_heads)
    from tfimm_tpu_torch.ops.kernels.build import kernel_library

    b, n, three_d = qkv.shape
    dim = three_d // 3
    out = torch.empty((b, n, dim), dtype=qkv.dtype, device=qkv.device)
    if b == 0:
        return out, None
    maps = stats = None
    if cait_route(nb_heads, qkv):
        maps = packed_cait_maps(b, n, nb_heads, dim // nb_heads)
        if save_stats:
            stats = stats_scratch(b, nb_heads, n, qkv.device)
    launch("talking_head_attention", kernel_library().tfimm_talking_head_fwd,
           qkv, qkv.stride(0), qkv.stride(1), *_mix_args(w_l, b_l, w_w, b_w),
           out, b, n, nb_heads, dim // nb_heads, float(scale),
           DTYPE_CODES[qkv.dtype], maps, stats)
    return out, stats


def ab_scratch(b: int, nb_heads: int, n: int, device) -> torch.Tensor:
    """The Hopper backward's bf16 scratch of a and draw, (2, B, H, N,
    ``cait_scratch_cols(N)``): its first launch writes every element its
    second reads (rows and keys below N; TMA reads zeros past N)."""
    return torch.empty((2, b, nb_heads, n, cait_scratch_cols(n)),
                       dtype=torch.bfloat16, device=device)


def talking_head_attention_bwd(qkv, w_l, b_l, w_w, b_w, g, *, nb_heads: int,
                               scale: float,
                               row_stats: Optional[torch.Tensor] = None):
    """(dqkv, dw_l, db_l, dw_w, db_w) of ``talking_head_attention`` from
    g = dL/dout (B, N, D): dqkv (B, N, 3D) in qkv's dtype and packed layout,
    the rest in f32, summed over the batch, db_l exactly zero. Runs
    ``talking_head_attention_bwd_reference`` when every input lies on the
    CPU and the kernels otherwise, where it raises on what they do not
    take. ``row_stats``: the log2 l that the forward's Hopper body kept
    (``_TalkingHead``), which spares the Hopper backward its first pass;
    the same gradients bit for bit. Two calls give bit-identical results:
    no atomics."""
    if _on_cpu(qkv, w_l, b_l, w_w, b_w, g):
        return talking_head_attention_bwd_reference(
            qkv, w_l, b_l, w_w, b_w, g, nb_heads=nb_heads, scale=scale)
    _check_kernel_inputs("talking_head_attention_bwd", qkv,
                         (w_l, b_l, w_w, b_w), nb_heads)
    b, n, three_d = qkv.shape
    dim, h = three_d // 3, nb_heads
    if (g.shape != (b, n, dim) or g.dtype != qkv.dtype
            or g.device != qkv.device or not g.is_contiguous()):
        raise ValueError(f"talking_head_attention_bwd: g must be a contiguous "
                         f"{(b, n, dim)} {qkv.dtype} tensor on {qkv.device}; "
                         f"got {tuple(g.shape)} {g.dtype} on {g.device}")
    from tfimm_tpu_torch.ops.kernels.build import kernel_library

    dev = qkv.device
    dqkv = torch.empty((b, n, three_d), dtype=qkv.dtype, device=dev)
    # dw_l, dw_w, db_w and db_l (exact zeros): the kernels' last launch
    # writes every element.
    alloc = torch.zeros if b == 0 else torch.empty
    mix = alloc((2 * h * h + 2 * h,), dtype=torch.float32, device=dev)
    dwl, dww = mix[:h * h].view(h, h), mix[h * h:2 * h * h].view(h, h)
    dbw, dbl = mix[2 * h * h:2 * h * h + h], mix[2 * h * h + h:]
    if b == 0:
        return dqkv, dwl, dbl, dww, dbw
    # The per-block partial sums of the two mix gradients (2 H^2 each) and
    # of db_w (H each); the first design also keeps the row statistics l
    # and delta (B, H, N) between its launches, the Hopper body a and draw.
    stats = scratch = maps = saved = None
    if cait_route(h, qkv, g):
        tiles = -(-n // WGMMA_TILE)
        scratch = ab_scratch(b, h, n, dev)
        maps = packed_cait_maps(b, n, h, dim // h, True)
        if row_stats is not None:
            if (row_stats.shape != (b, h, padded_rows(n))
                    or row_stats.dtype != torch.float32
                    or row_stats.device != dev
                    or not row_stats.is_contiguous()):
                raise ValueError(
                    f"talking_head_attention_bwd: row_stats must be a "
                    f"contiguous f32 {(b, h, padded_rows(n))} tensor on "
                    f"{dev}; got {tuple(row_stats.shape)} {row_stats.dtype}")
            saved = row_stats
    else:
        tiles = -(-n // TILE)
        stats = torch.empty((2, b, h, n), dtype=torch.float32, device=dev)
    part_rows = torch.empty((b * tiles, 2 * h * h), dtype=torch.float32,
                            device=dev)
    part_keys = torch.empty((b * tiles, h), dtype=torch.float32, device=dev)
    launch("talking_head_attention_bwd",
           kernel_library().tfimm_talking_head_bwd, qkv, qkv.stride(0),
           qkv.stride(1), *_mix_args(w_l, b_l, w_w, b_w), g, dqkv, stats,
           part_rows, part_keys, mix, scratch, maps, saved, b, n, h, dim // h,
           float(scale), DTYPE_CODES[qkv.dtype])
    return dqkv, dwl, dbl, dww, dbw


class _TalkingHead(torch.autograd.Function):
    """``talking_head_attention`` with ``talking_head_attention_bwd`` as its
    backward (the custom VJP of ``talking_head_diff`` in the JAX package).
    Saves qkv, the four mix parameters and, where the Hopper body runs, the
    row statistics log2 l (B, H, N rounded up to 64), so that the backward
    skips the pass that would recompute them. Each mix gradient comes back
    in its parameter's dtype."""

    @staticmethod
    def forward(ctx, qkv, w_l, b_l, w_w, b_w, nb_heads, scale):
        out, stats = _forward(qkv, w_l, b_l, w_w, b_w, nb_heads, scale, True)
        ctx.save_for_backward(qkv, w_l, b_l, w_w, b_w, stats)
        ctx.nb_heads, ctx.scale = nb_heads, scale
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        qkv, w_l, b_l, w_w, b_w, stats = ctx.saved_tensors
        grads = talking_head_attention_bwd(
            qkv, w_l, b_l, w_w, b_w, g.contiguous(), nb_heads=ctx.nb_heads,
            scale=ctx.scale, row_stats=stats)
        params = (w_l, b_l, w_w, b_w)
        return (grads[0], *(d.to(p.dtype) for d, p in zip(grads[1:], params)),
                None, None)


def talking_head_attention_packed(qkv, w_l, b_l: Optional[torch.Tensor], w_w,
                                  b_w: Optional[torch.Tensor], *,
                                  nb_heads: int, scale: float) -> torch.Tensor:
    """``talking_head_attention``, differentiable with respect to qkv and the
    four mix parameters. With both biases present it goes through the
    kernels' autograd Function where autograd records; with a bias missing
    it runs the plain version under autograd (the JAX package's ``_th_fwd``
    sends that case to its XLA twin; CaiT always has both biases)."""
    if b_l is None or b_w is None:
        return talking_head_attention_reference(
            qkv, w_l, b_l, w_w, b_w, nb_heads=nb_heads, scale=scale)
    tensors = (qkv, w_l, b_l, w_w, b_w)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _TalkingHead.apply(*tensors, nb_heads, scale)
    return talking_head_attention(*tensors, nb_heads=nb_heads, scale=scale)
