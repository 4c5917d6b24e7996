"""Flash attention with the decomposed relative-position bias (SAM, MViTv2).

Counterpart of ``tfimm_tpu/ops/pallas/flash_attention_relpos.py ·
flash_attention_relpos`` (its forward, ``_relpos_forward_call`` and the
head-paired ``_relpos_forward_call_paired``, which compute the same
function). q, k, v (B, N, d) with B = images * heads and N = gh * gw;
``rel_h_term`` (B, N, gh) and ``rel_w_term`` (B, N, gw) in the dtype. Per
row b:

    qs = q * scale                               (rounded to the dtype)
    s[i, c] = qs_i . k_c + rh[i, c // gw] + rw[i, c % gw]          (f32)
    m = max_c s,  p = exp(s - m),  l = max(sum_c p, 1e-30)         (f32)
    o = (p.astype(dtype) @ v) / l, summed in f32, rounded once
    lse = m + log(l)                                               (f32)

which is an exact softmax with a running max: no clamp (the
``SOFTMAX_CLAMP`` of the other attention kernels does not apply here). The
lse is what the backward needs; ``flash_attention_relpos_with_lse`` returns
it beside the output.

On a CUDA tensor the wrapper launches the hand-written kernel of
``tfimm_tpu_torch/csrc/flash_attention_relpos.cu`` (see the note at its top
for the design and what bounds it) and raises on what it does not take; on
CPU tensors it runs ``flash_attention_relpos_reference``. The kernel takes
bf16 and f32, d a multiple of 8 up to 128, any gh and gw up to 128, and
reads q, k and v through their batch and row strides. There is no backward
yet: on CUDA tensors that require grad the wrapper raises, and the SAM
encoder's gate (``RelPosAttention.kernel_ok``) sends windows under autograd
to the eager composition.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tfimm_tpu_torch.ops.kernels.dispatch import launch

__all__ = ["flash_attention_relpos", "flash_attention_relpos_with_lse",
           "flash_attention_relpos_reference", "flash_attention_relpos_supports",
           "scale_query"]

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
MAX_GRID_SIDE = 128       # gh and gw: a 2048-pixel SAM input at patch 16
MIN_SUM = 1e-30


def scale_query(q: torch.Tensor, scale: float) -> torch.Tensor:
    """``q * scale`` with the scale rounded to q's dtype first and the
    product rounded once, as ``q * jnp.asarray(scale, q.dtype)`` in JAX."""
    return q * torch.tensor(scale, dtype=q.dtype).item()


def flash_attention_relpos_reference(
        q, k, v, rel_h_term, rel_w_term, *, grid_size: Tuple[int, int],
        scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the kernel: (out (B, N, d) in q's dtype, lse
    (B, N) in f32, f64 for f64 inputs)."""
    gh, gw = grid_size
    b, n, _ = q.shape
    dt = q.dtype
    acc = torch.promote_types(dt, torch.float32)
    s = torch.matmul(scale_query(q, scale).to(acc), k.to(acc).transpose(-1, -2))
    s = (s.reshape(b, n, gh, gw) + rel_h_term.to(acc)[..., :, None]
         + rel_w_term.to(acc)[..., None, :]).reshape(b, n, n)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=MIN_SUM)
    out = torch.matmul(p.to(dt).to(acc), v.to(acc)) / l
    return out.to(dt), (m + torch.log(l)).squeeze(-1)


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


def _check_kernel_inputs(q, k, v, rel_h_term, rel_w_term, grid_size):
    name = "flash_attention_relpos"
    tensors = (q, k, v, rel_h_term, rel_w_term)
    devices = {t.device for t in tensors}
    if len(devices) > 1 or q.device.type != "cuda":
        raise ValueError(f"{name}: all inputs must lie on one CUDA device; "
                         f"got {sorted(map(str, devices))}")
    if q.dtype not in DTYPE_CODES or any(t.dtype != q.dtype for t in tensors):
        raise ValueError(f"{name}: q, k, v and the rel terms must all be bf16 "
                         f"or all f32; got {[t.dtype for t in tensors]}")
    if any(t.requires_grad for t in tensors) and torch.is_grad_enabled():
        raise NotImplementedError(
            f"{name}: the backward kernel is not ported yet (ROADMAP.md, "
            "queue B, item 10); call it outside autograd")
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


def flash_attention_relpos_with_lse(
        q, k, v, rel_h_term, rel_w_term, *, grid_size: Tuple[int, int],
        scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out (B, N, d) in q's dtype, lse (B, N) in f32). Runs the plain
    version when every input lies on the CPU and the kernel otherwise."""
    grid_size = tuple(grid_size)
    if all(t.device.type == "cpu" for t in (q, k, v, rel_h_term, rel_w_term)):
        return flash_attention_relpos_reference(
            q, k, v, rel_h_term, rel_w_term, grid_size=grid_size, scale=scale)
    _check_kernel_inputs(q, k, v, rel_h_term, rel_w_term, grid_size)
    from tfimm_tpu_torch.ops.kernels.build import kernel_library

    b, n, d = q.shape
    gh, gw = grid_size
    out = torch.empty((b, n, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, n), dtype=torch.float32, device=q.device)
    if b == 0:
        return out, lse
    qs = _strided(scale_query(q, scale))
    k, v = _strided(k), _strided(v)
    rh, rw = rel_h_term.contiguous(), rel_w_term.contiguous()
    launch("flash_attention_relpos",
           kernel_library().tfimm_flash_attention_relpos_fwd, qs, k, v,
           qs.stride(0), qs.stride(1), k.stride(0), k.stride(1), v.stride(0),
           v.stride(1), rh, rw, out, lse, b, n, d, gh, gw,
           DTYPE_CODES[q.dtype])
    return out, lse


def flash_attention_relpos(q, k, v, rel_h_term, rel_w_term, *,
                           grid_size: Tuple[int, int],
                           scale: float) -> torch.Tensor:
    """q, k, v (B, N, d) with N = gh * gw; rel terms (B, N, gh) and
    (B, N, gw), computed from the unscaled q, as ``add_decomposed_rel_pos``
    adds them. Returns the attention output (B, N, d) in q's dtype."""
    return flash_attention_relpos_with_lse(
        q, k, v, rel_h_term, rel_w_term, grid_size=grid_size, scale=scale)[0]
