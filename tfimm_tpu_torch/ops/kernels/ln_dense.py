"""Fused LayerNorm + Dense, forward and backward.

Counterpart of ``tfimm_tpu/ops/pallas/ln_dense.py``. On rows x (M, C) it
returns ``LN(x) @ weight^T + bias`` in x's dtype, with the JAX kernel's
roundings: f32 row statistics with the one-pass variance
``max(E[x^2] - E[x]^2, 0)``, ``z = ((x - mean) * rstd) * gamma + beta`` in
f32 rounded to the dtype, the product summed in f32 with the bias and
rounded once. ``weight`` is (O, C), the port's Dense layout (the JAX ``w``
is its transpose), so a block's ``norm1`` and ``qkv`` parameters go in as
they are.

The backward (``_bwd`` of the JAX package) casts g to the dtype and gives
dx (dz = g @ weight in f32, never rounded, then the LayerNorm backward on
whole rows), dgamma and dbeta (f32 sums over the rows), dW = g^T @ z with z
recomputed as in the forward, and db = the f32 sum of g; each gradient is
cast to its parameter's dtype, and db is None without a bias.

On CUDA tensors the wrappers launch the hand-written kernels of
``tfimm_tpu_torch/csrc/ln_dense.cu`` (see the note at its top for the
design and what bounds it) and raise on what they do not take; on CPU
tensors they run the plain versions. No model calls this op, in either
package: ``ln_dense_or_none`` is the public entry point.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from tfimm_tpu_torch.ops.kernels.dispatch import (
    KERNEL_DTYPES,
    launch,
    log_dispatch,
)
from tfimm_tpu_torch.ops.kernels.tma import (
    LN_BWD_ROWS,
    gemm_route,
    ln_dense_bwd_plan,
    ln_dense_bwd_route,
    packed_gemm_maps,
    packed_ln_dense_bwd_maps,
    sm_count,
)

__all__ = ["ln_dense", "ln_dense_diff", "ln_dense_or_none", "ln_dense_bwd",
           "ln_dense_reference", "ln_dense_bwd_reference", "dx_block_rows"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# The dx kernel keeps the f32 dz of its rows in shared memory; these mirror
# ``dx_smem`` and ``kMaxSmem`` of ln_dense.cu.
_MAX_SMEM = 232448
_TILE = 128


def dx_block_rows(c: int, itemsize: int) -> Optional[int]:
    """Rows of the dx kernel's block at C channels (64, 32 or 16, the most
    whose f32 dz tile and staging buffers fit a block's shared memory), or
    None when even 16 rows do not fit (C above about 3,300)."""
    depth, pad = 64 // itemsize, 16 // itemsize
    for bm in (64, 32, 16):
        stage = bm * (depth + pad) + depth * (_TILE + pad)
        if 2 * stage * itemsize + 8 * bm + 4 * bm * c <= _MAX_SMEM:
            return bm
    return None


def _dw_splits(m: int, c: int, o: int, sms: int) -> int:
    """Row slices of the dW pass: enough blocks for about four a
    multiprocessor, with at least 256 rows a slice."""
    tiles = -(-o // _TILE) * -(-c // _TILE)
    return max(1, min(-(-4 * sms // tiles), m // 256))


def _stats(xf: torch.Tensor, eps: float):
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp(xf.square().mean(dim=-1, keepdim=True) - mean.square(),
                      min=0.0)
    return mean, torch.rsqrt(var + eps)


def _acc(dt: torch.dtype) -> torch.dtype:
    return torch.promote_types(dt, torch.float32)


def ln_dense_reference(x, gamma, beta, weight, bias=None,
                       eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version of the forward (``_reference_ln_dense`` in the
    JAX package)."""
    dt, acc = x.dtype, _acc(x.dtype)
    xf = x.to(acc)
    mean, rstd = _stats(xf, eps)
    z = ((xf - mean) * rstd * gamma.to(acc) + beta.to(acc)).to(dt)
    y = z.to(acc) @ weight.to(dt).to(acc).t()
    if bias is not None:
        y = y + bias.to(acc)
    return y.to(dt)


def ln_dense_bwd_reference(x, gamma, beta, weight, g, has_bias: bool = True,
                           eps: float = 1e-6):
    """Plain PyTorch version of the backward: (dx, dgamma, dbeta, dW, db),
    each in its parameter's dtype (db in the weight's, None without a
    bias)."""
    dt, acc = x.dtype, _acc(x.dtype)
    gf = g.to(dt).to(acc)
    xf = x.to(acc)
    mean, rstd = _stats(xf, eps)
    xn = (xf - mean) * rstd
    dz = gf @ weight.to(dt).to(acc)
    dxn = dz * gamma.to(acc)
    dx = rstd * (dxn - dxn.mean(dim=-1, keepdim=True)
                 - xn * (dxn * xn).mean(dim=-1, keepdim=True))
    z = (xn * gamma.to(acc) + beta.to(acc)).to(dt).to(acc)
    db = gf.sum(dim=0).to(weight.dtype) if has_bias else None
    return (dx.to(dt), (dz * xn).sum(dim=0).to(gamma.dtype),
            dz.sum(dim=0).to(beta.dtype), (gf.t() @ z).to(weight.dtype), db)


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors if t is not None)


def _check_kernel_inputs(name, x, gamma, beta, weight, bias=None, g=None):
    """Raise on inputs the kernels do not take."""
    tensors = [t for t in (x, gamma, beta, weight, bias, g) if t is not None]
    devices = {t.device for t in tensors}
    if len(devices) > 1 or x.device.type != "cuda":
        raise ValueError(f"{name}: all inputs must lie on one CUDA device; "
                         f"got {sorted(map(str, devices))}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: x must be bf16 or f32; got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous (M, C) tensor; got "
                         f"{tuple(x.shape)}")
    m, c = x.shape
    o = weight.shape[0]
    shapes = {"gamma": (gamma, (c,)), "beta": (beta, (c,)),
              "weight": (weight, (o, c)), "bias": (bias, (o,)),
              "g": (g, (m, o))}
    for arg, (t, want) in shapes.items():
        if t is not None and tuple(t.shape) != want:
            raise ValueError(f"{name}: {arg} must be {want}; got "
                             f"{tuple(t.shape)}")
    if dx_block_rows(c, x.element_size()) is None:
        raise ValueError(f"{name}: C = {c} is above what the dx kernel's "
                         f"shared-memory tile holds")


def _forward(x, gamma, beta, weight, bias, eps):
    if _on_cpu(x, gamma, beta, weight, bias):
        return ln_dense_reference(x, gamma, beta, weight, bias, eps)
    _check_kernel_inputs("ln_dense", x, gamma, beta, weight, bias)
    from tfimm_tpu_torch.ops.kernels.build import kernel_library

    dt = x.dtype
    (m, c), o = x.shape, weight.shape[0]
    out = torch.empty((m, o), dtype=dt, device=x.device)
    if m == 0:
        return out
    mean = torch.empty((m,), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    weight = weight.to(dt).contiguous()
    maps = None
    if gemm_route(x, weight, out, ln_depth=c):
        maps = packed_gemm_maps((m, o, c, True, False,
                                 sm_count(x.device.index)))
    launch("ln_dense", kernel_library().tfimm_ln_dense_fwd, x,
           gamma.float().contiguous(), beta.float().contiguous(), weight,
           None if bias is None else bias.float().contiguous(), mean, rstd,
           out, m, c, o, float(eps), _DTYPE_CODES[dt], maps)
    return out


def ln_dense_bwd(x, gamma, beta, weight, g, has_bias: bool = True,
                 eps: float = 1e-6):
    """(dx, dgamma, dbeta, dW, db), as ``ln_dense_bwd_reference``. Runs the
    plain version when every input lies on the CPU and the backward kernels
    otherwise, counted as one launch: on ``tma.ln_dense_bwd_route`` (bf16)
    four to seven (dz = g @ weight in f32; dx, z, the row statistics and
    the dgamma and dbeta partials; their two sums; dW and db, or their
    partials over slices of the rows and the partials' two sums; a
    row-statistics launch first below C = 256), else seven (row
    statistics; dx with the dgamma and dbeta partials; their two sums; dW
    and db partials; their two sums)."""
    if _on_cpu(x, gamma, beta, weight, g):
        return ln_dense_bwd_reference(x, gamma, beta, weight, g, has_bias, eps)
    dt = x.dtype
    g = g.to(dt).contiguous()
    _check_kernel_inputs("ln_dense_bwd", x, gamma, beta, weight, None, g)
    from tfimm_tpu_torch.ops.kernels.build import kernel_library

    (m, c), o = x.shape, weight.shape[0]
    dev = x.device
    dx = torch.empty_like(x)
    if m == 0:
        zeros = [torch.zeros_like(t) for t in (gamma, beta, weight)]
        return (dx, *zeros,
                torch.zeros(o, dtype=weight.dtype, device=dev) if has_bias
                else None)
    w = weight.to(dt).contiguous()
    sms = sm_count(dev.index)
    route = ln_dense_bwd_route(x, w, g, dx)
    if route:
        maps = packed_ln_dense_bwd_maps(m, c, o, sms)
        rows, splits = LN_BWD_ROWS, ln_dense_bwd_plan(m, c, o, sms).splits
    else:
        maps = None
        rows = dx_block_rows(c, x.element_size())
        splits = _dw_splits(m, c, o, sms)
    # The scratch in one f32 allocation, its parts on 16-byte boundaries:
    # mean, rstd, the dgamma / dbeta partials, the dW and db partials, and
    # on the route dz (f32) and z (the dtype): fewer allocations, less host
    # time a call. dgamma, dbeta and db get one of their own, since they
    # outlive the call.
    parts = [m, m, 2 * -(-m // rows) * c, splits * o * c, splits * o]
    if route:
        parts += [m * c, -(-m * c * x.element_size() // 4)]
    offsets = [0]
    for n in parts:
        offsets.append(offsets[-1] + -(-n // 4) * 4)
    scratch = torch.empty(offsets[-1], dtype=torch.float32, device=dev)
    ptrs = [scratch.data_ptr() + 4 * off for off in offsets[:-1]]
    mean, rstd, part_gb, part_dw, part_db = ptrs[:5]
    dz, z = ptrs[5:] if route else (None, None)
    sums = torch.empty(2 * c + o, dtype=torch.float32, device=dev)
    dgb, db = sums[:2 * c].view(2, c), sums[2 * c:]
    dw = torch.empty((o, c), dtype=dt, device=dev)
    launch("ln_dense_bwd", kernel_library().tfimm_ln_dense_bwd, x,
           gamma.float().contiguous(), beta.float().contiguous(), w, g,
           mean, rstd, dx, part_gb, dgb, part_dw, part_db, dw, db, m, c, o,
           rows, splits, float(eps), _DTYPE_CODES[dt], z, dz, maps)
    return (dx, dgb[0].to(gamma.dtype), dgb[1].to(beta.dtype),
            dw.to(weight.dtype), db.to(weight.dtype) if has_bias else None)


class _LnDense(torch.autograd.Function):
    """The forward with ``ln_dense_bwd`` as its backward (the custom VJP
    ``ln_dense_diff`` of the JAX package). Saves x, gamma, beta and the
    weight, as ``_fwd`` does; the row statistics are recomputed."""

    @staticmethod
    def forward(ctx, x, gamma, beta, weight, bias, eps):
        ctx.eps, ctx.has_bias = eps, bias is not None
        ctx.save_for_backward(x, gamma, beta, weight)
        return _forward(x, gamma, beta, weight, bias, eps)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        grads = ln_dense_bwd(*ctx.saved_tensors, g, ctx.has_bias, ctx.eps)
        return (*grads, None)


def ln_dense_diff(x, gamma, beta, weight, bias, eps: float = 1e-6
                  ) -> torch.Tensor:
    """x (M, C), gamma and beta (C,), weight (O, C), bias (O,) or None;
    returns (M, O) in x's dtype, differentiable through the backward
    kernels (their plain version on the CPU)."""
    return _LnDense.apply(x, gamma, beta, weight, bias, eps)


def ln_dense(x, gamma, beta, weight, bias=None, *, eps: float = 1e-6
             ) -> torch.Tensor:
    """``ln_dense_diff`` where autograd records, else the forward alone."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, gamma, beta, weight, bias)):
        return ln_dense_diff(x, gamma, beta, weight, bias, eps)
    return _forward(x, gamma, beta, weight, bias, eps)


def ln_dense_or_none(x, gamma, beta, weight, bias=None, *, eps: float = 1e-6
                     ) -> Optional[torch.Tensor]:
    """The fused LN + Dense where it applies, else None (the caller runs
    the unfused composition). x may be (..., C); the output keeps the
    leading dims. ``TFIMM_TPU_LN_DENSE=0`` opts out; float16 and C above
    the dx kernel's tile decline."""
    if os.environ.get("TFIMM_TPU_LN_DENSE", "1") != "1":
        return None
    c = x.shape[-1]
    if x.dtype not in KERNEL_DTYPES or dx_block_rows(c, x.element_size()) is None:
        return None
    log_dispatch("ln_dense")
    lead = x.shape[:-1]
    y = ln_dense_diff(x.reshape(-1, c).contiguous(), gamma, beta, weight,
                      bias, eps)
    return y.reshape(*lead, weight.shape[0])
