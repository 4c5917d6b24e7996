"""A whole Swin transformer block on window-partitioned tokens (inference).

Counterpart of ``tfimm_tpu/ops/pallas/swin_block.py · swin_block_fused``.
On x (BW, N, C), the windows of a (rolled) feature map, it returns

    X2  = x + proj(window_attention(LN1(x)))
    out = X2 + fc2(gelu(fc1(LN2(X2))))

in x's dtype, with the Pallas kernel's roundings: LN in f32 with the
one-pass variance (eps 1e-5) and H1 rounded to the dtype; q, k, v, the
attention output A and P = proj(A) each rounded to the dtype; X2 kept in
f32; H2 rounded; fc1 rounded to the dtype before the GELU of the kernel's
dtype policy (tanh form in bf16/f16, exact erf in f32, whatever
``TFIMM_TPU_EXACT_GELU`` says); one rounding at the end. The attention is
``window_mha_reference``'s function. Weights are in the port's Dense layout:
w_qkv (3C, C), w_proj (C, C), w1 (hidden, C), w2 (C, hidden).

On a CUDA tensor ``swin_block`` launches the hand-written kernel of
``tfimm_tpu_torch/csrc/swin_block.cu`` (see the note at its top for the
design and what bounds it) and raises on what it does not take; on CPU
tensors it runs ``swin_block_reference``. In bf16 its four products run
``csrc/mlp_gemm.cuh``'s TMA + wgmma body: the wrapper hands the kernel
contiguous 16-byte aligned operands and their tensor maps, and raises where
``tma.gemm_route`` declines them (a hidden width off a multiple of 8). On
that body fc1's tanh GELU is s / (1 + e^(-2u)) after the rounding. In f32
they run the FMA body. Its attention takes ``window_mha``'s TMA + wgmma body
where ``tma.window_route`` takes the qkv scratch's slices (bf16, N <= 64,
d <= 64), with their maps. It has no backward: Swin calls it only where
autograd is not recording.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from tfimm_tpu_torch.ops.kernels.dispatch import launch
from tfimm_tpu_torch.ops.kernels.tma import (
    F32_BYTES,
    GemmProduct,
    gemm_route,
    packed_gemm_maps,
    packed_window_maps,
    sm_count,
    window_route,
)
from tfimm_tpu_torch.ops.kernels.window_mha import (
    DTYPE_CODES,
    MAX_HEAD_DIM,
    MAX_TOKENS,
    window_mha_reference,
    window_mha_supports,
)

__all__ = ["SwinBlockParams", "swin_block", "swin_block_reference",
           "swin_gemm_products"]


class SwinBlockParams(NamedTuple):
    """The tensors of one block, in the port's layout."""

    ln1_w: torch.Tensor
    ln1_b: torch.Tensor
    w_qkv: torch.Tensor
    b_qkv: torch.Tensor
    w_proj: torch.Tensor
    b_proj: torch.Tensor
    ln2_w: torch.Tensor
    ln2_b: torch.Tensor
    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor


def _layer_norm(x32, weight, bias, eps):
    mean = x32.mean(dim=-1, keepdim=True)
    var = torch.clamp(x32.square().mean(dim=-1, keepdim=True) - mean.square(),
                      min=0.0)
    return (x32 - mean) * torch.rsqrt(var + eps) * weight + bias


def swin_block_reference(x, params: SwinBlockParams, bias,
                         mask: Optional[torch.Tensor] = None, *,
                         nb_heads: int, scale: float,
                         eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch twin of the kernel (the Pallas body,
    ``swin_block.py:161-211`` in the JAX package)."""
    dt = x.dtype
    acc = torch.promote_types(dt, torch.float32)
    p = SwinBlockParams(*(t.to(acc) if t.dim() == 1 else t.to(dt).to(acc)
                          for t in params))
    c = x.shape[-1]

    def dense(h, w, b):
        return (torch.matmul(h.to(acc), w.t()) + b).to(dt)

    x32 = x.to(acc)
    h1 = _layer_norm(x32, p.ln1_w, p.ln1_b, eps).to(dt)
    qkv = dense(h1, p.w_qkv, p.b_qkv)
    a = window_mha_reference(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:],
                             bias, mask, nb_heads=nb_heads, scale=scale)
    x2 = x32 + dense(a, p.w_proj, p.b_proj).to(acc)
    h2 = _layer_norm(x2, p.ln2_w, p.ln2_b, eps).to(dt)
    m1 = dense(h2, p.w1, p.b1).to(acc)
    approximate = "tanh" if dt in (torch.bfloat16, torch.float16) else "none"
    m1 = F.gelu(m1, approximate=approximate).to(dt)
    return (x2 + (torch.matmul(m1.to(acc), p.w2.t()) + p.b2)).to(dt)


def _check_kernel_inputs(x, params, bias, mask, nb_heads):
    """Raise on inputs the kernel does not take."""
    tensors = [x, bias, *params] + ([mask] if mask is not None else [])
    devices = {t.device for t in tensors}
    if len(devices) > 1 or x.device.type != "cuda":
        raise ValueError(f"swin_block: all inputs must lie on one CUDA device; "
                         f"got {sorted(map(str, devices))}")
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"swin_block: x must be bf16 or f32; got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"swin_block: x must be a contiguous (BW, N, C); got "
                         f"{tuple(x.shape)}")
    bw, n, c = x.shape
    if not window_mha_supports(n, c, nb_heads):
        raise ValueError(f"swin_block: the attention takes N <= {MAX_TOKENS} "
                         f"and a head dim that is a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}; got N={n}, C={c}, H={nb_heads}")
    hidden = params.w1.shape[0]
    shapes = {"ln1_w": (c,), "ln1_b": (c,), "w_qkv": (3 * c, c),
              "b_qkv": (3 * c,), "w_proj": (c, c), "b_proj": (c,),
              "ln2_w": (c,), "ln2_b": (c,), "w1": (hidden, c),
              "b1": (hidden,), "w2": (c, hidden), "b2": (c,)}
    for name, want in shapes.items():
        got = tuple(getattr(params, name).shape)
        if got != want:
            raise ValueError(f"swin_block: {name} must be {want}; got {got}")
    if tuple(bias.shape) != (nb_heads, n, n):
        raise ValueError(f"swin_block: bias must be {(nb_heads, n, n)}; got "
                         f"{tuple(bias.shape)}")
    if mask is not None and (mask.dim() != 3 or tuple(mask.shape[1:]) != (n, n)
                             or bw % mask.shape[0]):
        raise ValueError(f"swin_block: mask must be (nW, {n}, {n}) with nW "
                         f"dividing BW={bw}; got {tuple(mask.shape)}")


def swin_gemm_products(m: int, c: int, hidden: int, sms: int):
    """The bf16 block's four products on ``sms`` SMs, in launch order, as
    ``tma.packed_gemm_maps`` takes them: qkv (LN1 prologue on x), proj (x
    the bf16 shortcut, X2 the f32 output), fc1 (LN2 prologue on the f32
    X2) and fc2 (X2 the f32 shortcut); their kernels have 192-column
    tiles."""
    f32 = F32_BYTES
    return (GemmProduct(m, 3 * c, c, True, False, sms, w192=True),
            GemmProduct(m, c, c, False, True, sms, out_bytes=f32, w192=True),
            GemmProduct(m, hidden, c, True, False, sms, a_bytes=f32,
                        w192=True),
            GemmProduct(m, c, hidden, False, True, sms, sc_bytes=f32,
                        w192=True))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous with a 16-byte aligned base (a copy where it is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def swin_block(x, params: SwinBlockParams, bias,
               mask: Optional[torch.Tensor] = None, *, nb_heads: int,
               scale: float, eps: float = 1e-5) -> torch.Tensor:
    """x (BW, N, C) windows; ``params`` the block's tensors; bias (H, N, N);
    mask (nW, N, N) or None. Returns (BW, N, C) in x's dtype. Runs the plain
    version when every input lies on the CPU and the kernel otherwise."""
    tensors = [x, bias, *params] + ([mask] if mask is not None else [])
    if all(t.device.type == "cpu" for t in tensors):
        return swin_block_reference(x, params, bias, mask, nb_heads=nb_heads,
                                    scale=scale, eps=eps)
    _check_kernel_inputs(x, params, bias, mask, nb_heads)
    from tfimm_tpu_torch.ops.kernels.build import kernel_library

    dt, dev = x.dtype, x.device
    bw, n, c = x.shape
    out = torch.empty_like(x)
    if bw == 0:
        return out
    m, hidden = bw * n, params.w1.shape[0]
    # The kernel reads the matrices in the dtype and the vectors in f32; for
    # a model cast to the dtype the matrices pass through unchanged.
    p = [t.float().contiguous() if t.dim() == 1 else _aligned(t.to(dt))
         for t in params]
    bias = bias.float().contiguous()
    nb_win = 1
    if mask is not None:
        mask = mask.float().contiguous()
        nb_win = mask.shape[0]
    scratch = {"qkv": torch.empty((m, 3 * c), dtype=dt, device=dev),
               "attn": torch.empty((m, c), dtype=dt, device=dev),
               "x2": torch.empty((m, c), dtype=torch.float32, device=dev),
               "hid": torch.empty((m, hidden), dtype=dt, device=dev),
               "mean": torch.empty((m,), dtype=torch.float32, device=dev),
               "rstd": torch.empty((m,), dtype=torch.float32, device=dev)}
    maps = attn_maps = None
    if dt == torch.bfloat16:
        x = _aligned(x)
        mats = SwinBlockParams(*p)
        if not gemm_route(x.view(m, c), mats.w_qkv, mats.w_proj, mats.w1,
                          mats.w2,
                          scratch["qkv"], scratch["attn"], scratch["hid"],
                          out.view(m, c), ln_depth=c, f32=(scratch["x2"],)):
            raise ValueError(f"swin_block: bf16 runs the TMA + wgmma GEMMs, "
                             f"which need C and hidden multiples of 8 and C "
                             f"at most 4096; got C={c}, hidden={hidden}")
        sms = sm_count(dev.index)
        maps = packed_gemm_maps(*swin_gemm_products(m, c, hidden, sms))
        # The attention reads the three slices of the qkv scratch in place.
        qkv = scratch["qkv"].view(bw, n, 3 * c)
        d = c // nb_heads
        if window_route(n, d, *(qkv[..., i * c:(i + 1) * c]
                                for i in range(3))):
            rows = qkv.stride()[:2]
            attn_maps = packed_window_maps(bw, n, nb_heads, d, rows, rows,
                                           rows, sms)
    launch("swin_block", kernel_library().tfimm_swin_block, x, *p[:4], bias,
           mask, *p[4:], *scratch.values(), out, bw, n, c, nb_heads, hidden,
           nb_win, float(eps), float(scale), DTYPE_CODES[dt], maps,
           attn_maps)
    return out
