"""Post-training int8 quantization for inference; counterpart of
tfimm_tpu/quant.py.

``quantize_int8`` returns a copy of a model whose eligible ``Dense`` layers
(and 1x1 ConvMLP convs, and with ``convs=True`` wide KxK convs) hold their
weights as symmetric per-output-channel int8 (``basic.Int8Layer``). At call
time the activations are quantized dynamically, per token for a Dense and
a 1x1 conv and over the whole tensor for a KxK conv, multiplied int8 x
int8 with int32 accumulation (``torch._int_mm``, PyTorch's int8 GEMM),
and rescaled to the activation's dtype. On the CPU the results equal the
JAX package's bit for bit: the same roundings in the same order, and the
integer products are exact in any order.

Rules carried over as the JAX package states them:

- eligibility is decided on the JAX layout of each layer's weight, under
  its module path, which is the JAX tree path (``utils/convert.py``): a
  Dense, or a 1x1 conv named ``fc1``/``fc2`` in the MLP orientation (an
  SE gate, reduce then expand, stays float), with both channel sizes at
  least ``min_features``; a KxK conv only with ``convs=True`` and both
  channel sizes at least ``min_conv_features``; nothing whose path holds a
  ``skip`` substring, nothing named exactly ``fc`` (timm's CNN heads), no
  LoRA layer;
- weights are cast to float32 first (a bf16 model quantizes its bf16
  values) and scaled per output channel by ``max(absmax, 1e-8) / 127``;
- the int8 weights are frozen: the backward is the straight-through one,
  through the dequantized weight in the gradient's dtype.

``torch._int_mm`` takes, on the card, more than 16 rows and inner and
outer sizes that are multiples of 8; ``int_mm`` pads other shapes with
zeros (exact) on every device, so the CPU runs what the card runs.
"""

from __future__ import annotations

import copy
from typing import Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from tfimm_tpu_torch.ops.basic import Int8Layer, dequantize
from tfimm_tpu_torch.ops.conv import same_pads
from tfimm_tpu_torch.utils.convert import _jax_leaf

__all__ = ["quantize_int8", "int8_dense_matmul", "int8_conv",
           "is_quantized", "any_quantized"]

# Substrings of module paths whose layers are never quantized: the
# classifier heads (accuracy; a negligible share of the FLOPs).
DEFAULT_SKIP: Tuple[str, ...] = (
    "head", "pre_logits", "classifier", "fc_dist", "last_linear",
)

# The shapes torch._int_mm takes on the card: rows, and a multiple for the
# inner and outer sizes.
_MIN_ROWS = 17
_MULTIPLE = 8


def _is_int8(module: nn.Module) -> bool:
    return isinstance(module, Int8Layer) and module.quantized


def any_quantized(*modules: nn.Module) -> bool:
    """True when any of ``modules`` holds an int8 weight: the gate helper
    of the fused kernels, which read several layers' weights raw, so that
    a ``skip`` list that quantizes only some of them declines the
    kernel."""
    return any(_is_int8(m) for m in modules)


def is_quantized(model: nn.Module) -> bool:
    """True if any layer of ``model`` has been int8-quantized."""
    return any(_is_int8(m) for m in model.modules())


def int_mm(a: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 ``a`` times the transpose of the (N, K) int8 ``wq`` in
    int32, through ``torch._int_mm``, with zeros padded up to the shapes it
    takes on the card (more than 16 rows, K and N multiples of 8)."""
    m, k = a.shape
    n = wq.shape[0]
    mp = max(m, _MIN_ROWS)
    kp = -(-k // _MULTIPLE) * _MULTIPLE
    np_ = -(-n // _MULTIPLE) * _MULTIPLE
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        wq = F.pad(wq, (0, kp - k, 0, np_ - n))
    acc = torch._int_mm(a.contiguous(), wq.contiguous().t())
    return acc[:m, :n] if (mp, np_) != (m, n) else acc


def _quantize(xf: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """round(x / s) clipped to [-127, 127], in int8 (ties to even, as
    ``jnp.round``)."""
    return torch.round(xf / s).clamp_(-127.0, 127.0).to(torch.int8)


def _tensors(layer_or_tensors) -> Tuple[torch.Tensor, torch.Tensor]:
    if isinstance(layer_or_tensors, nn.Module):
        return layer_or_tensors.weight_q, layer_or_tensors.weight_scale
    wq, ws = layer_or_tensors
    return wq, ws


def _dense_forward(x, wq, ws):
    k = x.shape[-1]
    xf = x.float().reshape(-1, k)
    s = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-6) * (1.0 / 127.0)
    acc = int_mm(_quantize(xf, s), wq)
    y = acc.float().mul_(s).mul_(ws.float())          # (acc * s) * ws
    return y.to(x.dtype).reshape(*x.shape[:-1], wq.shape[0])


class _Int8Dense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wq, ws):
        ctx.save_for_backward(wq, ws)
        ctx.x_dtype = x.dtype
        return _dense_forward(x, wq, ws)

    @staticmethod
    def backward(ctx, g):
        wq, ws = ctx.saved_tensors
        w = dequantize(wq, ws).to(g.dtype)             # (out, in)
        return torch.matmul(g, w).to(ctx.x_dtype), None, None


def int8_dense_matmul(layer_or_tensors, x: torch.Tensor) -> torch.Tensor:
    """Dynamic-activation int8 matmul (``tfimm_tpu/quant.py:69``).

    ``layer_or_tensors``: a quantized ``Dense`` or 1x1 ``Conv2d``, or the
    pair (``weight_q`` (out, in) int8, ``weight_scale`` (out,) float32).
    ``x``: (..., in) float. Each row of x gets the scale
    ``max(absmax, 1e-6) / 127``; the int32 product is rescaled as
    ``(acc * s) * ws`` in float32, then x's dtype. No bias. The backward
    is straight-through: ``g @ (weight_q * weight_scale)`` in g's dtype;
    the int8 weight and the scale get no gradient.
    """
    wq, ws = _tensors(layer_or_tensors)
    if torch.is_grad_enabled() and x.requires_grad:
        return _Int8Dense.apply(x, wq, ws)
    return _dense_forward(x, wq, ws)


def _conv_pads(padding, hw, kernel, strides, dilation):
    """((top, bottom), (left, right)) of ``padding``: "SAME", "VALID" (in
    any case) or explicit (lo, hi) pairs."""
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return (0, 0), (0, 0)
        if padding.upper() == "SAME":
            return tuple(same_pads(size, d * (k - 1) + 1, s) for size, k, d, s
                         in zip(hw, kernel, dilation, strides))
        raise ValueError(f"unknown padding {padding!r}")
    return tuple((int(lo), int(hi)) for lo, hi in padding)


def _im2col(q, kernel, strides, pads, dilation):
    """(B, H, W, C) -> (B * H' * W', C * kh * kw) patches in the order of
    an OIHW weight's flattening, zero padded by ``pads``."""
    (pt, pb), (pl, pr) = pads
    if pt or pb or pl or pr:
        q = F.pad(q, (0, 0, pl, pr, pt, pb))
    (kh, kw), (sh, sw), (dh, dw) = kernel, strides, dilation
    p = q.unfold(1, dh * (kh - 1) + 1, sh).unfold(2, dw * (kw - 1) + 1, sw)
    p = p[..., ::dh, ::dw]                              # (B, H', W', C, kh, kw)
    b, ho, wo = p.shape[:3]
    return p.reshape(b * ho * wo, -1), (b, ho, wo)


def _float_conv(x, w, strides, pads, dilation):
    (pt, pb), (pl, pr) = pads
    x = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb))
    return F.conv2d(x, w, None, strides, 0, dilation).permute(0, 2, 3, 1)


def _conv_forward(x, wq, ws, strides, pads, dilation):
    xf = x.float()
    s = xf.abs().amax().clamp_min(1e-6) * (1.0 / 127.0)
    patches, (b, ho, wo) = _im2col(_quantize(xf, s), wq.shape[2:], strides,
                                   pads, dilation)
    acc = int_mm(patches, wq.reshape(wq.shape[0], -1))
    y = acc.float().mul_(s * ws.float())                # acc * (s * ws)
    return y.to(x.dtype).reshape(b, ho, wo, wq.shape[0])


class _Int8Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wq, ws, strides, pads, dilation):
        ctx.save_for_backward(wq, ws)
        ctx.conv = (x.shape, x.dtype, strides, pads, dilation)
        return _conv_forward(x, wq, ws, strides, pads, dilation)

    @staticmethod
    def backward(ctx, g):
        wq, ws = ctx.saved_tensors
        shape, dtype, strides, pads, dilation = ctx.conv
        w = dequantize(wq, ws).to(g.dtype)
        with torch.enable_grad():   # the conv's VJP: linear in x
            xx = torch.zeros(shape, dtype=g.dtype, device=g.device,
                             requires_grad=True)
            y = _float_conv(xx, w, strides, pads, dilation)
            gx, = torch.autograd.grad(y, xx, g)
        return gx.to(dtype), None, None, None, None, None


def int8_conv(layer_or_tensors, x: torch.Tensor,
              strides: Sequence[int],
              padding: Union[str, Sequence[Sequence[int]]],
              dilation: Sequence[int]) -> torch.Tensor:
    """Dynamic-activation int8 KxK convolution (``tfimm_tpu/quant.py:118``).

    ``layer_or_tensors``: a quantized ``Conv2d`` with a 4-D ``weight_q``
    (out, in, kh, kw) int8, or the pair (``weight_q``, ``weight_scale``).
    ``x``: (B, H, W, in) float. ``padding``: "SAME", "VALID" or
    ((top, bottom), (left, right)). One scale ``max(absmax, 1e-6) / 127``
    over the whole tensor, the batch included (a KxK window spans
    positions, so the scale cannot vary by position); the int8 patches
    (im2col) times the flattened weight in int32, rescaled as
    ``acc * (s * ws)`` in float32, then x's dtype. No bias. The backward
    is straight-through, the float conv's VJP against the dequantized
    weight.
    """
    wq, ws = _tensors(layer_or_tensors)
    strides, dilation = tuple(strides), tuple(dilation)
    pads = _conv_pads(padding, x.shape[1:3], wq.shape[2:], strides, dilation)
    if torch.is_grad_enabled() and x.requires_grad:
        return _Int8Conv.apply(x, wq, ws, strides, pads, dilation)
    return _conv_forward(x, wq, ws, strides, pads, dilation)


def set_int8(layer: Int8Layer, weight_q: torch.Tensor,
             weight_scale: torch.Tensor) -> None:
    """Replace ``layer``'s ``weight`` parameter by the buffers ``weight_q``
    and ``weight_scale`` (on the weight's device)."""
    device = layer.weight.device
    layer.int8_weight_shape = tuple(layer.weight.shape)
    del layer.weight
    layer.register_buffer("weight_q", weight_q.to(device, torch.int8))
    layer.register_buffer("weight_scale",
                          weight_scale.to(device, torch.float32))


def _eligible(k: Tuple[int, ...], path: Tuple[str, ...], *, min_features,
              skip, convs, min_conv_features) -> bool:
    """``tfimm_tpu/quant.py · eligible`` on the JAX-layout shape ``k`` of a
    kernel at ``path`` (LoRA layers are left out by the caller)."""
    skipped = any(s in comp for comp in path for s in skip)
    if path and path[-1] == "fc":
        return False
    if len(k) == 4 and (k[0] != 1 or k[1] != 1):
        return convs and min(k[2], k[3]) >= min_conv_features and not skipped
    if len(k) == 4:
        if not path or path[-1] not in ("fc1", "fc2"):
            return False
        cin, cout = k[2], k[3]
        if path[-1] == "fc1" and cout < cin:
            return False
        if path[-1] == "fc2" and cin < cout:
            return False
    elif len(k) != 2:
        return False
    return min(k[-2:]) >= min_features and not skipped


def _convert_kernel(w: torch.Tensor):
    """``tfimm_tpu/quant.py · convert_kernel`` on a float32 JAX-layout
    kernel: (int8 kernel, 1x1 convs as (in, out); per-output-channel
    float32 scale)."""
    if w.dim() == 4 and w.shape[0] == w.shape[1] == 1:
        w = w.reshape(w.shape[2], w.shape[3])
    axes = (0, 1, 2) if w.dim() == 4 else (0,)
    scale = w.abs().amax(dim=axes).clamp_min(1e-8) / 127.0
    return _quantize(w, scale), scale


def quantize_int8(model: nn.Module, *, min_features: int = 256,
                  skip: Tuple[str, ...] = DEFAULT_SKIP, convs: bool = False,
                  min_conv_features: int = 128) -> nn.Module:
    """A copy of ``model`` with its eligible layers in int8 (the module
    docstring's rules, ``tfimm_tpu/quant.py:196``); ``model`` is left as it
    is. Biases and every other tensor are untouched. The copy's dtype
    casts leave ``weight_q`` int8 and ``weight_scale`` float32.

    The weights are quantized on the CPU, so a model on the card gets the
    same int8 values as on the CPU. ``convs=True`` also converts KxK,
    K > 1, convs with both channel sizes at least ``min_conv_features``; a
    grouped conv that qualifies dequantizes at call time, and
    ``StdConv2d`` (BiT) always does.
    """
    out = copy.deepcopy(model)
    rules = dict(min_features=min_features, skip=tuple(skip), convs=convs,
                 min_conv_features=min_conv_features)
    for name, module in out.named_modules():
        if not isinstance(module, Int8Layer) \
                or "weight" not in module._parameters \
                or "weight_lora_a" in module._parameters:
            continue
        leaf, perm = _jax_leaf(module, "weight")
        weight = module.weight
        if leaf != "kernel" or perm is None:
            continue
        shape = tuple(weight.shape[i] for i in perm)
        if not _eligible(shape, tuple(name.split(".")) if name else (),
                         **rules):
            continue
        w = weight.detach().to("cpu", torch.float32).permute(perm)
        wq, scale = _convert_kernel(w)
        if wq.dim() == 2:                 # (in, out) -> (out, in)
            wq = wq.t()
        else:                             # the inverse of perm
            wq = wq.permute(sorted(range(4), key=perm.__getitem__))
        set_int8(module, wq.contiguous(), scale)
    return out
