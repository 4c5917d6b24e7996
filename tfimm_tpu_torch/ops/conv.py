"""Convolutions on NHWC input; the parts of tfimm_tpu/ops/conv.py that the
ported families use.

``Conv2d`` takes the JAX layer's stride, dilation, groups and padding
modes. Where its stride equals its kernel and it pads nothing, dilates
nothing and has one group (ViT's patch embedding, ConvNeXt's stem and
downsampling, 1x1 convs), the patches are a reshape of the image: they are
multiplied with the flattened OIHW weight through ``F.linear``, which is
exactly the convolution and never meets cuDNN's default TF32 convolutions.
Every other conv (ResNet's, VGG's, the grouped ones, SAM's 3x3 neck conv)
is ``F.conv2d`` on the channels-last view of the NHWC tensor, as the JAX
package leaves it to XLA; the NHWC view of the result is returned, so
neither side is copied. In f32 on the card its precision follows
``torch.backends.cudnn.allow_tf32``.

``DepthwiseConv2d`` is ConvNeXt's 7x7 depthwise conv, computed by
``F.conv2d`` the same way. EfficientNet's depthwise convs (stride 1 or 2,
no bias, either padding) are ``Conv2d`` with ``groups`` = channels.

``StdConv2d`` is BiT's weight-standardised ``Conv2d`` (ResNetV2 and the
hybrid ViTs' backbones): the same routes, on a weight standardised at every
call.

``Conv1d`` is ECA's 1-D conv across channels (``ops/se.py``).

``ConvTranspose2d`` is SAM's mask-decoder upscaling, ``F.conv_transpose2d``
on the channels-first view (the JAX package's ``ConvTranspose2d`` in
``segment_anything/mask_decoder.py``).

A conv that ``quantize_int8`` converted (``basic.Int8Layer``) takes the JAX
layer's three ways, not the routes above: a 1x1, stride-1, undilated,
unpadded, ungrouped conv is a matmul through ``quant.int8_dense_matmul``
(a scale a position); a 4-D ``weight_q`` with one group goes through
``quant.int8_conv`` (one scale for the whole tensor), a KxK stride-K conv
the reshape route would take included; any other (a grouped conv, a 1x1
off the matmul geometry) is dequantized in ``_kernel`` and convolved in
float. ``StdConv2d`` declines both int8 products: standardisation must see
the float weight. A quantized ``ConvTranspose2d`` raises, as the JAX
decoder, which reads its ``kernel`` leaf, fails.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from tfimm_tpu_torch.ops.basic import Int8Layer, trunc_normal_
from tfimm_tpu_torch.utils.etc import to_2tuple

__all__ = ["Conv2d", "StdConv2d", "DepthwiseConv2d", "Conv1d",
           "ConvTranspose2d", "same_pads"]


def same_pads(size: int, window: int, stride: int) -> Tuple[int, int]:
    """XLA's "SAME" padding of one axis: (before, after), the larger after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


class Conv2d(Int8Layer):
    """2-D convolution of (B, H, W, C) maps. Parameters: ``weight`` (out,
    in / groups, kh, kw) and ``bias`` (out,), or no bias with
    ``use_bias=False``.

    ``stride`` defaults to the kernel size and ``padding`` to 0 (the
    patchify convs); ``padding`` is an int or a pair (zeros on both sides
    of H and W), ``"valid"`` (none), ``"symmetric"`` (``d * (k - 1) // 2``
    on both sides, timm's) or ``"same"`` (XLA's SAME, the larger pad
    after). ``zero_bias`` starts the bias at zero (ConvNeXt's stem and
    downsampling); ``weight_std`` draws the weight from a truncated normal,
    ``fanout_init`` from EfficientNet's normal with std sqrt(2 / fan out),
    fan out = kh * kw * out / groups (the JAX ``FanoutInitializer``), else
    it is PyTorch's uniform in +-1/sqrt(fan in).
    """

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Union[int, Tuple[int, int]], *,
                 stride: Optional[Union[int, Tuple[int, int]]] = None,
                 padding: Union[str, int, Tuple[int, int]] = 0,
                 dilation: Union[int, Tuple[int, int]] = 1, groups: int = 1,
                 use_bias: bool = True, weight_std: Optional[float] = None,
                 zero_bias: bool = False, fanout_init: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if in_channels % groups or out_channels % groups:
            raise ValueError(f"channels {in_channels} -> {out_channels} not "
                             f"divisible by {groups} groups")
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = to_2tuple(kernel_size)
        self.stride = to_2tuple(self.kernel_size if stride is None else stride)
        self.dilation = to_2tuple(dilation)
        self.groups = groups
        if padding == "symmetric":
            padding = tuple(d * (k - 1) // 2
                            for k, d in zip(self.kernel_size, self.dilation))
        elif padding == "valid":
            padding = 0
        elif padding == "same" and self.stride == (1, 1):
            # At stride 1 SAME pads d * (k - 1) whatever the map's size:
            # resolved here where it splits evenly (a 1x1 conv then takes
            # the reshape route below).
            totals = [d * (k - 1) for k, d in zip(self.kernel_size,
                                                  self.dilation)]
            if all(t % 2 == 0 for t in totals):
                padding = tuple(t // 2 for t in totals)
        elif padding != "same":
            padding = to_2tuple(padding)
            padding = tuple(int(p) for p in padding)
        self.padding = padding
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels // groups, *self.kernel_size))
        self.bias = (nn.Parameter(torch.empty(out_channels)) if use_bias
                     else None)
        fan_in = in_channels // groups * self.kernel_size[0] * self.kernel_size[1]
        bound = 1.0 / math.sqrt(fan_in)
        with torch.no_grad():
            if weight_std is not None:
                trunc_normal_(self.weight, weight_std, generator)
            elif fanout_init:
                fan_out = (self.kernel_size[0] * self.kernel_size[1]
                           * out_channels // groups)
                self.weight.normal_(0.0, math.sqrt(2.0 / fan_out),
                                    generator=generator)
            else:
                self.weight.uniform_(-bound, bound, generator=generator)
            if self.bias is not None:
                if zero_bias:
                    self.bias.zero_()
                else:
                    self.bias.uniform_(-bound, bound, generator=generator)
        self.patchify = (self.stride == self.kernel_size
                         and self.padding in (0, (0, 0))
                         and self.dilation == (1, 1) and groups == 1)

    # Weight-standardised subclasses clear this: a quantized weight is then
    # dequantized in ``_kernel`` and never takes an int8 product.
    _INT8_CONV = True

    def _kernel(self, dtype: torch.dtype) -> torch.Tensor:
        """The weight the conv multiplies by, in ``dtype`` (a quantized
        one dequantized)."""
        if self.quantized:
            return self._dequantized(dtype)
        return self.weight.to(dtype)

    def _int8_matmul_ok(self) -> bool:
        """1x1, stride 1, undilated, ungrouped, no padding: the conv is a
        matmul over channels."""
        return (self.kernel_size == (1, 1) and self.stride == (1, 1)
                and self.dilation == (1, 1) and self.groups == 1
                and self.padding in (0, (0, 0), "same"))

    def int8_pads(self, x: torch.Tensor):
        """((top, bottom), (left, right)) zero padding of the (B, H, W, C)
        input ``x``."""
        if self.padding == "same":
            return tuple(same_pads(size, d * (k - 1) + 1, s) for size, k, d, s
                         in zip(x.shape[1:3], self.kernel_size, self.dilation,
                                self.stride))
        ph, pw = to_2tuple(self.padding)
        return (ph, ph), (pw, pw)

    def _int8_forward(self, x: torch.Tensor) -> Optional[torch.Tensor]:
        """The JAX layer's int8 products, or None where it convolves in
        float."""
        from tfimm_tpu_torch.quant import int8_conv, int8_dense_matmul

        if self._int8_matmul_ok():
            y = int8_dense_matmul(self, x)
        elif self.weight_q.dim() == 4 and self.groups == 1:
            y = int8_conv(self, x, self.stride, self.int8_pads(x),
                          self.dilation)
        else:
            return None
        return y if self.bias is None else y + self.bias.to(y.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quantized and self._INT8_CONV:
            y = self._int8_forward(x)
            if y is not None:
                return y
        weight = self._kernel(x.dtype)
        bias = self.bias.to(x.dtype) if self.bias is not None else None
        if self.patchify:
            (kh, kw), (b, h, w, c) = self.kernel_size, x.shape
            gh, gw = h // kh, w // kw
            x = x[:, :gh * kh, :gw * kw]
            patches = (x.reshape(b, gh, kh, gw, kw, c)
                       .permute(0, 1, 3, 5, 2, 4)      # (B, gh, gw, C, kh, kw)
                       .reshape(b, gh, gw, c * kh * kw))
            return F.linear(patches, weight.reshape(self.out_channels, -1),
                            bias)
        x = x.permute(0, 3, 1, 2)
        padding = self.padding
        if padding == "same":
            pads = [same_pads(size, d * (k - 1) + 1, s) for size, k, d, s in
                    zip(x.shape[2:], self.kernel_size, self.dilation,
                        self.stride)]
            if all(lo == hi for lo, hi in pads):
                padding = tuple(lo for lo, _ in pads)
            else:
                x = F.pad(x, (*pads[1], *pads[0]))
                padding = 0
        y = F.conv2d(x, weight, bias, self.stride, padding, self.dilation,
                     self.groups)
        return y.permute(0, 2, 3, 1).contiguous()


class StdConv2d(Conv2d):
    """Weight-standardised ``Conv2d`` (BiT; the JAX layer's ``StdConv2d``):
    at every call each output channel's weight, over its (in / groups, kh,
    kw) taps, becomes ``(w - mean) * rsqrt(var + eps)`` in float32, with the
    population variance, then x's dtype. Under autograd the gradient flows
    through the standardisation to the raw ``weight``, which is what the
    optimizer and the L2 penalty see (the JAX ``kernel`` leaf)."""

    _INT8_CONV = False

    def __init__(self, *args, eps: float = 1e-8, **kwargs):
        super().__init__(*args, **kwargs)
        self.eps = eps

    def _kernel(self, dtype: torch.dtype) -> torch.Tensor:
        w = self._dequantized(torch.float32) if self.quantized \
            else self.weight.float()
        var, mean = torch.var_mean(w, dim=(1, 2, 3), keepdim=True,
                                   correction=0)
        return ((w - mean) * torch.rsqrt(var + self.eps)).to(dtype)


class DepthwiseConv2d(Int8Layer):
    """Depthwise ``kernel_size`` x ``kernel_size`` conv, stride 1, "same"
    padding, one filter per channel. Parameters: ``weight`` (C, 1, k, k),
    initialised as ConvNeXt does (truncated normal, std 0.02), and ``bias``
    (C,), zero. (B, H, W, C) -> (B, H, W, C)."""

    def __init__(self, channels: int, kernel_size: int = 7, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.channels = channels
        self.padding = kernel_size // 2
        self.weight = nn.Parameter(
            torch.empty(channels, 1, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(channels))
        with torch.no_grad():
            trunc_normal_(self.weight, 0.02, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight = (self._dequantized(x.dtype) if self.quantized
                  else self.weight.to(x.dtype))
        y = F.conv2d(x.permute(0, 3, 1, 2), weight,
                     self.bias.to(x.dtype), padding=self.padding,
                     groups=self.channels)
        return y.permute(0, 2, 3, 1)


class Conv1d(nn.Module):
    """1-D conv of (B, in, L) input, zero padding ``padding`` on both
    sides, no bias: ECA's conv across channels. Parameter: ``weight``
    (out, in, k), the JAX layer's (k, in, out) kernel transposed, uniform
    in +-1/sqrt(in k) at init."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 *, padding: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.padding = padding
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel_size))
        bound = 1.0 / math.sqrt(in_channels * kernel_size)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv1d(x, self.weight.to(x.dtype), padding=self.padding)


class ConvTranspose2d(Int8Layer):
    """Transposed conv on NHWC maps, no padding. Parameters: ``weight``
    (in, out, k, k), PyTorch's ``nn.ConvTranspose2d`` layout, and ``bias``.

    The JAX package keeps its kernel as (k, k, in, out) in PyTorch's tap
    order and flips it only to make ``lax.conv_transpose`` compute what
    ``F.conv_transpose2d`` computes; here that kernel is taken as
    ``transpose(2, 3, 0, 1)``, with no flip (``utils/convert.py``). In f32
    on the card its precision follows ``torch.backends.cudnn.allow_tf32``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(
            torch.empty(in_channels, out_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels))
        bound = 1.0 / math.sqrt(in_channels * kernel_size ** 2)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quantized:
            raise NotImplementedError(
                "an int8-quantized ConvTranspose2d has no int8 or float path "
                "(the JAX decoder reads its float kernel): quantize_int8 "
                "converts SAM's output_upscaling only with convs=True and "
                "min_conv_features <= 64; leave it out with "
                "skip=DEFAULT_SKIP + ('output_upscaling',)")
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype),
                               self.bias.to(x.dtype), stride=self.stride)
        return y.permute(0, 2, 3, 1)
