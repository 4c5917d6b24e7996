"""Kernel tests that need an NVIDIA card (marker ``cuda``); they skip
without one. This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest tests/test_torch_cuda.py --noconftest -q -p no:cacheprovider

Each CUDA kernel is held against its plain PyTorch version on the card.
fused_mha forward: 2e-2 in bf16 (the kernel rounds p to bf16 before p @ v), 1e-5 in
f32 with TF32 off (same math, another summation order). Backward:
max|diff| <= 2e-2 * max|plain| in bf16 (the kernel rounds p and ds to bf16
before their products), 1e-4 * max|plain| in f32 with TF32 off (sums in
another order). window_mha and swin_block: 2e-2 * max|plain| in bf16 (the
plain version rounds at the same places, the sums run in another order, so
a rounding may land on the other side); in f32 1e-5 * max|plain| for
window_mha and 1e-4 * max|plain| for swin_block, whose four products and
two LayerNorms each sum in another order. window_mha_bwd: dq, dk, dv and
dbias each within 2e-2 * max|plain| in bf16 (the kernel rounds p and ds to
bf16 before their products) and 1e-4 * max|plain| in f32 (sums in another
order; dbias sums over every window). flash_attention_relpos: the output
and the lse within 2e-2 * max|plain| in bf16 (the kernel rounds p to bf16
relative to its running max, the plain version relative to the row's max)
and 1e-5 * max|plain| in f32 (sums in another order). Its backward: dq,
dk, dv, drh and drw each within 2e-2 * max|plain| in bf16 (the kernel rounds
p and ds to bf16 before their products) and 1e-4 * max|plain| in f32 (sums
in another order; drh and drw sum over whole key rows and columns).
pvt_sra: 2e-2 * max|plain| in bf16 (the kernel rounds q, p and o where the
plain version does, its sums run in another order) and 1e-5 * max|plain|
in f32. poolformer_block: 2e-2 * max|plain| in bf16 and 1e-4 * max|plain|
in f32 (two whole-map GroupNorm reductions and two products, each summed
in another order). swin_block and poolformer_block are also held at their
models' stage shapes at batch 128 and chip_smoke.py's edges, on each GEMM
route (the profile names the body), and repeat bit for bit; the outputs of
mlp_gemm.cuh's other users (convnext_mlp, convnext_block, ln_dense's
forward) must keep the digests scripts/perf/torch_gemm_digests.py took of
them before swin_block and poolformer_block moved onto that GEMM.
convnext_block: 2e-2 * max|plain| in bf16 (the plain
version rounds z and h to bf16 at the same places; the sums run in another
order, so a rounding may land on the other side) and 1e-4 * max|plain| in
f32 (the 49 taps, the LayerNorm and two products, each summed in another
order). flash_attention: the output within 2e-2 * max|plain| in bf16 (the
kernel rounds p to bf16 relative to its running max, the plain version
relative to the row's max) and 1e-5 * max|plain| in f32, the lse within
1e-5 of max|lse| in both. Its backward: dq, dk and dv within 2e-2 *
max|plain| in bf16 (the kernel rounds p and ds to bf16 before their
products) and 1e-4 * max|plain| in f32 (sums in another order); at N = 1,
where dq and dk are 0, both versions' rounding noise within 1e-4 *
max|dv|. ln_dense: the output and dx within 2e-2 * max|plain| in bf16
(a rounding of z, y or dx may land on the other side) and 1e-5 in f32;
dgamma, dbeta, dW and db, which sum over every row, within 2e-2 and 1e-4.
float16
models (no kernel takes f16): logits within 5e-2 of max|f32| of the same
weights, with no launch. The bf16 fused_mha, its backward, the rel-pos
forward and the flash forward read their operands through TMA boxes of 64
rows x 64 columns: their tests also cover N and d around the boxes' edges,
a next row (image or head) of inf that a box running past N or d would
carry in as NaN, qkv (and g) at a storage offset, packed strided q, k, v
and bit-identical repeats, at the same bars; the backward also the clamp
input at every shape, with the unmasked backward missing the bar.
``fused_mha``'s no-grad op (``torch.ops.tfimm_tpu_torch.fused_mha``): its
fake function's shape, dtype and device are the real output's, its output
is bit for bit the wrapper's, and a small ViT exported on the card launches
the kernel once a block.
"""

import importlib
import itertools
import threading

import numpy as np
import pytest
import torch

from tfimm_tpu_torch.architectures.segment_anything import image_encoder
from tfimm_tpu_torch.architectures.swin import _attention_mask
from tfimm_tpu_torch.ops.conv import DepthwiseConv2d
from tfimm_tpu_torch.ops.kernels.cait_attention import (
    talking_head_attention,
    talking_head_attention_bwd,
    talking_head_attention_bwd_reference,
    talking_head_attention_packed,
    talking_head_attention_reference,
)
from tfimm_tpu_torch.ops.kernels import cait_attention as cait_module
from tfimm_tpu_torch.ops.kernels import dispatch
from tfimm_tpu_torch.ops.kernels import flash_attention as flash_module
from tfimm_tpu_torch.ops.kernels import flash_attention_relpos as relpos_module
from tfimm_tpu_torch.ops.kernels.convnext_block import (
    MAX_CHANNELS,
    convnext_block,
    convnext_block_reference,
)
from tfimm_tpu_torch.ops.kernels.convnext_mlp import (
    convnext_mlp,
    convnext_mlp_reference,
)
from tfimm_tpu_torch.core import Context
from tfimm_tpu_torch.ops.kernels.flash_attention_relpos import (
    flash_attention_relpos,
    flash_attention_relpos_bwd,
    flash_attention_relpos_bwd_reference,
    flash_attention_relpos_reference,
    flash_attention_relpos_with_lse,
    scale_query,
)
from tfimm_tpu_torch.ops.kernels.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_packed,
    flash_attention_reference,
    flash_attention_with_lse,
)
from tfimm_tpu_torch.ops.kernels.ln_dense import (
    ln_dense,
    ln_dense_bwd,
    ln_dense_bwd_reference,
    ln_dense_or_none,
    ln_dense_reference,
)
from tfimm_tpu_torch.ops.kernels.fused_mha import (
    fused_mha,
    fused_mha_bwd,
    fused_mha_bwd_reference,
    fused_mha_reference,
)
from tfimm_tpu_torch.ops.kernels.poolformer_block import (
    poolformer_block,
    poolformer_block_reference,
)
from tfimm_tpu_torch.ops.kernels.pvt_sra import pvt_sra, pvt_sra_reference
from tfimm_tpu_torch.ops.kernels.swin_block import (
    SwinBlockParams,
    swin_block,
    swin_block_reference,
)
from tfimm_tpu_torch.ops.kernels.window_mha import (
    window_mha,
    window_mha_bwd,
    window_mha_bwd_reference,
    window_mha_packed,
    window_mha_reference,
)

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


SHAPES = [(4, 197, 12, 64), (2, 65, 3, 64), (2, 50, 4, 32), (2, 17, 16, 80),
          (1, 130, 2, 128), (3, 9, 5, 8), (2, 100, 2, 24)]


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("b,n,h,d", SHAPES)
def test_fused_mha_kernel_matches_plain(card, b, n, h, d, dtype, tol):
    g = torch.Generator(device=card).manual_seed(b * n + h * d)
    qkv = torch.randn(b, n, 3 * h * d, generator=g, device=card).to(dtype)
    before = dispatch.launch_counts["fused_mha"]
    out = fused_mha(qkv, h, d ** -0.5)
    torch.cuda.synchronize()
    assert dispatch.launch_counts["fused_mha"] == before + 1
    ref = fused_mha_reference(qkv, h, d ** -0.5)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


def test_fused_mha_kernel_refuses_what_it_does_not_take(card):
    qkv = torch.zeros(2, 8, 3 * 64, device=card)
    with pytest.raises(ValueError):
        fused_mha(qkv.half(), 1, 0.125)
    with pytest.raises(ValueError):
        fused_mha(qkv[:, ::2], 1, 0.125)   # not contiguous
    with pytest.raises(ValueError):
        fused_mha(torch.zeros(2, 8, 3 * 2 * 12, device=card), 2, 0.125)
    with pytest.raises(ValueError):
        fused_mha_bwd(qkv, torch.zeros(2, 8, 32, device=card), 1, 0.125)


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("b,n,h,d", SHAPES)
def test_fused_mha_bwd_kernel_matches_plain(card, b, n, h, d, dtype, tol):
    gen = torch.Generator(device=card).manual_seed(b * n + h * d + 1)
    qkv = torch.randn(b, n, 3 * h * d, generator=gen, device=card).to(dtype)
    g = torch.randn(b, n, h * d, generator=gen, device=card).to(dtype)
    before = dispatch.launch_counts["fused_mha_bwd"]
    got = fused_mha_bwd(qkv, g, h, d ** -0.5)
    torch.cuda.synchronize()
    assert dispatch.launch_counts["fused_mha_bwd"] == before + 1
    want = fused_mha_bwd_reference(qkv, g, h, d ** -0.5).float()
    err = (got.float() - want).abs().max().item()
    assert err <= tol * want.abs().max().item(), err


def test_fused_mha_gives_a_gradient_through_the_kernels(card):
    b, n, h, d = 2, 50, 4, 32
    gen = torch.Generator(device=card).manual_seed(5)
    qkv = torch.randn(b, n, 3 * h * d, generator=gen, device=card)
    g = torch.randn(b, n, h * d, generator=gen, device=card)
    counts = dict(dispatch.launch_counts)
    x = qkv.clone().requires_grad_()
    fused_mha(x, h, d ** -0.5).backward(g)
    torch.cuda.synchronize()
    assert dispatch.launch_counts["fused_mha"] == counts["fused_mha"] + 1
    assert dispatch.launch_counts["fused_mha_bwd"] == counts["fused_mha_bwd"] + 1
    want = fused_mha_bwd_reference(qkv, g, h, d ** -0.5)
    assert (x.grad - want).abs().max() <= 1e-4 * want.abs().max()


# The TMA layout of the bf16 fused_mha (csrc/fused_mha.cu): N around the
# 64-row boxes and the 128-row blocks, every class of head dim (one and two
# 64-column chunks, zero-filled past d) and H from 1 to 16.
TMA_MHA_N = [1, 17, 64, 65, 196, 197, 256, 257, 1023]
TMA_MHA_D = [8, 16, 32, 48, 64, 80, 128]
TMA_MHA_H = [1, 3, 12, 16]


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("n,d", list(itertools.product(TMA_MHA_N, TMA_MHA_D)))
def test_fused_mha_kernel_matches_plain_at_the_tma_edges(card, n, d, dtype,
                                                         tol):
    for h in TMA_MHA_H:
        g = torch.Generator(device=card).manual_seed(n * 7 + d * 3 + h)
        qkv = torch.randn(2, n, 3 * h * d, generator=g, device=card).to(dtype)
        out = fused_mha(qkv, h, d ** -0.5)
        ref = fused_mha_reference(qkv, h, d ** -0.5)
        torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                   rtol=tol, msg=lambda m: f"H={h}: {m}")


def _next_row_inf(x):
    """x with every row but the first set to inf: a box of row 0 that ran
    past N into row 1 would carry 0 * inf = NaN into p @ v."""
    x = x.clone()
    x[1:] = float("inf")
    return x


@pytest.mark.parametrize("n", [17, 65, 197])
def test_fused_mha_boxes_stop_at_n(card, n):
    h, d = 3, 64
    g = torch.Generator(device=card).manual_seed(n)
    qkv = torch.randn(2, n, 3 * h * d, generator=g, device=card).bfloat16()
    out = fused_mha(_next_row_inf(qkv), h, d ** -0.5)
    ref = fused_mha_reference(qkv[:1], h, d ** -0.5)
    torch.testing.assert_close(out[:1].float(), ref.float(), atol=2e-2,
                               rtol=2e-2)


def test_fused_mha_reads_qkv_at_a_storage_offset(card):
    """qkv 16 bytes into its storage: the tensor maps start at its first
    element."""
    b, n, h, d = 2, 197, 12, 64
    g = torch.Generator(device=card).manual_seed(3)
    buf = torch.randn(b * n * 3 * h * d + 8, generator=g,
                      device=card).bfloat16()
    qkv = buf[8:].view(b, n, 3 * h * d)
    assert qkv.storage_offset() == 8 and qkv.data_ptr() % 16 == 0
    out = fused_mha(qkv, h, d ** -0.5)
    assert torch.equal(out, fused_mha(qkv.clone(), h, d ** -0.5))
    torch.testing.assert_close(out.float(),
                               fused_mha_reference(qkv, h, d ** -0.5).float(),
                               atol=2e-2, rtol=2e-2)


def test_fused_mha_kernel_clamps_like_plain(card):
    """Query 0 of every head points along keys 3 and 5, so that two of its
    scores pass 80: the kernel holds the clamped plain version, and the
    unclamped softmax is far from both."""
    b, n, h, d = 2, 197, 12, 64
    g = torch.Generator(device=card).manual_seed(4)
    x = torch.randn(b, n, 3, h, d, generator=g, device=card)
    x[:, 0, 0] = 20.0 * (x[:, 3, 1] + x[:, 5, 1])
    qkv = x.reshape(b, n, 3 * h * d).bfloat16()
    scale = d ** -0.5
    out = fused_mha(qkv, h, scale).float()
    ref = fused_mha_reference(qkv, h, scale).float()
    torch.testing.assert_close(out, ref, atol=2e-2, rtol=2e-2)
    q, k, v = (t.float() for t in qkv.reshape(b, n, 3, h, d).permute(
        2, 0, 3, 1, 4))
    s = torch.matmul(q * scale, k.transpose(-1, -2))
    assert s[:, :, 0].max().item() > 100.0
    exact = torch.matmul(torch.softmax(s, dim=-1), v).transpose(1, 2)
    assert (out - exact.reshape(b, n, h * d)).abs().max().item() > 5 * 2e-2


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("n,d", list(itertools.product(TMA_MHA_N, TMA_MHA_D)))
def test_fused_mha_bwd_kernel_matches_plain_at_the_tma_edges(card, n, d, dtype,
                                                             tol):
    for h in TMA_MHA_H:
        gen = torch.Generator(device=card).manual_seed(n * 5 + d * 7 + h)
        qkv = torch.randn(2, n, 3 * h * d, generator=gen, device=card).to(dtype)
        g = torch.randn(2, n, h * d, generator=gen, device=card).to(dtype)
        got = fused_mha_bwd(qkv, g, h, d ** -0.5).float()
        want = fused_mha_bwd_reference(qkv, g, h, d ** -0.5).float()
        err = (got - want).abs().max().item()
        assert bool(torch.isfinite(got).all()), h
        assert err <= tol * want.abs().max().item(), (h, err)


@pytest.mark.parametrize("n", [17, 64, 65, 197])
def test_fused_mha_bwd_boxes_stop_at_n(card, n):
    """Image 1 of qkv and g set to inf: a box of image 0 that ran past N
    would carry it into image 0's products."""
    h, d = 3, 64
    gen = torch.Generator(device=card).manual_seed(n + 1)
    qkv = torch.randn(2, n, 3 * h * d, generator=gen, device=card).bfloat16()
    g = torch.randn(2, n, h * d, generator=gen, device=card).bfloat16()
    got = fused_mha_bwd(_next_row_inf(qkv), _next_row_inf(g), h, d ** -0.5)
    want = fused_mha_bwd_reference(qkv[:1], g[:1], h, d ** -0.5).float()
    assert bool(torch.isfinite(got[:1]).all())
    err = (got[:1].float() - want).abs().max().item()
    assert err <= 2e-2 * want.abs().max().item(), err


def test_fused_mha_bwd_reads_qkv_and_g_at_a_storage_offset(card):
    """qkv and g 16 bytes into their storages: the tensor maps start at
    their first elements."""
    b, n, h, d = 2, 197, 12, 64
    gen = torch.Generator(device=card).manual_seed(8)
    buf = torch.randn(b * n * 4 * h * d + 16, generator=gen,
                      device=card).bfloat16()
    qkv = buf[8:8 + b * n * 3 * h * d].view(b, n, 3 * h * d)
    g = buf[16 + b * n * 3 * h * d:].view(b, n, h * d)
    assert qkv.storage_offset() == 8 and qkv.data_ptr() % 16 == 0
    assert g.data_ptr() % 16 == 0
    got = fused_mha_bwd(qkv, g, h, d ** -0.5)
    assert torch.equal(got, fused_mha_bwd(qkv.clone(), g.clone(), h,
                                          d ** -0.5))
    want = fused_mha_bwd_reference(qkv, g, h, d ** -0.5).float()
    err = (got.float() - want).abs().max().item()
    assert err <= 2e-2 * want.abs().max().item(), err


def _unmasked_bwd(qkv, g, nb_heads, scale):
    """The plain backward in f32 with the clamp mask left out (packed)."""
    b, n, three_d = qkv.shape
    d = three_d // 3 // nb_heads
    q, k, v = qkv.float().reshape(b, n, 3, nb_heads, d).permute(2, 0, 3, 1, 4)
    g = g.float().reshape(b, n, nb_heads, d).transpose(1, 2)
    s = torch.matmul(q * scale, k.transpose(-1, -2))
    e = torch.exp(torch.clamp(s, max=80.0))
    p = e / e.sum(dim=-1, keepdim=True)
    dp = torch.matmul(g, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    grads = (scale * torch.matmul(ds, k),
             scale * torch.matmul(ds.transpose(-1, -2), q),
             torch.matmul(p.transpose(-1, -2), g))
    return torch.stack(grads, dim=2).permute(0, 3, 2, 1, 4).reshape(
        b, n, three_d)


def test_fused_mha_bwd_kernel_masks_the_clamp_like_plain(card):
    """Query 0 of every head points along keys 3 and 5, so that two of its
    scores pass 80: the kernel holds the masked plain backward, and the
    unmasked backward misses that bar."""
    b, n, h, d = 2, 197, 12, 64
    gen = torch.Generator(device=card).manual_seed(9)
    x = torch.randn(b, n, 3, h, d, generator=gen, device=card)
    x[:, 0, 0] = 20.0 * (x[:, 3, 1] + x[:, 5, 1])
    qkv = x.reshape(b, n, 3 * h * d).bfloat16()
    g = torch.randn(b, n, h * d, generator=gen, device=card).bfloat16()
    scale = d ** -0.5
    got = fused_mha_bwd(qkv, g, h, scale).float()
    want = fused_mha_bwd_reference(qkv, g, h, scale).float()
    bar = 2e-2 * want.abs().max().item()
    assert (got - want).abs().max().item() <= bar
    assert (got - _unmasked_bwd(qkv, g, h, scale)).abs().max().item() > bar


@pytest.mark.parametrize("b,n,h,d", SHAPES)
def test_fused_mha_bwd_kernel_holds_the_clamp_input_at_every_shape(card, b, n,
                                                                   h, d):
    """The clamp input at every shape: at small d query 0's scores sit near
    80, where dp - delta cancels and a delta summed from one bf16 part of
    the exponentials missed the bar (the kernel sums two parts)."""
    gen = torch.Generator(device=card).manual_seed(b + n + h + d)
    x = torch.randn(b, n, 3, h, d, generator=gen, device=card)
    x[:, 0, 0] = 20.0 * (x[:, 3, 1] + x[:, 5, 1])
    qkv = x.reshape(b, n, 3 * h * d).bfloat16()
    g = torch.randn(b, n, h * d, generator=gen, device=card).bfloat16()
    got = fused_mha_bwd(qkv, g, h, d ** -0.5).float()
    want = fused_mha_bwd_reference(qkv, g, h, d ** -0.5).float()
    err = (got - want).abs().max().item()
    assert err <= 2e-2 * want.abs().max().item(), err


def test_hopper_kernels_repeat_bit_for_bit(card):
    g = torch.Generator(device=card).manual_seed(6)
    qkv = torch.randn(4, 197, 3 * 12 * 64, generator=g, device=card).bfloat16()
    assert torch.equal(fused_mha(qkv, 12, 0.125), fused_mha(qkv, 12, 0.125))
    dout = torch.randn(4, 197, 12 * 64, generator=g, device=card).bfloat16()
    assert torch.equal(fused_mha_bwd(qkv, dout, 12, 0.125),
                       fused_mha_bwd(qkv, dout, 12, 0.125))
    q, k, v = (torch.randn(2, 12, 1025, 64, generator=g, device=card).bfloat16()
               for _ in range(3))
    first = flash_attention_with_lse(q, k, v)
    again = flash_attention_with_lse(q, k, v)
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])
    q, k, v, rh, rw = _relpos_inputs(12, 32, 32, 64, torch.bfloat16, card, 6)
    kw = dict(grid_size=(32, 32), scale=0.125)
    first = flash_attention_relpos_with_lse(q, k, v, rh, rw, **kw)
    again = flash_attention_relpos_with_lse(q, k, v, rh, rw, **kw)
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


# convnext_mlp: (M, C, H) at the four ConvNeXt-B stages (M cut to a few
# thousand rows), ConvNeXt-T's C = 96, the golden fixture's C = 12 (not a
# multiple of 8: the mma.sync body), an odd M = 2 * 7 * 7, and the TMA
# tiles' tails: M off 128 rows, C off 64 columns, H off the 128- and
# 256-column tiles. Bars: bf16 max|diff| <= 2e-2 * max|plain| (the plain
# version rounds z and h to bf16 at the same places; the sums run in
# another order, so a rounding may land on the other side); f32 with TF32
# off <= 1e-5 * max|plain|.
CONVNEXT_SHAPES = [(3136, 128, 512), (2048, 256, 1024), (1568, 512, 2048),
                   (392, 1024, 4096), (3136, 96, 384), (200, 12, 48),
                   (98, 1024, 4096), (3137, 96, 392), (1000, 512, 2056)]


def _convnext_inputs(m, c, hidden, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=g, device=device) * scale + shift

    return (rnd(m, c).to(dtype), rnd(m, c).to(dtype), rnd(c, scale=0.1, shift=1.0),
            rnd(c, scale=0.1), rnd(hidden, c, scale=c ** -0.5).to(dtype),
            rnd(hidden, scale=0.1), rnd(c, hidden, scale=hidden ** -0.5).to(dtype),
            rnd(c, scale=0.1), rnd(c, scale=0.1, shift=1.0))


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("m,c,hidden", CONVNEXT_SHAPES)
def test_convnext_mlp_kernel_matches_plain(card, m, c, hidden, dtype, tol):
    args = _convnext_inputs(m, c, hidden, dtype, card, seed=m + c)
    before = dispatch.launch_counts["convnext_mlp"]
    got = convnext_mlp(*args, 1e-6)
    torch.cuda.synchronize()
    assert dispatch.launch_counts["convnext_mlp"] == before + 1
    assert got.dtype == dtype and got.shape == (m, c)
    want = convnext_mlp_reference(*args, 1e-6).float()
    err = (got.float() - want).abs().max().item()
    assert err <= tol * want.abs().max().item(), err


def _offset(t):
    """A copy of t whose base lies one element past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


def test_convnext_mlp_takes_each_route(card):
    """bf16 at C = 128: the TMA + wgmma body; x one element off a 16-byte
    boundary and C = 12: the mma.sync body. Each within the bf16 bar."""
    from tfimm_tpu_torch.ops.kernels.tma import gemm_route

    for m, c, hidden, shift, route in [(300, 128, 512, False, True),
                                       (300, 128, 512, True, False),
                                       (300, 12, 48, False, False)]:
        args = list(_convnext_inputs(m, c, hidden, torch.bfloat16, card, c))
        if shift:
            args[0] = _offset(args[0])
        assert gemm_route(args[0], args[1], args[4], args[6],
                          ln_depth=c) is route
        got = convnext_mlp(*args, 1e-6)
        want = convnext_mlp_reference(*args, 1e-6).float()
        err = (got.float() - want).abs().max().item()
        assert err <= 2e-2 * want.abs().max().item(), (m, c, shift, err)


@pytest.mark.parametrize("c", [128, 512, 12])
def test_convnext_mlp_layer_norm_of_rows_far_from_zero(card, c):
    """Rows of mean 30 and std 1: the LayerNorm must subtract the mean
    before the product (a LayerNorm folded into the epilogue would cancel
    two terms of size 30 rstd against each other and miss the bar)."""
    args = list(_convnext_inputs(2 * 197, c, 4 * c, torch.bfloat16, card, 5))
    args[0] = (30.0 + args[0].float()).to(torch.bfloat16)
    got = convnext_mlp(*args, 1e-6)
    want = convnext_mlp_reference(*args, 1e-6).float()
    err = (got.float() - want).abs().max().item()
    assert err <= 2e-2 * want.abs().max().item(), err


# scripts/perf/torch_gemm_digests.py's digests of convnext_mlp, convnext_block
# and ln_dense's forward, taken from the tree before swin_block and
# poolformer_block moved onto mlp_gemm.cuh (on an H100 80GB HBM3; every
# later run of either tree on that card gave the same).
MLP_GEMM_DIGESTS = {
    "convnext_mlp (3137, 128, 512) bfloat16": "86286ab1a0201ae4",
    "convnext_mlp (1000, 512, 2056) bfloat16": "de4a90b86e21db97",
    "convnext_mlp (200, 12, 48) bfloat16": "360aa2aa356e599c",
    "convnext_mlp (300, 128, 512) bfloat16 off16": "9252438423468ce7",
    "convnext_mlp (600, 96, 384) float32": "ab9aa05427cca83a",
    "convnext_block (2, 28, 28, 256, 1024) bfloat16": "3587e12ae804e7f2",
    "convnext_block (2, 14, 14, 128, 512) bfloat16 off16": "4233dd752361a194",
    "convnext_block (1, 9, 13, 128, 512) float32": "46b927df3639325b",
    "ln_dense (394, 768, 2304, True) bfloat16": "9836f16f9e558de8",
    "ln_dense (197, 96, 40, False) bfloat16": "3f0997a581124dfc",
    "ln_dense (130, 100, 36, True) float32": "4b382a7140f5a698",
}


def test_mlp_gemm_users_keep_their_outputs_bit_for_bit(card):
    """mlp_gemm.cuh's other users, on each body (wgmma, mma.sync off 16
    bytes or at C = 12, f32), give the outputs they gave before the body
    took swin_block's and poolformer_block's prologue and epilogues: the
    same digests (new template arguments, the old instantiations as they
    were)."""
    import importlib.util
    from pathlib import Path

    path = (Path(__file__).resolve().parents[1] / "scripts" / "perf"
            / "torch_gemm_digests.py")
    spec = importlib.util.spec_from_file_location("torch_gemm_digests", path)
    digests = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(digests)
    assert digests.digests(card) == MLP_GEMM_DIGESTS


def test_convnext_mlp_repeats(card):
    args = _convnext_inputs(3137, 256, 1024, torch.bfloat16, card, 8)
    assert torch.equal(convnext_mlp(*args, 1e-6), convnext_mlp(*args, 1e-6))


def test_convnext_mlp_kernel_refuses_what_it_does_not_take(card):
    args = _convnext_inputs(64, 128, 512, torch.float32, card, seed=0)
    with pytest.raises(ValueError):
        convnext_mlp(args[0].half(), args[1].half(), *args[2:])
    with pytest.raises(ValueError):   # mixed devices
        convnext_mlp(*args[:4], args[4].cpu(), *args[5:])
    with pytest.raises(ValueError):   # w1 of the wrong shape
        convnext_mlp(*args[:4], args[4][:, :64], *args[5:])


def test_depthwise_conv_keeps_nhwc_without_a_copy(card):
    # cuDNN takes the channels-last view of the NHWC input as it is and
    # returns a channels-last result, so the NHWC view of the output is
    # contiguous and convnext_mlp reads its (M, C) rows without a copy.
    conv = DepthwiseConv2d(128).to(card, torch.bfloat16)
    x = torch.randn(4, 56, 56, 128, device=card).to(torch.bfloat16)
    y = conv(x)
    assert y.shape == x.shape and y.is_contiguous()
    assert y.reshape(-1, 128).data_ptr() == y.data_ptr()


# window_mha and swin_block: (BW, N, C, H, map side or 0 for no mask). Swin-T's
# stage 1 (cut to 2 images) shifted and stage 4 unshifted, window 12 (N =
# 144) shifted, d = 16, d = 64, d = 8 with N = 16 (the hf_swin fixture),
# d = 24 (no power of two), d = 128, and an odd window count.
WINDOW_SHAPES = [(128, 49, 96, 3, 56), (128, 49, 768, 24, 0),
                 (8, 144, 128, 4, 24), (16, 49, 64, 4, 0), (8, 49, 256, 4, 14),
                 (8, 16, 16, 2, 8), (4, 49, 72, 3, 0), (4, 49, 256, 2, 0),
                 (3, 49, 96, 3, 0)]


def _window_geometry(n, side, nb_heads, device, gen):
    """A bias of std 0.5 (a small table would hide a kernel that drops it)
    and, for ``side`` > 0, the shifted-window mask of a side x side map."""
    bias = 0.5 * torch.randn(nb_heads, n, n, generator=gen, device=device)
    mask = None
    if side:
        ws = int(round(n ** 0.5))
        mask = torch.from_numpy(_attention_mask((side, side), ws, ws // 2))
        mask = mask.to(device)
    return bias, mask


def _bw(bw, mask):
    return bw if mask is None else mask.shape[0] * max(1, bw // mask.shape[0])


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("bw,n,c,h,side", WINDOW_SHAPES)
def test_window_mha_kernel_matches_plain(card, bw, n, c, h, side, dtype, tol):
    gen = torch.Generator(device=card).manual_seed(bw + n + c)
    bias, mask = _window_geometry(n, side, h, card, gen)
    bw = _bw(bw, mask)
    # q, k, v as the three slices of a packed qkv, read through its strides.
    qkv = torch.randn(bw, n, 3 * c, generator=gen, device=card).to(dtype)
    q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
    scale = (c // h) ** -0.5
    before = dispatch.launch_counts["window_mha"]
    got = window_mha(q, k, v, bias, mask, nb_heads=h, scale=scale)
    torch.cuda.synchronize()
    assert dispatch.launch_counts["window_mha"] == before + 1
    assert got.dtype == dtype and got.shape == (bw, n, c)
    want = window_mha_reference(q, k, v, bias, mask, nb_heads=h,
                                scale=scale).float()
    err = (got.float() - want).abs().max().item()
    assert err <= tol * want.abs().max().item(), err


def _block_inputs(bw, n, c, h, side, dtype, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=gen, device=device) * scale + shift

    bias, mask = _window_geometry(n, side, h, device, gen)
    bw = _bw(bw, mask)
    hid = 4 * c
    params = SwinBlockParams(
        rnd(c, scale=0.1, shift=1.0), rnd(c, scale=0.1),
        rnd(3 * c, c, scale=c ** -0.5).to(dtype), rnd(3 * c, scale=0.1),
        rnd(c, c, scale=c ** -0.5).to(dtype), rnd(c, scale=0.1),
        rnd(c, scale=0.1, shift=1.0), rnd(c, scale=0.1),
        rnd(hid, c, scale=c ** -0.5).to(dtype), rnd(hid, scale=0.1),
        rnd(c, hid, scale=hid ** -0.5).to(dtype), rnd(c, scale=0.1))
    return rnd(bw, n, c).to(dtype), params, bias, mask


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("bw,n,c,h,side", WINDOW_SHAPES)
def test_swin_block_kernel_matches_plain(card, bw, n, c, h, side, dtype, tol):
    x, params, bias, mask = _block_inputs(bw, n, c, h, side, dtype, card,
                                          seed=bw + c)
    scale = (c // h) ** -0.5
    before = dispatch.launch_counts["swin_block"]
    got = swin_block(x, params, bias, mask, nb_heads=h, scale=scale)
    torch.cuda.synchronize()
    assert dispatch.launch_counts["swin_block"] == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    want = swin_block_reference(x, params, bias, mask, nb_heads=h,
                                scale=scale).float()
    err = (got.float() - want).abs().max().item()
    assert err <= tol * want.abs().max().item(), err


def test_window_kernels_refuse_what_they_do_not_take(card):
    x, params, bias, _ = _block_inputs(4, 49, 96, 3, 0, torch.float32, card, 0)
    with pytest.raises(ValueError):   # N > 144
        q = torch.zeros(2, 169, 96, device=card)
        window_mha(q, q, q, torch.zeros(3, 169, 169, device=card), nb_heads=3,
                   scale=1.0)
    with pytest.raises(ValueError):   # d = 12, no multiple of 8
        window_mha(x, x, x, torch.zeros(8, 49, 49, device=card), nb_heads=8,
                   scale=1.0)
    with pytest.raises(ValueError):   # mixed devices
        window_mha(x, x, x.cpu(), bias, nb_heads=3, scale=1.0)
    with pytest.raises(ValueError):   # w1 of the wrong shape
        swin_block(x, params._replace(w1=params.w1[:, :48]), bias, nb_heads=3,
                   scale=1.0)
    with pytest.raises(ValueError):   # not contiguous
        swin_block(x[:, ::2], params, bias[:, ::2, ::2], nb_heads=3, scale=1.0)
    assert np.isfinite(swin_block(x, params, bias, nb_heads=3,
                                  scale=1.0).cpu().numpy()).all()


# swin_block at Swin-T's stage shapes at batch 128, unshifted and shifted,
# and chip_smoke.py's edges (BW, N, C, H, map side or 0 for no mask): every
# bf16 one on mlp_gemm.cuh's TMA + wgmma GEMMs, every f32 one on the FMA
# body.
SWIN_STAGE_CASES = [(8192, 49, 96, 3, side) for side in (0, 56)] + [
    (2048, 49, 192, 6, side) for side in (0, 28)] + [
    (512, 49, 384, 12, side) for side in (0, 14)]
SWIN_EDGE_CASES = [(32, 144, 128, 4, 24), (64, 49, 64, 4, 14),
                   (64, 49, 256, 4, 0), (64, 16, 16, 2, 8), (3, 49, 96, 3, 0)]


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("bw,n,c,h,side", SWIN_STAGE_CASES + SWIN_EDGE_CASES)
def test_swin_block_at_the_stage_shapes_and_edges(card, bw, n, c, h, side,
                                                  dtype, tol):
    x, params, bias, mask = _block_inputs(bw, n, c, h, side, dtype, card,
                                          seed=bw + c + side)
    scale = (c // h) ** -0.5
    got = swin_block(x, params, bias, mask, nb_heads=h, scale=scale)
    want = swin_block_reference(x, params, bias, mask, nb_heads=h,
                                scale=scale)
    assert got.dtype == dtype and got.shape == x.shape
    _held_by(got, want, tol)


def test_swin_block_repeats(card):
    x, params, bias, mask = _block_inputs(128, 49, 96, 3, 56, torch.bfloat16,
                                          card, 5)
    kw = dict(nb_heads=3, scale=32 ** -0.5)
    assert torch.equal(swin_block(x, params, bias, mask, **kw),
                       swin_block(x, params, bias, mask, **kw))


def _profiled_names(call, need, tries=5):
    """The device kernels' names of one ``call`` (the last result too),
    from a profile taken again, up to ``tries`` times, while it lacks a
    name holding each key of ``need`` (a profile may drop events)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = call()
            torch.cuda.synchronize()
        names = " ".join(e.name for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA)
        if all(key in names for key in need):
            break
    return names, out


def test_swin_block_bf16_takes_the_wgmma_gemms_or_raises(card):
    """bf16: the four products on the TMA + wgmma body (the profile names
    them), also for x and the weights off 16 bytes (the wrapper copies
    them); a hidden width off a multiple of 8 raises in bf16 and runs the
    FMA body in f32."""
    x, params, bias, _ = _block_inputs(16, 49, 96, 3, 0, torch.bfloat16, card,
                                       7)
    odd = params._replace(w_qkv=_offset(params.w_qkv))
    want = [f"swin_{product}_wgmma_kernel"
            for product in ("qkv", "proj", "fc1", "fc2")]
    for xi, p in ((x, params), (_offset(x), odd)):
        names, got = _profiled_names(
            lambda: swin_block(xi, p, bias, nb_heads=3, scale=0.2), want)
        for key in want:
            assert key in names, key
        _held_by(got, swin_block_reference(xi, p, bias, nb_heads=3,
                                           scale=0.2), 2e-2)
    hid = 100
    wide = params._replace(w1=params.w1[:hid], b1=params.b1[:hid],
                           w2=params.w2[:, :hid].contiguous())
    with pytest.raises(ValueError):
        swin_block(x, wide, bias, nb_heads=3, scale=0.2)
    x32 = x.float()
    wide32 = SwinBlockParams(*(t.float() for t in wide))
    _held_by(swin_block(x32, wide32, bias, nb_heads=3, scale=0.2),
             swin_block_reference(x32, wide32, bias, nb_heads=3, scale=0.2),
             1e-4)


def _bwd_inputs(bw, n, c, h, side, dtype, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    bias, mask = _window_geometry(n, side, h, device, gen)
    bw = _bw(bw, mask)
    qkv = torch.randn(bw, n, 3 * c, generator=gen, device=device).to(dtype)
    g = torch.randn(bw, n, c, generator=gen, device=device).to(dtype)
    return qkv, g, bias, mask


# The backward's tile shapes beside the forward's: N = 144 with d = 64 and
# d = 128 (the largest shared-memory plan, whose tiles drop their padding).
BWD_SHAPES = WINDOW_SHAPES + [(8, 144, 256, 4, 24), (8, 144, 256, 2, 24)]


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("bw,n,c,h,side", BWD_SHAPES)
def test_window_mha_bwd_kernel_matches_plain(card, bw, n, c, h, side, dtype,
                                             tol):
    qkv, g, bias, mask = _bwd_inputs(bw, n, c, h, side, dtype, card,
                                     seed=bw + n + c + 1)
    scale = (c // h) ** -0.5
    before = dispatch.launch_counts["window_mha_bwd"]
    dqkv, dbias = window_mha_bwd(qkv, g, bias, mask, nb_heads=h, scale=scale)
    torch.cuda.synchronize()
    assert dispatch.launch_counts["window_mha_bwd"] == before + 1
    assert dqkv.dtype == dtype and dqkv.shape == qkv.shape
    assert dbias.dtype == torch.float32 and dbias.shape == bias.shape
    want = window_mha_bwd_reference(qkv[..., :c], qkv[..., c:2 * c],
                                    qkv[..., 2 * c:], bias, mask, g,
                                    nb_heads=h, scale=scale)
    got = (dqkv[..., :c], dqkv[..., c:2 * c], dqkv[..., 2 * c:], dbias)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        err = (a.float() - b.float()).abs().max().item()
        assert err <= tol * b.float().abs().max().item(), (name, err)


# Swin-T's window shapes (BW, N, C, H, map side or 0 for no mask): serving
# at batch 128 (stages 1-3 unshifted and shifted, stage 4) and training at
# batch 64 (the same, stage 4 unshifted).
SWIN_T_WINDOWS = [(bw * batch // 128, 49, c, h, side)
                  for batch in (128, 64)
                  for bw, c, h, sides in ((8192, 96, 3, (0, 56)),
                                          (2048, 192, 6, (0, 28)),
                                          (512, 384, 12, (0, 14)),
                                          (128, 768, 24, (0,)))
                  for side in sides]


@pytest.mark.parametrize("bw,n,c,h,side", SWIN_T_WINDOWS)
def test_window_kernels_bf16_swin_t_take_the_wgmma_bodies(card, bw, n, c, h,
                                                          side):
    """Every bf16 Swin-T window shape, serving and training, shifted and
    not: the forward and the backward on their TMA + wgmma bodies (the
    profile names them), each within the bf16 bar of its plain version."""
    qkv, g, bias, mask = _bwd_inputs(bw, n, c, h, side, torch.bfloat16, card,
                                     seed=bw + c + side)
    q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
    kw = dict(nb_heads=h, scale=(c // h) ** -0.5)
    names, got = _profiled_names(
        lambda: window_mha(q, k, v, bias, mask, **kw),
        ["window_mha_wgmma_kernel"])
    assert "window_mha_wgmma_kernel" in names
    assert "window_mha_bf16_kernel" not in names
    _held_by(got, window_mha_reference(q, k, v, bias, mask, **kw), 2e-2)
    names, (dqkv, dbias) = _profiled_names(
        lambda: window_mha_bwd(qkv, g, bias, mask, **kw),
        ["window_mha_bwd_wgmma_kernel"])
    assert "window_mha_bwd_wgmma_kernel" in names
    assert "window_mha_bwd_bf16_kernel" not in names
    want = window_mha_bwd_reference(q, k, v, bias, mask, g, **kw)
    for a, b in zip((dqkv[..., :c], dqkv[..., c:2 * c], dqkv[..., 2 * c:],
                     dbias), want):
        _held_by(a, b, 2e-2)


def test_window_kernels_decline_the_wgmma_bodies_off_the_route(card):
    """f32, N = 144, d = 72 and an operand off 16 bytes run the first bodies
    (the profile names them), each within its bar of its plain version."""
    cases = [((4, 49, 96, 3, 0), torch.float32, False, "f32"),
             ((8, 144, 128, 4, 24), torch.bfloat16, False, "bf16"),
             ((4, 49, 216, 3, 0), torch.bfloat16, False, "bf16"),
             ((4, 49, 96, 3, 0), torch.bfloat16, True, "bf16")]
    for (bw, n, c, h, side), dtype, offset, body in cases:
        qkv, g, bias, mask = _bwd_inputs(bw, n, c, h, side, dtype, card,
                                         seed=bw + n + c)
        if offset:
            qkv, g = _offset(qkv), _offset(g)
        q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
        kw = dict(nb_heads=h, scale=(c // h) ** -0.5)
        tol = 1e-5 if dtype == torch.float32 else 2e-2
        names, got = _profiled_names(
            lambda: window_mha(q, k, v, bias, mask, **kw),
            [f"window_mha_{body}_kernel"])
        assert f"window_mha_{body}_kernel" in names
        assert "wgmma" not in names
        _held_by(got, window_mha_reference(q, k, v, bias, mask, **kw), tol)
        names, (dqkv, dbias) = _profiled_names(
            lambda: window_mha_bwd(qkv, g, bias, mask, **kw),
            [f"window_mha_bwd_{body}_kernel"])
        assert f"window_mha_bwd_{body}_kernel" in names
        assert "wgmma" not in names
        want = window_mha_bwd_reference(q, k, v, bias, mask, g, **kw)
        for a, b in zip((dqkv[..., :c], dqkv[..., c:2 * c],
                         dqkv[..., 2 * c:], dbias), want):
            _held_by(a, b, 2e-2 if dtype == torch.bfloat16 else 1e-4)


def test_window_mha_bwd_dbias_is_deterministic(card):
    qkv, g, bias, mask = _bwd_inputs(512, 49, 96, 3, 56, torch.bfloat16,
                                     card, seed=3)
    runs = [window_mha_bwd(qkv, g, bias, mask, nb_heads=3, scale=32 ** -0.5)
            for _ in range(2)]
    assert torch.equal(runs[0][1], runs[1][1])
    assert torch.equal(runs[0][0], runs[1][0])


def test_window_mha_packed_gives_gradients_through_the_kernels(card):
    qkv, g, bias, mask = _bwd_inputs(128, 49, 96, 3, 56, torch.bfloat16, card,
                                     seed=4)
    counts = dict(dispatch.launch_counts)
    x, b = qkv.clone().requires_grad_(), bias.clone().requires_grad_()
    window_mha_packed(x, b, mask, nb_heads=3, scale=32 ** -0.5).backward(g)
    torch.cuda.synchronize()
    assert dispatch.launch_counts["window_mha"] == counts["window_mha"] + 1
    assert (dispatch.launch_counts["window_mha_bwd"]
            == counts["window_mha_bwd"] + 1)
    dqkv, dbias = window_mha_bwd(qkv, g, bias, mask, nb_heads=3,
                                 scale=32 ** -0.5)
    assert torch.equal(x.grad, dqkv) and torch.equal(b.grad, dbias)


def test_window_mha_bwd_refuses_what_it_does_not_take(card):
    qkv, g, bias, _ = _bwd_inputs(4, 49, 96, 3, 0, torch.float32, card, 0)
    with pytest.raises(ValueError):   # g not contiguous
        window_mha_bwd(qkv, g.transpose(0, 1).contiguous().transpose(0, 1),
                       bias, nb_heads=3, scale=1.0)
    with pytest.raises(ValueError):   # g of another dtype
        window_mha_bwd(qkv, g.bfloat16(), bias, nb_heads=3, scale=1.0)
    with pytest.raises(ValueError):   # d = 12, no multiple of 8
        window_mha_bwd(qkv, g, torch.zeros(8, 49, 49, device=card),
                       nb_heads=8, scale=1.0)
    with pytest.raises(ValueError):   # mixed devices
        window_mha_bwd(qkv, g, bias.cpu(), nb_heads=3, scale=1.0)


# talking_head_attention and its backward: (B, N, H, d) of cait_s24_224
# (cut to 4 images), cait_xxs (H = 4), cait_xs@384 (H = 6, N = 576),
# cait_m48@448 (H = 16, N = 784, two images), the golden fixture's H = 2,
# d = 8, d = 128 (D = 768), more than 8 heads above d = 64 (H = 10 with
# d = 72, H = 9 with d = 80: the second head of each warp) and an N below
# one tile. The mixes are random
# and not symmetric (a transposed mix passes every shape check), b_w at std
# 0.02 (its term b_w[h] colsum(v_h) sums N keys: a larger one would dwarf
# the attention under a bar relative to the largest value). Bars:
# max|diff| <= 2e-2 * max|plain| in bf16 (the forward rounds the mixed
# probabilities where the plain version does, the backward also rounds a and
# draw to bf16 before its products; the sums run in another order); f32 with
# TF32 off 1e-5 (forward) and 1e-4 (backward, whose mix gradients sum over
# every entry of the batch).
CAIT_SHAPES = [(4, 196, 8, 48), (2, 196, 4, 48), (1, 576, 6, 48),
               (2, 784, 16, 48), (3, 16, 2, 8), (2, 50, 6, 128),
               (2, 50, 10, 72), (2, 50, 9, 80), (2, 9, 8, 48)]


def _cait_inputs(b, n, h, d, dtype, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=device) * scale

    return (rnd(b, n, 3 * h * d).to(dtype), rnd(h, h, scale=0.5), rnd(h),
            rnd(h, h, scale=0.5), rnd(h, scale=0.02),
            rnd(b, n, h * d).to(dtype))


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("b,n,h,d", CAIT_SHAPES)
def test_talking_head_kernel_matches_plain(card, b, n, h, d, dtype, tol):
    qkv, wl, bl, ww, bw, _ = _cait_inputs(b, n, h, d, dtype, card, b + n + h)
    before = dispatch.launch_counts["talking_head_attention"]
    got = talking_head_attention(qkv, wl, bl, ww, bw, nb_heads=h,
                                 scale=d ** -0.5)
    torch.cuda.synchronize()
    assert dispatch.launch_counts["talking_head_attention"] == before + 1
    assert got.dtype == dtype and got.shape == (b, n, h * d)
    want = talking_head_attention_reference(qkv, wl, bl, ww, bw, nb_heads=h,
                                            scale=d ** -0.5).float()
    err = (got.float() - want).abs().max().item()
    assert err <= tol * want.abs().max().item(), err


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("b,n,h,d", CAIT_SHAPES)
def test_talking_head_bwd_kernel_matches_plain(card, b, n, h, d, dtype, tol):
    qkv, wl, bl, ww, bw, g = _cait_inputs(b, n, h, d, dtype, card, b + n + 1)
    before = dispatch.launch_counts["talking_head_attention_bwd"]
    got = talking_head_attention_bwd(qkv, wl, bl, ww, bw, g, nb_heads=h,
                                     scale=d ** -0.5)
    torch.cuda.synchronize()
    assert dispatch.launch_counts["talking_head_attention_bwd"] == before + 1
    assert got[0].dtype == dtype and got[0].shape == qkv.shape
    assert torch.equal(got[2], torch.zeros(h, device=card))
    want = talking_head_attention_bwd_reference(qkv, wl, bl, ww, bw, g,
                                                nb_heads=h, scale=d ** -0.5)
    c = h * d
    pieces = lambda t: (t[0][..., :c], t[0][..., c:2 * c], t[0][..., 2 * c:],
                        t[1], t[3], t[4])
    for name, a, w in zip(("dq", "dk", "dv", "dw_l", "dw_w", "db_w"),
                          pieces(got), pieces(want)):
        err = (a.float() - w.float()).abs().max().item()
        assert err <= tol * w.float().abs().max().item(), (name, err)


# Both bodies at chip_smoke.py's CAIT_SHAPES and CAIT_BWD_SHAPES: the
# Hopper body (TMA + wgmma) where tma.cait_route takes the call, and the
# first design's body (mma.sync) at every shape, sent there by a route
# that declines. Same bars.
ROUTE_SHAPES = [(128, 196, 8, 48), (64, 196, 8, 48), (16, 196, 4, 48),
                (4, 576, 6, 48), (2, 784, 16, 48), (16, 16, 2, 8),
                (2, 50, 10, 72)]
ROUTE_CASES = [(shape, hopper) for shape in ROUTE_SHAPES
               for hopper in (True, False)
               if not hopper or (shape[2] <= 8 and shape[3] <= 64)]


def _take_route(monkeypatch, hopper):
    """Keep the wrappers' route (checking it takes the call) or send every
    call to the first design's bodies."""
    if hopper:
        route = cait_module.cait_route

        def checked(*args):
            assert route(*args)
            return True

        monkeypatch.setattr(cait_module, "cait_route", checked)
    else:
        monkeypatch.setattr(cait_module, "cait_route", lambda *args: False)


@pytest.mark.parametrize("shape,hopper", ROUTE_CASES)
def test_talking_head_routes_match_plain(card, shape, hopper, monkeypatch):
    b, n, h, d = shape
    qkv, wl, bl, ww, bw, g = _cait_inputs(b, n, h, d, torch.bfloat16, card,
                                          b + n + h + d)
    _take_route(monkeypatch, hopper)
    kw = dict(nb_heads=h, scale=d ** -0.5)
    got = talking_head_attention(qkv, wl, bl, ww, bw, **kw)
    want = talking_head_attention_reference(qkv, wl, bl, ww, bw, **kw).float()
    err = (got.float() - want).abs().max().item()
    assert err <= 2e-2 * want.abs().max().item(), err
    del got, want
    grads = talking_head_attention_bwd(qkv, wl, bl, ww, bw, g, **kw)
    assert torch.equal(grads[2], torch.zeros(h, device=card))
    want = talking_head_attention_bwd_reference(qkv, wl, bl, ww, bw, g, **kw)
    c = h * d
    pieces = lambda t: (t[0][..., :c], t[0][..., c:2 * c], t[0][..., 2 * c:],
                        t[1], t[3], t[4])
    for name, a, w in zip(("dq", "dk", "dv", "dw_l", "dw_w", "db_w"),
                          pieces(grads), pieces(want)):
        err = (a.float() - w.float()).abs().max().item()
        assert err <= 2e-2 * w.float().abs().max().item(), (name, err)


@pytest.mark.parametrize("b,n,h,d", [(4, 196, 8, 48), (3, 50, 4, 48),
                                     (2, 9, 6, 48), (3, 17, 2, 8)])
def test_talking_head_bwd_overwrites_what_it_reads(card, b, n, h, d,
                                                   monkeypatch):
    """The Hopper backward's scratch of a and draw arrives full of NaN (the
    contents of ``torch.empty`` may be anything): its first launch writes
    every element its second reads, and the boxes read zeros past N, so the
    gradients are those of a zeroed scratch bit for bit, finite."""
    args = _cait_inputs(b, n, h, d, torch.bfloat16, card, b * n + h)
    kw = dict(nb_heads=h, scale=d ** -0.5)
    assert cait_module.cait_route(h, args[0], args[5])
    empty = cait_module.ab_scratch
    monkeypatch.setattr(cait_module, "ab_scratch",
                        lambda *a: empty(*a).zero_())
    want = talking_head_attention_bwd(*args, **kw)
    monkeypatch.setattr(cait_module, "ab_scratch",
                        lambda *a: empty(*a).fill_(float("nan")))
    got = talking_head_attention_bwd(*args, **kw)
    for a, w in zip(got, want):
        assert bool(torch.isfinite(a).all())
        assert torch.equal(a, w)


@pytest.mark.parametrize("b,n,h,d", [(4, 196, 8, 48), (3, 50, 4, 48),
                                     (2, 9, 6, 48), (3, 17, 2, 8)])
def test_talking_head_forward_keeps_the_row_statistics(card, b, n, h, d,
                                                       monkeypatch):
    """Under autograd the Hopper forward keeps log2 l of every row of its
    64-row tiles (B, H, N rounded up to 64) and the backward skips the pass
    that would recompute it: the gradients are the recomputing backward's
    bit for bit. The statistics arrive full of NaN (the contents of
    ``torch.empty`` may be anything): the forward writes the padded rows
    too, with values that give finite p there."""
    qkv, wl, bl, ww, bw, g = _cait_inputs(b, n, h, d, torch.bfloat16, card,
                                          b * n + d)
    kw = dict(nb_heads=h, scale=d ** -0.5)
    empty = cait_module.stats_scratch
    monkeypatch.setattr(cait_module, "stats_scratch",
                        lambda *a: empty(*a).fill_(float("nan")))
    leaves = [t.clone().requires_grad_() for t in (qkv, wl, bl, ww, bw)]
    counts = dict(dispatch.launch_counts)
    out = talking_head_attention_packed(*leaves, **kw)
    out.backward(g)
    torch.cuda.synchronize()
    for name in ("talking_head_attention", "talking_head_attention_bwd"):
        assert dispatch.launch_counts[name] == counts[name] + 1
    assert torch.equal(out, talking_head_attention(qkv, wl, bl, ww, bw, **kw))
    want = talking_head_attention_bwd(qkv, wl, bl, ww, bw, g, **kw)
    for leaf, w in zip(leaves, [want[0], *want[1:]]):
        assert bool(torch.isfinite(leaf.grad).all())
        assert torch.equal(leaf.grad, w.to(leaf.grad.dtype))


def test_talking_head_kernels_run_first_on_a_new_thread(card):
    """A thread whose first CUDA work is a Hopper launcher (an autograd
    thread that starts its backward there) finds no context current: the
    launchers make the card's current, and give the main thread's results
    bit for bit."""
    args = _cait_inputs(3, 50, 4, 48, torch.bfloat16, card, 9)
    kw = dict(nb_heads=4, scale=48 ** -0.5)
    want = (talking_head_attention(*args[:5], **kw),
            talking_head_attention_bwd(*args, **kw))
    got = {}

    def run():
        try:
            got["out"] = (talking_head_attention(*args[:5], **kw),
                          talking_head_attention_bwd(*args, **kw))
            torch.cuda.synchronize()
        except Exception as err:   # raised again on the test's thread
            got["err"] = err

    thread = threading.Thread(target=run)
    thread.start()
    thread.join(timeout=300)
    assert not thread.is_alive()
    if "err" in got:
        raise got["err"]
    assert torch.equal(got["out"][0], want[0])
    for a, w in zip(got["out"][1], want[1]):
        assert torch.equal(a, w)


def _hopper_launch(name, device):
    """A call of one Hopper (TMA + wgmma) launcher, bf16, on inputs made
    here, so that running it is the only CUDA work of a new thread."""
    gen = torch.Generator(device=device).manual_seed(11)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=device).bfloat16()

    if name == "fused_mha":
        qkv = rnd(2, 65, 3 * 4 * 64)
        return lambda: fused_mha(qkv, 4, 0.125)
    if name == "fused_mha_bwd":
        qkv, g = rnd(2, 65, 3 * 4 * 64), rnd(2, 65, 4 * 64)
        return lambda: fused_mha_bwd(qkv, g, 4, 0.125)
    if name == "flash_attention":
        q, k, v = _flash_inputs((2, 2, 130, 64), torch.bfloat16, device, 11)
        return lambda: flash_attention_with_lse(q, k, v)
    if name == "flash_attention_bwd":
        case = _flash_bwd_case((2, 2, 130, 64), torch.bfloat16, device, 11)
        return lambda: flash_attention_bwd(*case)
    if name == "flash_attention_relpos":
        q, k, v, rh, rw = _relpos_inputs(2, 9, 7, 64, torch.bfloat16, device, 11)
        return lambda: flash_attention_relpos_with_lse(
            q, k, v, rh, rw, grid_size=(9, 7), scale=0.125)
    if name == "flash_attention_relpos_bwd":
        case = _relpos_bwd_case(2, 9, 7, 64, torch.bfloat16, device, 11)
        return lambda: flash_attention_relpos_bwd(*case, grid_size=(9, 7))
    if name == "swin_block":
        x, params, bias, mask = _block_inputs(128, 49, 96, 3, 56,
                                              torch.bfloat16, device, 11)
        return lambda: swin_block(x, params, bias, mask, nb_heads=3,
                                  scale=32 ** -0.5)
    if name == "window_mha":
        qkv, _, bias, mask = _bwd_inputs(128, 49, 96, 3, 56, torch.bfloat16,
                                         device, 11)
        return lambda: window_mha(qkv[..., :96], qkv[..., 96:192],
                                  qkv[..., 192:], bias, mask, nb_heads=3,
                                  scale=32 ** -0.5)
    if name == "window_mha_bwd":
        qkv, g, bias, mask = _bwd_inputs(128, 49, 96, 3, 56, torch.bfloat16,
                                         device, 11)
        return lambda: window_mha_bwd(qkv, g, bias, mask, nb_heads=3,
                                      scale=32 ** -0.5)
    if name == "poolformer_block":
        args = _pool_inputs(2, 28, 28, 128, 512, torch.bfloat16, device, 11)
        return lambda: poolformer_block(*args)
    if name == "pvt_sra":
        x, kv, wq, bq, wp, bp = _sra_inputs(4, 3136, 49, 64, torch.bfloat16,
                                            device, 11)
        return lambda: pvt_sra(x, kv, wq, bq, wp, bp, 0.125)
    if name == "ln_dense_bwd":
        x, gamma, beta, w, _, gy = _ln_dense_inputs(394, 768, 2304, True,
                                                    torch.bfloat16, device, 11)
        return lambda: ln_dense_bwd(x, gamma, beta, w, gy, True, 1e-6)
    args = _convnext_inputs(3136, 128, 512, torch.bfloat16, device, seed=11)
    return lambda: convnext_mlp(*args, 1e-6)


@pytest.mark.parametrize("name", [
    "fused_mha", "fused_mha_bwd", "flash_attention", "flash_attention_bwd",
    "flash_attention_relpos", "flash_attention_relpos_bwd", "convnext_mlp",
    "swin_block", "poolformer_block", "window_mha", "window_mha_bwd",
    "pvt_sra", "ln_dense_bwd"])
def test_hopper_launchers_run_first_on_a_new_thread(card, name):
    """As the talking-head kernels: every launcher that encodes tensor maps
    binds the thread's context first (``hopper.cuh · encode_bf16_map``)."""
    call = _hopper_launch(name, card)
    want = call()
    torch.cuda.synchronize()
    got = {}

    def run():
        try:
            got["out"] = call()
            torch.cuda.synchronize()
        except Exception as err:   # raised again on the test's thread
            got["err"] = err

    thread = threading.Thread(target=run)
    thread.start()
    thread.join(timeout=300)
    assert not thread.is_alive()
    if "err" in got:
        raise got["err"]
    want = want if isinstance(want, tuple) else (want,)
    out = got["out"] if isinstance(got["out"], tuple) else (got["out"],)
    for a, w in zip(out, want, strict=True):
        assert torch.equal(a, w)


def test_talking_head_bwd_is_deterministic(card):
    args = _cait_inputs(16, 196, 8, 48, torch.bfloat16, card, seed=3)
    runs = [talking_head_attention_bwd(*args, nb_heads=8, scale=48 ** -0.5)
            for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_talking_head_gives_gradients_through_the_kernels(card):
    qkv, wl, bl, ww, bw, g = _cait_inputs(2, 196, 8, 48, torch.float32, card, 4)
    leaves = [t.clone().requires_grad_() for t in (qkv, wl, bl, ww, bw)]
    counts = dict(dispatch.launch_counts)
    talking_head_attention_packed(*leaves, nb_heads=8,
                                  scale=48 ** -0.5).backward(g)
    torch.cuda.synchronize()
    for name in ("talking_head_attention", "talking_head_attention_bwd"):
        assert dispatch.launch_counts[name] == counts[name] + 1
    want = talking_head_attention_bwd(qkv, wl, bl, ww, bw, g, nb_heads=8,
                                      scale=48 ** -0.5)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_talking_head_kernels_read_the_mixes_in_place(card, dtype):
    # The model passes its Dense weights transposed (views) and, in bf16
    # serving, in bf16: the kernels read both through their strides and
    # dtype, bit for bit as from contiguous f32 copies of the same values.
    qkv, wl, bl, ww, bw, g = _cait_inputs(2, 50, 8, 48, dtype, card, 5)
    mixes = [t.bfloat16() for t in (wl, bl, ww, bw)]
    views = [mixes[0].t().contiguous().t(), mixes[1],
             mixes[2].t().contiguous().t(), mixes[3]]
    assert not views[0].is_contiguous()
    copies = [t.float() for t in mixes]
    kw = dict(nb_heads=8, scale=48 ** -0.5)
    assert torch.equal(talking_head_attention(qkv, *views, **kw),
                       talking_head_attention(qkv, *copies, **kw))
    for a, b in zip(talking_head_attention_bwd(qkv, *views, g, **kw),
                    talking_head_attention_bwd(qkv, *copies, g, **kw)):
        assert torch.equal(a, b)


def test_talking_head_kernels_refuse_what_they_do_not_take(card):
    qkv, wl, bl, ww, bw, g = _cait_inputs(2, 16, 4, 48, torch.float32, card, 0)
    with pytest.raises(ValueError):   # f16
        talking_head_attention(qkv.half(), wl, bl, ww, bw, nb_heads=4,
                               scale=1.0)
    with pytest.raises(ValueError):   # d = 12, no multiple of 8
        talking_head_attention(qkv, torch.zeros(16, 16, device=card),
                               torch.zeros(16, device=card),
                               torch.zeros(16, 16, device=card),
                               torch.zeros(16, device=card), nb_heads=16,
                               scale=1.0)
    with pytest.raises(ValueError):   # D = 1024 > 768
        big = torch.zeros(1, 4, 3 * 1024, device=card)
        talking_head_attention(big, torch.zeros(8, 8, device=card),
                               torch.zeros(8, device=card),
                               torch.zeros(8, 8, device=card),
                               torch.zeros(8, device=card), nb_heads=8,
                               scale=1.0)
    with pytest.raises(ValueError):   # mixed devices
        talking_head_attention(qkv, wl.cpu(), bl, ww, bw, nb_heads=4, scale=1.0)
    with pytest.raises(ValueError):   # a mix of the wrong shape
        talking_head_attention(qkv, wl[:2], bl, ww, bw, nb_heads=4, scale=1.0)
    with pytest.raises(ValueError):   # a missing bias
        talking_head_attention(qkv, wl, None, ww, bw, nb_heads=4, scale=1.0)
    with pytest.raises(ValueError):
        talking_head_attention_bwd(qkv, wl, bl, ww, None, g, nb_heads=4,
                                   scale=1.0)
    with pytest.raises(ValueError):   # g not contiguous
        talking_head_attention_bwd(qkv, wl, bl, ww, bw, g[:, ::2], nb_heads=4,
                                   scale=1.0)
    with pytest.raises(ValueError):   # g of another dtype
        talking_head_attention_bwd(qkv, wl, bl, ww, bw, g.bfloat16(),
                                   nb_heads=4, scale=1.0)


# (B, gh, gw, d): SAM-B's global blocks (12 heads of one image at 64 x 64)
# and windowed blocks (25 windows x 12 heads at 14 x 14), SAM-H's head dim
# (80, 16 heads), a grid with gh != gw, N = 49, and d = 8 and 128.
RELPOS_SHAPES = [(12, 64, 64, 64), (300, 14, 14, 64), (16, 14, 14, 80),
                 (2, 48, 64, 64), (4, 7, 7, 64), (3, 5, 9, 8), (2, 9, 7, 128)]


def _relpos_inputs(b, gh, gw, d, dtype, device, seed, big=False):
    """q, k, v normal; rel terms at std 2. With ``big``, query 0 of every
    row points along keys 3 and 5: two of its scores near 300, far above
    the clamp of 80 of the other attention kernels."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n = gh * gw
    q, k, v = (torch.randn(b, n, d, generator=gen, device=device)
               for _ in range(3))
    if big:
        q[:, 0] = 300.0 / d ** 0.5 * (k[:, 3] + k[:, 5])
    rh = 2.0 * torch.randn(b, n, gh, generator=gen, device=device)
    rw = 2.0 * torch.randn(b, n, gw, generator=gen, device=device)
    return [t.to(dtype) for t in (q, k, v, rh, rw)]


@pytest.mark.parametrize("big", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("b,gh,gw,d", RELPOS_SHAPES)
def test_flash_attention_relpos_kernel_matches_plain(card, b, gh, gw, d, dtype,
                                                     tol, big):
    q, k, v, rh, rw = _relpos_inputs(b, gh, gw, d, dtype, card,
                                     b * gh + gw * d, big)
    kw = dict(grid_size=(gh, gw), scale=d ** -0.5)
    before = dispatch.launch_counts["flash_attention_relpos"]
    out, lse = flash_attention_relpos_with_lse(q, k, v, rh, rw, **kw)
    torch.cuda.synchronize()
    assert dispatch.launch_counts["flash_attention_relpos"] == before + 1
    assert out.dtype == dtype and lse.dtype == torch.float32
    ref, ref_lse = flash_attention_relpos_reference(q, k, v, rh, rw, **kw)
    for got, want in ((out, ref), (lse, ref_lse)):
        want = want.float()
        err = (got.float() - want).abs().max().item()
        assert err <= tol * want.abs().max().item(), err
    if big:
        assert ref_lse[:, 0].min().item() > 100.0


def test_flash_attention_relpos_reads_strided_inputs(card):
    """q, k, v as slices of one packed tensor: the same output as from
    contiguous copies."""
    b, gh, gw, d = 4, 14, 14, 64
    q, k, v, rh, rw = _relpos_inputs(b, gh, gw, d, torch.bfloat16, card, 3)
    packed = torch.cat([q, k, v], dim=-1)
    views = [packed[..., j * d:(j + 1) * d] for j in range(3)]
    assert not views[1].is_contiguous()
    kw = dict(grid_size=(gh, gw), scale=d ** -0.5)
    assert torch.equal(flash_attention_relpos(*views, rh, rw, **kw),
                       flash_attention_relpos(q, k, v, rh, rw, **kw))


# The TMA layout of the bf16 rel-pos forward: SAM-B's global and windowed
# grids, a grid with gh != gw, N = 49 and N = 1, at d = 64 and d = 80 (two
# 64-column chunks), with q, k and v read as strided views of a packed qkv.
RELPOS_TMA_GRIDS = [(64, 64), (14, 14), (48, 64), (7, 7), (1, 1)]


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("gh,gw", RELPOS_TMA_GRIDS)
def test_flash_attention_relpos_reads_a_packed_qkv_at_the_tma_edges(
        card, gh, gw, d, dtype, tol):
    """The output and lse of strided q, k, v against the plain version of
    contiguous copies; where N allows, query 0's scores pass 300 (its lse
    above 100)."""
    b, n = (2 if gh * gw > 1024 else 6), gh * gw
    big = n > 5
    q, k, v, rh, rw = _relpos_inputs(b, gh, gw, d, dtype, card, gh + gw + d,
                                     big)
    packed = torch.cat([q, k, v], dim=-1)
    views = [packed[..., j * d:(j + 1) * d] for j in range(3)]
    kw = dict(grid_size=(gh, gw), scale=d ** -0.5)
    out, lse = flash_attention_relpos_with_lse(*views, rh, rw, **kw)
    ref, ref_lse = flash_attention_relpos_reference(q, k, v, rh, rw, **kw)
    for got, want in ((out, ref), (lse, ref_lse)):
        want = want.float()
        err = (got.float() - want).abs().max().item()
        assert err <= tol * want.abs().max().item(), err
    if big:
        assert ref_lse[:, 0].min().item() > 100.0


@pytest.mark.parametrize("gh,gw", [(14, 14), (7, 7), (4, 5)])
def test_flash_attention_relpos_boxes_stop_at_n(card, gh, gw):
    q, k, v, rh, rw = _relpos_inputs(2, gh, gw, 64, torch.bfloat16, card, gw)
    kw = dict(grid_size=(gh, gw), scale=0.125)
    out, lse = flash_attention_relpos_with_lse(
        *(_next_row_inf(t) for t in (q, k, v)), rh, rw, **kw)
    ref, ref_lse = flash_attention_relpos_reference(
        q[:1], k[:1], v[:1], rh[:1], rw[:1], **kw)
    for got, want in ((out[:1], ref), (lse[:1], ref_lse)):
        want = want.float()
        err = (got.float() - want).abs().max().item()
        assert err <= 2e-2 * want.abs().max().item(), err


def test_flash_attention_relpos_refuses_what_it_does_not_take(card):
    q, k, v, rh, rw = _relpos_inputs(2, 4, 4, 64, torch.float32, card, 0)
    kw = dict(grid_size=(4, 4), scale=0.125)
    with pytest.raises(ValueError):   # f16
        flash_attention_relpos(*(t.half() for t in (q, k, v, rh, rw)), **kw)
    with pytest.raises(ValueError):   # N != gh * gw
        flash_attention_relpos(q, k, v, rh, rw, grid_size=(4, 5), scale=0.125)
    with pytest.raises(ValueError):   # d = 60
        flash_attention_relpos(q[..., :60], k[..., :60], v[..., :60], rh, rw,
                               **kw)
    with pytest.raises(ValueError):   # mixed devices
        flash_attention_relpos(q, k, v, rh.cpu(), rw, **kw)
    with pytest.raises(ValueError):   # rel terms of the wrong shape
        flash_attention_relpos(q, k, v, rw, rh[..., :3], **kw)
    out, lse = flash_attention_relpos_with_lse(q, k, v, rh, rw, **kw)
    bwd = (q, k, v, rh, rw, out, lse, torch.randn_like(out))
    with pytest.raises(ValueError):   # do of another dtype
        flash_attention_relpos_bwd(*bwd[:7], bwd[7].bfloat16(),
                                   grid_size=(4, 4))
    with pytest.raises(ValueError):   # an f64 lse
        flash_attention_relpos_bwd(*bwd[:6], lse.double(), bwd[7],
                                   grid_size=(4, 4))
    with pytest.raises(ValueError):   # N != gh * gw
        flash_attention_relpos_bwd(*bwd, grid_size=(2, 4))


def _relpos_bwd_case(b, gh, gw, d, dtype, device, seed, big=False):
    """The backward's inputs: qs, k, v, the rel terms, the kernel forward's
    out and lse, and a normal cotangent do."""
    q, k, v, rh, rw = _relpos_inputs(b, gh, gw, d, dtype, device, seed, big)
    scale = d ** -0.5
    out, lse = flash_attention_relpos_with_lse(q, k, v, rh, rw,
                                               grid_size=(gh, gw), scale=scale)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    do = torch.randn(out.shape, generator=gen, device=device).to(dtype)
    return scale_query(q, scale), k, v, rh, rw, out, lse, do


@pytest.mark.parametrize("big", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("b,gh,gw,d", RELPOS_SHAPES)
def test_flash_attention_relpos_bwd_kernel_matches_plain(card, b, gh, gw, d,
                                                         dtype, tol, big):
    args = _relpos_bwd_case(b, gh, gw, d, dtype, card, b * gw + gh * d, big)
    kw = dict(grid_size=(gh, gw))
    before = dict(dispatch.launch_counts)
    got = flash_attention_relpos_bwd(*args, **kw)
    torch.cuda.synchronize()
    assert dispatch.launch_counts == {
        **before, "flash_attention_relpos_bwd":
        before["flash_attention_relpos_bwd"] + 1}
    want = flash_attention_relpos_bwd_reference(*args, **kw)
    for name, g, w in zip(("dq", "dk", "dv", "drh", "drw"), got, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        w = w.float()
        err = (g.float() - w).abs().max().item()
        assert err <= tol * w.abs().max().item(), (name, err)
        assert bool(torch.isfinite(g).all()), name


def test_flash_attention_relpos_bwd_reads_strided_inputs_and_repeats(card):
    """qs, k, v as slices of one packed tensor give the gradients of
    contiguous copies, and two calls are bit-identical."""
    b, gh, gw, d = 24, 14, 14, 64
    qs, k, v, rh, rw, out, lse, do = _relpos_bwd_case(
        b, gh, gw, d, torch.bfloat16, card, 5)
    packed = torch.cat([qs, k, v], dim=-1)
    views = [packed[..., j * d:(j + 1) * d] for j in range(3)]
    assert not views[1].is_contiguous()
    kw = dict(grid_size=(gh, gw))
    first = flash_attention_relpos_bwd(qs, k, v, rh, rw, out, lse, do, **kw)
    again = flash_attention_relpos_bwd(qs, k, v, rh, rw, out, lse, do, **kw)
    strided = flash_attention_relpos_bwd(*views, rh, rw, out, lse, do, **kw)
    for a, b_, c in zip(first, again, strided):
        assert torch.equal(a, b_) and torch.equal(a, c)


# The Hopper rel-pos backward at gw = 64 with a ragged gh (48 x 64, its own
# drw and drh path) and the head dims of one and two 64-column chunks.
@pytest.mark.parametrize("d", [8, 80, 128])
def test_flash_attention_relpos_bwd_kernel_at_gw_64_and_other_head_dims(card,
                                                                        d):
    args = _relpos_bwd_case(2, 48, 64, d, torch.bfloat16, card, 48 + d)
    kw = dict(grid_size=(48, 64))
    got = flash_attention_relpos_bwd(*args, **kw)
    want = flash_attention_relpos_bwd_reference(*args, **kw)
    for name, g, w in zip(("dq", "dk", "dv", "drh", "drw"), got, want):
        _held_by(g, w, 2e-2)


@pytest.mark.parametrize("gh,gw", [(64, 64), (14, 14), (7, 7)])
def test_flash_attention_relpos_bwd_packed_offset_and_next_row(card, gh, gw):
    """qs, k, v as views of one packed tensor 16 bytes into its storage give
    the gradients of contiguous copies bit for bit, two calls agree, and
    with every row b but the first set to inf (q, k, v, the rel terms, do)
    row 0 keeps the gradients of its own row, finite."""
    b, d = 3, 64
    n = gh * gw
    qs, k, v, rh, rw, out, lse, do = _relpos_bwd_case(
        b, gh, gw, d, torch.bfloat16, card, gh + gw)
    buf = torch.zeros(b * n * 3 * d + 8, device=card, dtype=torch.bfloat16)
    packed = buf[8:].view(b, n, 3 * d)
    packed.copy_(torch.cat([qs, k, v], dim=-1))
    views = [packed[..., j * d:(j + 1) * d] for j in range(3)]
    assert views[0].storage_offset() == 8 and not views[1].is_contiguous()
    kw = dict(grid_size=(gh, gw))
    rest = (rh, rw, out, lse, do)
    got = flash_attention_relpos_bwd(*views, *rest, **kw)
    again = flash_attention_relpos_bwd(*views, *rest, **kw)
    copies = flash_attention_relpos_bwd(qs, k, v, *rest, **kw)
    for a, b_, c in zip(got, again, copies):
        assert torch.equal(a, b_) and torch.equal(a, c)
    inf = [_next_row_inf(t) for t in (qs, k, v, rh, rw)]
    out_i, lse_i = flash_attention_relpos_with_lse(
        *inf, grid_size=(gh, gw), scale=1.0)
    do_i = _next_row_inf(do)
    got = flash_attention_relpos_bwd(*inf[:3], inf[3], inf[4], out_i, lse_i,
                                     do_i, **kw)
    alone = flash_attention_relpos_bwd(*(t[:1] for t in inf), out_i[:1],
                                       lse_i[:1], do_i[:1], **kw)
    for g, a in zip(got, alone):
        assert bool(torch.isfinite(g[0]).all())
        assert torch.equal(g[:1], a)


def _nan_scratch(rows, n, device, empty=relpos_module.stats_scratch):
    """The statistics scratch, full of NaN where ``torch.empty`` may hold
    anything."""
    return empty(rows, n, device).fill_(float("nan"))


@pytest.mark.parametrize("gh,gw", [(7, 7), (14, 14), (3, 43)])
def test_flash_attention_relpos_bwd_writes_the_padded_statistics_rows(
        card, gh, gw, monkeypatch):
    """Launch A writes every row of the f32 scratch that launch B reads,
    the rows past N included: a scratch that arrives full of NaN gives the
    gradients of an empty one bit for bit, finite (a padded row left as it
    came would put NaN into dk and dv through p^T do)."""
    args = _relpos_bwd_case(2, gh, gw, 64, torch.bfloat16, card, gh * gw)
    kw = dict(grid_size=(gh, gw))
    want = flash_attention_relpos_bwd(*args, **kw)
    monkeypatch.setattr(relpos_module, "stats_scratch", _nan_scratch)
    got = flash_attention_relpos_bwd(*args, **kw)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        assert torch.equal(g, w)


def test_flash_attention_relpos_gives_gradients_through_the_kernels(card):
    """autograd through the Function: one forward and one backward launch,
    the gradients of autograd through the plain forward (f32)."""
    q, k, v, rh, rw = _relpos_inputs(6, 7, 7, 32, torch.float32, card, 8)
    kw = dict(grid_size=(7, 7), scale=32 ** -0.5)
    do = torch.randn_like(q)

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in (q, k, v, rh, rw)]
        out = fn(*leaves, **kw)
        (out[0] if isinstance(out, tuple) else out).backward(do)
        return [t.grad for t in leaves]

    before = dict(dispatch.launch_counts)
    got = grads(flash_attention_relpos)
    assert dispatch.launch_counts == {
        **before,
        "flash_attention_relpos": before["flash_attention_relpos"] + 1,
        "flash_attention_relpos_bwd": before["flash_attention_relpos_bwd"] + 1}
    for g, w in zip(got, grads(flash_attention_relpos_reference)):
        assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item()


def test_sam_attention_gate_on_the_card(card):
    """In eval mode both block kinds take the kernel, with or without
    autograd, and their gradients run the backward kernel; in training a
    window runs eager (no launch) and a global block takes both kernels."""
    window = image_encoder.RelPosAttention(True, 64, 2, True, True, 0.0, 0.0,
                                           (14, 14)).to(card)
    glob = image_encoder.RelPosAttention(True, 64, 2, True, True, 0.0, 0.0,
                                         (32, 32)).to(card)
    x_w = torch.randn(3, 14, 14, 64, device=card)
    x_g = torch.randn(1, 32, 32, 64, device=card)
    fwd, bwd = "flash_attention_relpos", "flash_attention_relpos_bwd"
    for module, x in ((window, x_w), (glob, x_g)):
        before = dict(dispatch.launch_counts)
        with torch.no_grad():
            module(x)
        module(x).sum().backward()
        assert dispatch.launch_counts[fwd] == before[fwd] + 2
        assert dispatch.launch_counts[bwd] == before[bwd] + 1
        assert float(module.rel_pos_h.grad.abs().sum()) > 0
    for module, x, launches in ((window, x_w, 0), (glob, x_g, 1)):
        before = dict(dispatch.launch_counts)
        with Context(training=True):
            y = module(x)
        y.sum().backward()
        assert dispatch.launch_counts[fwd] == before[fwd] + launches
        assert dispatch.launch_counts[bwd] == before[bwd] + launches


# -- pvt_sra and poolformer_block (PVT, PVTv2, PoolFormer) -------------------

# (B, N, S, C): pvt_v2_b2's stage 1 (fewer images), pvt_v2_b0's C = 32,
# S = 256, a ragged N, C = 512, C = 72 with a ragged S, S = 1.
SRA_SHAPES = [(4, 3136, 49, 64), (2, 3136, 49, 32), (2, 200, 256, 64),
              (3, 77, 49, 64), (1, 64, 7, 512), (2, 50, 13, 72),
              (2, 33, 1, 16)]


def _sra_inputs(b, n, s, c, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=device) * scale

    return (rnd(b, n, c).to(dtype), rnd(b, s, 2 * c).to(dtype),
            rnd(c, c, scale=c ** -0.5).to(dtype), rnd(c, scale=0.1),
            rnd(c, c, scale=c ** -0.5).to(dtype), rnd(c, scale=0.1))


def _held_by(got, want, tol):
    want = want.float()
    err = (got.float() - want).abs().max().item()
    assert err <= tol * want.abs().max().item(), err
    assert bool(torch.isfinite(got).all())


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("b,n,s,c", SRA_SHAPES)
def test_pvt_sra_kernel_matches_plain(card, b, n, s, c, dtype, tol):
    x, kv, wq, bq, wp, bp = _sra_inputs(b, n, s, c, dtype, card, n + s + c)
    scale = c ** -0.5
    before = dict(dispatch.launch_counts)
    got = pvt_sra(x, kv, wq, bq, wp, bp, scale)
    torch.cuda.synchronize()
    assert dispatch.launch_counts == {**before,
                                      "pvt_sra": before["pvt_sra"] + 1}
    want = pvt_sra_reference(x, kv[..., :c], kv[..., c:], wq, bq, wp, bp,
                             scale)
    assert got.dtype == dtype and got.shape == want.shape
    _held_by(got, want, tol)


def test_pvt_sra_repeats_and_takes_no_biases(card):
    x, kv, wq, bq, wp, bp = _sra_inputs(2, 3136, 49, 64, torch.bfloat16,
                                        card, 1)
    first = pvt_sra(x, kv, wq, bq, wp, bp, 0.125)
    assert torch.equal(first, pvt_sra(x, kv, wq, bq, wp, bp, 0.125))
    got = pvt_sra(x, kv, wq, None, wp, None, 0.125)
    want = pvt_sra_reference(x, kv[..., :64], kv[..., 64:], wq, None, wp,
                             None, 0.125)
    _held_by(got, want, 2e-2)


def test_pvt_sra_refuses_what_it_does_not_take(card):
    x, kv, wq, bq, wp, bp = _sra_inputs(2, 16, 4, 64, torch.float32, card, 2)
    with pytest.raises(ValueError):   # f16
        pvt_sra(x.half(), kv.half(), wq, bq, wp, bp, 0.125)
    with pytest.raises(ValueError):   # C = 60
        pvt_sra(x[..., :60], kv[..., :120], wq[:60, :60], bq[:60],
                wp[:60, :60], bp[:60], 0.125)
    with pytest.raises(ValueError):   # S = 300
        pvt_sra(x, torch.zeros(2, 300, 128, device=card), wq, bq, wp, bp, 0.1)
    with pytest.raises(ValueError):   # mixed devices
        pvt_sra(x, kv, wq.cpu(), bq, wp, bp, 0.125)
    with pytest.raises(NotImplementedError):   # no backward
        pvt_sra(x.requires_grad_(), kv, wq, bq, wp, bp, 0.125)


def _wider(t, extra, fill):
    """A view of t's values in a tensor ``extra`` columns wider in its
    middle dimension (rows past t's hold ``fill``): the same shape, a
    longer batch stride."""
    b, s, c = t.shape
    big = torch.full((b, s + extra, c), fill, dtype=t.dtype, device=t.device)
    big[:, :s].copy_(t)
    return big[:, :s]


def test_pvt_sra_takes_each_route(card):
    """bf16 with C a multiple of 16 up to 64 and S up to 64 (pvt_v2_b2's and
    pvt_v2_b0's stage 1, a ragged N, S = 1, kv a view with rows of NaN past
    S) runs the TMA + wgmma body; S = 256, C = 512, C = 72 and f32 run the
    first bodies (the profile names them). Each within its bar."""
    cases = [((4, 3136, 49, 64), torch.bfloat16, False, "wgmma"),
             ((2, 3136, 49, 32), torch.bfloat16, False, "wgmma"),
             ((3, 77, 49, 64), torch.bfloat16, False, "wgmma"),
             ((2, 33, 1, 16), torch.bfloat16, False, "wgmma"),
             ((3, 200, 49, 64), torch.bfloat16, True, "wgmma"),
             ((2, 200, 256, 64), torch.bfloat16, False, "bf16"),
             ((1, 64, 7, 512), torch.bfloat16, False, "bf16"),
             ((2, 50, 13, 72), torch.bfloat16, False, "bf16"),
             ((3, 77, 49, 64), torch.float32, False, "f32")]
    for (b, n, s, c), dtype, wide, body in cases:
        x, kv, wq, bq, wp, bp = _sra_inputs(b, n, s, c, dtype, card, n + c)
        if wide:
            kv = _wider(kv, 15, float("nan"))
        names, got = _profiled_names(
            lambda: pvt_sra(x, kv, wq, bq, wp, bp, c ** -0.5),
            [f"pvt_sra_{body}_kernel"])
        assert f"pvt_sra_{body}_kernel" in names
        assert body == "wgmma" or "wgmma" not in names
        _held_by(got, pvt_sra_reference(x, kv[..., :c], kv[..., c:], wq, bq,
                                         wp, bp, c ** -0.5),
                 2e-2 if dtype == torch.bfloat16 else 1e-5)


@pytest.mark.parametrize("b,n,s,c", [(300, 49, 49, 64), (300, 64, 1, 16)])
def test_pvt_sra_walks_many_one_tile_images(card, b, n, s, c):
    """One 64-row tile an image and three tiles on some of the blocks, so
    that the two consumers take alternate images and release each other's
    k and v buffers (tests/test_torch_pvt_sra_order.py walks these
    barriers): the wgmma body ends and is held by the plain version."""
    x, kv, wq, bq, wp, bp = _sra_inputs(b, n, s, c, torch.bfloat16, card, b)
    names, got = _profiled_names(
        lambda: pvt_sra(x, kv, wq, bq, wp, bp, c ** -0.5),
        ["pvt_sra_wgmma_kernel"])
    assert "pvt_sra_wgmma_kernel" in names
    _held_by(got, pvt_sra_reference(x, kv[..., :c], kv[..., c:], wq, bq, wp,
                                     bp, c ** -0.5), 2e-2)


# (B, H, W, C, hidden): poolformer_s12's four stage shapes (two images), a
# 4x4 map where the edges dominate, an odd C (element loads), one row.
POOL_SHAPES = [(2, 56, 56, 64, 256), (2, 28, 28, 128, 512),
               (2, 14, 14, 320, 1280), (2, 7, 7, 512, 2048),
               (3, 4, 4, 8, 32), (2, 5, 3, 12, 20), (1, 1, 6, 16, 64)]


def _pool_inputs(b, h, w, c, hidden, dtype, device, seed):
    """x normal, the norm weights and layer scales near 1 (at the init
    scale of 1e-5 the block would be x to bf16 precision), the MLP scaled to
    unit-size products."""
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=g, device=device) * scale + shift

    near_one = dict(scale=0.1, shift=1.0)
    return (rnd(b, h, w, c).to(dtype), rnd(c, **near_one), rnd(c, scale=0.1),
            rnd(c, **near_one), rnd(c, **near_one), rnd(c, scale=0.1),
            rnd(hidden, c, scale=c ** -0.5).to(dtype), rnd(hidden, scale=0.1),
            rnd(c, hidden, scale=hidden ** -0.5).to(dtype), rnd(c, scale=0.1),
            rnd(c, **near_one))


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("b,h,w,c,hidden", POOL_SHAPES)
def test_poolformer_block_kernel_matches_plain(card, b, h, w, c, hidden,
                                               dtype, tol):
    args = _pool_inputs(b, h, w, c, hidden, dtype, card, h * w + c)
    before = dict(dispatch.launch_counts)
    got = poolformer_block(*args)
    torch.cuda.synchronize()
    assert dispatch.launch_counts == {
        **before, "poolformer_block": before["poolformer_block"] + 1}
    want = poolformer_block_reference(*args)
    assert got.dtype == dtype and got.shape == want.shape
    _held_by(got, want, tol)


# poolformer_block at PoolFormer-S12's stage shapes at batch 128 and
# chip_smoke.py's edges (B, H, W, C, hidden): a 4x4 map, C = 60 and C = 6
# (the mma.sync GEMMs, one channel a pool thread).
POOL_STAGE_CASES = [(128, 56, 56, 64, 256), (128, 28, 28, 128, 512),
                    (128, 14, 14, 320, 1280), (128, 7, 7, 512, 2048)]
POOL_EDGE_CASES = [(128, 4, 4, 64, 256), (16, 7, 7, 60, 240),
                   (4, 5, 3, 6, 24)]


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("b,h,w,c,hidden", POOL_STAGE_CASES + POOL_EDGE_CASES)
def test_poolformer_block_at_the_stage_shapes_and_edges(card, b, h, w, c,
                                                        hidden, dtype, tol):
    args = _pool_inputs(b, h, w, c, hidden, dtype, card, b + h * w + c)
    got = poolformer_block(*args)
    want = poolformer_block_reference(*args)
    assert got.dtype == dtype and got.shape == want.shape
    _held_by(got, want, tol)


@pytest.mark.parametrize("c,hidden,moved,wgmma,runs", [
    (64, 256, None, True, True),      # the TMA + wgmma GEMMs, 8-channel runs
    (60, 240, None, False, False),    # 120-byte bf16 rows: mma.sync, and a
                                      # channel a pool thread
    (64, 256, "w1", False, True),     # w1 off 16 bytes: mma.sync
    (64, 256, "x", True, False),      # x one element off: a channel a thread
])
def test_poolformer_block_takes_each_route(card, c, hidden, moved, wgmma,
                                           runs):
    """The GEMM body the route decides and the pool's form, named by the
    profile, each within the bf16 bar."""
    args = list(_pool_inputs(2, 14, 14, c, hidden, torch.bfloat16, card, c))
    if moved is not None:
        i = {"x": 0, "w1": 6}[moved]
        args[i] = _offset(args[i])
    body = "wgmma" if wgmma else "tile"
    want = [f"pf_fc1_{body}_kernel", f"pf_fc2_{body}_kernel", "pool_x1_kernel"]
    names, got = _profiled_names(lambda: poolformer_block(*args), want)
    for key in want:
        assert key in names, key
    assert ("pool_x1_kernel<__nv_bfloat16, 8>" in names) is runs
    _held_by(got, poolformer_block_reference(*args), 2e-2)


def test_poolformer_block_repeats(card):
    args = _pool_inputs(4, 56, 56, 64, 256, torch.bfloat16, card, 3)
    assert torch.equal(poolformer_block(*args), poolformer_block(*args))


def test_poolformer_block_refuses_what_it_does_not_take(card):
    args = list(_pool_inputs(1, 4, 4, 8, 32, torch.float32, card, 4))
    with pytest.raises(ValueError):   # f16
        poolformer_block(args[0].half(), *args[1:])
    with pytest.raises(ValueError):   # w1 of the wrong shape
        poolformer_block(*args[:6], args[6][:, :4], *args[7:])
    with pytest.raises(ValueError):   # mixed devices
        poolformer_block(*args[:10], args[10].cpu())
    with pytest.raises(NotImplementedError):   # no backward
        poolformer_block(args[0].requires_grad_(), *args[1:])


@pytest.mark.parametrize("name,kernel,launches", [
    ("pvt_v2_b0", "pvt_sra", 2), ("pvt_tiny", "pvt_sra", 2),
    ("poolformer_s12", "poolformer_block", 12)])
def test_models_launch_their_kernel_when_switched_on(card, monkeypatch, name,
                                                     kernel, launches):
    """A registered variant at its full widths on the card, with the switch
    on: the expected launches, and logits within 5e-2 of the same weights in
    f32 on the CPU; with the switch off, no launch."""
    import tfimm_tpu_torch as tfm

    model = tfm.create_model(name, device=card, dtype=torch.bfloat16,
                             input_size=(64, 64), seed=0)
    g = torch.Generator().manual_seed(0)
    sd = {k: (1.0 + 0.1 * torch.randn(v.shape, generator=g)
              if k.endswith(("layer_scale_1", "layer_scale_2"))
              else v.float()) for k, v in model.state_dict().items()}
    model.load_state_dict(sd)
    x = torch.randn(2, 64, 64, 3, generator=g)
    for switch, want_launches in (("1", launches), ("0", 0)):
        monkeypatch.setenv("TFIMM_TPU_FUSED_PVT_SRA", switch)
        monkeypatch.setenv("TFIMM_TPU_FUSED_POOLFORMER", switch)
        before = dispatch.launch_counts[kernel]
        out = model.predict(x.to(card, torch.bfloat16))
        torch.cuda.synchronize()
        assert dispatch.launch_counts[kernel] == before + want_launches
        ref = tfm.create_model(name, device="cpu", input_size=(64, 64))
        ref.load_state_dict(sd)
        want = ref.predict(x)
        err = (out.float().cpu() - want).abs().max() / want.abs().max()
        assert bool(torch.isfinite(out).all()) and err < 5e-2, err


# -- convnext_block (ConvNeXt with TFIMM_TPU_FUSED_CONVNEXT=1) ---------------

# (B, H, W, C, hidden): ConvNeXt-B's four stage shapes (B cut), ConvNeXt-T's
# C = 96, a ragged 9 x 13 map (the taps' edges at every offset),
# convnext_xlarge's widest stage (C = 2048, hidden 8192, 24 KB of f32 a
# pixel in shared memory), an odd C = 12 (element loads, the mma.sync body
# and the row-run depthwise launch), and the TMA tiles' tails (M = 234 off
# 128 rows, C = 96 off 64 columns, hidden 392 off the column tiles, a
# 9 x 13 map off the depthwise tiles of 8 x 8), and hidden 100 (the mma.sync
# GEMMs beside the tiled depthwise launch).
CONVNEXT_BLOCK_SHAPES = [(2, 56, 56, 128, 512), (2, 28, 28, 256, 1024),
                         (2, 14, 14, 512, 2048), (2, 7, 7, 1024, 4096),
                         (2, 56, 56, 96, 384), (3, 9, 13, 24, 96),
                         (1, 7, 7, 2048, 8192), (2, 5, 3, 12, 48),
                         (2, 9, 13, 96, 392), (2, 14, 14, 64, 100)]


def _convnext_block_inputs(b, h, w, c, hidden, dtype, device, seed):
    """x normal, the taps of a unit-size output, the LN weight and gamma near
    1 (at gamma's init of 1e-6 the block is x to bf16 precision), the MLP
    scaled to unit-size products."""
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=g, device=device) * scale + shift

    near_one = dict(scale=0.1, shift=1.0)
    return (rnd(b, h, w, c).to(dtype), rnd(c, 1, 7, 7, scale=0.2),
            rnd(c, scale=0.1), rnd(c, **near_one), rnd(c, scale=0.1),
            rnd(hidden, c, scale=c ** -0.5).to(dtype), rnd(hidden, scale=0.1),
            rnd(c, hidden, scale=hidden ** -0.5).to(dtype), rnd(c, scale=0.1),
            rnd(c, **near_one))


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("b,h,w,c,hidden", CONVNEXT_BLOCK_SHAPES)
def test_convnext_block_kernel_matches_plain(card, b, h, w, c, hidden, dtype,
                                             tol):
    args = _convnext_block_inputs(b, h, w, c, hidden, dtype, card, h * w + c)
    before = dict(dispatch.launch_counts)
    got = convnext_block(*args)
    torch.cuda.synchronize()
    assert dispatch.launch_counts == {
        **before, "convnext_block": before["convnext_block"] + 1}
    want = convnext_block_reference(*args)
    assert got.dtype == dtype and got.shape == want.shape
    _held_by(got, want, tol)


def test_convnext_block_repeats(card):
    args = _convnext_block_inputs(4, 28, 28, 256, 1024, torch.bfloat16, card, 3)
    assert torch.equal(convnext_block(*args), convnext_block(*args))


def test_convnext_block_takes_each_route(card):
    """x one element off a 16-byte boundary: the mma.sync body and the
    row-run depthwise launch, within the bf16 bar as the TMA route is."""
    from tfimm_tpu_torch.ops.kernels.tma import gemm_route

    args = list(_convnext_block_inputs(2, 14, 14, 128, 512, torch.bfloat16,
                                       card, 6))
    for shift in (False, True):
        x = _offset(args[0]) if shift else args[0]
        assert gemm_route(x.view(-1, 128)) is not shift
        got = convnext_block(x, *args[1:])
        _held_by(got, convnext_block_reference(x, *args[1:]), 2e-2)


def test_convnext_block_depthwise_form_follows_its_operands(card):
    """The tiled depthwise launch runs wherever its 16-byte copies hold,
    whichever body the GEMMs take (a hidden width of 100 keeps mma.sync);
    x one element off a 16-byte boundary takes the row-run form."""
    from torch.profiler import ProfilerActivity, profile

    from tfimm_tpu_torch.ops.kernels.tma import gemm_route

    args = list(_convnext_block_inputs(2, 14, 14, 64, 100, torch.bfloat16,
                                       card, 7))
    assert not gemm_route(args[7])   # w2 (64, 100): 200-byte rows
    for shift in (False, True):
        x = _offset(args[0]) if shift else args[0]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            got = convnext_block(x, *args[1:])
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        assert any("dw_ln" in n for n in names)
        assert any("dw_ln_tile" in n for n in names) is not shift
        _held_by(got, convnext_block_reference(x, *args[1:]), 2e-2)


def test_convnext_block_refuses_what_it_does_not_take(card):
    args = list(_convnext_block_inputs(1, 4, 4, 8, 32, torch.float32, card, 4))
    with pytest.raises(ValueError):   # f16
        convnext_block(args[0].half(), *args[1:])
    with pytest.raises(ValueError):   # w1 of the wrong shape
        convnext_block(*args[:5], args[5][:, :4], *args[6:])
    with pytest.raises(ValueError):   # a 3x3 depthwise weight
        convnext_block(args[0], args[1][..., :3, :3], *args[2:])
    with pytest.raises(ValueError):   # mixed devices
        convnext_block(*args[:9], args[9].cpu())
    with pytest.raises(ValueError):   # not contiguous
        convnext_block(args[0].transpose(1, 2), *args[1:])
    with pytest.raises(NotImplementedError):   # no backward
        convnext_block(args[0].requires_grad_(), *args[1:])
    c = MAX_CHANNELS + 8
    wide = _convnext_block_inputs(1, 1, 1, c, 8, torch.bfloat16, card, 5)
    with pytest.raises(ValueError):   # wider than a block's shared memory
        convnext_block(*wide)


def test_convnext_launches_convnext_block_when_switched_on(card, monkeypatch):
    """convnext_tiny at its full widths on the card in bf16: with the switch
    on, one convnext_block launch a block and no convnext_mlp; off, the
    reverse. Logits within 5e-2 of the same weights in f32 on the CPU."""
    import tfimm_tpu_torch as tfm

    model = tfm.create_model("convnext_tiny", device=card, dtype=torch.bfloat16,
                             input_size=(64, 64), seed=0)
    g = torch.Generator().manual_seed(0)
    sd = {k: (1.0 + 0.1 * torch.randn(v.shape, generator=g)
              if k.endswith("gamma") else v.float())
          for k, v in model.state_dict().items()}
    model.load_state_dict(sd)
    x = torch.randn(2, 64, 64, 3, generator=g)
    blocks = sum(model.cfg.nb_blocks)
    ref = tfm.create_model("convnext_tiny", device="cpu", input_size=(64, 64))
    ref.load_state_dict(sd)
    want = ref.predict(x)
    for switch, fused in (("1", blocks), ("0", 0)):
        monkeypatch.setenv("TFIMM_TPU_FUSED_CONVNEXT", switch)
        before = dict(dispatch.launch_counts)
        out = model.predict(x.to(card, torch.bfloat16))
        torch.cuda.synchronize()
        assert dispatch.launch_counts == {
            **before, "convnext_block": before["convnext_block"] + fused,
            "convnext_mlp": before["convnext_mlp"] + blocks - fused}
        err = (out.float().cpu() - want).abs().max() / want.abs().max()
        assert bool(torch.isfinite(out).all()) and err < 5e-2, err


# -- flash_attention (ViT at N >= 1024, the public attention op) -------------

# (B, H, N, d): ViT-B/16 at 512x512 (B cut), SAM-B's global shape (12 heads
# of one image at 64 x 64), N = 1024, one token, a ragged 63, d = 8, 128
# and 256, d = 136 (the split head columns with a ragged half), and more
# rows (B * H = 70,000) than one launch's gridDim.y of 65,535.
FLASH_SHAPES = [(2, 12, 1025, 64), (1, 12, 4096, 64), (2, 3, 1024, 64),
                (3, 2, 1, 64), (2, 2, 63, 64), (2, 2, 130, 8),
                (1, 2, 300, 128), (1, 2, 200, 256), (1, 2, 77, 136),
                (70000, 1, 16, 8)]


# Each shape plain and, where it has keys 3 and 5, with large scores.
FLASH_CASES = [(shape, big) for shape in FLASH_SHAPES for big in (False, True)
               if not big or shape[2] > 5]


def _flash_inputs(shape, dtype, device, seed, big=False):
    """q, k, v normal; with ``big``, query 0 of every row points along keys
    3 and 5, so that two of its scores sit near 300: far above the clamp of
    80 of ``fused_mha``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen, device=device)
               for _ in range(3))
    if big:
        q[..., 0, :] = 300.0 / shape[-1] ** 0.5 * (k[..., 3, :] + k[..., 5, :])
    return [t.to(dtype) for t in (q, k, v)]


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("shape,big", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(card, shape, big, dtype, tol):
    q, k, v = _flash_inputs(shape, dtype, card, sum(shape), big)
    before = dict(dispatch.launch_counts)
    out, lse = flash_attention_with_lse(q, k, v)
    torch.cuda.synchronize()
    assert dispatch.launch_counts == {
        **before, "flash_attention": before["flash_attention"] + 1}
    assert out.dtype == dtype and lse.dtype == torch.float32
    ref, ref_lse = flash_attention_reference(q, k, v)
    _held_by(out, ref, tol)
    _held_by(lse, ref_lse, 1e-5)
    if big:   # most rows' query 0 (a short k_3 at d = 8 may fall short)
        assert ref_lse[..., 0].median().item() > 100.0


def test_flash_attention_reads_the_packed_qkv(card):
    """q, k, v as strided views of one (B, N, 3 * H * d) projection and o
    written as (B, N, H * d): the output of contiguous copies."""
    b, n, h, d = 2, 1025, 12, 64
    gen = torch.Generator(device=card).manual_seed(4)
    qkv = torch.randn(b, n, 3 * h * d, generator=gen, device=card).bfloat16()
    q, k, v = qkv.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4).contiguous()
    want = flash_attention(q, k, v, scale=0.125)
    got = flash_attention_packed(qkv, h, 0.125)
    assert got.shape == (b, n, h * d) and got.is_contiguous()
    assert torch.equal(got, want.transpose(1, 2).reshape(b, n, h * d))


# The TMA layout of the bf16 flash forward (csrc/flash_attention.cu): N
# around the 64-key tiles and the 128-row blocks (1025: one row in the last
# block, whose second warpgroup runs no loop), one and two 64-column chunks
# (zero-filled past d), d = 256 past the TMA body, and H from 1 to 12.
TMA_FLASH_N = [1, 63, 64, 65, 127, 128, 129, 1024, 1025]
TMA_FLASH_D = [8, 64, 80, 128, 256]
TMA_FLASH_H = [1, 3, 12]


@pytest.mark.parametrize("n,d", list(itertools.product(TMA_FLASH_N,
                                                       TMA_FLASH_D)))
def test_flash_attention_kernel_matches_plain_at_the_tma_edges(card, n, d):
    for h in TMA_FLASH_H:
        q, k, v = _flash_inputs((2, h, n, d), torch.bfloat16, card,
                                n * 3 + d + h)
        out, lse = flash_attention_with_lse(q, k, v)
        ref, ref_lse = flash_attention_reference(q, k, v)
        _held_by(out, ref, 2e-2)
        _held_by(lse, ref_lse, 1e-5)


@pytest.mark.parametrize("n,d", [(1, 64), (63, 8), (129, 80), (1025, 64),
                                 (65, 128), (200, 256)])
def test_flash_attention_packed_route_at_the_tma_edges(card, n, d):
    """The packed qkv's strided views give the output of contiguous copies
    bit for bit, at every H."""
    for h in TMA_FLASH_H:
        gen = torch.Generator(device=card).manual_seed(n + d + h)
        qkv = torch.randn(2, n, 3 * h * d, generator=gen,
                          device=card).bfloat16()
        parts = qkv.view(2, n, 3, h, d).permute(2, 0, 3, 1, 4).contiguous()
        want = flash_attention(*parts, scale=0.125)
        got = flash_attention_packed(qkv, h, 0.125)
        assert torch.equal(got, want.transpose(1, 2).reshape(2, n, h * d)), h


@pytest.mark.parametrize("n", [63, 65, 1025])
def test_flash_attention_boxes_stop_at_the_head_and_image(card, n):
    """Head 1 and image 1 of the packed qkv set to inf: a box of head 0 that
    ran past N or past d would carry them in."""
    b, h, d = 2, 3, 64
    gen = torch.Generator(device=card).manual_seed(n)
    qkv = torch.randn(b, n, 3, h, d, generator=gen, device=card).bfloat16()
    want = flash_attention(*qkv[:1].permute(2, 0, 3, 1, 4)[:, :, :1],
                           scale=0.125)
    qkv[:, :, :, 1] = float("inf")
    qkv[1] = float("inf")
    got = flash_attention_packed(qkv.reshape(b, n, 3 * h * d), h, 0.125)
    head0 = got[:1, :, :d]
    assert bool(torch.isfinite(head0).all())
    assert torch.equal(head0, want[0, 0][None])


def _flash_bwd_case(shape, dtype, device, seed, big=False):
    """The backward's inputs: qs, k, v, the kernel forward's out and lse,
    and a normal cotangent do."""
    q, k, v = _flash_inputs(shape, dtype, device, seed, big)
    out, lse = flash_attention_with_lse(q, k, v)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    do = torch.randn(out.shape, generator=gen, device=device).to(dtype)
    return scale_query(q, shape[-1] ** -0.5), k, v, out, lse, do


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("shape,big", FLASH_CASES)
def test_flash_attention_bwd_kernel_matches_plain(card, shape, big, dtype,
                                                  tol):
    args = _flash_bwd_case(shape, dtype, card, sum(shape) + 1, big)
    before = dict(dispatch.launch_counts)
    got = flash_attention_bwd(*args)
    torch.cuda.synchronize()
    assert dispatch.launch_counts == {
        **before, "flash_attention_bwd": before["flash_attention_bwd"] + 1}
    want = flash_attention_bwd_reference(*args)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        assert bool(torch.isfinite(g).all()), name
        if shape[2] == 1 and name != "dv":
            # One key: p = 1, so dq and dk are 0, and both versions give the
            # rounding noise of dp - delta; held against max|dv|.
            err = g.float().abs().max().item()
            assert err <= 1e-4 * want[2].float().abs().max().item(), name
        else:
            _held_by(g, w, tol)


def test_flash_attention_bwd_reads_strided_inputs_and_repeats(card):
    """qs, k, v as views of one packed tensor give the gradients of
    contiguous copies, and two calls are bit-identical."""
    shape = (2, 4, 1025, 64)
    qs, k, v, out, lse, do = _flash_bwd_case(shape, torch.bfloat16, card, 6)
    packed = torch.cat([qs, k, v], dim=-1)
    views = [packed[..., j * 64:(j + 1) * 64] for j in range(3)]
    assert not views[1].is_contiguous()
    first = flash_attention_bwd(qs, k, v, out, lse, do)
    again = flash_attention_bwd(qs, k, v, out, lse, do)
    strided = flash_attention_bwd(*views, out, lse, do)
    for a, b_, c in zip(first, again, strided):
        assert torch.equal(a, b_) and torch.equal(a, c)


# The Hopper backward (csrc/attention_bwd.cuh) up to d = 128: N around the
# 64-row tiles and the padded statistics scratch, one and two 64-column
# chunks, d = 256 on the mma.sync body, H from 1 to 12.
@pytest.mark.parametrize("n,d", list(itertools.product(TMA_FLASH_N,
                                                       TMA_FLASH_D)))
def test_flash_attention_bwd_kernel_matches_plain_at_the_tma_edges(card, n, d):
    for h in TMA_FLASH_H:
        args = _flash_bwd_case((2, h, n, d), torch.bfloat16, card,
                               5 * n + d + h)
        got = flash_attention_bwd(*args)
        want = flash_attention_bwd_reference(*args)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            assert bool(torch.isfinite(g).all()), (h, name)
            if n == 1 and name != "dv":   # 0 up to both versions' noise
                err = g.float().abs().max().item()
                assert err <= 1e-4 * want[2].float().abs().max().item(), h
            else:
                _held_by(g, w, 2e-2)


def _packed_bwd_operands(b, h, n, d, device, seed):
    """qs, k, v as (B, H, N, d) views of one packed (B, N, 3, H, d) tensor
    that starts 16 bytes into its storage, the kernel forward's out and lse
    of them, and a normal cotangent."""
    gen = torch.Generator(device=device).manual_seed(seed)
    buf = torch.randn(b * n * 3 * h * d + 8, generator=gen,
                      device=device).bfloat16()
    packed = buf[8:].view(b, n, 3, h, d)
    assert packed.storage_offset() == 8 and packed.data_ptr() % 16 == 0
    qs, k, v = packed.permute(2, 0, 3, 1, 4).unbind(0)
    out, lse = flash_attention_with_lse(qs, k, v, scale=1.0)
    do = torch.randn(out.shape, generator=gen, device=device).bfloat16()
    return packed, (qs, k, v, out, lse, do)


@pytest.mark.parametrize("n,d", [(63, 64), (129, 80), (1025, 64), (65, 128)])
def test_flash_attention_bwd_reads_a_packed_qkv_at_an_offset(card, n, d):
    """Strided views of a packed projection at a storage offset give the
    gradients of contiguous copies bit for bit, and two calls agree."""
    _, args = _packed_bwd_operands(2, 3, n, d, card, n + d)
    got = flash_attention_bwd(*args)
    again = flash_attention_bwd(*args)
    copies = flash_attention_bwd(*(t.contiguous() for t in args))
    for a, b_, c in zip(got, again, copies):
        assert torch.equal(a, b_) and torch.equal(a, c)


@pytest.mark.parametrize("n", [63, 65, 1025])
def test_flash_attention_bwd_boxes_stop_at_the_head_and_image(card, n):
    """Head 1 and image 1 of the packed qkv (and so of out and lse) set to
    inf: head 0 of image 0 gets the gradients of its own head alone, finite
    and bit for bit; a box that ran past N or d, or a statistics row of
    another head, would carry the inf in."""
    b, h, d = 2, 3, 64
    packed, _ = _packed_bwd_operands(b, h, n, d, card, n)
    packed[:, :, :, 1] = float("inf")
    packed[1] = float("inf")
    qs, k, v = packed.permute(2, 0, 3, 1, 4).unbind(0)
    out, lse = flash_attention_with_lse(qs, k, v, scale=1.0)
    do = torch.randn(out.shape, device=card).bfloat16()
    got = flash_attention_bwd(qs, k, v, out, lse, do)
    alone = flash_attention_bwd(*(t[:1, :1].contiguous()
                                  for t in (qs, k, v, out, lse, do)))
    for g, a in zip(got, alone):
        assert bool(torch.isfinite(g[0, 0]).all())
        assert torch.equal(g[:1, :1], a)


@pytest.mark.parametrize("n,d", [(1, 64), (63, 64), (65, 80), (1025, 64),
                                 (130, 128)])
def test_flash_attention_bwd_writes_the_padded_statistics_rows(card, n, d,
                                                               monkeypatch):
    """As the rel-pos backward's: a statistics scratch that arrives full of
    NaN gives the gradients of an empty one bit for bit, finite."""
    args = _flash_bwd_case((2, 3, n, d), torch.bfloat16, card, n + d)
    want = flash_attention_bwd(*args)
    monkeypatch.setattr(flash_module, "stats_scratch", _nan_scratch)
    got = flash_attention_bwd(*args)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        assert torch.equal(g, w)


def test_flash_attention_gives_gradients_through_the_kernels(card):
    """autograd through the Function: one forward and one backward launch,
    the gradients of autograd through the plain forward (f32)."""
    q, k, v = _flash_inputs((2, 3, 1030, 32), torch.float32, card, 8)
    do = torch.randn_like(q)

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves, scale=0.2)
        (out[0] if isinstance(out, tuple) else out).backward(do)
        return [t.grad for t in leaves]

    before = dict(dispatch.launch_counts)
    got = grads(flash_attention)
    assert dispatch.launch_counts == {
        **before, "flash_attention": before["flash_attention"] + 1,
        "flash_attention_bwd": before["flash_attention_bwd"] + 1}
    for g, w in zip(got, grads(flash_attention_reference)):
        _held_by(g, w, 1e-4)


def test_flash_attention_refuses_what_it_does_not_take(card):
    q, k, v = _flash_inputs((2, 2, 64, 64), torch.float32, card, 0)
    with pytest.raises(ValueError):   # f16
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):   # d = 60
        flash_attention(q[..., :60], k[..., :60], v[..., :60])
    wide = torch.zeros(1, 1, 8, 264, device=card)
    with pytest.raises(ValueError):   # d = 264
        flash_attention(wide, wide, wide)
    with pytest.raises(ValueError):   # mixed devices
        flash_attention(q, k, v.cpu())
    with pytest.raises(ValueError):   # k of another length
        flash_attention(q, k[..., :32, :], v[..., :32, :])
    qs, k, v, out, lse, do = _flash_bwd_case((2, 2, 64, 64), torch.float32,
                                             card, 1)
    with pytest.raises(ValueError):   # do of another dtype
        flash_attention_bwd(qs, k, v, out, lse, do.bfloat16())
    with pytest.raises(ValueError):   # an f64 lse
        flash_attention_bwd(qs, k, v, out, lse.double(), do)


def test_vit_attention_routes_by_length_on_the_card(card):
    """MultiHeadAttention at N = 1025 launches flash (and its backward under
    autograd), at N = 197 fused_mha, in bf16."""
    from tfimm_tpu_torch.ops import MultiHeadAttention

    layer = MultiHeadAttention(768, 12).to(card, torch.bfloat16)
    for n, fwd, bwd in ((1025, "flash_attention", "flash_attention_bwd"),
                        (197, "fused_mha", "fused_mha_bwd")):
        x = torch.randn(2, n, 768, device=card, dtype=torch.bfloat16,
                        requires_grad=True)
        before = dict(dispatch.launch_counts)
        layer(x).float().sum().backward()
        torch.cuda.synchronize()
        assert dispatch.launch_counts == {**before, fwd: before[fwd] + 1,
                                          bwd: before[bwd] + 1}
        assert bool(torch.isfinite(x.grad).all())


# -- ln_dense -----------------------------------------------------------------
# (M, C, O, bias): ViT-B/16's LN1 -> qkv and LN2 -> fc1 with M cut to a few
# images, ViT-L's C = 1024, C = 96 with O = 40 and no bias (which the TPU
# declines), C = 100 (element copies in bf16), a C that needs the 16-row dx
# block, and M = 1.
LN_DENSE_SHAPES = [(394, 768, 2304, True), (394, 768, 3072, True),
                   (197, 1024, 3072, True), (197, 96, 40, False),
                   (130, 100, 36, True), (40, 3072, 64, True),
                   (1, 768, 256, True)]


def _ln_dense_inputs(m, c, o, bias, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=g, device=device) * scale + shift

    return (rnd(m, c, scale=2.0, shift=0.5).to(dtype),
            rnd(c, scale=0.1, shift=1.0), rnd(c, scale=0.1),
            rnd(o, c, scale=c ** -0.5).to(dtype),
            rnd(o, scale=0.1) if bias else None, rnd(m, o).to(dtype))


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("m,c,o,bias", LN_DENSE_SHAPES)
def test_ln_dense_kernel_matches_plain(card, m, c, o, bias, dtype, tol):
    x, gamma, beta, w, b, _ = _ln_dense_inputs(m, c, o, bias, dtype, card,
                                               m + c + o)
    before = dispatch.launch_counts["ln_dense"]
    got = ln_dense(x, gamma, beta, w, b, eps=1e-6)
    torch.cuda.synchronize()
    assert dispatch.launch_counts["ln_dense"] == before + 1
    _held_by(got, ln_dense_reference(x, gamma, beta, w, b, 1e-6), tol)


@pytest.mark.parametrize("dtype,tol,sum_tol", [(torch.bfloat16, 2e-2, 2e-2),
                                               (torch.float32, 1e-5, 1e-4)])
@pytest.mark.parametrize("m,c,o,bias", LN_DENSE_SHAPES)
def test_ln_dense_bwd_kernel_matches_plain(card, m, c, o, bias, dtype, tol,
                                           sum_tol):
    x, gamma, beta, w, _, gy = _ln_dense_inputs(m, c, o, bias, dtype, card,
                                                m + c + o + 1)
    before = dispatch.launch_counts["ln_dense_bwd"]
    got = ln_dense_bwd(x, gamma, beta, w, gy, bias, 1e-6)
    torch.cuda.synchronize()
    assert dispatch.launch_counts["ln_dense_bwd"] == before + 1
    want = ln_dense_bwd_reference(x, gamma, beta, w, gy, bias, 1e-6)
    assert (got[4] is None) == (not bias)
    for i, (a, b) in enumerate(zip(got, want)):
        if b is not None:
            assert a.dtype == b.dtype and a.shape == b.shape
            _held_by(a, b, tol if i == 0 else sum_tol)


def test_ln_dense_forward_takes_each_route(card):
    """ViT-B/16's LN1 -> qkv on the TMA + wgmma body, at 256- and 128-column
    tiles; O = 36, C = 100 and x off a 16-byte boundary on the mma.sync
    body; rows of mean 30 on both. Each within the bf16 bar."""
    from tfimm_tpu_torch.ops.kernels.tma import gemm_route

    for m, c, o, shift, route in [(394, 768, 2304, False, True),
                                  (394, 768, 128, False, True),
                                  (130, 768, 36, False, False),
                                  (130, 100, 128, False, False),
                                  (394, 768, 2304, True, False)]:
        x, gamma, beta, w, b, _ = _ln_dense_inputs(m, c, o, True,
                                                   torch.bfloat16, card, o)
        for far in (False, True):
            xi = (30.0 + x.float()).to(torch.bfloat16) if far else x
            xi = _offset(xi) if shift else xi
            out = torch.empty(m, o, dtype=torch.bfloat16, device=card)
            assert gemm_route(xi, w, out, ln_depth=c) is route
            _held_by(ln_dense(xi, gamma, beta, w, b, eps=1e-6),
                     ln_dense_reference(xi, gamma, beta, w, b, 1e-6), 2e-2)


def test_ln_dense_bwd_takes_each_route(card):
    """ViT-B/16's LN1 -> qkv and LN2 -> fc1, ViT-L's C = 1024, C = 96 with
    O = 40 and M = 1 run the TMA + wgmma backward; C = 100 with O = 36,
    C = 3072, f32 and x off a 16-byte boundary run the first body (the
    profile names their launches). Each within its bars."""
    cases = [((394, 768, 2304), torch.bfloat16, False, "wgmma"),
             ((394, 768, 3072), torch.bfloat16, False, "wgmma"),
             ((197, 1024, 3072), torch.bfloat16, False, "wgmma"),
             ((197, 96, 40), torch.bfloat16, False, "wgmma"),
             ((1, 768, 256), torch.bfloat16, False, "wgmma"),
             ((130, 100, 36), torch.bfloat16, False, "first"),
             ((40, 3072, 64), torch.bfloat16, False, "first"),
             ((394, 768, 2304), torch.float32, False, "first"),
             ((394, 768, 2304), torch.bfloat16, True, "first")]
    wgmma = ["ln_dense_dz_wgmma_kernel", "ln_dense_dx_rows_kernel",
             "ln_dense_dw_wgmma_kernel"]
    first = ["ln_dense_dx_kernel", "ln_dense_dw_kernel"]
    for (m, c, o), dtype, shift, body in cases:
        x, gamma, beta, w, _, gy = _ln_dense_inputs(m, c, o, True, dtype,
                                                    card, m + o)
        x = _offset(x) if shift else x
        need = wgmma if body == "wgmma" else first
        names, got = _profiled_names(
            lambda: ln_dense_bwd(x, gamma, beta, w, gy, True, 1e-6), need)
        assert all(key in names for key in need)
        assert body == "wgmma" or "wgmma" not in names
        want = ln_dense_bwd_reference(x, gamma, beta, w, gy, True, 1e-6)
        fp32 = dtype == torch.float32
        for i, (a, r) in enumerate(zip(got, want)):
            _held_by(a, r, (1e-5 if i == 0 else 1e-4) if fp32 else 2e-2)


def test_ln_dense_bwd_repeats_bit_for_bit(card):
    args = _ln_dense_inputs(394, 768, 2304, True, torch.bfloat16, card, 7)
    x, gamma, beta, w, _, gy = args
    first = ln_dense_bwd(x, gamma, beta, w, gy, True, 1e-6)
    second = ln_dense_bwd(x, gamma, beta, w, gy, True, 1e-6)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_ln_dense_gives_gradients_through_the_kernels(card):
    x, gamma, beta, w, b, gy = _ln_dense_inputs(2 * 197, 768, 2304, True,
                                                torch.bfloat16, card, 9)
    leaves = [t.clone().requires_grad_() for t in (x, gamma, beta, w, b)]
    counts = dict(dispatch.launch_counts)
    y = ln_dense_or_none(leaves[0].view(2, 197, 768), *leaves[1:], eps=1e-6)
    assert y.shape == (2, 197, 2304)
    y.backward(gy.view(2, 197, 2304))
    torch.cuda.synchronize()
    assert dispatch.launch_counts["ln_dense"] == counts["ln_dense"] + 1
    assert dispatch.launch_counts["ln_dense_bwd"] == counts["ln_dense_bwd"] + 1
    want = ln_dense_bwd_reference(x, gamma, beta, w, gy, True, 1e-6)
    for leaf, ref in zip(leaves, want):
        _held_by(leaf.grad, ref, 2e-2)


def test_ln_dense_refuses_what_it_does_not_take(card):
    x, gamma, beta, w, b, gy = _ln_dense_inputs(8, 96, 40, True,
                                                torch.float32, card, 11)
    with pytest.raises(ValueError):
        ln_dense(x.half(), gamma, beta, w.half(), b)
    with pytest.raises(ValueError):
        ln_dense(x[:, ::2], gamma[:48], beta[:48], w[:, :48], b)
    with pytest.raises(ValueError):
        ln_dense(x, gamma, beta, w.t().contiguous(), b)
    with pytest.raises(ValueError):
        ln_dense(x, gamma.cpu(), beta, w, b)
    wide = torch.zeros(2, 4096, device=card)
    with pytest.raises(ValueError):
        ln_dense(wide, torch.ones(4096, device=card),
                 torch.zeros(4096, device=card),
                 torch.zeros(8, 4096, device=card), None)
    with pytest.raises(ValueError):
        ln_dense_bwd(x, gamma, beta, w, gy[:, :8])


# -- float16 models take their plain paths (no f16 kernel) -------------------

F16_MODELS = [
    ("convnext_tiny", dict(input_size=(64, 64)), {}),
    ("swin_tiny_patch4_window7_224", {}, {}),
    ("cait_xxs24_224", dict(nb_blocks=2), {}),
    ("pvt_v2_b0", dict(input_size=(64, 64)), {"TFIMM_TPU_FUSED_PVT_SRA": "1"}),
    ("poolformer_s12", dict(input_size=(64, 64)),
     {"TFIMM_TPU_FUSED_POOLFORMER": "1"}),
    ("vit_base_patch16_224", dict(nb_blocks=2, input_size=(512, 512)), {}),
    ("sam_vit_b", dict(input_size=(256, 256), encoder_nb_blocks=2,
                       encoder_global_attn_indices=(1,)), {}),
]


@pytest.mark.parametrize("name,overrides,env", F16_MODELS)
def test_float16_models_run_their_plain_paths(card, monkeypatch, name,
                                              overrides, env):
    """A registered variant in float16 on the card, switches on: no kernel
    launch and no error, and the output within 5e-2 of max|f32| of the same
    weights (the f32 model on the card, its kernels included). SAM: the
    image encoder, as ``set_image`` runs it."""
    import tfimm_tpu_torch as tfm

    for var, value in env.items():
        monkeypatch.setenv(var, value)
    model = tfm.create_model(name, device=card, seed=0, **overrides)
    g = torch.Generator().manual_seed(0)
    sd = {k: (1.0 + 0.1 * torch.randn(v.shape, generator=g)
              if k.rsplit(".", 1)[-1].startswith(("gamma", "layer_scale"))
              else v.float()) for k, v in model.state_dict().items()}
    sd = {k: (0.02 * torch.randn(v.shape, generator=g)
              if k.startswith("head") else v) for k, v in sd.items()}
    model.load_state_dict(sd)
    size = model.cfg.input_size
    x = torch.randn(2, *size, 3, generator=g).to(card)

    def run(m, dtype):
        with torch.inference_mode():
            if name.startswith("sam"):
                return m.image_encoder(x.to(dtype))
            return m.predict(x.to(dtype))

    want = run(model, torch.float32).float()
    before = dict(dispatch.launch_counts)
    got = run(model.half(), torch.float16)
    torch.cuda.synchronize()
    assert dispatch.launch_counts == before
    assert got.dtype == torch.float16 and bool(torch.isfinite(got).all())
    _held_by(got, want, 5e-2)


# -- the conv nets' ops (ResNet, VGG, ConvMixer, PiT, EfficientNet) -----------
# Conv2d's cuDNN route on the card against the same conv on the CPU (f32
# with TF32 off 1e-5 * max, bf16 2e-2): ResNet-50's 7x7 stem, a 3x3, a
# ResNeXt 32-group 3x3 at stride 2, ConvMixer's depthwise 7x7 SAME, PiT's
# pooling conv (groups = C_in, 2 C_in outputs), an asymmetric SAME pad,
# a strided 1x1 and EfficientNet's stride-2 depthwise convs under TF SAME
# (k = 3 and 5 on even maps: pads (0, 1), through F.pad); the NHWC result
# contiguous, so the next layer copies nothing.
CONV_CASES = [(3, 64, 7, 2, 3, 1, 224), (64, 64, 3, 1, 1, 1, 56),
              (256, 256, 3, 2, 1, 32, 28), (96, 96, 7, 1, "same", 96, 32),
              (64, 128, 3, 2, 1, 64, 31), (16, 32, 3, 2, "same", 1, 14),
              (64, 256, 1, 2, 0, 1, 28), (144, 144, 3, 2, "same", 144, 56),
              (240, 240, 5, 2, "same", 240, 28)]


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("cin,cout,k,s,pad,groups,side", CONV_CASES)
def test_conv2d_on_the_card_matches_the_cpu(card, cin, cout, k, s, pad,
                                            groups, side, dtype, tol):
    from tfimm_tpu_torch.ops.conv import Conv2d

    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        conv = Conv2d(cin, cout, k, stride=s, padding=pad, groups=groups,
                      generator=torch.Generator().manual_seed(cin + k))
        assert not conv.patchify
        x = torch.randn(2, side, side, cin,
                        generator=torch.Generator().manual_seed(side))
        want = conv.to(dtype)(x.to(dtype)).float()
        got = conv.to(card)(x.to(card, dtype))
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert got.is_contiguous() and got.dtype == dtype
    assert (got.float().cpu() - want).abs().max() <= tol * want.abs().max()


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("b,n,h,d", [(8, 962, 4, 64), (8, 730, 3, 48),
                                     (8, 257, 8, 64), (8, 65, 12, 48)])
def test_fused_mha_at_the_pit_shapes(card, b, n, h, d, dtype, tol):
    """PiT-B's and PiT-S's stages (batch cut to 8): the kernel against its
    plain version, and its backward (PiT training) likewise."""
    g = torch.Generator(device=card).manual_seed(n + h)
    qkv = torch.randn(b, n, 3 * h * d, generator=g, device=card).to(dtype)
    out = fused_mha(qkv, h, d ** -0.5)
    ref = fused_mha_reference(qkv, h, d ** -0.5)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    go = torch.randn(b, n, h * d, generator=g, device=card).to(dtype)
    dqkv = fused_mha_bwd(qkv, go, h, d ** -0.5)
    dref = fused_mha_bwd_reference(qkv, go, h, d ** -0.5).float()
    bar = (2e-2 if dtype == torch.bfloat16 else 1e-4) * dref.abs().max()
    assert (dqkv.float() - dref).abs().max() <= bar


# -- BiT and the hybrid ViTs (ResNetV2's StdConv2d, fused_mha at N = 577) -----
# StdConv2d on the card against the same conv on the CPU (f32 with TF32 off
# 1e-5 * max, bf16 2e-2): the weight standardised at each call in f32, then
# the F.linear route (1x1 at stride 1: the bottlenecks' conv1 and conv3) or
# cuDNN's (the 7x7 stems under both paddings, a strided 3x3 and 1x1 under
# SAME, an odd map's uneven SAME pads).
STD_CONV_CASES = [(64, 256, 1, 1, "same", 24), (256, 64, 1, 1, "symmetric", 23),
                  (3, 64, 7, 2, "symmetric", 64), (3, 64, 7, 2, "same", 63),
                  (128, 128, 3, 2, "same", 24), (128, 128, 3, 1, "same", 13),
                  (256, 512, 1, 2, "same", 24)]


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("cin,cout,k,s,pad,side", STD_CONV_CASES)
def test_std_conv2d_on_the_card_matches_the_cpu(card, cin, cout, k, s, pad,
                                                side, dtype, tol):
    from tfimm_tpu_torch.ops.conv import StdConv2d

    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        conv = StdConv2d(cin, cout, k, stride=s, padding=pad, use_bias=False,
                         generator=torch.Generator().manual_seed(cin + k))
        assert conv.patchify == (k == 1 and s == 1)
        x = torch.randn(2, side, side, cin,
                        generator=torch.Generator().manual_seed(side))
        want = conv.to(dtype)(x.to(dtype)).float()
        got = conv.to(card)(x.to(card, dtype))
        torch.cuda.synchronize()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev
    assert got.dtype == dtype
    assert (got.float().cpu() - want).abs().max() <= tol * want.abs().max()


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-5)])
def test_fused_mha_at_the_hybrid_shape(card, dtype, tol):
    """ViT-B/16-R50's blocks at 384x384 (N = 577, H = 12, d = 64; batch cut
    to 8): the forward and the backward against their plain versions; in
    bf16 on the TMA + wgmma bodies, in f32 on the FMA bodies (the profile
    names them)."""
    b, n, h, d = 8, 577, 12, 64
    g = torch.Generator(device=card).manual_seed(577)
    qkv = torch.randn(b, n, 3 * h * d, generator=g, device=card).to(dtype)
    go = torch.randn(b, n, h * d, generator=g, device=card).to(dtype)
    kind = "bf16" if dtype == torch.bfloat16 else "f32"
    fwd = [f"fused_mha_fwd_{kind}_kernel"]
    bwd = [f"fused_mha_bwd_dq_{kind}_kernel", f"fused_mha_bwd_dkv_{kind}_kernel"]
    names, out = _profiled_names(lambda: fused_mha(qkv, h, d ** -0.5), fwd)
    assert all(key in names for key in fwd), names
    ref = fused_mha_reference(qkv, h, d ** -0.5)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    names, dqkv = _profiled_names(lambda: fused_mha_bwd(qkv, go, h, d ** -0.5),
                                  bwd)
    assert all(key in names for key in bwd), names
    dref = fused_mha_bwd_reference(qkv, go, h, d ** -0.5).float()
    bar = (2e-2 if dtype == torch.bfloat16 else 1e-4) * dref.abs().max()
    assert (dqkv.float() - dref).abs().max() <= bar


# -- SAM's automatic mask generator and LoRA-ConvNeXt ------------------------

_TINY_SAM = dict(input_size=(64, 64), encoder_embed_dim=16, encoder_nb_blocks=2,
                 encoder_nb_heads=2, embed_dim=8, encoder_global_attn_indices=(1,),
                 encoder_window_size=2, prompt_mask_hidden_dim=4,
                 decoder_nb_blocks=2, decoder_nb_heads=2,
                 decoder_mlp_channels=16, decoder_iou_hidden_dim=8)


def _seeded_sam(device, seed=4):
    """The tiny SAM of tests/models/test_amg.py with every tensor drawn
    from a seed: norm weights near 1, rel-pos tables and the position
    embedding at std 0.5, the rest 0.2."""
    import tfimm_tpu_torch as tfm

    model = tfm.create_model("sam_vit_b", device="cpu", **_TINY_SAM)
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for name, t in model.state_dict().items():
        r = torch.randn(t.shape, generator=g)
        if "norm" in name and name.endswith("weight"):
            sd[name] = 1.0 + 0.1 * r
        elif name.endswith(("rel_pos_h", "rel_pos_w", "pos_embed")):
            sd[name] = 0.5 * r
        else:
            sd[name] = 0.2 * r
    model.load_state_dict(sd)
    return model.to(device)


def test_mask_generator_batch_on_the_card_matches_the_cpu(card):
    """One batch of ``_process_points`` in f32 with TF32 off, on the card
    and on the CPU, against one embedding: a mask pixel may differ only
    where the CPU logit lies within 1e-4 of the threshold; IoU predictions
    and stability scores within 1e-4; boxes equal where the masks are."""
    from tfimm_tpu_torch.architectures.segment_anything import (
        SAMAutomaticMaskGenerator,
    )
    from tfimm_tpu_torch.architectures.segment_anything.amg import (
        build_point_grid,
    )
    from tfimm_tpu_torch.ops.resize import resize_linear

    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        image = np.random.default_rng(7).integers(0, 255, (44, 36, 3)).astype(
            np.uint8)
        gens = {}
        for device in ("cpu", card):
            gen = SAMAutomaticMaskGenerator(_seeded_sam(device))
            gen.predictor.set_image(image)
            gens[str(device)] = gen
        cpu, gpu = gens["cpu"], gens[str(card)]
        gpu.predictor.image_embedding = cpu.predictor.image_embedding.to(card)
        points = build_point_grid(8) * np.array([36, 44], np.float32)
        scaled = torch.as_tensor(cpu.predictor.resizer.scale_points(
            points.astype(np.float32)))
        crop = (44, 36)
        before = dict(dispatch.launch_counts)
        got = gpu._process_points(scaled.to(card), crop)
        torch.cuda.synchronize()
        assert dispatch.launch_counts == before   # the decode runs no kernel
        want = cpu._process_points(scaled, crop)
        masks, iou, stability, boxes = (t.cpu() for t in got)
        assert masks.shape == want[0].shape == (3 * 64, *crop)

        pred = cpu.predictor
        n = len(scaled)
        up, _, _ = pred._decode(
            scaled[:, None], torch.ones(n, 1, dtype=torch.int32),
            torch.zeros(n, 0, 4), torch.zeros(n, 0, *pred.mask_size()), True)
        rh, rw = pred.resizer.rescaled_size
        logits = resize_linear(up.reshape(-1, *up.shape[2:])[:, :rh, :rw],
                               (3 * n, *crop))
        near = (logits - pred.model.mask_threshold).abs() < 1e-4
        differ = masks != want[0]
        assert not (differ & ~near).any()
        torch.testing.assert_close(iou.float(), want[1].float(), atol=1e-4,
                                   rtol=0)
        torch.testing.assert_close(stability, want[2], atol=1e-4, rtol=0)
        same = ~differ.any(dim=(1, 2))
        assert torch.equal(boxes[same], want[3][same])
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def test_lora_convnext_block_feeds_convnext_mlp_the_merged_weights(card):
    """A bf16 ConvNeXt block whose MLP layers are LoRA layers with a
    nonzero B, at inference on the card: one ``convnext_mlp`` launch,
    within 2e-2 * max|plain| of the kernel's plain version fed the merged
    weights; the plain version fed the base weights misses that bar."""
    from tfimm_tpu_torch.architectures.convnext import ConvNeXtBlock
    from tfimm_tpu_torch.architectures.lora import convert_to_lora_layer

    g = torch.Generator().manual_seed(14)
    block = ConvNeXtBlock(128, 4.0, False, 0.0, 0.0, "layer_norm_eps_1e-6",
                          "gelu", 1.0, generator=g)
    block.mlp.fc1 = convert_to_lora_layer(block.mlp.fc1, lora_rank=4,
                                          lora_alpha=4.0, generator=g)
    block.mlp.fc2 = convert_to_lora_layer(block.mlp.fc2, lora_rank=4,
                                          lora_alpha=4.0, generator=g)
    with torch.no_grad():
        for fc in (block.mlp.fc1, block.mlp.fc2):
            fc.weight_lora_b.normal_(0.0, 0.1, generator=g)
    block = block.to(card, torch.bfloat16).eval()
    x = torch.randn(4, 14, 14, 128, generator=g).to(card, torch.bfloat16)
    before = dispatch.launch_counts["convnext_mlp"]
    with torch.inference_mode():
        got = block(x).float()
        y = block.conv_dw(x).reshape(-1, 128)
        mlp = block.mlp
        common = (x.reshape(-1, 128), block.norm.weight, block.norm.bias)

        def plain(w1, w2):
            return convnext_mlp_reference(
                y, *common, w1, mlp.fc1.bias, w2, mlp.fc2.bias, block.gamma,
                block.norm.eps).float().reshape(got.shape)

        merged = plain(mlp.fc1._kernel(torch.bfloat16),
                       mlp.fc2._kernel(torch.bfloat16))
        unmerged = plain(mlp.fc1.weight, mlp.fc2.weight)
    torch.cuda.synchronize()
    assert dispatch.launch_counts["convnext_mlp"] == before + 1
    bar = 2e-2 * merged.abs().max()
    assert (got - merged).abs().max() <= bar
    assert (got - unmerged).abs().max() > 5 * bar


# -- int8 quantization ----------------------------------------------------------

# int8_dense_matmul (M, K, N): ViT-B/16's qkv rows at batch 2, fc2, the
# padded shapes (M <= 16, K and N off multiples of 8); int8_conv (B, H, W,
# C, O, k, stride, padding).
INT8_DENSE_CASES = [(394, 768, 2304), (394, 3072, 768), (5, 100, 36),
                    (16, 8, 8), (17, 7, 9)]
INT8_CONV_CASES = [(2, 14, 14, 256, 256, 3, 1, "SAME"),
                   (2, 15, 15, 128, 128, 3, 2, "SAME"),
                   (2, 8, 8, 64, 64, 2, 2, "VALID"),
                   (1, 9, 11, 5, 7, 3, 1, ((1, 2), (0, 1)))]


def _int8_weight(shape, seed):
    g = torch.Generator().manual_seed(seed)
    wq = torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)
    ws = torch.rand(shape[0], generator=g) * 1e-3 + 1e-4
    return wq, ws, g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", INT8_DENSE_CASES)
def test_int8_dense_matmul_on_the_card_equals_the_cpu(card, m, k, n, dtype):
    """The same seeded int8 weight and activations: the card's output
    equals the CPU's bit for bit (integer sums are exact in any order, and
    the roundings are the same)."""
    from tfimm_tpu_torch.quant import int8_dense_matmul

    wq, ws, g = _int8_weight((n, k), m + k + n)
    x = (torch.randn(m, k, generator=g) * 3).to(dtype)
    want = int8_dense_matmul((wq, ws), x)
    got = int8_dense_matmul((wq.to(card), ws.to(card)), x.to(card))
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got.cpu(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,c,o,k,s,pad", INT8_CONV_CASES)
def test_int8_conv_on_the_card_equals_the_cpu(card, b, h, w, c, o, k, s, pad,
                                              dtype):
    from tfimm_tpu_torch.quant import int8_conv

    wq, ws, g = _int8_weight((o, c, k, k), b * h + c)
    x = torch.randn(b, h, w, c, generator=g).to(dtype)
    want = int8_conv((wq, ws), x, (s, s), pad, (1, 1))
    got = int8_conv((wq.to(card), ws.to(card)), x.to(card), (s, s), pad,
                    (1, 1))
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got.cpu(), want)


def test_int8_layers_give_gradients_on_the_card(card):
    """The straight-through backward on the card: the input gradient of a
    quantized Dense and conv equals g against the dequantized weight."""
    from tfimm_tpu_torch.quant import int8_conv, int8_dense_matmul

    wq, ws, g = _int8_weight((48, 64), 3)
    x = torch.randn(20, 64, generator=g, device="cpu").to(card)
    x.requires_grad_()
    int8_dense_matmul((wq.to(card), ws.to(card)), x).sum().backward()
    w = wq.float() * ws[:, None]
    assert torch.allclose(x.grad.cpu(), w.sum(0).expand(20, 64), rtol=1e-5,
                          atol=1e-5)
    wq, ws, g = _int8_weight((16, 8, 3, 3), 4)
    x = torch.randn(2, 6, 6, 8, generator=g).to(card).requires_grad_()
    int8_conv((wq.to(card), ws.to(card)), x, (1, 1), "SAME",
              (1, 1)).sum().backward()
    assert torch.isfinite(x.grad).all() and x.grad.abs().max() > 0


@pytest.mark.parametrize("name,overrides,rules,env,launches", [
    ("swin_tiny_patch4_window7_224",
     dict(input_size=(56, 56), embed_dim=64, nb_heads=(2, 4),
          nb_blocks=(2, 2)), dict(min_features=128), {},
     {"swin_block": 2, "window_mha": 0}),
    ("convnext_base", dict(input_size=(32, 32), embed_dim=(128, 256),
                           nb_blocks=(1, 1)), dict(min_features=256),
     {"TFIMM_TPU_FUSED_CONVNEXT": "0"}, {"convnext_mlp": 1}),
    ("convnext_base", dict(input_size=(32, 32), embed_dim=(128, 256),
                           nb_blocks=(1, 1)), dict(min_features=256),
     {"TFIMM_TPU_FUSED_CONVNEXT": "1"}, {"convnext_block": 1})])
def test_int8_models_launch_where_their_float_blocks_are(
        card, monkeypatch, name, overrides, rules, env, launches):
    """A small bf16 model quantized in its second stage: the float stage
    launches its kernel, the int8 stage declines it, on the card; finite
    logits."""
    import tfimm_tpu_torch as tfm
    from tfimm_tpu_torch.quant import quantize_int8

    for var, value in env.items():
        monkeypatch.setenv(var, value)
    model = tfm.create_model(name, device=card, dtype=torch.bfloat16, seed=0,
                             **overrides)
    q = quantize_int8(model, **rules)
    x = torch.randn(2, *overrides["input_size"], 3,
                    generator=torch.Generator().manual_seed(5))
    before = dict(dispatch.launch_counts)
    out = q.predict(x.to(card, torch.bfloat16))
    torch.cuda.synchronize()
    assert {k: dispatch.launch_counts[k] - before[k] for k in launches} \
        == launches
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_the_fused_mha_op_is_the_kernel(card, dtype):
    """The no-grad op ``tfimm_tpu_torch::fused_mha``: its fake function
    gives the real output's shape, dtype and device, and its output is bit
    for bit the kernel wrapper's, with one launch a call."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    module = importlib.import_module("tfimm_tpu_torch.ops.kernels.fused_mha")
    g = torch.Generator(device=card).manual_seed(26)
    qkv = torch.randn(4, 197, 3 * 768, generator=g, device=card).to(dtype)
    before = dispatch.launch_counts["fused_mha"]
    with torch.no_grad():
        out = torch.ops.tfimm_tpu_torch.fused_mha(qkv, 12, 0.125)
    direct = module._fused_mha_forward(qkv, 12, 0.125)
    torch.cuda.synchronize()
    assert dispatch.launch_counts["fused_mha"] == before + 2
    assert torch.equal(out, direct)
    with FakeTensorMode() as mode:
        fake = torch.ops.tfimm_tpu_torch.fused_mha(mode.from_tensor(qkv), 12,
                                                   0.125)
    assert (fake.shape, fake.dtype, fake.device) == (out.shape, out.dtype,
                                                     out.device)


def test_an_exported_vit_launches_the_kernel(card, tmp_path):
    """A small f32 ViT exported on the card: its program launches
    fused_mha once a block at run time and matches the eager model."""
    import tfimm_tpu_torch as tfm
    from tfimm_tpu_torch.utils.export import export_model, load_exported

    model = tfm.create_model("vit_tiny_patch16_224", device=card, seed=0,
                             input_size=(64, 64), nb_blocks=2)
    path = str(tmp_path / "model.pt2")
    export_model(model, path, normalize_logits=True)
    exported = load_exported(path)
    assert exported.device.type == "cuda"
    x = torch.randint(0, 256, (5, 64, 64, 3),
                      generator=torch.Generator().manual_seed(3),
                      dtype=torch.uint8)
    before = dispatch.launch_counts["fused_mha"]
    got = exported(x)
    torch.cuda.synchronize()
    assert dispatch.launch_counts["fused_mha"] == before + 2
    pp = tfm.create_preprocessing("vit_tiny_patch16_224", device=card)
    with torch.no_grad():
        want = torch.log_softmax(model(pp(x)), dim=-1)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
