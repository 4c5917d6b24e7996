"""Kernel tests that need an NVIDIA card (marker ``cuda``); they skip
without one. This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest tests/test_torch_cuda.py --noconftest -q -p no:cacheprovider

Each CUDA kernel is held against its plain PyTorch version on the card.
Forward: 2e-2 in bf16 (the kernel rounds p to bf16 before p @ v), 1e-5 in
f32 with TF32 off (same math, another summation order). Backward:
max|diff| <= 2e-2 * max|plain| in bf16 (the kernel rounds p and ds to bf16
before their products), 1e-4 * max|plain| in f32 with TF32 off (sums in
another order).
"""

import pytest
import torch

from tfimm_tpu_torch.ops.kernels import dispatch
from tfimm_tpu_torch.ops.kernels.fused_mha import (
    fused_mha,
    fused_mha_bwd,
    fused_mha_bwd_reference,
    fused_mha_reference,
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
