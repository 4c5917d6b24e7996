"""Port parity for the flash attention backward's plain version:
``flash_attention_bwd_reference`` of tfimm_tpu_torch (through the autograd
Function, whose backward runs it on CPU tensors) against ``jax.vjp`` of the
JAX package's Pallas ``flash_attention`` in interpret mode (its custom VJP,
``_flash_backward_call``), against autograd through the plain forward, and
gradcheck in f64.

Inputs and cotangents are made with numpy from a seed and handed to both
packages. Bars, as max|diff| / max|JAX| per gradient: 1e-5 in f32 (the same
f32 math, summed in another order); 2e-2 in bf16 (the forward's o, and so
delta, rounds p to bf16 relative to another max; dq, dk, dv round once).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfimm_tpu.ops.pallas.flash_attention_kernel import (
    flash_attention as pallas_flash,
)
from tfimm_tpu_torch.ops.kernels import dispatch
from tfimm_tpu_torch.ops.kernels.flash_attention import (
    _forward_reference,
    flash_attention,
    flash_attention_bwd,
    flash_attention_packed,
    flash_attention_reference,
    scale_query,
)

torch.set_num_threads(1)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _rel(got, want):
    got = np.asarray(got.double() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _inputs(seed, shape, big=False):
    """q, k, v and the cotangent g of ``shape`` (numpy, f32). With ``big``,
    query 0 of every row points along keys 3 and 5: its scores pass 100."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=shape).astype(np.float32) for _ in range(4))
    if big:
        q[..., 0, :] = 20.0 * (k[..., 3, :] + k[..., 5, :])
    return q, k, v, g


def _port_grads(arrays, scale, dtype):
    q, k, v = (torch.from_numpy(a).to(getattr(torch, dtype)).requires_grad_()
               for a in arrays[:3])
    out = flash_attention(q, k, v, scale=scale)
    out.backward(torch.from_numpy(arrays[3]).to(out.dtype))
    return out, [t.grad for t in (q, k, v)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("n", [130, 1025])
def test_gradients_match_jax_vjp_of_the_pallas_kernel(n, d, dtype):
    """dq, dk, dv of the port (scale chained by autograd outside the
    Function) against ``jax.vjp`` of the interpret kernel; (B, H) = (2, 2)
    at N = 130, (1, 2) at 1025; d = 32 with a custom scale."""
    shape = (1 if n > 1024 else 2, 2, n, d)
    scale = 0.3 if d == 32 else None
    arrays = _inputs(n + d, shape)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jq, jk, jv, jg = (jnp.asarray(a, jdt) for a in arrays)
    _, vjp = jax.vjp(lambda q, k, v: pallas_flash(q, k, v, scale=scale,
                                                  interpret=True), jq, jk, jv)
    want = vjp(jg)
    dispatch.reset_launch_counts()
    _, got = _port_grads(arrays, scale, dtype)
    assert sum(dispatch.launch_counts.values()) == 0
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == getattr(torch, dtype), name
        assert _rel(g, np.asarray(w.astype(jnp.float32))) < TOL[dtype], name


@pytest.mark.parametrize("big", [False, True])
def test_gradients_match_autograd_through_the_plain_forward(big):
    """f32 against autograd through the plain forward's own ops (the same
    function differentiated op by op), scores above 100 included."""
    arrays = _inputs(5, (2, 3, 70, 24), big=big)
    _, got = _port_grads(arrays, None, "float32")
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays[:3])
    out, _ = _forward_reference(scale_query(q, 24 ** -0.5), k, v)
    out.backward(torch.from_numpy(arrays[3]))
    for name, g, t in zip("qkv", got, (q, k, v)):
        assert _rel(g, t.grad.numpy()) < 1e-5, name


def test_gradcheck_f64():
    q, k, v = (torch.from_numpy(a).double().requires_grad_()
               for a in _inputs(9, (1, 2, 9, 8))[:3])
    assert torch.autograd.gradcheck(
        lambda q, k, v: flash_attention(q, k, v, scale=0.7), (q, k, v))


def test_bwd_reference_from_saved_tensors():
    """``flash_attention_bwd`` from qs, k, v, o and the lse, as the Function
    calls it, equals the gradients autograd chains through the scale
    (dq = scale * dqs); the lse path gives no gradient."""
    arrays = _inputs(11, (2, 2, 50, 16))
    q, k, v, g = (torch.from_numpy(a) for a in arrays)
    qs = scale_query(q, 0.4)
    out, lse = flash_attention_reference(q, k, v, scale=0.4)
    dqs, dk, dv = flash_attention_bwd(qs, k, v, out, lse, g)
    _, (gq, gk, gv) = _port_grads(arrays, 0.4, "float32")
    assert _rel(0.4 * dqs, gq.numpy()) < 1e-6
    assert torch.equal(dk, gk) and torch.equal(dv, gv)


def test_packed_route_gradients():
    """Gradients through ``flash_attention_packed`` (strided views of one
    qkv) equal those of the heads taken apart."""
    b, n, h, d = 2, 33, 3, 16
    rng = np.random.default_rng(12)
    x = rng.normal(size=(b, n, 3 * h * d)).astype(np.float32)
    g = torch.from_numpy(rng.normal(size=(b, n, h * d)).astype(np.float32))
    qkv = torch.from_numpy(x).requires_grad_()
    flash_attention_packed(qkv, h, 0.25).backward(g)
    parts = [t.contiguous().requires_grad_() for t in
             torch.from_numpy(x).reshape(b, n, 3, h, d).permute(2, 0, 3, 1, 4)]
    out = flash_attention(*parts, scale=0.25)
    out.backward(g.reshape(b, n, h, d).transpose(1, 2))
    want = torch.stack([t.grad for t in parts]).permute(1, 3, 0, 2, 4)
    assert torch.allclose(qkv.grad, want.reshape(b, n, 3 * h * d),
                          rtol=1e-6, atol=1e-6)
