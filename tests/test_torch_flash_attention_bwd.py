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


# -- The bf16 CUDA kernel's order of work (csrc/attention_bwd.cuh) -----------

LOG2E = 1.4426950408889634
TILE = 64


def kernel_order_bwd(qs, k, v, out, lse, do, *, rounded, rel=None,
                     key_mask=True, nan_scratch=False):
    """The Hopper backward's order of work on (R, N, d) rows, in f32, with
    its bf16 roundings where ``rounded``: (dqs, dk, dv) and, with ``rel =
    (rh, rw, (gh, gw))``, (drh, drw). Launch A writes lse * log2(e) and
    delta = rowsum(do * o) into a scratch padded to whole 64-row tiles
    (+inf and 0 on the padded rows; NaN with ``nan_scratch``, the contents
    of an uninitialised scratch), and per 64-key tile forms
    p = 2^(s log2(e) - lse log2(e)), ds = p (dP - delta), zero past N
    (``key_mask``), dqs += bf16(ds) k and the rel sums: at gw = 64 drw += ds
    and drh[:, t] = rowsum(ds) a tile, otherwise each key's ds into its
    key-grid row and column. Launch B, per 64-query tile, from the scratch:
    p^T, ds^T, dv += bf16(p^T) do, dk += bf16(ds^T) qs. Rows and keys past N
    are zeros, as TMA fills them."""
    r = (lambda t: t.bfloat16().float()) if rounded else (lambda t: t)
    rows, n, d = qs.shape
    n_pad = -(-n // TILE) * TILE

    def padded(t):
        return torch.nn.functional.pad(t.float(), (0, 0, 0, n_pad - n))

    q, kk, vv, o, g = (padded(t) for t in (qs, k, v, out, do))
    fill = float("nan") if nan_scratch else float("inf")
    lse2 = torch.full((rows, n_pad), fill)
    lse2[:, :n] = lse.float() * LOG2E
    delta = (g * o).sum(-1)
    if nan_scratch:
        delta[:, n:] = float("nan")
    keys = torch.arange(n_pad)
    if rel is not None:
        rh, rw, (gh, gw) = rel
        rh, rw = padded(rh), padded(rw)
        kh = torch.clamp(keys // gw, max=gh - 1)
        kw = keys % gw
        drh = torch.zeros(rows, n_pad, gh)
        drw = torch.zeros(rows, n_pad, gw)

    dq = torch.zeros(rows, n_pad, d)
    for t in range(n_pad // TILE):
        cols = slice(TILE * t, TILE * (t + 1))
        s = q @ kk[:, cols].transpose(1, 2)
        if rel is not None:
            s = s + rh[:, :, kh[cols]] + rw[:, :, kw[cols]]
        p = torch.exp2(s * LOG2E - lse2[..., None])
        ds = p * (g @ vv[:, cols].transpose(1, 2) - delta[..., None])
        if key_mask:
            ds = torch.where(keys[cols] < n, ds, torch.zeros(()))
        dq += r(ds) @ kk[:, cols]
        if rel is not None and gw == TILE:
            drw += ds
            drh[:, :, t] = ds.sum(-1)
        elif rel is not None:
            drh.index_add_(2, kh[cols], ds)
            drw.index_add_(2, kw[cols], ds)

    dk = torch.zeros(rows, n_pad, d)
    dv = torch.zeros(rows, n_pad, d)
    own = torch.clamp(keys, max=n - 1)   # (B) reads key 0's grid past N
    for t in range(n_pad // TILE):
        qt = slice(TILE * t, TILE * (t + 1))
        st = kk @ q[:, qt].transpose(1, 2)
        if rel is not None:
            bias = rh[:, qt][:, :, kh[own]] + rw[:, qt][:, :, kw[own]]
            st = st + bias.transpose(1, 2)
        pt = torch.exp2(st * LOG2E - lse2[:, None, qt])
        dst = pt * (vv @ g[:, qt].transpose(1, 2) - delta[:, None, qt])
        dv += r(pt) @ g[:, qt]
        dk += r(dst) @ q[:, qt]
    grads = [t[:, :n] for t in (dq, dk, dv)]
    if rel is not None:
        grads += [drh[:, :n], drw[:, :n]]
    return grads


def _kernel_order_case(shape, dtype, seed):
    """q, k, v, g (numpy) and the emulation's inputs in ``dtype`` as the
    port's Function hands them over: qs, k, v, out, lse and do as
    (R, N, d) rows."""
    arrays = _inputs(seed, shape)
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    scale = shape[-1] ** -0.5
    qs = scale_query(t[0], scale)
    out, lse = _forward_reference(qs, t[1], t[2])
    rows = (-1, *shape[-2:])
    return arrays, scale, [x.reshape(rows) for x in (qs, t[1], t[2], out)] + [
        lse.reshape(rows[:2]), t[3].reshape(rows)]


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("n", [130, 1025])
def test_kernel_order_of_work_matches_the_pallas_backward(n, dtype, tol):
    """The emulation of the bf16 CUDA kernel (tiles of 64, the padded
    scratch, exp2 with log2-scaled lse, p and ds rounded to bf16 before
    their products where bf16) against ``jax.vjp`` of the interpret kernel:
    each gradient within ``tol`` of max|JAX|."""
    shape = (1 if n > 1024 else 2, 2, n, 64)
    arrays, scale, rows = _kernel_order_case(shape, dtype, 3 * n)
    got = kernel_order_bwd(*rows, rounded=dtype == "bfloat16")
    got[0] = got[0] * scale   # dq from dqs through the scale
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jq, jk, jv, jg = (jnp.asarray(a, jdt) for a in arrays)
    _, vjp = jax.vjp(lambda q, k, v: pallas_flash(q, k, v, interpret=True),
                     jq, jk, jv)
    for name, g, w in zip("qkv", got, vjp(jg)):
        want = np.asarray(w.astype(jnp.float32)).reshape(g.shape)
        assert _rel(g.to(getattr(torch, dtype)), want) < tol, name


def test_kernel_order_control_uninitialised_scratch_misses():
    """Control: padded scratch rows left as an uninitialised scratch may hold
    (NaN) give launch B NaN where p^T meets the zero rows of do; with +inf
    and 0 they add nothing."""
    shape = (2, 2, 130, 64)
    _, _, rows = _kernel_order_case(shape, "float32", 8)
    good = kernel_order_bwd(*rows, rounded=False)
    bad = kernel_order_bwd(*rows, rounded=False, nan_scratch=True)
    want = flash_attention_bwd(*rows)
    for g, w in zip(good, want):
        assert _rel(g, w.numpy()) < 1e-4
    assert not bool(torch.isfinite(bad[2]).all())
