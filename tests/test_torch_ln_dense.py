"""The port's fused LayerNorm + Dense (tfimm_tpu_torch/ops/kernels/ln_dense.py)
against the JAX package's Pallas kernels in interpret mode, on the CPU.

The same seeded numpy inputs go through ``ln_dense`` / ``ln_dense_diff`` of
``tfimm_tpu/ops/pallas/ln_dense.py`` (``interpret=True``) and through the
port, whose wrappers run their plain versions on CPU tensors. The JAX ``w``
is (C, O); the port's weight is its transpose. Bars: the forward within
2e-5 of max|JAX| in f32 and 2e-2 in bf16 (a rounding of z or y may land on
the other side); the five gradients within 5e-4 of each one's max|JAX| in
f32 (sums over M = 197 rows in another order) and 2e-2 in bf16.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tfimm_tpu_torch.ops.kernels import dispatch

# The modules themselves: each package exports a function of the same name.
jax_ln_dense = importlib.import_module("tfimm_tpu.ops.pallas.ln_dense")
port = importlib.import_module("tfimm_tpu_torch.ops.kernels.ln_dense")

EPS = 1e-6
SHAPES = [(197, 96, 40), (72, 128, 256)]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(m, c, o, bias=True, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.normal(size=(m, c)).astype(np.float32) * 2 + 0.5,
        gamma=(1 + 0.1 * rng.normal(size=(c,))).astype(np.float32),
        beta=(0.1 * rng.normal(size=(c,))).astype(np.float32),
        w=(0.05 * rng.normal(size=(c, o))).astype(np.float32),
        b=(0.1 * rng.normal(size=(o,))).astype(np.float32) if bias else None,
        g=rng.normal(size=(m, o)).astype(np.float32))


def _jax(a, dtype):
    x = jnp.asarray(a["x"], dtype)
    w = jnp.asarray(a["w"], dtype)
    b = None if a["b"] is None else jnp.asarray(a["b"])
    return x, jnp.asarray(a["gamma"]), jnp.asarray(a["beta"]), w, b


def _torch(a, dtype, requires_grad=False):
    def t(v, dt=torch.float32):
        if v is None:
            return None
        return torch.tensor(v).to(dt).requires_grad_(requires_grad)

    return (t(a["x"], dtype), t(a["gamma"]), t(a["beta"]),
            t(np.ascontiguousarray(a["w"].T), dtype), t(a["b"]))


def _close(got, want, tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("dt,tol", [("f32", 2e-5), ("bf16", 2e-2)])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("m,c,o", SHAPES)
def test_forward_matches_the_pallas_kernel(m, c, o, bias, dt, tol):
    a = _inputs(m, c, o, bias)
    jdt, tdt = DTYPES[dt]
    want = jax_ln_dense.ln_dense(*_jax(a, jdt), eps=EPS, interpret=True)
    got = port.ln_dense(*_torch(a, tdt), eps=EPS)
    assert got.dtype == tdt
    _close(got.float(), jnp.asarray(want, jnp.float32), tol)


@pytest.mark.parametrize("dt,tol", [("f32", 5e-4), ("bf16", 2e-2)])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("m,c,o", SHAPES)
def test_gradients_match_the_pallas_backward(m, c, o, bias, dt, tol):
    a = _inputs(m, c, o, bias, seed=1)
    jdt, tdt = DTYPES[dt]
    jargs = _jax(a, jdt)
    n = 5 if bias else 4

    def fn(*args):
        return jax_ln_dense.ln_dense_diff(*args[:4], args[4] if bias else None,
                                          EPS, True)

    y, vjp = jax.vjp(fn, *jargs[:n])
    want = vjp(jnp.asarray(a["g"], y.dtype))
    targs = _torch(a, tdt, requires_grad=True)
    port.ln_dense_diff(*targs, EPS).backward(torch.tensor(a["g"]).to(tdt))
    for name, got, ref in zip(("dx", "dgamma", "dbeta", "dw", "db"),
                              targs[:n], want):
        grad = got.grad.float()
        if name == "dw":
            grad = grad.t()
        assert got.grad.dtype == got.dtype, name
        _close(grad, jnp.asarray(ref, jnp.float32), tol)


def test_backward_is_the_gradient_of_the_forward():
    """The plain backward against autograd through the plain forward, in
    float64 (where z is not rounded)."""
    a = _inputs(13, 24, 10, seed=2)
    args = [t.double().detach().requires_grad_() for t in _torch(a, torch.float32)]
    assert torch.autograd.gradcheck(
        lambda *t: port.ln_dense_diff(*t, EPS), args)


def test_plain_backward_without_a_bias_gives_none():
    a = _inputs(9, 16, 8, bias=False, seed=3)
    x, gamma, beta, w, _ = _torch(a, torch.float32)
    grads = port.ln_dense_bwd(x, gamma, beta, w, torch.tensor(a["g"]),
                              has_bias=False, eps=EPS)
    assert grads[4] is None
    assert [tuple(t.shape) for t in grads[:4]] == [(9, 16), (16,), (16,),
                                                  (8, 16)]


def test_dispatcher_keeps_leading_dims_on_the_plain_version(monkeypatch):
    monkeypatch.delenv("TFIMM_TPU_LN_DENSE", raising=False)
    a = _inputs(2 * 20, 96, 40, seed=4)
    x, gamma, beta, w, b = _torch(a, torch.float32)
    counts = dict(dispatch.launch_counts)
    with dispatch.capture_dispatches() as seen:
        y = port.ln_dense_or_none(x.reshape(2, 20, 96), gamma, beta, w, b,
                                  eps=EPS)
    assert seen == {"ln_dense"}
    assert dispatch.launch_counts == counts   # the CPU runs no kernel
    assert y.shape == (2, 20, 40)
    want = jax_ln_dense._reference_ln_dense(*_jax(a, jnp.float32), EPS)
    _close(y.reshape(40, 40), want, 2e-5)


def test_dispatcher_declines_opt_out_float16_and_wide_rows(monkeypatch):
    a = _inputs(8, 96, 40, seed=5)
    x, gamma, beta, w, b = _torch(a, torch.float32)
    monkeypatch.setenv("TFIMM_TPU_LN_DENSE", "0")
    assert port.ln_dense_or_none(x, gamma, beta, w, b, eps=EPS) is None
    monkeypatch.setenv("TFIMM_TPU_LN_DENSE", "1")
    assert port.ln_dense_or_none(x.half(), gamma, beta, w.half(), b) is None
    assert port.ln_dense_or_none(x, gamma, beta, w, b) is not None
    wide = torch.zeros(2, 4096)
    assert port.ln_dense_or_none(wide, torch.ones(4096), torch.zeros(4096),
                                 torch.zeros(8, 4096), None) is None


@pytest.mark.parametrize("c,itemsize,rows", [
    (768, 2, 64), (768, 4, 64), (1024, 2, 32), (96, 2, 64), (3072, 2, 16),
    (3318, 2, 16), (3400, 4, None)])
def test_dx_block_rows_fit_shared_memory(c, itemsize, rows):
    assert port.dx_block_rows(c, itemsize) == rows


def test_dw_splits_give_every_slice_rows():
    assert port._dw_splits(12608, 768, 2304, 132) == 5
    assert port._dw_splits(12608, 768, 3072, 132) == 4
    assert port._dw_splits(197, 96, 40, 132) == 1
