"""Port parity: tfimm_tpu_torch's convnext_mlp (its plain version, on the
CPU) against the JAX package's Pallas convnext_mlp in interpret mode and its
XLA twin _reference_mlp.

Inputs are made with numpy from a seed and handed to both packages; the
JAX kernel takes w1 (C, H) and w2 (H, C), the port the Dense layout (H, C)
and (C, H). Tolerances are the JAX suite's own for this kernel: 1e-5 in
f32 (2e-5 for the chunked plan, as there), 5e-2 in bf16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfimm_tpu.ops.pallas.convnext_mlp import _reference_mlp
from tfimm_tpu.ops.pallas.convnext_mlp import convnext_mlp as jax_convnext_mlp
from tfimm_tpu_torch.ops.kernels import dispatch
from tfimm_tpu_torch.ops.kernels.convnext_mlp import (
    convnext_mlp,
    convnext_mlp_reference,
)

torch.set_num_threads(1)

_TOL = {"float32": 1e-5, "bfloat16": 5e-2}


def _inputs(m, c, hidden, seed=0):
    """x, shortcut, ln_w, ln_b, w1 (C, H), b1, w2 (H, C), b2, gamma as f32
    numpy arrays, in the JAX kernel's layout."""
    rng = np.random.default_rng(seed)

    def rnd(*shape, scale=1.0, shift=0.0):
        return (rng.normal(size=shape) * scale + shift).astype(np.float32)

    return (rnd(m, c), rnd(m, c), rnd(c, scale=0.1, shift=1.0),
            rnd(c, scale=0.1), rnd(c, hidden, scale=0.05), rnd(hidden, scale=0.05),
            rnd(hidden, c, scale=0.05), rnd(c, scale=0.05),
            rnd(c, scale=0.1, shift=1.0))


def _jax_args(args, dtype):
    """The io tensors and the weights in the dtype, the vectors in f32 (as
    tests/ops/test_convnext_mlp.py passes them)."""
    dt = getattr(jnp, dtype)
    kinds = (dt, dt, jnp.float32, jnp.float32, dt, jnp.float32, dt,
             jnp.float32, jnp.float32)
    return [jnp.asarray(a, k) for a, k in zip(args, kinds)]


def _torch_args(args, dtype):
    """The same values, with w1 and w2 in the port's Dense layout."""
    x, sc, lw, lb, w1, b1, w2, b2, gamma = args
    dt = getattr(torch, dtype)
    t = torch.from_numpy
    return (t(x).to(dt), t(sc).to(dt), t(lw), t(lb), t(w1.T.copy()).to(dt),
            t(b1), t(w2.T.copy()).to(dt), t(b2), t(gamma))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,c,hidden", [(64, 128, 512), (32, 256, 1024)])
def test_matches_pallas_kernel_in_interpret_mode(m, c, hidden, dtype):
    args = _inputs(m, c, hidden, seed=m + c)
    want = jax_convnext_mlp(*_jax_args(args, dtype), eps=1e-6, interpret=True)
    before = dispatch.launch_counts["convnext_mlp"]
    got = convnext_mlp(*_torch_args(args, dtype), 1e-6)
    assert dispatch.launch_counts["convnext_mlp"] == before  # no kernel on the CPU
    assert got.dtype == getattr(torch, dtype) and got.shape == (m, c)
    _close(got, want, _TOL[dtype])


def test_matches_chunked_pallas_plan():
    # The Pallas kernel's hidden-chunked plan (f32 accumulator carried over
    # four chunks of 1024), forced as the JAX suite forces it.
    args = _inputs(16, 128, 4096, seed=1)
    want = jax_convnext_mlp(*_jax_args(args, "float32"), eps=1e-6,
                            interpret=True, block_plan=(16, 1024, 10 * 2 ** 20))
    _close(convnext_mlp(*_torch_args(args, "float32"), 1e-6), want, 2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [98, 5])
def test_matches_xla_twin_where_pallas_declines(m, dtype):
    # C = 12 is no lane multiple: the Pallas kernel cannot take it, the port's
    # kernel does, so the port is held against the XLA twin.
    args = _inputs(m, 12, 48, seed=3)
    want = _reference_mlp(*_jax_args(args, dtype), 1e-6)
    _close(convnext_mlp(*_torch_args(args, dtype), 1e-6), want, _TOL[dtype])


def test_gelu_follows_the_kernel_dtype_policy(monkeypatch):
    # Like the Pallas kernel, the fused function keeps its tanh GELU in bf16
    # when TFIMM_TPU_EXACT_GELU asks the eager layers for erf.
    monkeypatch.setenv("TFIMM_TPU_EXACT_GELU", "1")
    args = _inputs(32, 128, 512, seed=4)
    want = jax_convnext_mlp(*_jax_args(args, "bfloat16"), eps=1e-6,
                            interpret=True)
    got = convnext_mlp(*_torch_args(args, "bfloat16"), 1e-6)
    _close(got, want, _TOL["bfloat16"])
    ref = convnext_mlp_reference(*_torch_args(args, "bfloat16"), 1e-6)
    assert torch.equal(got, ref)


def test_one_pass_variance_is_clamped():
    # A constant row has E[x^2] - E[x]^2 at or below zero in f32; the clamp
    # keeps rsqrt finite, so z is the LN bias there.
    args = list(_torch_args(_inputs(4, 128, 512, seed=5), "float32"))
    args[0][1] = 3.0
    out = convnext_mlp(*args, 1e-6)
    assert torch.isfinite(out).all()


def test_raises_on_mixed_devices():
    args = list(_torch_args(_inputs(4, 16, 64, seed=6), "float32"))
    args[4] = args[4].to("meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        convnext_mlp(*args, 1e-6)
