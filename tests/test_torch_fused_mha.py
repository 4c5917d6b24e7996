"""Port parity: tfimm_tpu_torch's fused_mha plain version against the JAX
package's Pallas fused_mha (interpret mode) and its XLA twin _reference_mha.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: 1e-5 in f32 (same math, only the summation order differs);
2e-2 in bf16, the JAX suite's own bar for this kernel (one bf16 rounding of
the output plus the kernel's bf16 cast of p).
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfimm_tpu.ops.pallas.fused_mha import _reference_mha, fused_mha
from tfimm_tpu_torch.ops.kernels import dispatch
from tfimm_tpu_torch.ops.kernels.fused_mha import (
    fused_mha as torch_fused_mha,
    fused_mha_or_none,
    fused_mha_reference,
)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]

_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _qkv(seed, b, n, h, d, gain=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, n, 3 * h * d)) * gain).astype(np.float32)


def _to_torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _to_jax(x, dtype):
    return jnp.asarray(x, getattr(jnp, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h", [(17, 2), (197, 2), (17, 4), (197, 4)])
def test_reference_matches_pallas_and_xla_twin(n, h, dtype):
    d = 64
    scale = d ** -0.5
    x = _qkv(n * 10 + h, 2, n, h, d)
    got = fused_mha_reference(_to_torch(x, dtype), h, scale).float().numpy()
    pallas = np.asarray(fused_mha(_to_jax(x, dtype), h, scale, interpret=True),
                        np.float32)
    twin = np.asarray(_reference_mha(_to_jax(x, dtype), h, scale), np.float32)
    tol = _TOL[dtype]
    np.testing.assert_allclose(got, pallas, atol=tol, rtol=tol)
    np.testing.assert_allclose(got, twin, atol=tol, rtol=tol)


def test_clamp_saturates_like_softmax_nomax():
    """Scores above 80 saturate at exp(80), as softmax_nomax does, instead
    of following a true softmax."""
    b, n, h, d = 2, 17, 2, 64
    scale = d ** -0.5
    x = _qkv(7, b, n, h, d).reshape(b, n, 3, h, d)
    # Query 0 of every head points along keys 3 and 5: both of its scores
    # land near 160, far above the clamp, and differ by several units.
    x[:, 0, 0] = 20.0 * (x[:, 3, 1] + x[:, 5, 1])
    x = x.reshape(b, n, 3 * h * d)
    got = fused_mha_reference(torch.from_numpy(x), h, scale).numpy()
    ref = np.asarray(fused_mha(jnp.asarray(x), h, scale, interpret=True))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)

    q, k, v = (torch.from_numpy(x)[..., i * h * d:(i + 1) * h * d]
               .reshape(b, n, h, d).transpose(1, 2) for i in range(3))
    s = (q * scale) @ k.transpose(-1, -2)
    assert (s[:, :, 0] > dispatch.SOFTMAX_CLAMP).sum(-1).min() >= 2
    true_softmax = (torch.softmax(s, -1) @ v).transpose(1, 2).reshape(b, n, -1)
    assert not np.allclose(got, true_softmax.numpy(), atol=1e-3)


def test_wrapper_runs_plain_version_on_cpu():
    x = torch.from_numpy(_qkv(3, 2, 17, 3, 8))
    before = dispatch.launch_counts["fused_mha"]
    with dispatch.capture_dispatches() as seen:
        out = fused_mha_or_none(x, 3, 8 ** -0.5)
    assert seen == {"fused_mha"}
    torch.testing.assert_close(out, fused_mha_reference(x, 3, 8 ** -0.5))
    torch.testing.assert_close(torch_fused_mha(x, 3, 8 ** -0.5), out)
    assert dispatch.launch_counts["fused_mha"] == before


@pytest.mark.parametrize("shape,heads,dtype", [
    ((2, 5, 3 * 2 * 12), 2, torch.float32),    # d = 12, not a multiple of 8
    ((2, 5, 3 * 2 * 136), 2, torch.float32),   # d = 136 > 128
    ((2, 5, 3 * 2 * 64), 2, torch.float16),    # dtype the kernel does not take
])
def test_dispatcher_declines_what_the_kernel_does_not_take(shape, heads, dtype):
    assert fused_mha_or_none(torch.zeros(shape, dtype=dtype), heads, 1.0) is None


def test_import_pulls_in_no_jax():
    code = ("import sys, tfimm_tpu_torch; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'tfimm_tpu' or m.startswith('tfimm_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
