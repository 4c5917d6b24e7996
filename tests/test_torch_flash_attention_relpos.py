"""Port parity for the rel-pos flash attention kernel's plain version:
``flash_attention_relpos_reference`` of tfimm_tpu_torch (through the
wrapper, which runs it on CPU tensors) against the JAX package's Pallas
kernel ``flash_attention_relpos`` in interpret mode, per head and with the
head pairs packed into 128 lanes (``TFIMM_TPU_RELPOS_PAIRED``), and against
the oracle ``_relpos_ref_from_terms`` of tests/ops/test_flash_attention.py.

Inputs are made with numpy from a seed and handed to both packages. Bars,
as max|diff| / max|JAX|: 1e-5 in f32 (the same f32 math, summed in another
order); 2e-2 in bf16 (both round p to bf16 before p @ v, the Pallas kernel
relative to its running max, the plain version relative to the row's max).
The lse is held against ``logsumexp`` of the f32 scores at 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.ops.test_flash_attention import _relpos_ref_from_terms
from tfimm_tpu.ops.pallas.flash_attention_relpos import (
    flash_attention_relpos as pallas_relpos,
)
from tfimm_tpu_torch.ops.kernels import dispatch
from tfimm_tpu_torch.ops.kernels.flash_attention_relpos import (
    flash_attention_relpos,
    flash_attention_relpos_reference,
    flash_attention_relpos_supports,
    flash_attention_relpos_with_lse,
)

torch.set_num_threads(1)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _rel(got, want):
    got = np.asarray(got.double() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _inputs(seed, b, gh, gw, d, big=False):
    """q, k, v (B, N, d) normal; rel terms (B, N, gh), (B, N, gw) at std
    1.5 (numpy, f32). With ``big``, query 0 of every row points along keys
    3 and 5, so that its scores pass 100: far above the clamp
    of 80 that the other attention kernels apply."""
    rng = np.random.default_rng(seed)
    n = gh * gw
    q, k, v = (rng.normal(size=(b, n, d)).astype(np.float32) for _ in range(3))
    if big:
        q[:, 0] = 20.0 * (k[:, 3] + k[:, 5])
    rh = (1.5 * rng.normal(size=(b, n, gh))).astype(np.float32)
    rw = (1.5 * rng.normal(size=(b, n, gw))).astype(np.float32)
    return q, k, v, rh, rw


def _pallas(arrays, grid, scale, block, dtype):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    q, k, v, rh, rw = (jnp.asarray(a, jdt) for a in arrays)
    out = pallas_relpos(q, k, v, rh, rw, grid_size=grid, scale=scale,
                        block_q=block, block_k=block, interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _port(arrays, grid, scale, dtype):
    tdt = getattr(torch, dtype)
    q, k, v, rh, rw = (torch.from_numpy(a).to(tdt) for a in arrays)
    return flash_attention_relpos_with_lse(q, k, v, rh, rw, grid_size=grid,
                                           scale=scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["per_head", "paired", "paired_big"])
def test_plain_matches_pallas_interpret(case, dtype, monkeypatch):
    """Per head: d = 8, gh = gw = 4, block 16. Paired: d = 64 with
    TFIMM_TPU_RELPOS_PAIRED=1 (even B, 2d = 128 lanes), 8 x 8 grid, block
    32; ``paired_big`` also has scores far above 80."""
    if case == "per_head":
        monkeypatch.setenv("TFIMM_TPU_RELPOS_PAIRED", "0")
        b, gh, gw, d, block = 3, 4, 4, 8, 16
    else:
        monkeypatch.setenv("TFIMM_TPU_RELPOS_PAIRED", "1")
        b, gh, gw, d, block = 4, 8, 8, 64, 32
    arrays = _inputs(7, b, gh, gw, d, big=case == "paired_big")
    scale = d ** -0.5
    counts = dict(dispatch.launch_counts)
    got, lse = _port(arrays, (gh, gw), scale, dtype)
    assert dispatch.launch_counts == counts       # CPU: the plain version
    want = _pallas(arrays, (gh, gw), scale, block, dtype)
    assert got.dtype == getattr(torch, dtype) and lse.dtype == torch.float32
    assert _rel(got, want) < TOL[dtype]
    if case == "paired_big":
        q, k = arrays[0], arrays[1]
        assert (q[:, 0] @ k.transpose(0, 2, 1) * scale).max() > 100.0


@pytest.mark.parametrize("big", [False, True])
def test_plain_matches_the_oracle_and_logsumexp(big):
    """f32, a non-square 4 x 6 grid: the output against
    ``_relpos_ref_from_terms`` (jax.nn.softmax over the full scores) and
    the lse against ``logsumexp`` of the same scores."""
    b, gh, gw, d = 2, 4, 6, 16
    q, k, v, rh, rw = _inputs(3, b, gh, gw, d, big=big)
    scale = d ** -0.5
    got, lse = _port((q, k, v, rh, rw), (gh, gw), scale, "float32")
    want = _relpos_ref_from_terms(*(jnp.asarray(a) for a in (q, k, v, rh, rw)),
                                  gh, gw, scale)
    assert _rel(got, want) < 1e-5
    n = gh * gw
    s = (np.einsum("bqd,bkd->bqk", q.astype(np.float64) * np.float32(scale), k)
         .reshape(b, n, gh, gw) + rh[..., :, None] + rw[..., None, :])
    s = s.reshape(b, n, n)
    m = s.max(-1, keepdims=True)
    want_lse = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    assert _rel(lse, want_lse) < 1e-5
    if big:
        assert s.max() > 100.0


def test_bias_terms_enter_by_key_row_and_column():
    """A bias on one key row (rh) or one key column (rw) moves the output
    exactly as the full (N, N) bias with that row or column raised."""
    b, gh, gw, d = 1, 3, 5, 8
    q, k, v, rh, rw = _inputs(5, b, gh, gw, d)
    rh[:] = 0.0
    rw[:] = 0.0
    rh[0, :, 1] = 4.0    # every query prefers key row 1: keys 5..9
    rw[0, :, 3] = -4.0   # and avoids key column 3: keys 3, 8, 13
    scale = d ** -0.5
    got, _ = _port((q, k, v, rh, rw), (gh, gw), scale, "float32")
    bias = np.zeros((gh * gw,), np.float64)
    bias[5:10] += 4.0
    bias[[3, 8, 13]] -= 4.0
    s = np.einsum("bqd,bkd->bqk", q.astype(np.float64) * np.float32(scale), k)
    s = s + bias
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    assert _rel(got, np.einsum("bqk,bkd->bqd", p, v)) < 1e-5


def test_wrapper_runs_the_plain_version_on_the_cpu():
    q, k, v, rh, rw = (torch.from_numpy(a) for a in _inputs(1, 2, 2, 3, 8))
    kw = dict(grid_size=(2, 3), scale=8 ** -0.5)
    out = flash_attention_relpos(q, k, v, rh, rw, **kw)
    ref, _ = flash_attention_relpos_reference(q, k, v, rh, rw, **kw)
    assert torch.equal(out, ref)


def test_supports():
    assert flash_attention_relpos_supports(64, (64, 64))
    assert flash_attention_relpos_supports(80, (14, 14))      # SAM-H
    assert flash_attention_relpos_supports(8, (7, 7))
    assert not flash_attention_relpos_supports(60, (14, 14))
    assert not flash_attention_relpos_supports(136, (14, 14))
    assert not flash_attention_relpos_supports(64, (129, 64))
