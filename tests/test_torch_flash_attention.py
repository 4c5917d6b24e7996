"""Port parity for the flash attention kernel's plain version and its
routes: ``flash_attention`` of tfimm_tpu_torch (through the wrapper, which
runs the plain version on CPU tensors) against the JAX package's Pallas
kernel ``flash_attention`` in interpret mode, as tests/ops/test_flash_attention.py
runs it; the public ``scaled_dot_product_attention`` against the JAX
package's; and the routing of ``MultiHeadAttention`` by the sequence length.

Inputs are made with numpy from a seed and handed to both packages. Bars,
as max|diff| / max|JAX|: 1e-5 in f32 (the same f32 math, summed in another
order); 2e-2 in bf16 (both round p to bf16 before p @ v, the Pallas kernel
relative to its running max, the plain version relative to the row's max).
The lse is held against ``logsumexp`` of the f64 scores at 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfimm_tpu.ops.attention import (
    scaled_dot_product_attention as jax_sdpa,
)
from tfimm_tpu.ops.pallas.dispatch import capture_dispatches as jax_capture
from tfimm_tpu.ops.pallas.flash_attention_kernel import (
    flash_attention as pallas_flash,
)
from tfimm_tpu_torch.core import Context
from tfimm_tpu_torch.ops import MultiHeadAttention, scaled_dot_product_attention
from tfimm_tpu_torch.ops.kernels import dispatch
from tfimm_tpu_torch.ops.kernels.flash_attention import (
    flash_attention,
    flash_attention_or_none,
    flash_attention_packed,
    flash_attention_reference,
    flash_attention_supports,
    flash_attention_with_lse,
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
    """q, k, v of ``shape`` (..., N, d) normal (numpy, f32). With ``big``,
    query 0 of every row points along keys 3 and 5, so that its scores pass
    100: far above the clamp of 80 that ``fused_mha`` applies."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    if big:
        q[..., 0, :] = 20.0 * (k[..., 3, :] + k[..., 5, :])
    return q, k, v


def _pallas(arrays, scale, dtype):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    q, k, v = (jnp.asarray(a, jdt) for a in arrays)
    out = pallas_flash(q, k, v, scale=scale, interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _port(arrays, scale, dtype):
    q, k, v = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays)
    return flash_attention_with_lse(q, k, v, scale=scale)


def _logsumexp(q, k, scale, dtype):
    """The lse of the f64 scores of the scaled q rounded as the port
    rounds it, and k in the dtype."""
    tdt = getattr(torch, dtype)
    qs = torch.from_numpy(q).to(tdt) * torch.tensor(scale, dtype=tdt).item()
    s = torch.matmul(qs.double(), torch.from_numpy(k).to(tdt).double()
                     .transpose(-1, -2))
    return torch.logsumexp(s, dim=-1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("n", [130, 197, 1025])
def test_plain_matches_pallas_interpret(n, d, dtype):
    """(B, H) = (2, 2) below N = 1024 and (1, 2) at 1025 (the interpret
    kernel is slow there); d = 32 with a custom scale of 0.3, d = 64 with
    the default d ** -0.5."""
    shape = (1 if n > 1024 else 2, 2, n, d)
    scale = 0.3 if d == 32 else None
    arrays = _inputs(n + d, shape)
    want = _pallas(arrays, scale, dtype)
    out, lse = _port(arrays, scale, dtype)
    assert out.dtype == getattr(torch, dtype) and lse.dtype == torch.float32
    assert _rel(out, want) < TOL[dtype]
    lse_want = _logsumexp(arrays[0], arrays[1], scale or d ** -0.5, dtype)
    assert (lse.double() - lse_want).abs().max().item() < 1e-5 * float(
        lse_want.abs().max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_large_scores_follow_the_exact_softmax(dtype):
    """Scores above 100 (query 0): the plain version matches the Pallas
    flash kernel, and the clamped no-max softmax of ``fused_mha``
    (``dispatch.softmax_nomax``, exact only while the scores stay below 80)
    misses the same bar by far."""
    arrays = _inputs(3, (2, 2, 197, 32), big=True)
    want = _pallas(arrays, None, dtype)
    out, _ = _port(arrays, None, dtype)
    q, k, v = (torch.from_numpy(a).double() for a in arrays)
    s = torch.matmul(q * 32 ** -0.5, k.transpose(-1, -2))
    assert s[..., 0, :].max() > 100
    clamped = torch.matmul(dispatch.softmax_nomax(s), v)
    bar = TOL[dtype]
    assert _rel(out, want) < bar
    assert _rel(clamped, want) > 10 * bar


def test_wrapper_keeps_shapes_and_runs_plain_on_the_cpu():
    """(..., N, d) of 3, 4 and 5 dims; no launch on the CPU; the packed
    route equals the attention of the heads taken apart."""
    dispatch.reset_launch_counts()
    for shape in [(3, 40, 16), (2, 3, 40, 16), (2, 1, 3, 40, 16)]:
        q, k, v = (torch.from_numpy(a) for a in _inputs(7, shape))
        out = flash_attention(q, k, v)
        ref, lse = flash_attention_reference(q, k, v)
        assert out.shape == shape and lse.shape == shape[:-1]
        assert torch.equal(out, ref)
    b, n, h, d = 2, 40, 3, 16
    qkv = torch.from_numpy(np.random.default_rng(8).normal(
        size=(b, n, 3 * h * d)).astype(np.float32))
    q, k, v = qkv.reshape(b, n, 3, h, d).permute(2, 0, 3, 1, 4).contiguous()
    want = flash_attention(q, k, v, scale=0.2).transpose(1, 2).reshape(
        b, n, h * d)
    assert torch.allclose(flash_attention_packed(qkv, h, 0.2), want,
                          rtol=1e-6, atol=1e-6)
    assert sum(dispatch.launch_counts.values()) == 0


def test_supports_and_or_none():
    assert flash_attention_supports(64, torch.bfloat16)
    assert flash_attention_supports(256, torch.float32)
    assert flash_attention_supports(8, torch.float32)
    assert not flash_attention_supports(264, torch.float32)
    assert not flash_attention_supports(12, torch.float32)
    assert not flash_attention_supports(64, torch.float16)
    q = torch.zeros(1, 2, 1024, 32)
    assert flash_attention_or_none(q, q, q) is not None
    assert flash_attention_or_none(q[..., :1023, :], q[..., :1023, :],
                                   q[..., :1023, :]) is None
    assert flash_attention_or_none(q, q, q, bias=torch.zeros(1024)) is None
    assert flash_attention_or_none(q, q[..., :512, :], q[..., :512, :]) is None
    assert flash_attention_or_none(q.half(), q.half(), q.half()) is None


def test_public_op_takes_the_kernel_at_1025_as_jax(monkeypatch):
    """N = 1025: the JAX dispatcher takes its flash kernel (interpret mode
    forced), the port its flash plain version; f32 within 1e-5."""
    monkeypatch.setenv("TFIMM_TPU_PALLAS_INTERPRET", "1")
    arrays = _inputs(11, (1, 2, 1025, 32))
    with jax_capture() as jseen:
        want = jax_sdpa(*(jnp.asarray(a) for a in arrays), scale=0.25)
    assert "flash_attention" in jseen
    with dispatch.capture_dispatches() as seen:
        got = scaled_dot_product_attention(
            *(torch.from_numpy(a) for a in arrays), scale=0.25)
    assert seen == {"flash_attention"}
    assert _rel(got, np.asarray(want)) < 1e-5


@pytest.mark.parametrize("case", ["short", "bias", "weights"])
def test_public_op_plain_paths_match_jax(case):
    """N = 197 (below the switch), a bias at N = 1025 and
    ``return_weights``: the plain attention in both packages, f32 within
    1e-5 (output and weights)."""
    n = 1025 if case == "bias" else 197
    arrays = _inputs(13, (2, 2, n, 16))
    bias = (np.random.default_rng(14).normal(size=(2, 1, n, n))
            .astype(np.float32) if case == "bias" else None)
    kwargs = dict(return_weights=case == "weights")
    want = jax_sdpa(*(jnp.asarray(a) for a in arrays),
                    bias=None if bias is None else jnp.asarray(bias),
                    **kwargs)
    with dispatch.capture_dispatches() as seen:
        got = scaled_dot_product_attention(
            *(torch.from_numpy(a) for a in arrays),
            bias=None if bias is None else torch.from_numpy(bias), **kwargs)
    assert seen == {"attention[plain]"}
    if case == "weights":
        assert _rel(got[1], np.asarray(want[1])) < 1e-5
        got, want = got[0], want[0]
    assert _rel(got, np.asarray(want)) < 1e-5


@pytest.mark.parametrize("n,path", [(1024, "flash_attention"),
                                    (1025, "flash_attention"),
                                    (1023, "fused_mha"), (197, "fused_mha")])
def test_attention_layer_routes_by_length(n, path):
    """``MultiHeadAttention`` sends N >= 1024 to flash and shorter
    sequences to ``fused_mha``, and both agree with the plain attention
    (capturing the weights takes it) to 1e-5 in f32; a float16 input, which
    neither kernel takes, runs the plain attention."""
    layer = MultiHeadAttention(64, 2, generator=torch.Generator().manual_seed(0))
    x = torch.randn(1, n, 64, generator=torch.Generator().manual_seed(1))
    with torch.no_grad(), dispatch.capture_dispatches() as seen:
        out = layer(x)
    assert seen == {path}
    with torch.no_grad(), Context(capture_features=True), \
            dispatch.capture_dispatches() as seen:
        want = layer(x, feature_name="attn")
    assert seen == {"attention[plain]"}
    assert _rel(out, want.numpy()) < 1e-5
    with torch.no_grad(), dispatch.capture_dispatches() as seen:
        layer.half()(x.half())
    assert seen == {"attention[plain]"}
