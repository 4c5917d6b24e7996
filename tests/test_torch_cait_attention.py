"""Port parity for the talking-head attention kernel's plain versions:
``talking_head_attention_reference`` and
``talking_head_attention_bwd_reference`` of tfimm_tpu_torch, and the
autograd Function behind ``talking_head_attention_packed``, against the JAX
package's Pallas kernel and backward (``talking_head_attention``,
``_thattn_bwd_call``) in interpret mode, the custom VJP of
``talking_head_diff`` and the XLA twin ``_reference`` with ``jax.vjp``.

Inputs are made with numpy from a seed, as in tests/ops/test_cait_attention.py,
and handed to both packages. The (H, H) mixes are random and not symmetric
(std 0.3): a mix applied transposed would pass every shape check. Bars, as
max|diff| / max|JAX|: 1e-5 for the f32 forward (the same f32 math, summed in
another order); 2e-2 in bf16 (the port rounds the mixed probabilities once
before their product with v, the Pallas kernel rounds each p_g and mixes in
f32, the XLA twin rounds every step); 1e-4 for the f32 backward (five
products and two mixes, summed in another order; the mix gradients sum over
the batch). db_l is exactly zero in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfimm_tpu.ops.pallas.cait_attention import (
    _reference,
    _thattn_bwd_call,
    talking_head_attention as pallas_talking_head,
    talking_head_diff,
)
from tfimm_tpu_torch.ops.kernels import dispatch
from tfimm_tpu_torch.ops.kernels.cait_attention import (
    talking_head_attention,
    talking_head_attention_bwd,
    talking_head_attention_bwd_reference,
    talking_head_attention_packed,
    talking_head_attention_reference,
    talking_head_attention_supports,
)

torch.set_num_threads(1)

NAMES = ("dqkv", "dw_l", "db_l", "dw_w", "db_w")


def _rel(got, want):
    got = np.asarray(got.double() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _inputs(seed=0, b=2, n=52, h=4, d=48):
    """qkv (B, N, 3D) and g (B, N, D) normal; non-symmetric mixes of std
    0.3 and unit-size biases (numpy, f32)."""
    rng = np.random.default_rng(seed)
    dim = h * d
    qkv = rng.normal(size=(b, n, 3 * dim)).astype(np.float32)
    wl = (0.3 * rng.normal(size=(h, h))).astype(np.float32)
    ww = (0.3 * rng.normal(size=(h, h))).astype(np.float32)
    bl = rng.normal(size=(h,)).astype(np.float32)
    bw = rng.normal(size=(h,)).astype(np.float32)
    g = rng.normal(size=(b, n, dim)).astype(np.float32)
    assert np.abs(wl - wl.T).max() > 0.1 and np.abs(ww - ww.T).max() > 0.1
    return qkv, wl, bl, ww, bw, g, h, d ** -0.5


def _port(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


@pytest.mark.parametrize("chunk", [None, "1", "4"])
@pytest.mark.parametrize("n", [52, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_matches_pallas_kernel_and_twin(monkeypatch, dtype, n,
                                                  chunk):
    # The stacked body (the TPU default), with head chunks of 1 and 4 where
    # forced; n = 52 pads the query rows to 56 in the Pallas kernel.
    if chunk is not None:
        monkeypatch.setenv("TFIMM_TPU_CAIT_STACK_CHUNK", chunk)
    qkv, wl, bl, ww, bw, _, h, scale = _inputs(seed=n, n=n)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jqkv = jnp.asarray(qkv, jdt)
    mixes = [jnp.asarray(a) for a in (wl, bl, ww, bw)]
    pallas = pallas_talking_head(jqkv, *mixes, nb_heads=h, scale=scale,
                                 interpret=True)
    twin = _reference(jqkv, *mixes, h, scale)
    got = talking_head_attention_reference(
        torch.from_numpy(qkv).to(tdt), *_port((wl, bl, ww, bw)), nb_heads=h,
        scale=scale)
    assert got.dtype == tdt and got.shape == (2, n, h * 48)
    bar = 1e-5 if dtype == "float32" else 2e-2
    for want in (pallas, twin):
        assert _rel(got, np.asarray(want, np.float32)) < bar


def test_wrapper_runs_the_plain_version_on_the_cpu():
    qkv, wl, bl, ww, bw, _, h, scale = _inputs(seed=1)
    args = _port((qkv, wl, bl, ww, bw))
    counts = dict(dispatch.launch_counts)
    got = talking_head_attention(*args, nb_heads=h, scale=scale)
    want = talking_head_attention_reference(*args, nb_heads=h, scale=scale)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # A missing bias counts as zeros, as in the Pallas kernel.
    got = talking_head_attention(*args[:2], None, args[3], None, nb_heads=h,
                                 scale=scale)
    pallas = pallas_talking_head(jnp.asarray(qkv), jnp.asarray(wl), None,
                                 jnp.asarray(ww), None, nb_heads=h,
                                 scale=scale, interpret=True)
    assert _rel(got, np.asarray(pallas)) < 1e-5
    assert dispatch.launch_counts == counts


def test_a_transposed_mix_misses_the_bar():
    # The control the card check also runs: with w_w transposed (or the
    # pre-softmax mix left out) the result is far from the Pallas kernel's.
    qkv, wl, bl, ww, bw, _, h, scale = _inputs(seed=2)
    want = np.asarray(pallas_talking_head(
        jnp.asarray(qkv), *(jnp.asarray(a) for a in (wl, bl, ww, bw)),
        nb_heads=h, scale=scale, interpret=True))
    t = _port((qkv, wl, bl, ww, bw))
    for wrong in ((t[0], t[1], t[2], t[3].T, t[4]),
                  (t[0], torch.eye(h), t[2], t[3], t[4]),
                  (t[0], t[1].T, t[2], t[3], t[4])):
        got = talking_head_attention_reference(*wrong, nb_heads=h, scale=scale)
        assert _rel(got, want) > 5e-3


@pytest.mark.parametrize("chunk", [None, "1", "4"])
@pytest.mark.parametrize("n", [52, 64])
def test_reference_backward_matches_pallas_backward_and_vjps(monkeypatch, n,
                                                             chunk):
    if chunk is not None:
        monkeypatch.setenv("TFIMM_TPU_CAIT_STACK_CHUNK", chunk)
    qkv, wl, bl, ww, bw, g, h, scale = _inputs(seed=10 + n, n=n)
    jargs = [jnp.asarray(a) for a in (qkv, wl, bl, ww, bw)]
    jg = jnp.asarray(g)
    pallas = _thattn_bwd_call(*jargs, jg, h, scale, interpret=True)
    _, vjp = jax.vjp(lambda *a: talking_head_diff(*a, h, scale, True), *jargs)
    custom = vjp(jg)
    _, vjp = jax.vjp(lambda *a: _reference(*a, h, scale), *jargs)
    twin = vjp(jg)

    targs = _port((qkv, wl, bl, ww, bw))
    got = talking_head_attention_bwd_reference(*targs, torch.from_numpy(g),
                                               nb_heads=h, scale=scale)
    assert torch.equal(got[2], torch.zeros(h))
    # The autograd Function on the plain path gives the same gradients.
    leaves = [t.clone().requires_grad_() for t in targs]
    talking_head_attention_packed(*leaves, nb_heads=h, scale=scale).backward(
        torch.from_numpy(g))
    through_autograd = [leaf.grad for leaf in leaves]
    for ours in (got, through_autograd):
        for want in (pallas, custom):
            assert np.all(np.asarray(want[2]) == 0)
            for name, a, w in zip(NAMES, ours, want):
                if name == "db_l":
                    assert torch.equal(a, torch.zeros(h))
                else:
                    assert _rel(a, np.asarray(w)) < 1e-4, name
        # The XLA twin's b_l gradient is zero up to f32 noise.
        assert np.abs(np.asarray(twin[2])).max() < 1e-3
        for name, a, w in zip(NAMES, ours, twin):
            if name != "db_l":
                assert _rel(a, np.asarray(w)) < 1e-4, name


def _clamp_inputs():
    """Query 0 of every head points along keys 3 and 5, so that its raw
    scores there are near 60 |k|^2: their mixed scores land far above the
    clamp of 80 for some output heads and far below it for others."""
    qkv, wl, bl, ww, bw, g, h, scale = _inputs(seed=5, n=24)
    dim = h * 48
    x = qkv.reshape(2, 24, 3, h, 48)
    x[:, 0, 0] = 60.0 * (x[:, 3, 1] + x[:, 5, 1])
    return x.reshape(2, 24, 3 * dim), wl, bl, ww, bw, g, h, scale


def test_clamp_case_matches_the_pallas_kernels():
    qkv, wl, bl, ww, bw, g, h, scale = _clamp_inputs()
    raw = np.einsum("bqhd,bkhd->bhqk", qkv.reshape(2, 24, 3, h, 48)[:, :, 0],
                    qkv.reshape(2, 24, 3, h, 48)[:, :, 1])
    s = np.einsum("bhqk,hg->bgqk", raw, scale * wl) + bl[:, None, None]
    assert (s > 80).any() and (s[:, :, 0] < 80).any()
    jargs = [jnp.asarray(a) for a in (qkv, wl, bl, ww, bw)]
    fwd = pallas_talking_head(*jargs, nb_heads=h, scale=scale, interpret=True)
    bwd = _thattn_bwd_call(*jargs, jnp.asarray(g), h, scale, interpret=True)
    targs = _port((qkv, wl, bl, ww, bw))
    got = talking_head_attention_reference(*targs, nb_heads=h, scale=scale)
    assert np.isfinite(got.numpy()).all()
    assert _rel(got, np.asarray(fwd)) < 1e-5
    grads = talking_head_attention_bwd_reference(*targs, torch.from_numpy(g),
                                                 nb_heads=h, scale=scale)
    for name, a, w in zip(NAMES, grads, bwd):
        if name != "db_l":
            assert _rel(a, np.asarray(w)) < 1e-4, name


def test_gradcheck_float64():
    qkv, wl, bl, ww, bw, _, h, _ = _inputs(seed=6, b=2, n=5, h=3, d=8)
    leaves = tuple(t.double().requires_grad_()
                   for t in _port((qkv, wl, bl, ww, bw)))
    counts = dict(dispatch.launch_counts)
    assert torch.autograd.gradcheck(
        lambda *t: talking_head_attention_packed(*t, nb_heads=h, scale=0.35),
        leaves)
    assert dispatch.launch_counts == counts


def test_bwd_wrapper_and_packed_dispatch_on_the_cpu():
    qkv, wl, bl, ww, bw, g, h, scale = _inputs(seed=7, n=16)
    args = _port((qkv, wl, bl, ww, bw))
    got = talking_head_attention_bwd(*args, torch.from_numpy(g), nb_heads=h,
                                     scale=scale)
    want = talking_head_attention_bwd_reference(*args, torch.from_numpy(g),
                                                nb_heads=h, scale=scale)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=0, atol=0)
    # Under no_grad, or with nothing that requires grad, no autograd node.
    with torch.no_grad():
        out = talking_head_attention_packed(
            *[t.clone().requires_grad_() for t in args], nb_heads=h,
            scale=scale)
    assert out.grad_fn is None
    # A missing bias runs the plain version under autograd (the JAX
    # package's _th_fwd sends that case to its XLA twin).
    leaf = args[0].clone().requires_grad_()
    out = talking_head_attention_packed(leaf, args[1], None, args[3], None,
                                        nb_heads=h, scale=scale)
    assert out.grad_fn is not None and "_TalkingHead" not in type(
        out.grad_fn).__name__


def test_supports_takes_every_registered_cait():
    for n, dim, h in ((196, 192, 4), (576, 288, 6), (196, 384, 8),
                      (576, 384, 8), (576, 768, 16), (784, 768, 16),
                      (16, 16, 2)):
        assert talking_head_attention_supports(n, dim, h), (n, dim, h)
    assert not talking_head_attention_supports(196, 192, 16)     # d = 12
    assert not talking_head_attention_supports(196, 1024, 8)     # D > 768
    assert not talking_head_attention_supports(196, 34 * 16, 34)  # H > 16
