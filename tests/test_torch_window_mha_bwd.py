"""Port parity for the backward of window_mha: tfimm_tpu_torch's plain
backward (``window_mha_bwd_reference``), the packed wrapper
``window_mha_bwd`` and the autograd Function behind ``window_mha_packed``,
against the JAX package's Pallas backward ``_window_mha_bwd_call`` in
interpret mode, the custom VJP of ``window_mha_diff`` and ``jax.vjp`` of the
XLA twin ``_reference_window_mha``.

Inputs are made with numpy from a seed and handed to both packages; the
bias has std 0.3 (a trunc-normal(0.02) table would hide a backward that
drops it) and the mask is the model's own -100 shift mask. Bars, as
max|diff| / max|JAX|: 1e-5 in f32 (the same five f32 products, summed in
another order); 2e-2 in bf16 (q, k, v and g rounded to bf16 on both sides,
dq, dk and dv rounded once; the JAX package's bf16 mask and the packing of
window pairs change the f32 sums' order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfimm_tpu.architectures.swin import _attention_mask as jax_attention_mask
from tfimm_tpu.ops.pallas.window_mha import (
    _reference_window_mha,
    _window_mha_bwd_call,
    window_mha_diff,
)
from tfimm_tpu_torch.ops.kernels import dispatch
from tfimm_tpu_torch.ops.kernels.window_mha import (
    window_mha_bwd,
    window_mha_bwd_reference,
    window_mha_packed,
    window_mha_reference,
)

torch.set_num_threads(1)

_BARS = {"float32": 1e-5, "bfloat16": 2e-2}


def _rel(got, want):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _inputs(bw, n, c, h, seed):
    """q, k, v, g (BW, N, C) normal and a bias (H, N, N) of std 0.3."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(bw, n, c)).astype(np.float32)
                  for _ in range(4))
    bias = (0.3 * rng.normal(size=(h, n, n))).astype(np.float32)
    return q, k, v, g, bias


def _port(arrays, dtype):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("h,d", [(3, 32), (4, 16)])
def test_reference_matches_pallas_backward_and_vjps(dtype, masked, h, d):
    bw, n, c = 8, 49, h * d
    q, k, v, g, bias = _inputs(bw, n, c, h, seed=10 * h + d + masked)
    mask = jax_attention_mask((14, 14), 7, 3) if masked else None  # 4 windows
    scale = d ** -0.5
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jq, jk, jv, jg = (jnp.asarray(a, jdt) for a in (q, k, v, g))
    jbias = jnp.asarray(bias)
    jmask = None if mask is None else jnp.asarray(mask)

    pallas = _window_mha_bwd_call(jq, jk, jv, jbias, jmask, jg, h, scale,
                                  stacked=False, interpret=True)
    _, vjp = jax.vjp(lambda *a: window_mha_diff(*a, jmask, h, scale, True),
                     jq, jk, jv, jbias)
    custom = vjp(jg)
    _, vjp = jax.vjp(lambda *a: _reference_window_mha(*a, jmask, h, scale),
                     jq, jk, jv, jbias)
    twin = vjp(jg)

    tq, tk, tv, tg = _port((q, k, v, g), tdt)
    got = window_mha_bwd_reference(
        tq, tk, tv, torch.from_numpy(bias),
        None if mask is None else torch.from_numpy(mask), tg, nb_heads=h,
        scale=scale)
    assert [t.dtype for t in got] == [tdt] * 3 + [torch.float32]
    # The autograd Function on the packed qkv: its gradients, split.
    qkv = torch.cat([tq, tk, tv], dim=-1).requires_grad_()
    tbias = torch.from_numpy(bias).requires_grad_()
    window_mha_packed(qkv, tbias,
                      None if mask is None else torch.from_numpy(mask),
                      nb_heads=h, scale=scale).backward(tg)
    through_autograd = (qkv.grad[..., :c], qkv.grad[..., c:2 * c],
                        qkv.grad[..., 2 * c:], tbias.grad)
    for ours in (got, through_autograd):
        for want in (pallas, custom, twin):
            for name, a, b in zip(("dq", "dk", "dv", "dbias"), ours, want):
                assert _rel(a, np.asarray(b, np.float32)) < _BARS[dtype], name


def test_clamp_zeroes_the_score_cotangent_in_both_packages():
    # One window, no mask: dbias is the score cotangent ds itself. Four
    # bias entries of 100 push their scores far above the clamp of 80,
    # where both packages zero ds.
    bw, n, c, h = 1, 49, 64, 2
    q, k, v, g, bias = _inputs(bw, n, c, h, seed=3)
    hot = (np.array([0, 0, 1, 1]), np.array([0, 5, 7, 48]),
           np.array([3, 9, 0, 48]))
    bias[hot] = 100.0
    scale = 32 ** -0.5
    want = _window_mha_bwd_call(*(jnp.asarray(a) for a in (q, k, v, bias)),
                                None, jnp.asarray(g), h, scale,
                                stacked=False, interpret=True)
    got = window_mha_bwd_reference(*_port((q, k, v), torch.float32),
                                   torch.from_numpy(bias), None,
                                   torch.from_numpy(g), nb_heads=h,
                                   scale=scale)
    dbias, want_dbias = got[3].numpy(), np.asarray(want[3])
    assert (dbias[hot] == 0).all() and (want_dbias[hot] == 0).all()
    assert np.abs(dbias).max() > 0
    for a, b in zip(got, want):
        assert _rel(a, np.asarray(b)) < 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
def test_autograd_through_window_mha_packed_uses_the_plain_backward(dtype,
                                                                    masked):
    bw, n, c, h = 8, 49, 96, 3
    q, k, v, g, bias = _inputs(bw, n, c, h, seed=20 + masked)
    qkv = torch.from_numpy(np.concatenate([q, k, v], axis=-1)).to(dtype)
    g = torch.from_numpy(g).to(dtype)
    mask = (torch.from_numpy(jax_attention_mask((14, 14), 7, 3)) if masked
            else None)
    bias = torch.from_numpy(bias)
    counts = dict(dispatch.launch_counts)
    x, b = qkv.clone().requires_grad_(), bias.clone().requires_grad_()
    out = window_mha_packed(x, b, mask, nb_heads=h, scale=0.2)
    assert out.grad_fn is not None
    c3 = (qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:])
    torch.testing.assert_close(
        out.detach(), window_mha_reference(*c3, bias, mask, nb_heads=h,
                                           scale=0.2), rtol=0, atol=0)
    out.backward(g)
    dq, dk, dv, dbias = window_mha_bwd_reference(*c3, bias, mask, g,
                                                 nb_heads=h, scale=0.2)
    assert x.grad.dtype == dtype and b.grad.dtype == torch.float32
    torch.testing.assert_close(x.grad, torch.cat([dq, dk, dv], -1), rtol=0,
                               atol=0)
    torch.testing.assert_close(b.grad, dbias, rtol=0, atol=0)
    assert dispatch.launch_counts == counts   # no kernel on the CPU


def test_packed_dqkv_layout_is_autograd_of_the_plain_forward():
    # dqkv's three column blocks are the gradients of q, k and v, each with
    # the heads in (H, d) order, as autograd through the plain forward on
    # three separate leaves gives them; dbias is the bias's gradient.
    bw, n, c, h = 4, 16, 48, 3
    q, k, v, g, bias = _inputs(bw, n, c, h, seed=7)
    mask = torch.from_numpy(jax_attention_mask((8, 8), 4, 2))
    leaves = [t.requires_grad_() for t in _port((q, k, v, bias), torch.float32)]
    out = window_mha_reference(*leaves, mask, nb_heads=h, scale=0.3)
    out.backward(torch.from_numpy(g))
    qkv = torch.from_numpy(np.concatenate([q, k, v], axis=-1))
    dqkv, dbias = window_mha_bwd(qkv, torch.from_numpy(g),
                                 torch.from_numpy(bias), mask, nb_heads=h,
                                 scale=0.3)
    assert dqkv.shape == (bw, n, 3 * c) and dbias.shape == (h, n, n)
    for i, leaf in enumerate(leaves[:3]):
        assert _rel(dqkv[..., i * c:(i + 1) * c], leaf.grad) < 1e-5, i
    assert _rel(dbias, leaves[3].grad) < 1e-5


def test_gradcheck_float64():
    bw, n, c, h = 4, 4, 16, 2
    q, k, v, _, bias = _inputs(bw, n, c, h, seed=5)
    qkv = torch.from_numpy(np.concatenate([q, k, v], -1)).double()
    mask = torch.from_numpy(jax_attention_mask((4, 4), 2, 1)).double()
    assert torch.autograd.gradcheck(
        lambda t, b: window_mha_packed(t, b, mask, nb_heads=h, scale=0.5),
        (qkv.requires_grad_(), torch.from_numpy(bias).double().requires_grad_()))


def test_no_grad_skips_the_autograd_function():
    q, k, v, _, bias = _inputs(2, 9, 16, 2, seed=6)
    qkv = torch.from_numpy(np.concatenate([q, k, v], -1)).requires_grad_()
    with torch.no_grad():
        out = window_mha_packed(qkv, torch.from_numpy(bias), nb_heads=2,
                                scale=0.5)
    assert out.grad_fn is None
    out = window_mha_packed(qkv.detach(), torch.from_numpy(bias), nb_heads=2,
                            scale=0.5)
    assert out.grad_fn is None
