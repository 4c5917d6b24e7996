"""Port parity for the backward of fused_mha: tfimm_tpu_torch's plain
backward (``fused_mha_bwd_reference``) and its autograd Function, against
the JAX package's Pallas backward ``_fused_mha_bwd_call`` in interpret mode
and the custom VJP of ``fused_mha_diff``.

Inputs are made with numpy from a seed and handed to both packages. Bars,
as max|diff| / max|JAX|: 1e-5 in f32 (the same five f32 products, summed
in another order); 1e-4 for a whole ViT's parameter gradients (a dozen
layers of such sums). The bf16 CUDA kernel's order of work (delta from
g . o~ rather than from dp, and its bf16 roundings) is emulated here and
held to the same Pallas backward: 1e-4 in f32 (the rearranged sums) and
2e-2 in bf16, the card's bar for the kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfimm_tpu
import tfimm_tpu_torch
from tfimm_tpu.ops.pallas.dispatch import softmax_clamp_grad_mask as jax_mask
from tfimm_tpu.ops.pallas.fused_mha import _fused_mha_bwd_call, fused_mha_diff
from tfimm_tpu_torch.ops.kernels import dispatch
from tfimm_tpu_torch.ops.kernels.fused_mha import (
    _heads,
    _merge_heads,
    _split_qkv,
    fused_mha,
    fused_mha_bwd,
    fused_mha_bwd_reference,
    fused_mha_reference,
)
from tfimm_tpu_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(1)

SMALL = dict(input_size=(64, 64), patch_size=16, embed_dim=128, nb_blocks=2,
             nb_heads=2, nb_classes=7)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _inputs(seed, b, n, h, d, clamp=False):
    """qkv (B, N, 3*H*d) and g (B, N, H*d). With ``clamp``, query 0 of every
    head points along keys 3 and 5, so that two of its scores land near 160,
    far above the softmax clamp of 80."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n, 3, h, d)).astype(np.float32)
    if clamp:
        x[:, 0, 0] = 20.0 * (x[:, 3, 1] + x[:, 5, 1])
    g = rng.normal(size=(b, n, h * d)).astype(np.float32)
    return x.reshape(b, n, 3 * h * d), g


@pytest.mark.parametrize("n,h,clamp", [(197, 2, False), (197, 4, False),
                                       (50, 2, False), (50, 4, False),
                                       (50, 2, True)])
def test_reference_matches_pallas_backward_and_custom_vjp(n, h, clamp):
    d = 64
    scale = d ** -0.5
    qkv, g = _inputs(n + h, 2, n, h, d, clamp)
    got = fused_mha_bwd_reference(torch.from_numpy(qkv), torch.from_numpy(g),
                                  h, scale).numpy()
    pallas = _fused_mha_bwd_call(jnp.asarray(qkv), jnp.asarray(g), h, scale,
                                 interpret=True)
    _, vjp = jax.vjp(lambda t: fused_mha_diff(t, h, scale, True),
                     jnp.asarray(qkv))
    (custom,) = vjp(jnp.asarray(g))
    assert _rel(got, pallas) < 1e-5
    assert _rel(got, custom) < 1e-5
    if clamp:
        # The mask zeroes the score cotangent where the clamp saturated, so
        # the gradient of query 0 is (nearly) nothing: its softmax is
        # pinned at the clamp.
        dq0 = np.abs(got[:, 0, :h * d]).max()
        assert dq0 < 1e-3 * np.abs(got[:, :, :h * d]).max(), dq0


def _kernel_order_bwd(qkv, g, nb_heads, scale, rounded, split=True):
    """The bf16 kernel's order of work (``csrc/fused_mha_bwd.cu``), in f32
    with its bf16 roundings where ``rounded``. Launch A: pass 1 sums
    l = sum e over the keys and o~ = sum e v with e in two bf16 parts
    (``split``; one bf16 part otherwise), then delta = g . o~ / l; pass 2
    forms ds = where(s < 80, e / l * (dP - delta), 0) and
    dq = scale * bf16(ds) k. Launch B, from l and delta: dv = bf16(p)^T g and
    dk = scale * bf16(ds)^T q."""
    r = (lambda t: t.bfloat16().float()) if rounded else (lambda t: t)
    q, k, v = _split_qkv(qkv, nb_heads)
    g = _heads(g, nb_heads, q.dtype)
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    e = torch.exp(torch.clamp(s, max=dispatch.SOFTMAX_CLAMP))
    l = e.sum(dim=-1, keepdim=True)
    e_parts = r(e) + r(e - r(e)) if split else r(e)
    delta = (g * torch.matmul(e_parts, v)).sum(dim=-1, keepdim=True) / l
    p = e / l
    dp = torch.matmul(g, v.transpose(-1, -2))
    ds = torch.where(s < dispatch.SOFTMAX_CLAMP, p * (dp - delta), 0.0)
    dq = scale * torch.matmul(r(ds), k)
    dk = scale * torch.matmul(r(ds).transpose(-1, -2), q)
    dv = torch.matmul(r(p).transpose(-1, -2), g)
    return torch.cat([_merge_heads(t) for t in (dq, dk, dv)],
                     dim=-1).to(qkv.dtype)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("n,h,clamp", [(197, 2, False), (65, 4, False),
                                       (50, 2, True)])
def test_kernel_order_of_work_matches_pallas_backward(n, h, clamp, dtype,
                                                      tol):
    """The two-pass delta and the bf16 roundings of the CUDA kernel hold the
    Pallas backward (interpret mode) on the same inputs, the clamp case
    included: each of dq, dk and dv within ``tol`` of max|JAX|."""
    d = 64
    scale = d ** -0.5
    qkv, g = _inputs(3 * n + h, 2, n, h, d, clamp)
    qkv_t = torch.from_numpy(qkv).to(dtype)
    g_t = torch.from_numpy(g).to(dtype)
    got = _kernel_order_bwd(qkv_t, g_t, h, scale,
                            rounded=dtype == torch.bfloat16)
    want = _fused_mha_bwd_call(jnp.asarray(qkv_t.float().numpy()),
                               jnp.asarray(g_t.float().numpy()), h, scale,
                               interpret=True)
    got = got.float().numpy()
    for part in range(3):
        cols = slice(part * h * d, (part + 1) * h * d)
        assert _rel(got[..., cols], np.asarray(want)[..., cols]) < tol, part
    if clamp:
        # The clamped entries are where the order of work could part from
        # the reference: the mask must still pin query 0's gradient.
        ref = fused_mha_bwd_reference(qkv_t, g_t, h, scale).float().numpy()
        assert _rel(got, ref) < tol


def test_kernel_order_of_work_holds_scores_near_the_clamp():
    """At d = 8 the clamp input puts query 0's scores near 80, where
    dp - delta can cancel: with e in two bf16 parts delta stays exact enough
    and the order of work holds the plain backward within 2e-2 of its max
    on every seed; with one bf16 part (the control) it does not."""
    b, n, h, d = 3, 9, 5, 8
    worst, worst_one_part = 0.0, 0.0
    for seed in range(12):
        x, g = _inputs(seed, b, n, h, d, clamp=True)
        qkv = torch.from_numpy(x).bfloat16()
        g = torch.from_numpy(g).bfloat16()
        want = fused_mha_bwd_reference(qkv, g, h, d ** -0.5).float().numpy()
        for split in (True, False):
            got = _kernel_order_bwd(qkv, g, h, d ** -0.5, rounded=True,
                                    split=split).float().numpy()
            if split:
                worst = max(worst, _rel(got, want))
            else:
                worst_one_part = max(worst_one_part, _rel(got, want))
    assert worst < 2e-2, worst
    assert worst_one_part > 2e-2, worst_one_part


def test_clamp_grad_mask_matches_jax():
    rng = np.random.default_rng(3)
    s = rng.normal(size=(4, 9)).astype(np.float32) * 60.0
    s[0, 0] = dispatch.SOFTMAX_CLAMP   # on the clamp: masked, as in JAX
    ds = rng.normal(size=(4, 9)).astype(np.float32)
    got = dispatch.softmax_clamp_grad_mask(torch.from_numpy(s),
                                           torch.from_numpy(ds))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_mask(jnp.asarray(s),
                                                      jnp.asarray(ds))))
    assert (got.numpy() == 0).sum() == (s >= dispatch.SOFTMAX_CLAMP).sum() > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_through_fused_mha_uses_the_plain_backward_on_cpu(dtype):
    qkv, g = _inputs(11, 2, 50, 4, 32)
    qkv, g = torch.from_numpy(qkv).to(dtype), torch.from_numpy(g).to(dtype)
    counts = dict(dispatch.launch_counts)
    x = qkv.clone().requires_grad_()
    out = fused_mha(x, 4, 32 ** -0.5)
    torch.testing.assert_close(out.detach(), fused_mha_reference(qkv, 4, 32 ** -0.5))
    out.backward(g)
    want = fused_mha_bwd_reference(qkv, g, 4, 32 ** -0.5)
    assert x.grad.dtype == dtype
    torch.testing.assert_close(x.grad, want, rtol=0, atol=0)
    torch.testing.assert_close(fused_mha_bwd(qkv, g, 4, 32 ** -0.5), want)
    assert dispatch.launch_counts == counts   # no kernel on the CPU


def test_gradcheck_float64():
    qkv = torch.from_numpy(_inputs(5, 1, 5, 2, 8)[0]).double().requires_grad_()
    assert torch.autograd.gradcheck(lambda t: fused_mha(t, 2, 8 ** -0.5),
                                    (qkv,))


def test_no_grad_skips_the_autograd_function():
    x = torch.from_numpy(_inputs(6, 1, 9, 2, 8)[0]).requires_grad_()
    with torch.no_grad():
        out = fused_mha(x, 2, 8 ** -0.5)
    assert out.grad_fn is None


def _seeded(params, seed):
    rng = np.random.default_rng(seed)
    leaves, tree = jax.tree_util.tree_flatten_with_path(params)
    new = []
    for path, leaf in leaves:
        r = rng.normal(size=np.shape(leaf)).astype(np.float32)
        is_scale = getattr(path[-1], "key", None) == "scale"
        new.append(jnp.asarray(1.0 + 0.1 * r if is_scale else 0.05 * r))
    return jax.tree_util.tree_unflatten(tree, new)


def test_vit_gradients_match_jax_through_the_kernels(monkeypatch):
    """loss.backward() through a port ViT, whose attention goes through
    fused_mha and its backward, gives the JAX package's gradients through
    the Pallas forward and backward (interpret mode)."""
    monkeypatch.setenv("TFIMM_TPU_PALLAS_INTERPRET", "1")
    jm = tfimm_tpu.create_model("vit_base_patch16_224", **SMALL)
    params = _seeded(jm.params, 1)
    tm = tfimm_tpu_torch.create_model("vit_base_patch16_224", device="cpu",
                                      **SMALL)
    tm.load_state_dict(state_dict_from_jax(params))
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    labels = np.array([3, 5])

    def jax_loss(p):
        logits = jm.apply(p, jnp.asarray(x), training=True)
        logp = jax.nn.log_softmax(logits)
        return -jnp.take_along_axis(logp, jnp.asarray(labels)[:, None], 1).mean()

    want = state_dict_from_jax(jax.grad(jax_loss)(params))
    tm.train()
    with dispatch.capture_dispatches() as seen:
        logits = tm(torch.from_numpy(x))
    assert seen == {"fused_mha"}
    torch.nn.functional.cross_entropy(logits, torch.from_numpy(labels)).backward()
    for name, p in tm.named_parameters():
        assert _rel(p.grad, want[name]) < 1e-4, name
    assert np.abs(want["blocks.0.attn.qkv.weight"].numpy()).max() > 0
