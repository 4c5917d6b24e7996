"""Port parity for the rel-pos flash attention backward: the gradients of
``flash_attention_relpos`` of tfimm_tpu_torch on CPU tensors (its autograd
Function, whose backward runs ``flash_attention_relpos_bwd_reference``)
against ``jax.vjp`` of the JAX package's ``flash_attention_relpos`` in
interpret mode (its custom VJP, the Pallas backward kernels), in both of
its forms: streaming (``block_q = block_k = 32`` on an 8 x 16 grid, as
tests/ops/test_flash_attention.py drives it) and window-sized
(``block = N`` on a 6 x 6 grid, the single-pass ``_bwd_fused_kernel``),
per head and with the head pairs packed into 128 lanes.

Inputs and cotangents are made with numpy from a seed and handed to both
packages. Bars, as max|diff| / max|JAX| per gradient: 2e-4 in f32 (the
JAX tests' bar; the same f32 math summed in another order) and 2e-2 in
bf16 (both packages round the forward's output, and the gradients once, to
bf16). The Function against autograd through the plain forward: 1e-5 in
f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfimm_tpu.ops.pallas.flash_attention_relpos import (
    flash_attention_relpos as pallas_relpos,
)
from tfimm_tpu_torch.ops.kernels import dispatch
from tfimm_tpu_torch.ops.kernels.flash_attention_relpos import (
    flash_attention_relpos,
    flash_attention_relpos_bwd,
    flash_attention_relpos_bwd_reference,
    flash_attention_relpos_reference,
    flash_attention_relpos_with_lse,
    scale_query,
)

torch.set_num_threads(1)

TOL = {"float32": 2e-4, "bfloat16": 2e-2}
NAMES = ("dq", "dk", "dv", "drh", "drw")


def _rel(got, want):
    got = np.asarray(got.detach().double() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _inputs(seed, b, gh, gw, d, big=False):
    """q, k, v, the cotangent do (B, N, d) normal; rel terms (B, N, gh),
    (B, N, gw) at std 1.5 (numpy, f32). With ``big``, query 0 of every row
    points along keys 3 and 5, so that its scores pass 100."""
    rng = np.random.default_rng(seed)
    n = gh * gw
    q, k, v, do = (rng.normal(size=(b, n, d)).astype(np.float32)
                   for _ in range(4))
    if big:
        q[:, 0] = 20.0 * (k[:, 3] + k[:, 5])
    rh = (1.5 * rng.normal(size=(b, n, gh))).astype(np.float32)
    rw = (1.5 * rng.normal(size=(b, n, gw))).astype(np.float32)
    return (q, k, v, rh, rw), do


def _pallas_vjp(arrays, do, grid, scale, block, dtype):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    primals = [jnp.asarray(a, jdt) for a in arrays]

    def fn(q, k, v, rh, rw):
        return pallas_relpos(q, k, v, rh, rw, grid_size=grid, scale=scale,
                             block_q=block, block_k=block, interpret=True)

    _, vjp = jax.vjp(fn, *primals)
    return [np.asarray(g.astype(jnp.float32))
            for g in vjp(jnp.asarray(do, jdt))]


def _port_grads(arrays, do, grid, scale, dtype, fn=flash_attention_relpos):
    tdt = getattr(torch, dtype)
    leaves = [torch.from_numpy(a).to(tdt).requires_grad_() for a in arrays]
    out = fn(*leaves, grid_size=grid, scale=scale)
    out = out[0] if isinstance(out, tuple) else out
    out.backward(torch.from_numpy(do).to(tdt))
    return [t.grad for t in leaves]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("paired", ["0", "1"])
@pytest.mark.parametrize("form", ["streaming", "window"])
def test_gradients_match_the_pallas_vjp(form, paired, dtype, monkeypatch):
    """All five cotangents, dq through the scale, against the custom VJP:
    streaming (gh, gw, d = 8, 16, 32, blocks of 32) or window-sized (6, 6,
    32, block N), per head or paired (TFIMM_TPU_RELPOS_PAIRED)."""
    monkeypatch.setenv("TFIMM_TPU_RELPOS_PAIRED", paired)
    gh, gw, d = (8, 16, 32) if form == "streaming" else (6, 6, 32)
    block = 32 if form == "streaming" else gh * gw
    arrays, do = _inputs(11, 2, gh, gw, d)
    scale = d ** -0.5
    counts = dict(dispatch.launch_counts)
    got = _port_grads(arrays, do, (gh, gw), scale, dtype)
    assert dispatch.launch_counts == counts       # CPU: the plain versions
    want = _pallas_vjp(arrays, do, (gh, gw), scale, block, dtype)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == getattr(torch, dtype), name
        assert _rel(g, w) < TOL[dtype], name


@pytest.mark.parametrize("case", ["square", "big", "ragged"])
def test_function_matches_autograd_through_the_plain_forward(case):
    """f32: the Function's backward against autograd through
    ``flash_attention_relpos_reference``; with scores above 100 (no clamp)
    and on a ragged 7 x 7 grid."""
    gh, gw, d = {"square": (4, 4, 16), "big": (4, 6, 16),
                 "ragged": (7, 7, 8)}[case]
    arrays, do = _inputs(13, 3, gh, gw, d, big=case == "big")
    scale = d ** -0.5
    got = _port_grads(arrays, do, (gh, gw), scale, "float32")
    want = _port_grads(arrays, do, (gh, gw), scale, "float32",
                       fn=flash_attention_relpos_reference)
    for name, g, w in zip(NAMES, got, want):
        assert _rel(g, w) < 1e-5, name
    if case == "big":
        q, k = arrays[0], arrays[1]
        assert (q[:, 0] @ k.transpose(0, 2, 1) * scale).max() > 100.0


def test_bwd_reference_is_what_the_wrapper_runs_on_the_cpu():
    """The backward wrapper on CPU tensors is its plain version, and the lse
    is a second output without a gradient."""
    arrays, do = _inputs(17, 2, 3, 5, 8)
    q, k, v, rh, rw = (torch.from_numpy(a) for a in arrays)
    do = torch.from_numpy(do)
    kw = dict(grid_size=(3, 5))
    qs = scale_query(q, 8 ** -0.5)
    out, lse = flash_attention_relpos_with_lse(q, k, v, rh, rw, scale=8 ** -0.5,
                                               **kw)
    args = (qs, k, v, rh, rw, out, lse, do)
    for g, r in zip(flash_attention_relpos_bwd(*args, **kw),
                    flash_attention_relpos_bwd_reference(*args, **kw)):
        assert torch.equal(g, r)
    leaf = q.clone().requires_grad_()
    out, lse = flash_attention_relpos_with_lse(leaf, k, v, rh, rw,
                                               scale=8 ** -0.5, **kw)
    assert out.requires_grad and not lse.requires_grad


def _terms(q, r_h, r_w, gh, gw, einsum):
    """SAM's rel terms from q: (B, N, gh) and (B, N, gw)."""
    b, n, d = q.shape
    qg = q.reshape(b, gh, gw, d)
    return (einsum("bhwc,hkc->bhwk", qg, r_h).reshape(b, n, gh),
            einsum("bhwc,wkc->bhwk", qg, r_w).reshape(b, n, gw))


def test_rel_term_gradients_reach_q_and_a_control_misses():
    """f32, the rel terms computed from q as SAM computes them: dq (through
    the scale and the two terms) and the gradients of the rel-pos rows
    against ``jax.grad`` of the Pallas path, streaming form. Control: a
    backward that drops drh and drw (the terms detached) misses the bar by
    far."""
    gh, gw, d, b = 8, 16, 32, 2
    arrays, do = _inputs(19, b, gh, gw, d)
    q, k, v = arrays[:3]
    rng = np.random.default_rng(20)
    r_h = (0.5 * rng.normal(size=(gh, gh, d))).astype(np.float32)
    r_w = (0.5 * rng.normal(size=(gw, gw, d))).astype(np.float32)
    scale = d ** -0.5

    def jloss(q, r_h, r_w):
        rh, rw = _terms(q, r_h, r_w, gh, gw, jnp.einsum)
        out = pallas_relpos(q, jnp.asarray(k), jnp.asarray(v), rh, rw,
                            grid_size=(gh, gw), scale=scale, block_q=32,
                            block_k=32, interpret=True)
        return jnp.sum(out * jnp.asarray(do))

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, r_h, r_w)))

    def grads(detach):
        leaves = [torch.from_numpy(a).requires_grad_() for a in (q, r_h, r_w)]
        rh, rw = _terms(*leaves, gh, gw, torch.einsum)
        if detach:
            rh, rw = rh.detach(), rw.detach()
        out = flash_attention_relpos(leaves[0], torch.from_numpy(k),
                                     torch.from_numpy(v), rh, rw,
                                     grid_size=(gh, gw), scale=scale)
        (out * torch.from_numpy(do)).sum().backward()
        return [t.grad for t in leaves]

    got = grads(detach=False)
    for name, g, w in zip(("dq", "d r_h", "d r_w"), got, want):
        assert _rel(g, w) < TOL["float32"], name
    miss = _rel(grads(detach=True)[0], want[0])
    assert miss > 5 * TOL["float32"], miss


# -- The bf16 CUDA kernel's order of work (csrc/attention_bwd.cuh) -----------

from tests.test_torch_flash_attention_bwd import kernel_order_bwd  # noqa: E402

GRIDS = [(14, 14), (64, 64), (48, 64), (7, 7)]


def _kernel_order_case(gh, gw, d, dtype, seed):
    """The numpy inputs and, in ``dtype``, the emulation's: qs, k, v, out,
    lse, do and the rel terms, from the plain forward."""
    b = 1 if gh * gw > 1024 else 2
    arrays, do = _inputs(seed, b, gh, gw, d)
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    scale = d ** -0.5
    qs = scale_query(t[0], scale)
    out, lse = flash_attention_relpos_reference(*t, grid_size=(gh, gw),
                                                scale=scale)
    rows = [qs, t[1], t[2], out, lse,
            torch.from_numpy(do).to(getattr(torch, dtype))]
    return arrays, do, scale, rows, (t[3], t[4], (gh, gw))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gh,gw", GRIDS)
def test_kernel_order_of_work_matches_the_pallas_backward(gh, gw, dtype):
    """The emulation of the bf16 CUDA kernel (tiles of 64; the padded
    scratch; exp2 with log2-scaled lse; p and ds rounded to bf16 before
    their products where bf16; drw tile by tile and drh as each tile's row
    sums at gw = 64, the general key-grid sums otherwise; keys past N out of
    the sums) against ``jax.vjp`` of the interpret kernel: all five
    gradients within 1e-4 (f32) or 2e-2 (bf16) of max|JAX|."""
    d = 16
    arrays, do, scale, rows, rel = _kernel_order_case(gh, gw, d, dtype,
                                                      gh * gw + 1)
    got = kernel_order_bwd(*rows, rounded=dtype == "bfloat16", rel=rel)
    got[0] = got[0] * scale   # dq from dqs through the scale
    block = gh * gw if gh * gw <= 512 else 512   # window-sized, or streaming
    want = _pallas_vjp(arrays, do, (gh, gw), scale, block, dtype)
    tol = 1e-4 if dtype == "float32" else 2e-2
    for name, g, w in zip(NAMES, got, want):
        assert _rel(g.to(getattr(torch, dtype)), w) < tol, name


@pytest.mark.parametrize("control", ["no_key_mask", "nan_scratch"])
def test_kernel_order_controls_miss(control):
    """Controls on the ragged 14 x 14 grid (196 keys in four 64-key tiles):
    the keys past N left in drh and drw, or the padded scratch rows left as
    NaN, miss the plain backward by far; the emulation holds it at 1e-4."""
    _, _, _, rows, rel = _kernel_order_case(14, 14, 16, "float32", 5)
    want = flash_attention_relpos_bwd_reference(*rows[:3], rel[0], rel[1],
                                                *rows[3:], grid_size=rel[2])
    good = kernel_order_bwd(*rows, rounded=False, rel=rel)
    for name, g, w in zip(NAMES, good, want):
        assert _rel(g, w) < 1e-4, name
    if control == "no_key_mask":
        bad = kernel_order_bwd(*rows, rounded=False, rel=rel, key_mask=False)
        miss = min(_rel(bad[i], want[i]) for i in (3, 4))
        assert miss > 5e-2, miss
    else:
        bad = kernel_order_bwd(*rows, rounded=False, rel=rel,
                               nan_scratch=True)
        assert not bool(torch.isfinite(bad[2]).all())
