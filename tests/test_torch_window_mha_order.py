"""The order of work of the window attention's Hopper bodies
(``csrc/window_mha.cu``'s and ``window_mha_bwd.cu``'s TMA + wgmma bodies,
``window_mha_common.cuh``), emulated in plain PyTorch on the CPU, against
the JAX package's ``window_mha`` (the Pallas kernel in interpret mode and
its XLA twin ``_reference_window_mha``) and its VJP (``_window_mha_bwd_call``
in interpret mode and the custom VJP of ``window_mha_diff``).

The emulation does what the bodies do, in their order:
- the bias and the mask of the window's position summed in f32 first, then
  scaled by log2(e) (``load_bias``), where the first body and the JAX
  package add them to the score one at a time;
- e = 2^min(scale log2(e) s + bm, 80 log2(e)) (one fused multiply-add, then
  the clamp), p = e (1 / rowsum) in f32 with the whole row's sum (a window
  is one tile), where the JAX package divides;
- the forward rounds p to the dtype before o = p v, sums o in f32 and
  rounds it once;
- the backward takes delta = rowsum(p dp) from the f32 p and dp in one
  pass, ds = where(at the clamp, 0, p (dp - delta)) in f32, sums ds over
  the windows for dbias in f32, and rounds p and ds to the dtype before
  dq = scale ds k, dk = scale ds^T q and dv = p^T g.

Inputs are made with numpy from a seed; the bias has std 0.5 and the mask
is the model's own -100 shift mask. Bars, as max|diff| / max|JAX|: f32
1e-5 (the same function; log2(e) folded in moves the exponent by an f32
rounding), bf16 2e-2 (p and ds rounded before the products, as the first
bodies do). Two controls must miss: the emulation with the mask left out
(by five bars), and without the clamp on scores past 80 (NaN rows).
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
from tfimm_tpu.ops.pallas.window_mha import window_mha as jax_window_mha

torch.set_num_threads(1)

_BARS = {"float32": 1e-5, "bfloat16": 2e-2}
LOG2E = np.float32(1.4426950408889634)
CLAMP_LOG2 = np.float32(np.float32(80.0) * LOG2E)


def _heads(t, h):
    """(BW, N, H*d) -> (BW, H, N, d) in f32."""
    bw, n, c = t.shape
    return t.float().reshape(bw, n, h, c // h).transpose(1, 2)


def _merge(t, dtype):
    bw, h, n, d = t.shape
    return t.transpose(1, 2).reshape(bw, n, h * d).to(dtype)


def _exponent(qh, kh, bias, mask, scale, with_mask=True):
    """The f32 exponent x = scale log2(e) s + (bias + mask) log2(e) of each
    (window, head), as one fused multiply-add of the raw f32 score."""
    bw, h, n, _ = qh.shape
    s = torch.matmul(qh, kh.transpose(-1, -2))
    bm = bias.float()[None].expand(bw, h, n, n)
    if mask is not None and with_mask:
        nw = mask.shape[0]
        bm = (bm.reshape(bw // nw, nw, h, n, n)
              + mask.float()[None, :, None]).reshape(bw, h, n, n)
    bm = bm * torch.tensor(LOG2E)
    scale_log2 = torch.tensor(np.float32(np.float32(scale) * LOG2E))
    return (s.double() * scale_log2.double() + bm.double()).float()


def _softmax(x, clamp=True):
    """p = e (1 / rowsum) with e = 2^min(x, 80 log2(e)), f32: one
    reciprocal a row, as the bodies take it."""
    e = torch.exp2(torch.clamp(x, max=float(CLAMP_LOG2)) if clamp else x)
    return e * (1.0 / e.sum(dim=-1, keepdim=True))


def kernel_order_fwd(q, k, v, bias, mask, nb_heads, scale, with_mask=True,
                     clamp=True):
    """The Hopper forward's order of work (see the module note)."""
    dt = q.dtype
    qh, kh, vh = (_heads(t, nb_heads) for t in (q, k, v))
    p = _softmax(_exponent(qh, kh, bias, mask, scale, with_mask), clamp)
    return _merge(torch.matmul(p.to(dt).float(), vh), dt)


def kernel_order_bwd(q, k, v, bias, mask, g, nb_heads, scale):
    """The Hopper backward's order of work: dq, dk, dv in the dtype and
    dbias in f32 (see the module note)."""
    dt = q.dtype
    qh, kh, vh, gh = (_heads(t, nb_heads) for t in (q, k, v, g))
    x = _exponent(qh, kh, bias, mask, scale)
    p = _softmax(x)
    dp = torch.matmul(gh, vh.transpose(-1, -2))
    delta = (p * dp).sum(dim=-1, keepdim=True)
    ds = torch.where(x >= torch.tensor(CLAMP_LOG2), torch.zeros_like(p),
                     p * (dp - delta))
    ds_r, p_r = ds.to(dt).float(), p.to(dt).float()
    dq = scale * torch.matmul(ds_r, kh)
    dk = scale * torch.matmul(ds_r.transpose(-1, -2), qh)
    dv = torch.matmul(p_r.transpose(-1, -2), gh)
    return (_merge(dq, dt), _merge(dk, dt), _merge(dv, dt), ds.sum(dim=0))


def _rel(got, want):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _inputs(bw, n, c, h, seed, hot=False):
    """q, k, v, g (BW, N, C) normal and a bias (H, N, N) of std 0.5; with
    ``hot``, bias entries of 100 push their scores past the clamp."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(bw, n, c)).astype(np.float32)
                  for _ in range(4))
    bias = (0.5 * rng.normal(size=(h, n, n))).astype(np.float32)
    if hot:
        bias[0, 0, 3] = bias[h - 1, n - 1, 0] = bias[0, 5, 9] = 100.0
    return q, k, v, g, bias


# (H, d, N, map side or 0 for no mask, scores past the clamp): Swin-T's
# d = 32 shifted and not, hf_swin's N = 16, d = 8 shifted, and the clamp.
CASES = [(3, 32, 49, 14, False), (3, 32, 49, 0, False), (2, 8, 16, 8, False),
         (2, 16, 49, 0, True), (3, 32, 49, 14, True)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,d,n,side,hot", CASES)
def test_kernel_order_fwd_holds_the_jax_window_mha(dtype, h, d, n, side, hot):
    bw, c = 8, h * d
    ws = int(round(n ** 0.5))
    q, k, v, _, bias = _inputs(bw, n, c, h, seed=h + d + n + side + hot,
                               hot=hot)
    mask = jax_attention_mask((side, side), ws, ws // 2) if side else None
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    jmask = None if mask is None else jnp.asarray(mask)
    scale = d ** -0.5
    kernel = jax_window_mha(jq, jk, jv, jnp.asarray(bias), jmask, nb_heads=h,
                            scale=scale, interpret=True)
    twin = _reference_window_mha(jq, jk, jv, jnp.asarray(bias), jmask, h,
                                 scale)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    tmask = None if mask is None else torch.from_numpy(mask)
    got = kernel_order_fwd(tq, tk, tv, torch.from_numpy(bias), tmask, h,
                           scale)
    assert got.dtype == tdt
    for want in (kernel, twin):
        assert _rel(got, np.asarray(want, np.float32)) < _BARS[dtype]
    if side:
        # Control: the mask left out misses by far.
        miss = kernel_order_fwd(tq, tk, tv, torch.from_numpy(bias), tmask, h,
                                scale, with_mask=False)
        assert _rel(miss, np.asarray(kernel, np.float32)) > 5 * _BARS[dtype]
    if hot:
        # Control: without the clamp the exponentials of the scores past 80
        # overflow, and their rows turn to NaN.
        miss = kernel_order_fwd(tq, tk, tv, torch.from_numpy(bias), tmask, h,
                                scale, clamp=False)
        assert not bool(torch.isfinite(miss).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,d,n,side,hot", CASES)
def test_kernel_order_bwd_holds_the_jax_vjp(dtype, h, d, n, side, hot):
    bw, c = 8, h * d
    ws = int(round(n ** 0.5))
    q, k, v, g, bias = _inputs(bw, n, c, h, seed=10 + h + d + n + side + hot,
                               hot=hot)
    mask = jax_attention_mask((side, side), ws, ws // 2) if side else None
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jq, jk, jv, jg = (jnp.asarray(a, jdt) for a in (q, k, v, g))
    jbias = jnp.asarray(bias)
    jmask = None if mask is None else jnp.asarray(mask)
    scale = d ** -0.5
    pallas = _window_mha_bwd_call(jq, jk, jv, jbias, jmask, jg, h, scale,
                                  stacked=False, interpret=True)
    _, vjp = jax.vjp(lambda *a: window_mha_diff(*a, jmask, h, scale, True),
                     jq, jk, jv, jbias)
    custom = vjp(jg)
    tq, tk, tv, tg = (torch.from_numpy(a).to(tdt) for a in (q, k, v, g))
    got = kernel_order_bwd(tq, tk, tv, torch.from_numpy(bias),
                           None if mask is None else torch.from_numpy(mask),
                           tg, h, scale)
    assert [t.dtype for t in got] == [tdt] * 3 + [torch.float32]
    for want in (pallas, custom):
        for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
            assert _rel(a, np.asarray(b, np.float32)) < _BARS[dtype], name
    if hot:
        # The clamp's entries carry no score cotangent in either package.
        x = _exponent(_heads(tq, h), _heads(tk, h), torch.from_numpy(bias),
                      None if mask is None else torch.from_numpy(mask), scale)
        assert bool((x >= torch.tensor(CLAMP_LOG2)).any())


def test_window_parts_cuts_are_where_the_timing_script_finds_them():
    """scripts/perf/torch_window_parts.py times window_mha's Hopper body
    with a part left out by replacing lines in a copy of window_mha.cu:
    each line it replaces is there once."""
    import importlib.util
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    path = repo / "scripts" / "perf" / "torch_window_parts.py"
    spec = importlib.util.spec_from_file_location("torch_window_parts", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    code = (repo / "tfimm_tpu_torch" / "csrc" / "window_mha.cu").read_text()
    cuts = [old for form in script.CUTS.values() for old, _ in form]
    assert len(cuts) == 4
    for old in cuts:
        assert code.count(old) == 1, old
