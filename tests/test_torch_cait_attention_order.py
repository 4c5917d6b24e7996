"""The order of work of the talking-head attention's Hopper kernels
(``csrc/cait_attention.cu`` and ``cait_attention_bwd.cu``, their bf16 TMA +
wgmma bodies: ``tma.cait_route``), emulated in plain PyTorch on the CPU and
held against the JAX package's Pallas kernels in interpret mode
(``talking_head_attention``, ``_thattn_bwd_call``).

The emulations follow the kernels' tiles and roundings: query tiles of 64
rows and key stages of 16 with TMA's zero rows past N; scale and log2(e)
folded into the pre-softmax mix, so that p = 2^(min(s2, 80 log2 e) -
log2 l) is one subtraction and one exponential; l summed over the keys
below N in f32, log2 l set to 0 on the padded query rows; a_h rounded to
bf16 once; in the backward, a and draw rounded to bf16 into the scratch
that the second launch reads through 64 x 64 boxes (zeros past N), and the
mix-gradient partials summed a query tile (dw_l, dw_w) or a key tile
(db_w) at a time, then over the tiles in order. Inputs are made with numpy
from a seed; the (H, H) mixes are random and not symmetric.

Bars, as max|diff| / max|JAX|: f32 1e-5 (forward) and 1e-4 (backward), the
same math summed in another order; bf16 2e-2, where the kernels round a
and draw once and the Pallas kernels round each p_g. The controls (a_h left
unnormalised, w_w transposed, a scratch whose padded rows hold NaN read as
they are) must miss their bars. N = 196 (cait_s24_224) and a ragged 50, H =
8 and 4, d = 48, and a case with mixed scores on both sides of the clamp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfimm_tpu.ops.pallas.cait_attention import (
    _thattn_bwd_call,
    talking_head_attention as pallas_talking_head,
)
from tfimm_tpu_torch.ops.kernels.cait_attention import (
    talking_head_attention_bwd_reference,
    talking_head_attention_reference,
)
from tfimm_tpu_torch.ops.kernels.tma import CAIT_KEYS, TILE, cait_scratch_cols

torch.set_num_threads(1)

LOG2E = 1.4426950408889634
CLAMP2 = 80.0 * LOG2E
NAMES = ("dqkv", "dw_l", "db_l", "dw_w", "db_w")
CONTROL_FACTOR = 5.0


def _ceil(n, m):
    return -(-n // m) * m


def _heads(x, h):
    """(B, N, H * d) -> (B, H, N, d)."""
    b, n, c = x.shape
    return x.reshape(b, n, h, c // h).transpose(1, 2)


def _merge(x):
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


def _rows(x, rows):
    """(..., N, d) with zero rows up to ``rows``, as TMA fills a box."""
    return torch.nn.functional.pad(x, (0, 0, 0, rows - x.shape[-2]))


def _probs(q, k, w_l, b_l, n, scale, normalise=True):
    """The kernels' passes 1 and 2 over padded (B, H, rows, d) q and k:
    raw scores, s2 = log2(e) s', and p = 2^(min(s2, 80 log2 e) - log2 l)
    (with ``normalise`` False, the unnormalised 2^min(s2, 80 log2 e))."""
    raw = q @ k.transpose(-1, -2)
    s2 = torch.einsum("bhqk,hg->bgqk", raw, w_l * (scale * LOG2E))
    s2 = s2 + (LOG2E * b_l)[:, None, None]
    e = torch.exp2(torch.clamp(s2, max=CLAMP2))
    keys = torch.arange(k.shape[-2])
    l = torch.where(keys < n, e, torch.zeros(())).sum(-1)
    rows = torch.arange(q.shape[-2])
    log2l = torch.where(rows < n, torch.log2(l), torch.zeros(()))
    p = torch.exp2(torch.clamp(s2, max=CLAMP2) - log2l[..., None])
    return raw, s2, (p if normalise else e)


def kernel_order_fwd(qkv, w_l, b_l, w_w, b_w, *, nb_heads, scale,
                     rounded, normalise=True):
    """The Hopper forward's order of work on qkv (B, N, 3D) in f32 (bf16
    values where ``rounded``): out (B, N, D), rounded to bf16 once where
    ``rounded``."""
    r = (lambda t: t.bfloat16().float()) if rounded else (lambda t: t)
    b, n, _ = qkv.shape
    q, k, v = (_heads(t, nb_heads).float() for t in qkv.chunk(3, dim=-1))
    q, k, v = _rows(q, _ceil(n, TILE)), _rows(k, _ceil(n, CAIT_KEYS)), _rows(
        v, _ceil(n, CAIT_KEYS))
    _, _, p = _probs(q, k, w_l, b_l, n, scale, normalise)
    a = r(torch.einsum("bgqk,gh->bhqk", p, w_w))
    out = torch.zeros(*q.shape[:-1], v.shape[-1])
    for t in range(k.shape[-2] // CAIT_KEYS):   # a stage of 16 keys
        keys = slice(CAIT_KEYS * t, CAIT_KEYS * (t + 1))
        out += a[..., keys] @ v[:, :, keys]
    out = out + b_w[:, None, None] * v.sum(-2, keepdim=True)
    return r(_merge(out[:, :, :n]))


def kernel_order_bwd(qkv, w_l, b_l, w_w, b_w, g, *, nb_heads, scale, rounded,
                     padded_nan=False):
    """The Hopper backward's order of work on qkv (B, N, 3D) and g (B, N, D)
    in f32: (dqkv, dw_l, db_l, dw_w, db_w). Launch A, per 64-row query
    tile: l; delta = rowsum(p dp), dw_w's partial sum p_g da_h and a; ds
    through the clamp mask, draw and dw_l's partial sum raw_h ds_g; a and
    draw (bf16 where ``rounded``) into the scratch (2, B, H, N, cols),
    rows and keys below N. Launch B reads the scratch through 64 x 64 boxes
    with zeros past N: dk = draw^T q, dv = a^T g + b_w colsum(g), dq =
    draw k, and db_w's partial per key tile. With ``padded_nan`` the
    scratch starts as NaN and launch B reads its boxes as they lie in
    memory past N (as boxes over a scratch padded to whole tiles would)."""
    r = (lambda t: t.bfloat16().float()) if rounded else (lambda t: t)
    b, n, _ = qkv.shape
    h = nb_heads
    rows_pad, keys_pad = _ceil(n, TILE), _ceil(n, CAIT_KEYS)
    q, k, v = (_heads(t, h).float() for t in qkv.chunk(3, dim=-1))
    gh = _heads(g, h).float()
    qp, gp = _rows(q, rows_pad), _rows(gh, rows_pad)
    kp, vp = _rows(k, keys_pad), _rows(v, keys_pad)

    # Launch A, a query tile at a time.
    cols = cait_scratch_cols(n)
    fill = float("nan") if padded_nan else 0.0
    scratch = torch.full((2, b, h, n, cols), fill)
    part_wl, part_ww = [], []
    for t in range(rows_pad // TILE):
        rs = slice(TILE * t, TILE * (t + 1))
        raw, s2, p = _probs(qp[:, :, rs], kp, w_l, b_l, n, scale)
        da = gp[:, :, rs] @ vp.transpose(-1, -2)
        dp = torch.einsum("bhqk,gh->bgqk", da, w_w)
        delta = (p * dp).sum(-1, keepdim=True)
        part_ww.append(torch.einsum("bgqk,bhqk->bgh", p, da))
        a = r(torch.einsum("bgqk,gh->bhqk", p, w_w))
        ds = torch.where(s2 < CLAMP2, p * (dp - delta), torch.zeros(()))
        draw = r(torch.einsum("bgqk,hg->bhqk", ds, scale * w_l))
        part_wl.append(scale * torch.einsum("bhqk,bgqk->bhg", raw, ds))
        live = slice(TILE * t, min(TILE * (t + 1), n))
        width = live.stop - live.start
        scratch[0, :, :, live, :n] = a[:, :, :width, :n]
        scratch[1, :, :, live, :n] = draw[:, :, :width, :n]

    # Launch B, through 64 x 64 boxes of the scratch.
    pad = _ceil(n, TILE)
    if padded_nan:
        boxed = torch.full((2, b, h, pad, pad), float("nan"))
        boxed[..., :n, :min(cols, pad)] = scratch[..., :min(cols, pad)]
    else:
        boxed = torch.zeros(2, b, h, pad, pad)
        boxed[..., :n, :n] = scratch[..., :n]
    a_s, draw_s = boxed[0], boxed[1]
    q64, k64, g64, v64 = (_rows(t, pad) for t in (q, k, gh, v))
    dq = torch.zeros(b, h, pad, q.shape[-1])
    dk = torch.zeros_like(dq)
    dv = torch.zeros_like(dq)
    for t in range(pad // TILE):        # a 64-row tile of the streamed side
        tt = slice(TILE * t, TILE * (t + 1))
        dk += draw_s[:, :, tt].transpose(-1, -2) @ q64[:, :, tt]
        dv += a_s[:, :, tt].transpose(-1, -2) @ g64[:, :, tt]
        dq += draw_s[..., tt] @ k64[:, :, tt]
    gcol = g64.sum(-2)                                  # (B, H, d)
    dv = dv + b_w[:, None, None] * gcol[:, :, None]
    part_bw = [(gcol * v64[:, :, TILE * t:TILE * (t + 1)].sum(-2)).sum(-1)
               for t in range(pad // TILE)]              # (B, H) a key tile

    # The partials summed over the blocks in order (image by image).
    dwl = torch.zeros(h, h)
    dww = torch.zeros(h, h)
    dbw = torch.zeros(h)
    for bi in range(b):
        for t in range(len(part_wl)):
            dwl += part_wl[t][bi]
            dww += part_ww[t][bi]
        for t in range(len(part_bw)):
            dbw += part_bw[t][bi]
    dqkv = torch.cat([r(_merge(x[:, :, :n])) for x in (dq, dk, dv)], dim=-1)
    return dqkv, dwl, torch.zeros(h), dww, dbw


def _rel(got, want):
    got = np.asarray(got.double() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _inputs(seed, b, n, h, d=48, clamp=False):
    """qkv (B, N, 3D) and g (B, N, D) normal, mixes of std 0.3, b_l of
    unit size and b_w of std 0.02 (numpy, f32): a larger b_w makes its term
    b_w[h] colsum(v_h), a sum over N keys, dwarf the attention, and a bar
    relative to the largest value would then hide a wrong mix. With
    ``clamp``, query 0 of every head points
    along keys 3 and 5, so that its mixed scores land far above the clamp
    of 80 for some output heads and far below it for others."""
    rng = np.random.default_rng(seed)
    dim = h * d
    qkv = rng.normal(size=(b, n, 3 * dim)).astype(np.float32)
    if clamp:
        x = qkv.reshape(b, n, 3, h, d)
        x[:, 0, 0] = 60.0 * (x[:, 3, 1] + x[:, 5, 1])
        qkv = x.reshape(b, n, 3 * dim)
    wl = (0.3 * rng.normal(size=(h, h))).astype(np.float32)
    ww = (0.3 * rng.normal(size=(h, h))).astype(np.float32)
    bl = rng.normal(size=(h,)).astype(np.float32)
    bw = (0.02 * rng.normal(size=(h,))).astype(np.float32)
    g = rng.normal(size=(b, n, dim)).astype(np.float32)
    assert np.abs(wl - wl.T).max() > 0.1 and np.abs(ww - ww.T).max() > 0.1
    return qkv, wl, bl, ww, bw, g, h, d ** -0.5


def _case(arrays, dtype):
    """The port's f32 tensors of the values in ``dtype`` and the JAX
    arrays (qkv and g in ``dtype``, the mixes in f32)."""
    qkv, wl, bl, ww, bw, g = arrays
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    port = [torch.from_numpy(qkv).to(tdt).float(),
            *(torch.from_numpy(a) for a in (wl, bl, ww, bw)),
            torch.from_numpy(g).to(tdt).float()]
    jax_args = [jnp.asarray(qkv, jdt), *(jnp.asarray(a) for a in (wl, bl, ww,
                                                                   bw))]
    return port, jax_args, jnp.asarray(g, jdt)


SHAPES = [(1, 196, 8), (2, 50, 4)]
BARS = {"float32": (1e-5, 1e-4), "bfloat16": (2e-2, 2e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,h", SHAPES)
def test_forward_order_matches_the_pallas_kernel(b, n, h, dtype):
    *arrays, h, scale = _inputs(10 * n + h, b, n, h)
    port, jargs, _ = _case(arrays, dtype)
    want = np.asarray(pallas_talking_head(*jargs, nb_heads=h, scale=scale,
                                          interpret=True).astype(jnp.float32))
    got = kernel_order_fwd(*port[:5], nb_heads=h, scale=scale,
                           rounded=dtype == "bfloat16")
    assert _rel(got, want) < BARS[dtype][0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,h", SHAPES)
def test_backward_order_matches_the_pallas_backward(b, n, h, dtype):
    *arrays, h, scale = _inputs(20 * n + h, b, n, h)
    port, jargs, jg = _case(arrays, dtype)
    want = _thattn_bwd_call(*jargs, jg, h, scale, interpret=True)
    got = kernel_order_bwd(*port, nb_heads=h, scale=scale,
                           rounded=dtype == "bfloat16")
    assert torch.equal(got[2], torch.zeros(h))
    for name, a, w in zip(NAMES, got, want):
        if name != "db_l":
            w = np.asarray(w.astype(jnp.float32))
            assert _rel(a, w) < BARS[dtype][1], name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_order_holds_scores_at_the_clamp(dtype):
    """Mixed scores far on both sides of 80: the forward's exp2 clamped at
    80 log2(e) and the backward's mask on s2 < 80 log2(e) agree with the
    Pallas kernels' exp(min(s', 80)) and s' < 80."""
    *arrays, h, scale = _inputs(5, 2, 24, 4, clamp=True)
    port, jargs, jg = _case(arrays, dtype)
    raw = np.einsum("bqhd,bkhd->bhqk", *(arrays[0].reshape(2, 24, 3, h, 48)
                                         [:, :, i] for i in (0, 1)))
    s = np.einsum("bhqk,hg->bgqk", raw, scale * arrays[1]) + arrays[2][
        :, None, None]
    assert (s > 80).any() and (s[:, :, 0] < 80).any()
    rounded = dtype == "bfloat16"
    fwd = np.asarray(pallas_talking_head(*jargs, nb_heads=h, scale=scale,
                                         interpret=True).astype(jnp.float32))
    got = kernel_order_fwd(*port[:5], nb_heads=h, scale=scale, rounded=rounded)
    assert bool(torch.isfinite(got).all())
    assert _rel(got, fwd) < BARS[dtype][0]
    bwd = _thattn_bwd_call(*jargs, jg, h, scale, interpret=True)
    grads = kernel_order_bwd(*port, nb_heads=h, scale=scale, rounded=rounded)
    for name, a, w in zip(NAMES, grads, bwd):
        if name != "db_l":
            assert _rel(a, np.asarray(w.astype(jnp.float32))) < BARS[dtype][1]


def test_order_matches_the_plain_versions_in_f32():
    """The emulations against the port's plain versions (the kernels' CPU
    path) at the ragged N: the same function to f32 rounding."""
    *arrays, h, scale = _inputs(7, 2, 50, 8)
    port, _, _ = _case(arrays, "float32")
    want = talking_head_attention_reference(*port[:5], nb_heads=h,
                                            scale=scale)
    assert _rel(kernel_order_fwd(*port[:5], nb_heads=h, scale=scale,
                                 rounded=False), want.numpy()) < 1e-5
    grads = talking_head_attention_bwd_reference(*port, nb_heads=h,
                                                 scale=scale)
    ours = kernel_order_bwd(*port, nb_heads=h, scale=scale, rounded=False)
    for name, a, w in zip(NAMES, ours, grads):
        if name != "db_l":
            assert _rel(a, w.numpy()) < 1e-4, name


@pytest.mark.parametrize("control", ["unnormalised", "w_w transposed"])
def test_forward_controls_miss_the_bar(control):
    """a_h mixed from p_g left unnormalised, or through w_w transposed,
    misses the bf16 bar by far."""
    *arrays, h, scale = _inputs(11, 1, 196, 8)
    port, jargs, _ = _case(arrays, "bfloat16")
    want = np.asarray(pallas_talking_head(*jargs, nb_heads=h, scale=scale,
                                          interpret=True).astype(jnp.float32))
    qkv, wl, bl, ww, bw = port[:5]
    if control == "unnormalised":
        got = kernel_order_fwd(qkv, wl, bl, ww, bw, nb_heads=h, scale=scale,
                               rounded=True, normalise=False)
    else:
        got = kernel_order_fwd(qkv, wl, bl, ww.T, bw, nb_heads=h, scale=scale,
                               rounded=True)
    assert _rel(got, want) > CONTROL_FACTOR * BARS["bfloat16"][0]


def test_backward_control_padded_scratch_rows_miss():
    """Control: launch B reading its 64 x 64 boxes as they lie in a scratch
    that starts as NaN (the contents of ``torch.empty`` may be anything),
    past N included, gets NaN into dq and dk, where the zeros TMA gives
    past N add nothing; with the zeros the result holds its bar."""
    *arrays, h, scale = _inputs(12, 1, 50, 4)
    port, jargs, jg = _case(arrays, "bfloat16")
    want = _thattn_bwd_call(*jargs, jg, h, scale, interpret=True)
    good = kernel_order_bwd(*port, nb_heads=h, scale=scale, rounded=True)
    bad = kernel_order_bwd(*port, nb_heads=h, scale=scale, rounded=True,
                           padded_nan=True)
    w = np.asarray(want[0].astype(jnp.float32))
    assert _rel(good[0], w) < BARS["bfloat16"][1]
    d = 4 * 48
    assert not bool(torch.isfinite(bad[0][..., :d]).all())      # dq
    assert not bool(torch.isfinite(bad[0][..., d:2 * d]).all())  # dk
