"""The summation order of ``ln_dense``'s Hopper backward (``csrc/ln_dense.cu``
on ``tma.ln_dense_bwd_route``), emulated in plain PyTorch on the CPU, against
the JAX VJP of ``ln_dense_diff`` in interpret mode.

``kernel_order`` follows the body: the forward's row statistics; dz = g w in
f32, never rounded; z = LN(x) rounded to the dtype; per 64-row block, each of
its 8 warps adds dz * xhat and dz over its 8 rows in order and the block's
dgamma and dbeta partials are the warps' sums in order, the partials then
summed over the blocks in order; a row's sums of dxn and dxn * xhat over a
lane's columns (256 i + 8 lane .. + 7) in order, then across the 32 lanes
by xor shuffles (at C >= 256 the row statistics too, in row_stats' order);
dW as f32 partials over ``tma.ln_dense_bwd_plan``'s
slices of M, summed in order and rounded once; db per slice as two halves
of each 64-row step (rows 0-31 and 32-63 of every step, each summed in
order over the slice), added, then summed over the slices in order.
Inputs and bars as ``tests/test_torch_ln_dense.py``'s: the five gradients
within 5e-4 of max|JAX| in f32 and 2e-2 in bf16. The slice plans of 132 and
of 4 SMs (several slices) are both held.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfimm_tpu_torch.ops.kernels.tma import ln_dense_bwd_plan

jax_ln_dense = importlib.import_module("tfimm_tpu.ops.pallas.ln_dense")

torch.set_num_threads(1)

EPS = 1e-6
ROWS = 64        # a dx block's rows (tma.LN_BWD_ROWS)
WARPS = 8        # its warps, 8 consecutive rows each
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(m, c, o, seed):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.normal(size=(m, c)).astype(np.float32) * 2 + 0.5,
        gamma=(1 + 0.1 * rng.normal(size=(c,))).astype(np.float32),
        beta=(0.1 * rng.normal(size=(c,))).astype(np.float32),
        w=(0.05 * rng.normal(size=(c, o))).astype(np.float32),
        b=(0.1 * rng.normal(size=(o,))).astype(np.float32),
        g=rng.normal(size=(m, o)).astype(np.float32))


def _ordered_sum(t, dim):
    """The f32 sum of t along ``dim``, one term after another."""
    t = t.movedim(dim, 0)
    out = torch.zeros_like(t[0])
    for part in t:
        out = out + part
    return out


def _lane_sums(v):
    """A row's sum as the dx pass takes it: each lane over its columns
    256 i + 8 lane + e (i, then e) in order, then the xor butterfly over
    the 32 lanes. v (M, C) f32."""
    m, c = v.shape
    chunks = -(-c // 256)
    padded = torch.zeros(m, chunks * 256)
    padded[:, :c] = v
    lanes = padded.view(m, chunks, 32, 8).permute(2, 0, 1, 3).reshape(
        32, m, chunks * 8)
    acc = _ordered_sum(lanes, 2)   # (32, M)
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[torch.arange(32) ^ off]
    return acc[0]


def kernel_order(x, gamma, beta, w, g, sms=132):
    """(dx, dgamma, dbeta, dW, db) of the Hopper backward's order; x (M, C)
    and g (M, O) in the dtype, w (O, C) in the Dense layout."""
    dt, f32 = x.dtype, torch.float32
    (m, c), o = x.shape, w.shape[0]
    xf, gf = x.to(f32), g.to(dt).to(f32)
    if c >= 256:
        mean = _lane_sums(xf)[:, None] / c
        var = torch.clamp(_lane_sums(xf * xf)[:, None] / c - mean * mean,
                          min=0)
    else:
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean,
                          min=0)
    rstd = torch.rsqrt(var + EPS)
    xh = (xf - mean) * rstd
    z = (xh * gamma + beta).to(dt).to(f32)
    dz = gf @ w.to(dt).to(f32)
    dxn = dz * gamma
    m1 = _lane_sums(dxn)[:, None] / c
    m2 = _lane_sums(dxn * xh)[:, None] / c
    dx = (rstd * (dxn - m1 - xh * m2)).to(dt)

    blocks = -(-m // ROWS)
    pad = torch.zeros(blocks * ROWS, 2, c)
    pad[:m, 0], pad[:m, 1] = dz * xh, dz
    warps = _ordered_sum(pad.view(blocks, WARPS, ROWS // WARPS, 2, c), 2)
    dgb = _ordered_sum(_ordered_sum(warps, 1), 0)

    plan = ln_dense_bwd_plan(m, c, o, sms)
    parts, db_parts = [], []
    for split in range(plan.splits):
        r = slice(split * plan.per_split, min(m, (split + 1) * plan.per_split))
        parts.append(gf[r].t() @ z[r])
        steps = -(-(r.stop - r.start) // ROWS)
        gs = torch.zeros(steps * ROWS, o)
        gs[:r.stop - r.start] = gf[r]
        halves = gs.view(steps, 2, ROWS // 2, o).permute(1, 0, 2, 3).reshape(
            2, steps * ROWS // 2, o)
        db_parts.append(_ordered_sum(halves[0], 0) + _ordered_sum(halves[1], 0))
    dw = _ordered_sum(torch.stack(parts), 0).to(dt)
    db = _ordered_sum(torch.stack(db_parts), 0)
    return dx, dgb[0], dgb[1], dw, db


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("sms", [132, 4])
@pytest.mark.parametrize("dt,tol", [("f32", 5e-4), ("bf16", 2e-2)])
@pytest.mark.parametrize("m,c,o", [(197, 96, 40), (300, 136, 64),
                                   (130, 256, 24)])
def test_kernel_order_matches_the_jax_vjp(m, c, o, dt, tol, sms):
    a = _inputs(m, c, o, seed=m + c + o)
    jdt, tdt = DTYPES[dt]
    jargs = (jnp.asarray(a["x"], jdt), jnp.asarray(a["gamma"]),
             jnp.asarray(a["beta"]), jnp.asarray(a["w"], jdt),
             jnp.asarray(a["b"]))
    y, vjp = jax.vjp(lambda *t: jax_ln_dense.ln_dense_diff(*t, EPS, True),
                     *jargs)
    want = vjp(jnp.asarray(a["g"], y.dtype))
    got = kernel_order(torch.tensor(a["x"]).to(tdt), torch.tensor(a["gamma"]),
                       torch.tensor(a["beta"]),
                       torch.tensor(a["w"].T.copy()).to(tdt),
                       torch.tensor(a["g"]).to(tdt), sms)
    for name, grad, ref in zip(("dx", "dgamma", "dbeta", "dw", "db"), got,
                               want):
        grad = grad.float()
        if name == "dw":
            grad = grad.t()
        _close(grad, jnp.asarray(ref, jnp.float32), tol)


def test_plans_take_several_slices():
    """The 4-SM plans above slice M, so the partial sums are exercised."""
    assert ln_dense_bwd_plan(300, 136, 64, 4).splits > 1
    assert ln_dense_bwd_plan(197, 96, 40, 132).splits > 1
