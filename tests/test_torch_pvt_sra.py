"""Port parity: tfimm_tpu_torch's pvt_sra (its plain version, on the CPU)
against the JAX package's Pallas SRA kernel in interpret mode, and the
port's SpatialReductionAttention against the JAX modules.

Inputs are made with numpy from a seed and handed to both packages; the
Pallas kernel takes wq and wp as (in, out), the port the Dense layout
(out, in), and the port takes k and v as the kv projection's two halves.
Bars: 1e-5 in f32 and 2e-2 of the largest reference value in bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfimm_tpu.architectures.pvt import (
    SpatialReductionAttention as JaxSRA,
)
from tfimm_tpu.architectures.pvt_v2 import SpatialReductionAttentionV2
from tfimm_tpu.core import Context as JaxContext
from tfimm_tpu.ops.pallas.dispatch import capture_dispatches as jax_capture
from tfimm_tpu.ops.pallas.pvt_sra import sra_attention_or_none
from tfimm_tpu_torch.architectures.pvt import SpatialReductionAttention
from tfimm_tpu_torch.core import Context
from tfimm_tpu_torch.ops.kernels import dispatch
from tfimm_tpu_torch.ops.kernels.dispatch import capture_dispatches
from tfimm_tpu_torch.ops.kernels.pvt_sra import pvt_sra, pvt_sra_reference
from tfimm_tpu_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(1)


def _inputs(b, n, s, c, seed):
    """x, k, v, wq (in, out), bq, wp (in, out), bp as f32 numpy arrays; the
    weights scaled so that the scores spread over several units."""
    rng = np.random.default_rng(seed)

    def rnd(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return (rnd(b, n, c), rnd(b, s, c), rnd(b, s, c), rnd(c, c, scale=c ** -0.5),
            rnd(c, scale=0.1), rnd(c, c, scale=c ** -0.5), rnd(c, scale=0.1))


def _held(got, want, dtype):
    """f32: within 1e-5 absolute and relative; bf16: within 2e-2 of the
    largest reference value."""
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        err = np.abs(got - want).max()
        assert err <= 2e-2 * np.abs(want).max(), err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,s,c", [(2, 64, 16, 32), (2, 56, 49, 64),
                                     (1, 37, 7, 16), (1, 16, 256, 8)])
def test_matches_pallas_kernel_in_interpret_mode(monkeypatch, b, n, s, c,
                                                 dtype):
    monkeypatch.setenv("TFIMM_TPU_PALLAS_INTERPRET", "1")
    x, k, v, wq, bq, wp, bp = _inputs(b, n, s, c, seed=n + s + c)
    dt = getattr(jnp, dtype)
    scale = c ** -0.5
    want = sra_attention_or_none(
        jnp.asarray(x, dt), jnp.asarray(k, dt), jnp.asarray(v, dt),
        jnp.asarray(wq), jnp.asarray(bq), jnp.asarray(wp), jnp.asarray(bp),
        scale=scale)
    tdt = getattr(torch, dtype)
    t = torch.from_numpy
    kv = torch.cat([t(k), t(v)], dim=-1).to(tdt)
    before = dict(dispatch.launch_counts)
    got = pvt_sra(t(x).to(tdt), kv, t(wq.T.copy()), t(bq), t(wp.T.copy()),
                  t(bp), scale)
    assert dispatch.launch_counts == before   # no kernel on the CPU
    assert got.dtype == tdt
    _held(got, want, dtype)


def test_missing_biases_are_zero(monkeypatch):
    monkeypatch.setenv("TFIMM_TPU_PALLAS_INTERPRET", "1")
    x, k, v, wq, _, wp, _ = _inputs(2, 24, 9, 16, seed=3)
    want = sra_attention_or_none(jnp.asarray(x), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(wq), None, jnp.asarray(wp), None,
                                 scale=0.25)
    t = torch.from_numpy
    got = pvt_sra_reference(t(x), t(k), t(v), t(wq.T.copy()), None,
                            t(wp.T.copy()), None, 0.25)
    _held(got, want, "float32")


def test_softmax_keeps_its_max():
    # Scores far above 80: the standard softmax with its max, not the
    # clamped no-max softmax of the other attention kernels, which would
    # saturate here.
    x, k, v, wq, bq, wp, bp = _inputs(1, 8, 5, 8, seed=4)
    t = torch.from_numpy
    x = t(x) * 40.0
    got = pvt_sra_reference(x, t(k), t(v), t(wq.T.copy()), t(bq),
                            t(wp.T.copy()), t(bp), 1.0)
    q = (x @ t(wq) + t(bq))
    s = q @ t(k)[0].T
    assert s.max() > 100
    p = torch.softmax(s.double(), dim=-1)
    want = (p @ t(v)[0].double()) @ t(wp).double() + t(bp).double()
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)


def _module_pair(cls_jax, nb_heads, seed, **kw):
    kw = dict(embed_dim=32, nb_heads=nb_heads, sr_ratio=4, qkv_bias=True,
              attn_drop_rate=0.0, proj_drop_rate=0.0, **kw)
    jm = cls_jax(**kw)
    params = jm.init(jax.random.PRNGKey(seed))
    linear = kw.pop("linear_sr", False)
    kw.pop("act_layer", None)
    tm = SpatialReductionAttention(**kw, linear_sr=linear)
    tm.load_state_dict(state_dict_from_jax(params))  # strict: names match
    x = np.random.default_rng(seed).normal(size=(2, 64, 32)).astype(np.float32)
    return jm, params, tm, x


_MODULES = [
    ("v1", lambda h, s: _module_pair(JaxSRA, h, s)),
    ("v2", lambda h, s: _module_pair(SpatialReductionAttentionV2, h, s,
                                     linear_sr=False, act_layer="gelu")),
    ("v2_linear", lambda h, s: _module_pair(SpatialReductionAttentionV2, h, s,
                                            linear_sr=True, act_layer="gelu")),
]


@pytest.mark.parametrize("switch", ["0", "1"])
@pytest.mark.parametrize("name,make", _MODULES, ids=[m[0] for m in _MODULES])
def test_module_matches_jax(monkeypatch, name, make, switch):
    # Switched on, both packages take their kernel: the JAX package its
    # Pallas kernel in interpret mode, the port its kernel's plain version.
    monkeypatch.setenv("TFIMM_TPU_FUSED_PVT_SRA", switch)
    monkeypatch.setenv("TFIMM_TPU_PALLAS_INTERPRET", switch)
    jm, params, tm, x = make(1, 5)
    with JaxContext(training=False), jax_capture() as jax_seen:
        want = jm(params, jnp.asarray(x), (8, 8))
    with torch.no_grad(), capture_dispatches() as seen:
        got = tm(torch.from_numpy(x), (8, 8))
    expected = {"pvt_sra"} if switch == "1" else set()
    assert seen == expected and jax_seen == expected, (seen, jax_seen)
    _held(got, want, "float32")


@pytest.mark.parametrize("name,make", _MODULES, ids=[m[0] for m in _MODULES])
def test_multi_head_never_reaches_the_kernel(monkeypatch, name, make):
    monkeypatch.setenv("TFIMM_TPU_FUSED_PVT_SRA", "1")
    monkeypatch.setenv("TFIMM_TPU_PALLAS_INTERPRET", "1")
    jm, params, tm, x = make(2, 6)
    with JaxContext(training=False):
        want = jm(params, jnp.asarray(x), (8, 8))
    before = dict(dispatch.launch_counts)
    with torch.no_grad(), capture_dispatches() as seen:
        got = tm(torch.from_numpy(x), (8, 8))
    assert seen == set() and dispatch.launch_counts == before
    _held(got, want, "float32")


def test_gate_reads_the_training_flag_and_the_switch(monkeypatch):
    _, _, tm, x = _module_pair(JaxSRA, 1, 7)
    xt = torch.from_numpy(x)
    for switch, training, want in (("0", False, set()), ("1", True, set()),
                                   ("1", False, {"pvt_sra"})):
        monkeypatch.setenv("TFIMM_TPU_FUSED_PVT_SRA", switch)
        with Context(training=training), capture_dispatches() as seen:
            tm(xt, (8, 8))
        assert seen == want, (switch, training)


def test_bf16_module_matches_jax_kernel_path(monkeypatch):
    monkeypatch.setenv("TFIMM_TPU_FUSED_PVT_SRA", "1")
    monkeypatch.setenv("TFIMM_TPU_PALLAS_INTERPRET", "1")
    jm, params, tm, x = _module_pair(JaxSRA, 1, 8)
    pb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)
    with JaxContext(training=False):
        want = jm(pb, jnp.asarray(x, jnp.bfloat16), (8, 8))
    with torch.no_grad():
        got = tm.to(torch.bfloat16)(torch.from_numpy(x).bfloat16(), (8, 8))
    _held(got, want, "bfloat16")
