"""Port parity: tfimm_tpu_torch's poolformer_block (its plain version, on
the CPU) against the JAX package's Pallas PoolFormer block in interpret
mode, and the port's PoolFormerBlock against the JAX block.

Inputs are made with numpy from a seed and handed to both packages, with
the layer scales near 1 and the GroupNorm affines away from (1, 0): at the
init scale of 1e-5 the block's output equals x to bf16 precision and no
comparison would see its work. The Pallas kernel takes the 1x1 convs'
kernels (1, 1, C, 4C) and (1, 1, 4C, C); the port the Dense layout. Bars:
1e-5 in f32 and 2e-2 of the largest reference value in bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tfimm_tpu.architectures.poolformer import PoolFormerBlock as JaxBlock
from tfimm_tpu.core import Context as JaxContext
from tfimm_tpu.ops.pallas.dispatch import capture_dispatches as jax_capture
from tfimm_tpu.ops.pallas.poolformer_block import poolformer_block_or_none
from tfimm_tpu.ops.pool import avg_pool_2d_exclude_pad as jax_pool
from tfimm_tpu_torch.architectures.poolformer import PoolFormerBlock
from tfimm_tpu_torch.core import Context
from tfimm_tpu_torch.ops.kernels import dispatch
from tfimm_tpu_torch.ops.kernels.dispatch import capture_dispatches
from tfimm_tpu_torch.ops.kernels.poolformer_block import (
    _group_norm1,
    poolformer_block,
    poolformer_block_reference,
)
from tfimm_tpu_torch.ops.pool import avg_pool_2d_exclude_pad
from tfimm_tpu_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(1)


def _inputs(b, h, w, c, hidden, seed):
    """The block's input and parameters as f32 numpy arrays: norm weights
    and layer scales near 1, the MLP scaled to unit-size products."""
    rng = np.random.default_rng(seed)

    def rnd(*shape, scale=1.0, shift=0.0):
        return (rng.normal(size=shape) * scale + shift).astype(np.float32)

    return dict(x=rnd(b, h, w, c), n1w=rnd(c, scale=0.1, shift=1.0),
                n1b=rnd(c, scale=0.1), n2w=rnd(c, scale=0.1, shift=1.0),
                n2b=rnd(c, scale=0.1), w1=rnd(c, hidden, scale=c ** -0.5),
                b1=rnd(hidden, scale=0.1),
                w2=rnd(hidden, c, scale=hidden ** -0.5), b2=rnd(c, scale=0.1),
                ls1=rnd(c, scale=0.1, shift=1.0),
                ls2=rnd(c, scale=0.1, shift=1.0))


def _jax_params(a):
    """The JAX block's parameter tree of the same values."""
    c, hidden = a["w1"].shape
    return {"norm1": {"scale": a["n1w"], "bias": a["n1b"]},
            "norm2": {"scale": a["n2w"], "bias": a["n2b"]},
            "mlp": {"fc1": {"kernel": a["w1"].reshape(1, 1, c, hidden),
                            "bias": a["b1"]},
                    "fc2": {"kernel": a["w2"].reshape(1, 1, hidden, c),
                            "bias": a["b2"]}},
            "layer_scale_1": a["ls1"], "layer_scale_2": a["ls2"]}


def _torch_args(a, dtype):
    t = torch.from_numpy
    return (t(a["x"]).to(dtype), t(a["n1w"]), t(a["n1b"]), t(a["ls1"]),
            t(a["n2w"]), t(a["n2b"]), t(a["w1"].T.copy()), t(a["b1"]),
            t(a["w2"].T.copy()), t(a["b2"]), t(a["ls2"]))


def _pallas(monkeypatch, a, dtype):
    monkeypatch.setenv("TFIMM_TPU_PALLAS_INTERPRET", "1")
    hidden = a["w1"].shape[1]
    x = jnp.asarray(a["x"], getattr(jnp, dtype))
    out = poolformer_block_or_none(_jax_params(a), x,
                                   mlp_ratio=hidden / a["x"].shape[-1])
    return np.asarray(out.astype(jnp.float32))


def _held(got, want, dtype):
    """f32: within 1e-5 absolute and relative; bf16: within 2e-2 of the
    largest reference value."""
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        err = np.abs(got - want).max()
        assert err <= 2e-2 * np.abs(want).max(), err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,w,c,hidden", [(2, 6, 5, 16, 64),
                                            (1, 12, 12, 32, 128),
                                            (3, 7, 7, 24, 48)])
def test_matches_pallas_kernel_in_interpret_mode(monkeypatch, b, h, w, c,
                                                 hidden, dtype):
    a = _inputs(b, h, w, c, hidden, seed=h * w + c)
    want = _pallas(monkeypatch, a, dtype)
    before = dict(dispatch.launch_counts)
    got = poolformer_block(*_torch_args(a, getattr(torch, dtype)))
    assert dispatch.launch_counts == before   # no kernel on the CPU
    assert got.dtype == getattr(torch, dtype)
    _held(got, want, dtype)


@pytest.mark.parametrize("h,w", [(4, 4), (5, 3), (1, 6), (2, 1)])
def test_pool_edges_match_pallas(monkeypatch, h, w):
    # Maps where edge and corner pixels, with their 4 or 6 in-bounds taps
    # (1, 2 or 3 on a map one pixel wide), dominate.
    a = _inputs(2, h, w, 8, 16, seed=10 * h + w)
    for dtype in ("float32", "bfloat16"):
        want = _pallas(monkeypatch, a, dtype)
        _held(poolformer_block(*_torch_args(a, getattr(torch, dtype))), want,
              dtype)


@pytest.mark.parametrize("h,w", [(4, 4), (5, 3), (1, 6), (7, 2)])
def test_exclude_pad_pool_matches_jax(h, w):
    x = np.random.default_rng(h + w).normal(size=(2, h, w, 5)).astype(np.float32)
    got = avg_pool_2d_exclude_pad(torch.from_numpy(x), 3)
    _held(got, jax_pool(jnp.asarray(x), 3, stride=1), "float32")
    counts = avg_pool_2d_exclude_pad(torch.ones(1, h, w, 1), 3)
    assert torch.all(counts == 1.0)   # the divisor counts in-bounds taps


def _variant(x, n1w, n1b, ls1, n2w, n2b, w1, b1, w2, b2, ls2, *,
             round_x1=False, erf=False):
    """The plain version with x1 rounded to the dtype, or the erf GELU: what
    the block's eager path computes."""
    dt = x.dtype
    xf = x.float()
    y = _group_norm1(xf, n1w, n1b, 1e-5)
    x1 = xf + (avg_pool_2d_exclude_pad(y, 3) - y) * ls1
    if round_x1:
        x1 = x1.to(dt).float()
    z = _group_norm1(x1, n2w, n2b, 1e-5).to(dt)
    h = z.float() @ w1.to(dt).float().t() + b1
    h = F.gelu(h, approximate="none" if erf else "tanh").to(dt)
    o = h.float() @ w2.to(dt).float().t() + b2
    return (x1 + o * ls2).to(dt)


def test_tanh_gelu_and_f32_x1(monkeypatch):
    # With layer scales near 1 the kernel's two choices show: in f32 the
    # erf GELU misses the 1e-5 bar; in bf16 the plain version rounds like
    # the Pallas kernel almost everywhere, while rounding x1 to bf16 or
    # taking the erf GELU changes a fifth or more of the outputs.
    a = _inputs(2, 6, 5, 16, 64, seed=0)
    want32 = _pallas(monkeypatch, a, "float32")
    args32 = _torch_args(a, torch.float32)
    _held(poolformer_block_reference(*args32), want32, "float32")
    assert np.abs(_variant(*args32, erf=True).numpy() - want32).max() > 1e-4
    want16 = _pallas(monkeypatch, a, "bfloat16")
    args16 = _torch_args(a, torch.bfloat16)

    def differ(t):
        return np.mean(t.float().numpy() != want16)

    assert differ(poolformer_block_reference(*args16)) < 0.01
    assert differ(_variant(*args16, round_x1=True)) > 0.2
    assert differ(_variant(*args16, erf=True)) > 0.1


def _block_pair(seed, c=16, **kw):
    kw = dict(dict(mlp_ratio=4.0, drop_rate=0.0, drop_path_rate=0.0,
                   norm_layer="group_norm_1grp", act_layer="gelu",
                   init_scale=1e-5), **kw)
    jb = JaxBlock(c, **kw)
    params = jb.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    for key in ("layer_scale_1", "layer_scale_2"):
        params[key] = jnp.asarray(1.0 + 0.1 * rng.normal(size=c), jnp.float32)
    for key in ("norm1", "norm2"):
        params[key] = {"scale": jnp.asarray(1.0 + 0.1 * rng.normal(size=c)),
                       "bias": jnp.asarray(0.1 * rng.normal(size=c))}
    tb = PoolFormerBlock(c, **kw)
    tb.load_state_dict(state_dict_from_jax(params))  # strict: names match
    x = rng.normal(size=(2, 9, 7, c)).astype(np.float32)
    return jb, params, tb, x


@pytest.mark.parametrize("switch", ["0", "1"])
def test_block_matches_jax(monkeypatch, switch):
    # Switched on, both packages take their kernel (the JAX package its
    # Pallas kernel in interpret mode), off their eager paths.
    monkeypatch.setenv("TFIMM_TPU_FUSED_POOLFORMER", switch)
    monkeypatch.setenv("TFIMM_TPU_PALLAS_INTERPRET", switch)
    jb, params, tb, x = _block_pair(1)
    with JaxContext(training=False), jax_capture() as jax_seen:
        want = jb(params, jnp.asarray(x))
    with torch.no_grad(), capture_dispatches() as seen:
        got = tb(torch.from_numpy(x))
    expected = {"poolformer_block"} if switch == "1" else set()
    assert seen == expected and jax_seen == expected, (seen, jax_seen)
    _held(got, want, "float32")


def test_gate(monkeypatch):
    _, _, tb, x = _block_pair(2)
    xt = torch.from_numpy(x)
    for switch, training, want in (("0", False, set()), ("1", True, set()),
                                   ("1", False, {"poolformer_block"})):
        monkeypatch.setenv("TFIMM_TPU_FUSED_POOLFORMER", switch)
        with Context(training=training), capture_dispatches() as seen:
            tb(xt)
        assert seen == want, (switch, training)
    # Another norm or activation is not fusable, as in the JAX package.
    monkeypatch.setenv("TFIMM_TPU_FUSED_POOLFORMER", "1")
    for kw in (dict(act_layer="relu"), dict(norm_layer="group_norm", c=32)):
        _, _, other, _ = _block_pair(3, **kw)
        assert not other.fusable
        with capture_dispatches() as seen:
            other(torch.zeros(1, 3, 3, other.norm1.dim))
        assert seen == set()


def test_switch_is_off_by_default(monkeypatch):
    monkeypatch.delenv("TFIMM_TPU_FUSED_POOLFORMER", raising=False)
    _, _, tb, x = _block_pair(4)
    with capture_dispatches() as seen:
        tb(torch.from_numpy(x))
    assert seen == set()
