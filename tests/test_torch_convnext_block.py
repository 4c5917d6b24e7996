"""Port parity: tfimm_tpu_torch's convnext_block (its plain version, on the
CPU) against the JAX package's Pallas ConvNeXt block in interpret mode, and
the port's gate (``ConvNeXtBlock.fused_kernel_ok``) against the JAX gate
(``ConvNeXtBlock._use_fused_kernel``).

Inputs are made with numpy from a seed and handed to both packages, with
the layer scale gamma and the LN weight near 1: at gamma's init of 1e-6 the
block's output would be x to bf16 precision and no comparison would see its
work. The Pallas kernel takes the depthwise kernel as (7, 7, 1, C) and the
dense kernels as (C, hidden) and (hidden, C); the port takes (C, 1, 7, 7)
and the Dense layout. Bars: max|diff| / max|ref| < 1e-5 in f32 and
<= 2e-2 in bf16.

The JAX gate tests ``jax.default_backend() != "tpu"`` itself and ignores
``TFIMM_TPU_PALLAS_INTERPRET``, so on the CPU it never takes the kernel.
The tests that run the JAX block through it report the TPU backend
(``jax.default_backend`` patched for the test) and run the Pallas kernel in
interpret mode (``fused_convnext_block`` patched to a counted
``interpret=True`` call; the block imports it at call time).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import tfimm_tpu.ops.pallas.convnext_block as jax_convnext_block
from tfimm_tpu.architectures.convnext import ConvNeXtBlock as JaxBlock
from tfimm_tpu.core import Context as JaxContext
from tfimm_tpu_torch.architectures.convnext import ConvNeXtBlock
from tfimm_tpu_torch.core import Context
from tfimm_tpu_torch.ops.kernels import dispatch
from tfimm_tpu_torch.ops.kernels.convnext_block import (
    convnext_block,
    convnext_block_reference,
)
from tfimm_tpu_torch.ops.kernels.convnext_mlp import convnext_mlp_reference
from tfimm_tpu_torch.ops.kernels.dispatch import capture_dispatches
from tfimm_tpu_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(1)

_ORDER = ("x", "dw", "dw_b", "ln_w", "ln_b", "w1", "b1", "w2", "b2", "gamma")


def _inputs(b, h, w, c, hidden, seed):
    """The block's input and parameters as f32 numpy arrays, in the JAX
    layouts: LN weight and gamma near 1, the taps of a unit-size output,
    the MLP scaled to unit-size products."""
    rng = np.random.default_rng(seed)

    def rnd(*shape, scale=1.0, shift=0.0):
        return (rng.normal(size=shape) * scale + shift).astype(np.float32)

    return dict(x=rnd(b, h, w, c), dw=rnd(7, 7, 1, c, scale=0.2),
                dw_b=rnd(c, scale=0.1), ln_w=rnd(c, scale=0.1, shift=1.0),
                ln_b=rnd(c, scale=0.1), w1=rnd(c, hidden, scale=c ** -0.5),
                b1=rnd(hidden, scale=0.1),
                w2=rnd(hidden, c, scale=hidden ** -0.5), b2=rnd(c, scale=0.1),
                gamma=rnd(c, scale=0.1, shift=1.0))


def _pallas(a, dtype):
    dt = getattr(jnp, dtype)
    out = jax_convnext_block.fused_convnext_block(
        *(jnp.asarray(a[k], dt) for k in _ORDER), eps=1e-6, interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _torch_args(a, dtype):
    """The same values in the port's layouts, every tensor in ``dtype`` (a
    model cast to bf16 holds its parameters in bf16)."""
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    t["dw"] = torch.from_numpy(a["dw"].transpose(3, 2, 0, 1).copy())
    t["w1"] = torch.from_numpy(a["w1"].T.copy())
    t["w2"] = torch.from_numpy(a["w2"].T.copy())
    return tuple(t[k].to(dtype) for k in _ORDER)


def _rel(got, want):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


_BARS = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,w,c,hidden", [(2, 8, 10, 16, 64),
                                            (1, 7, 7, 32, 128),
                                            (2, 9, 13, 24, 96)])
def test_matches_pallas_kernel_in_interpret_mode(b, h, w, c, hidden, dtype):
    # 9 x 13 is ragged: taps fall off every edge at another offset.
    a = _inputs(b, h, w, c, hidden, seed=h * w + c)
    want = _pallas(a, dtype)
    before = dict(dispatch.launch_counts)
    got = convnext_block(*_torch_args(a, getattr(torch, dtype)))
    assert dispatch.launch_counts == before   # no kernel on the CPU
    assert got.dtype == getattr(torch, dtype)
    assert _rel(got, want) < _BARS[dtype]


def _default_path(x, dw, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma):
    """The default ConvNeXt path's function: the conv's output rounded to
    the dtype, then convnext_mlp's plain version."""
    c = x.shape[-1]
    d = F.conv2d(x.permute(0, 3, 1, 2), dw, dw_b, padding=3, groups=c)
    d = d.permute(0, 2, 3, 1)
    out = convnext_mlp_reference(d.reshape(-1, c), x.reshape(-1, c), ln_w,
                                 ln_b, w1, b1, w2, b2, gamma, 1e-6)
    return out.reshape(x.shape)


def test_plain_version_is_not_the_default_path_in_bf16():
    # The fused function keeps the conv's output in f32 into the LayerNorm;
    # the default path rounds it to bf16 first. The plain version rounds as
    # the Pallas kernel does almost everywhere; the default path's function
    # moves a third or more of the outputs.
    a = _inputs(2, 8, 10, 16, 64, seed=1)
    want = _pallas(a, "bfloat16")
    args = _torch_args(a, torch.bfloat16)

    def differ(t):
        return np.mean(t.float().numpy() != want)

    assert differ(convnext_block_reference(*args)) < 0.01
    assert differ(_default_path(*args)) > 0.3


def test_repeats_and_takes_a_strided_weight():
    a = _inputs(1, 5, 6, 8, 32, seed=2)
    args = _torch_args(a, torch.float32)
    first = convnext_block(*args)
    assert torch.equal(first, convnext_block(*args))
    # The port's (C, 1, 7, 7) weight is read by value, not by layout.
    dw = args[1].permute(2, 3, 1, 0).contiguous().permute(3, 2, 0, 1)
    assert not dw.is_contiguous()
    assert torch.equal(first, convnext_block(args[0], dw, *args[2:]))


def _block_pair(seed, c=16, dtype="float32", **kw):
    """The JAX block with seeded parameters (gamma and the LN weight near
    1), the port's block with the same, and a seeded (2, 9, 7, C) input."""
    kw = dict(dict(mlp_ratio=4.0, conv_mlp_block=False, drop_rate=0.0,
                   drop_path_rate=0.0, norm_layer="layer_norm_eps_1e-6",
                   act_layer="gelu", init_scale=1e-6), **kw)
    jb = JaxBlock(c, **kw)
    params = jb.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    params["gamma"] = jnp.asarray(1.0 + 0.1 * rng.normal(size=c), jnp.float32)
    params["norm"] = {"scale": jnp.asarray(1.0 + 0.1 * rng.normal(size=c)),
                      "bias": jnp.asarray(0.1 * rng.normal(size=c))}
    params["conv_dw"]["kernel"] = jnp.asarray(
        0.2 * rng.normal(size=(7, 7, 1, c)), jnp.float32)
    params = jax.tree_util.tree_map(lambda p: p.astype(getattr(jnp, dtype)),
                                    params)
    tb = ConvNeXtBlock(c, **kw)
    tb.load_state_dict(state_dict_from_jax(params))   # strict: names match
    tb = tb.to(getattr(torch, dtype))
    x = rng.normal(size=(2, 9, 7, c)).astype(np.float32)
    return jb, params, tb, x


@pytest.fixture
def jax_on_tpu(monkeypatch):
    """Open the JAX gate on the CPU: the TPU backend reported for this test
    only, the Pallas kernel run in interpret mode. Returns the list of its
    calls."""
    calls = []
    orig = jax_convnext_block.fused_convnext_block

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return functools.partial(orig, interpret=True)(*args, **kwargs)

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setenv("TFIMM_TPU_PALLAS_INTERPRET", "1")   # any other kernel
    monkeypatch.setattr(jax_convnext_block, "fused_convnext_block", counted)
    return calls


@pytest.mark.parametrize("switch", ["0", "1"])
def test_block_matches_jax_block_in_bf16(monkeypatch, jax_on_tpu, switch):
    # Switched on, both packages take the fused block (the JAX package its
    # Pallas kernel in interpret mode, the port its plain version); off,
    # the JAX package its XLA composition and the port convnext_mlp.
    monkeypatch.setenv("TFIMM_TPU_FUSED_CONVNEXT", switch)
    jb, params, tb, x = _block_pair(1, dtype="bfloat16")
    with JaxContext(training=False):
        want = jb(params, jnp.asarray(x, jnp.bfloat16))
    with torch.no_grad(), capture_dispatches() as seen:
        got = tb(torch.from_numpy(x).bfloat16())
    assert len(jax_on_tpu) == (1 if switch == "1" else 0)
    assert seen == ({"convnext_block"} if switch == "1" else {"convnext_mlp"})
    assert _rel(got, want) < (2e-2 if switch == "1" else 5e-2)


def _jax_gate(jb, x, training):
    with JaxContext(training=training):
        return bool(jb._use_fused_kernel(x))


def _port_gate(tb, x, training):
    with Context(training=training), torch.no_grad():
        return tb.fused_kernel_ok(x)


_GATE_CASES = {
    "on": ({}, {}, "bfloat16", False, True),
    "switch off": ({"TFIMM_TPU_FUSED_CONVNEXT": "0"}, {}, "bfloat16", False,
                   False),
    "switch unset": ({"TFIMM_TPU_FUSED_CONVNEXT": None}, {}, "bfloat16",
                     False, False),
    "exact gelu": ({"TFIMM_TPU_EXACT_GELU": "1"}, {}, "bfloat16", False,
                   False),
    "training": ({}, {}, "bfloat16", True, False),
    "conv mlp": ({}, {"conv_mlp_block": True}, "bfloat16", False, False),
    "dropout": ({}, {"drop_rate": 0.1}, "bfloat16", False, False),
    "f32": ({}, {}, "float32", False, False),
}


@pytest.mark.parametrize("case", sorted(_GATE_CASES))
def test_gate_matches_jax(monkeypatch, jax_on_tpu, case):
    env, kw, dtype, training, want = _GATE_CASES[case]
    monkeypatch.setenv("TFIMM_TPU_FUSED_CONVNEXT", "1")
    monkeypatch.delenv("TFIMM_TPU_EXACT_GELU", raising=False)
    for name, value in env.items():
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    jb, _, tb, x = _block_pair(2, **kw)
    jx = jnp.zeros(x.shape, getattr(jnp, dtype))
    tx = torch.zeros(x.shape, dtype=getattr(torch, dtype))
    assert _jax_gate(jb, jx, training) is want
    assert _port_gate(tb, tx, training) is want


def test_gate_departures(monkeypatch, jax_on_tpu):
    # Where the port declines and the JAX gate takes: f16 (the port has no
    # f16 kernel). Where the port takes and the JAX gate declines: over the
    # TPU's VMEM estimate (12 MiB; a 64 x 64 x 256 map with hidden 1024 is
    # 16.1 MB), which is TPU layout. Under autograd the port declines (no
    # backward), where the JAX gate has no such test.
    monkeypatch.setenv("TFIMM_TPU_FUSED_CONVNEXT", "1")
    monkeypatch.delenv("TFIMM_TPU_EXACT_GELU", raising=False)
    jb, _, tb, x = _block_pair(3)
    assert _jax_gate(jb, jnp.zeros(x.shape, jnp.float16), False)
    assert not _port_gate(tb, torch.zeros(x.shape, dtype=torch.float16), False)
    wide_jax, _, wide, _ = _block_pair(4, c=256)
    big = (1, 64, 64, 256)
    assert not _jax_gate(wide_jax, jnp.zeros(big, jnp.bfloat16), False)
    assert _port_gate(wide, torch.zeros(big, dtype=torch.bfloat16), False)
    xb = torch.zeros(x.shape, dtype=torch.bfloat16)
    assert tb.fused_kernel_ok(xb) is False          # parameters record
    tb.requires_grad_(False)
    assert tb.fused_kernel_ok(xb) is True
    assert tb.fused_kernel_ok(xb.clone().requires_grad_()) is False


def test_switch_is_off_by_default(monkeypatch):
    monkeypatch.delenv("TFIMM_TPU_FUSED_CONVNEXT", raising=False)
    _, _, tb, x = _block_pair(5, dtype="bfloat16")
    with torch.no_grad(), capture_dispatches() as seen:
        tb(torch.from_numpy(x).bfloat16())
    assert seen == {"convnext_mlp"}
