"""Port parity: tfimm_tpu_torch's window_mha and swin_block (their plain
versions, on the CPU) against the JAX package's Pallas kernels in interpret
mode and against the kernels' XLA twin ``_reference_window_mha``.

Inputs are made with numpy from a seed and handed to both packages. The
relative-position bias has std 0.3 (a trunc-normal(0.02) table would hide a
version that drops it) and the shift mask is the model's own -100 mask.
Bars: window_mha 1e-5 relative in f32 and 2e-2 of max|ref| in bf16 (the
Pallas kernel rounds p to bf16 as the port does; its XLA twin keeps p in
f32); swin_block 1e-4 in f32 (four products and two LayerNorms summed in
another order) and 2e-2 in bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfimm_tpu.architectures.swin import (
    SwinTransformerBlock as JaxSwinBlock,
    SwinTransformerConfig as JaxSwinConfig,
    _attention_mask as jax_attention_mask,
    window_partition as jax_window_partition,
)
from tfimm_tpu.ops.pallas.swin_block import _prep_params, swin_block_fused
from tfimm_tpu.ops.pallas.window_mha import _reference_window_mha
from tfimm_tpu.ops.pallas.window_mha import window_mha as jax_window_mha
from tfimm_tpu_torch.architectures.swin import _attention_mask
from tfimm_tpu_torch.ops.kernels import dispatch
from tfimm_tpu_torch.ops.kernels.swin_block import (
    SwinBlockParams,
    swin_block,
    swin_block_reference,
)
from tfimm_tpu_torch.ops.kernels.window_mha import (
    window_mha,
    window_mha_reference,
)

torch.set_num_threads(1)

_BARS = {"float32": 1e-5, "bfloat16": 2e-2}


def _rel(got, want):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _window_inputs(bw, n, c, h, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(bw, n, c)).astype(np.float32)
               for _ in range(3))
    bias = (0.3 * rng.normal(size=(h, n, n))).astype(np.float32)
    return q, k, v, bias


def test_attention_mask_matches_jax():
    for size, ws, shift in (((14, 14), 7, 3), ((56, 56), 7, 3),
                            ((8, 8), 4, 2), ((24, 12), 12, 6)):
        want = jax_attention_mask(size, ws, shift)
        np.testing.assert_array_equal(_attention_mask(size, ws, shift), want)
        assert set(np.unique(want)) == {0.0, -100.0}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("h,d", [(3, 32), (4, 16)])
def test_window_mha_matches_the_pallas_kernel(dtype, masked, h, d):
    bw, n, c = 8, 49, h * d
    q, k, v, bias = _window_inputs(bw, n, c, h, seed=h * d + masked)
    mask = jax_attention_mask((14, 14), 7, 3) if masked else None  # 4 windows
    scale = d ** -0.5
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    jmask = None if mask is None else jnp.asarray(mask)
    kernel = jax_window_mha(jq, jk, jv, jnp.asarray(bias), jmask, nb_heads=h,
                            scale=scale, interpret=True)
    twin = _reference_window_mha(jq, jk, jv, jnp.asarray(bias), jmask, h, scale)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    got = window_mha_reference(tq, tk, tv, torch.from_numpy(bias),
                               None if mask is None else torch.from_numpy(mask),
                               nb_heads=h, scale=scale)
    assert got.dtype == tdt
    assert _rel(got, kernel.astype(jnp.float32)) < _BARS[dtype]
    assert _rel(got, twin.astype(jnp.float32)) < _BARS[dtype]


def test_window_mha_on_cpu_runs_the_plain_version_through_strides():
    bw, n, c, h = 8, 49, 96, 3
    q, k, v, bias = _window_inputs(bw, n, c, h, seed=5)
    qkv = torch.from_numpy(np.concatenate([q, k, v], axis=-1))
    mask = torch.from_numpy(_attention_mask((14, 14), 7, 3))
    before = dict(dispatch.launch_counts)
    got = window_mha(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:],
                     torch.from_numpy(bias), mask, nb_heads=h, scale=0.2)
    assert dispatch.launch_counts == before  # CPU: no kernel launch
    want = window_mha_reference(*(torch.from_numpy(a) for a in (q, k, v)),
                                torch.from_numpy(bias), mask, nb_heads=h,
                                scale=0.2)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_window_mha_mask_and_bias_both_count():
    # The controls of the card check: leaving out the mask or the bias moves
    # the output far beyond the bar.
    bw, n, c, h = 8, 49, 96, 3
    q, k, v, bias = (torch.from_numpy(a) for a in _window_inputs(bw, n, c, h, 6))
    mask = torch.from_numpy(_attention_mask((14, 14), 7, 3))
    want = window_mha_reference(q, k, v, bias, mask, nb_heads=h, scale=0.2)
    no_mask = window_mha_reference(q, k, v, bias, None, nb_heads=h, scale=0.2)
    no_bias = window_mha_reference(q, k, v, 0 * bias, mask, nb_heads=h,
                                   scale=0.2)
    assert _rel(no_mask, want) > 10 * _BARS["bfloat16"]
    assert _rel(no_bias, want) > 5 * _BARS["bfloat16"]


def _jax_block(shift, c, heads, seed):
    """A JAX Swin block on a 14x14 map with seeded parameters: LN scales
    near 1, the bias table at std 0.3, the rest at std 0.05."""
    cfg = JaxSwinConfig(name="t", window_size=7)
    blk = JaxSwinBlock(cfg, input_size=(14, 14), embed_dim=c, nb_heads=heads,
                       drop_path_rate=0.0, shift_size=shift)
    rng = np.random.default_rng(seed)
    leaves, tree = jax.tree_util.tree_flatten_with_path(
        blk.init(jax.random.PRNGKey(0)))
    new = []
    for path, leaf in leaves:
        r = rng.normal(size=np.shape(leaf)).astype(np.float32)
        key = getattr(path[-1], "key", None)
        scale = {"scale": 0.1, "relative_position_bias_table": 0.3}.get(key, 0.05)
        new.append(jnp.asarray((1.0 if key == "scale" else 0.0) + scale * r))
    return blk, jax.tree_util.tree_unflatten(tree, new)


def _port_params(p):
    """The JAX block's parameters as SwinBlockParams (Dense layout)."""
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    return SwinBlockParams(
        t(p["norm1"]["scale"]), t(p["norm1"]["bias"]),
        t(p["attn"]["qkv"]["kernel"]).t(), t(p["attn"]["qkv"]["bias"]),
        t(p["attn"]["proj"]["kernel"]).t(), t(p["attn"]["proj"]["bias"]),
        t(p["norm2"]["scale"]), t(p["norm2"]["bias"]),
        t(p["mlp"]["fc1"]["kernel"]).t(), t(p["mlp"]["fc1"]["bias"]),
        t(p["mlp"]["fc2"]["kernel"]).t(), t(p["mlp"]["fc2"]["bias"]))


@pytest.mark.parametrize("dtype,bar", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("shift,c,heads", [(3, 96, 3), (0, 192, 6)])
def test_swin_block_matches_the_pallas_kernel(shift, c, heads, dtype, bar):
    blk, p = _jax_block(shift, c, heads, seed=c + shift)
    ss = blk.shift_size
    x = np.random.default_rng(2).normal(size=(2, 14, 14, c)).astype(np.float32)
    if ss:
        x = np.roll(x, (-ss, -ss), axis=(1, 2))
    wins = np.array(jax_window_partition(jnp.asarray(x), 7)).reshape(-1, 49, c)
    bias = np.array(blk._rel_bias(p))
    mask = None if blk.attn_mask is None else np.array(blk.attn_mask)
    scale = (c // heads) ** -0.5
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = swin_block_fused(jnp.asarray(wins, jdt), _prep_params(p, c, jdt),
                            jnp.asarray(bias),
                            None if mask is None else jnp.asarray(mask),
                            nb_heads=heads, scale=scale, interpret=True)
    got = swin_block_reference(torch.from_numpy(wins).to(tdt), _port_params(p),
                               torch.from_numpy(bias),
                               None if mask is None else torch.from_numpy(mask),
                               nb_heads=heads, scale=scale)
    assert got.dtype == tdt
    assert _rel(got, want.astype(jnp.float32)) < bar


def test_swin_block_on_cpu_runs_the_plain_version():
    blk, p = _jax_block(3, 96, 3, seed=4)
    params = _port_params(p)
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(8, 49, 96)).astype(np.float32))
    bias = torch.from_numpy(np.array(blk._rel_bias(p)))
    mask = torch.from_numpy(np.array(blk.attn_mask))
    before = dict(dispatch.launch_counts)
    got = swin_block(x, params, bias, mask, nb_heads=3, scale=32 ** -0.5)
    assert dispatch.launch_counts == before
    want = swin_block_reference(x, params, bias, mask, nb_heads=3,
                                scale=32 ** -0.5)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_swin_block_gelu_follows_the_kernel_dtype_policy(monkeypatch):
    # The fused function takes the tanh GELU in bf16 and erf in f32 whatever
    # TFIMM_TPU_EXACT_GELU says, as the Pallas kernel does.
    blk, p = _jax_block(0, 96, 3, seed=8)
    params = _port_params(p)
    x = torch.from_numpy(np.random.default_rng(9).normal(
        size=(4, 49, 96)).astype(np.float32)).bfloat16()
    bias = torch.from_numpy(np.array(blk._rel_bias(p)))
    before = swin_block_reference(x, params, bias, nb_heads=3, scale=0.2)
    monkeypatch.setenv("TFIMM_TPU_EXACT_GELU", "1")
    after = swin_block_reference(x, params, bias, nb_heads=3, scale=0.2)
    torch.testing.assert_close(before, after, rtol=0, atol=0)
