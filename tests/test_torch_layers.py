"""Port parity, layer by layer: each tfimm_tpu_torch layer against its JAX
counterpart, with the same parameters (JAX tree -> state_dict_from_jax) and
the same numpy inputs. f32 tolerances are 1e-5 (same math, another
summation order); bf16 ones are stated where they appear.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfimm_tpu.core import Context as JaxContext
from tfimm_tpu.ops.attention import MultiHeadAttention as JaxMHA
from tfimm_tpu.ops.basic import Dense as JaxDense
from tfimm_tpu.ops.basic import act_layer_factory as jax_act
from tfimm_tpu.ops.embed import PatchEmbeddings as JaxPatchEmbeddings
from tfimm_tpu.ops.mlp import MLP as JaxMLP
from tfimm_tpu.ops.norm import LayerNorm as JaxLayerNorm
from tfimm_tpu_torch.core import Context
from tfimm_tpu_torch.ops import (
    MLP,
    Dense,
    LayerNorm,
    MultiHeadAttention,
    PatchEmbeddings,
    act_layer_factory,
    norm_layer_factory,
)
from tfimm_tpu_torch.ops.kernels.dispatch import capture_dispatches
from tfimm_tpu_torch.ops.stochastic import drop_path, dropout
from tfimm_tpu_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(1)


def _seeded(params, seed):
    """Replace every leaf with seeded normal values (norm scales near 1)."""
    rng = np.random.default_rng(seed)
    leaves, tree = jax.tree_util.tree_flatten_with_path(params)
    new = []
    for path, leaf in leaves:
        r = rng.normal(size=np.shape(leaf)).astype(np.float32)
        is_scale = getattr(path[-1], "key", None) == "scale"
        new.append(jnp.asarray(1.0 + 0.1 * r if is_scale else 0.1 * r))
    return jax.tree_util.tree_unflatten(tree, new)


def _load(module, params):
    module.load_state_dict(state_dict_from_jax(params))
    return module


def _x(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


def test_layer_norm_one_pass_variance():
    jl = JaxLayerNorm(48, eps=1e-6)
    p = _seeded(jl.init(jax.random.PRNGKey(0)), 1)
    # A common offset, so that the one-pass variance E[x^2] - E[x]^2 differs
    # from the two-pass one; it is small enough that the cancellation costs
    # one digit, and the two summation orders still agree to 1e-5.
    x = _x(2, 3, 5, 48) + 3.0
    tl = _load(norm_layer_factory("layer_norm_eps_1e-6")(48), p)
    _close(tl(torch.from_numpy(x)).detach(), jl(p, jnp.asarray(x)))
    assert isinstance(tl, LayerNorm) and tl.eps == 1e-6
    with pytest.raises(NotImplementedError):
        norm_layer_factory("batch_norm")


def test_gelu_policy(monkeypatch):
    monkeypatch.delenv("TFIMM_TPU_EXACT_GELU", raising=False)
    gelu = act_layer_factory("gelu")
    x = torch.from_numpy(_x(3, 4, 64) * 3.0)
    # f32: exact erf, equal to the JAX package's.
    torch.testing.assert_close(gelu(x), torch.nn.functional.gelu(x))
    _close(gelu(x), jax_act("gelu")(jnp.asarray(x.numpy())))
    # bf16: the tanh form. Against JAX within 1e-2 (one bf16 rounding).
    xb = x.bfloat16()
    torch.testing.assert_close(
        gelu(xb), torch.nn.functional.gelu(xb, approximate="tanh"))
    _close(gelu(xb).float(),
           jax_act("gelu")(jnp.asarray(x.numpy(), jnp.bfloat16)), tol=1e-2)
    # TFIMM_TPU_EXACT_GELU=1 forces erf in bf16 too, in both packages.
    monkeypatch.setenv("TFIMM_TPU_EXACT_GELU", "1")
    torch.testing.assert_close(gelu(xb), torch.nn.functional.gelu(xb))
    _close(gelu(xb).float(),
           jax_act("gelu")(jnp.asarray(x.numpy(), jnp.bfloat16)), tol=1e-2)


@pytest.mark.parametrize("use_bias", [True, False])
def test_dense(use_bias):
    jd = JaxDense(24, 40, use_bias=use_bias)
    p = _seeded(jd.init(jax.random.PRNGKey(0)), 4)
    x = _x(5, 2, 7, 24)
    td = _load(Dense(24, 40, use_bias=use_bias), p)
    _close(td(torch.from_numpy(x)).detach(), jd(p, jnp.asarray(x)))
    # The weight is cast to the input dtype, as in the JAX layer.
    assert td(torch.from_numpy(x).bfloat16()).dtype == torch.bfloat16


def test_mlp():
    jm = JaxMLP(32, 64)
    p = _seeded(jm.init(jax.random.PRNGKey(0)), 6)
    x = _x(7, 2, 9, 32)
    tm = _load(MLP(32, 64), p)
    _close(tm(torch.from_numpy(x)).detach(), jm(p, jnp.asarray(x)))


def test_patch_embeddings_nhwc():
    jp = JaxPatchEmbeddings(16, 32, in_channels=3)
    p = _seeded(jp.init(jax.random.PRNGKey(0)), 8)
    x = _x(9, 2, 48, 64, 3)   # (B, H, W, C), a 3 x 4 grid
    tp = _load(PatchEmbeddings(16, 32, in_channels=3), p)
    got, grid = tp(torch.from_numpy(x))
    want, jgrid = jp(p, jnp.asarray(x))
    assert grid == jgrid == (3, 4)
    _close(got.detach(), want)


def _mha_case():
    jm = JaxMHA(128, 2)
    p = _seeded(jm.init(jax.random.PRNGKey(0)), 10)
    x = _x(11, 2, 17, 128)
    return jm, p, x, _load(MultiHeadAttention(128, 2), p)


def test_mha_fused_path(monkeypatch):
    monkeypatch.setenv("TFIMM_TPU_PALLAS_INTERPRET", "1")
    jm, p, x, tm = _mha_case()
    from tfimm_tpu.ops.pallas.dispatch import capture_dispatches as jax_capture

    with jax_capture() as jax_seen:
        want = jm(p, jnp.asarray(x))
    with capture_dispatches() as seen, torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert any(s.startswith("fused_mha[") for s in jax_seen), jax_seen
    assert seen == {"fused_mha"}
    _close(got, want)


def test_mha_weights_path():
    jm, p, x, tm = _mha_case()
    with JaxContext(capture_features=True) as jctx:
        want = jm(p, jnp.asarray(x), feature_name="attn")
    with Context(capture_features=True) as ctx, capture_dispatches() as seen, \
            torch.no_grad():
        got = tm(torch.from_numpy(x), feature_name="attn")
    assert seen == {"attention[plain]"}
    _close(got, want)
    _close(ctx.features["attn"], jctx.features["attn"])
    assert ctx.features["attn"].shape == (2, 2, 17, 17)


def test_dropout_and_drop_path_take_an_explicit_generator():
    x = torch.ones(64, 3, 8)
    for fn in (dropout, drop_path):
        assert fn(x, 0.5, training=False) is x
        assert fn(x, 0.0, training=True) is x
        with pytest.raises(ValueError, match="generator"):
            fn(x, 0.5, training=True)
        a = fn(x, 0.5, True, torch.Generator().manual_seed(3))
        b = fn(x, 0.5, True, torch.Generator().manual_seed(3))
        torch.testing.assert_close(a, b)
        assert set(a.unique().tolist()) == {0.0, 2.0}   # kept values rescaled
    # drop_path drops whole samples.
    a = drop_path(x, 0.5, True, torch.Generator().manual_seed(4))
    assert all(len(row.unique()) == 1 for row in a)


def test_vit_training_mode_draws_from_the_generator():
    import tfimm_tpu_torch

    model = tfimm_tpu_torch.create_model(
        "vit_tiny_patch16_224", device="cpu", input_size=(32, 32),
        nb_blocks=1, drop_rate=0.1, attn_drop_rate=0.1, drop_path_rate=0.1)
    x = torch.from_numpy(_x(12, 2, 32, 32, 3))
    model.train()
    with capture_dispatches() as seen:
        a = model(x, features_only=True, generator=torch.Generator().manual_seed(0))
    b = model(x, features_only=True, generator=torch.Generator().manual_seed(0))
    # Attention dropout in training takes the plain path (weights explicit).
    assert seen == {"attention[plain]"}
    torch.testing.assert_close(a, b)
    a.sum().backward()
    assert model.blocks[0].attn.qkv.weight.grad is not None
    with pytest.raises(ValueError, match="generator"):
        model(x)
    model.eval()
    torch.testing.assert_close(model(x), model.predict(x))
