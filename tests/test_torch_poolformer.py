"""Port parity for PoolFormer: tfimm_tpu_torch's model against the JAX
package and against the independent golden fixture (sail-sg/poolformer),
and the GroupNorm it adds.

The small PoolFormer (widths (32, 64), blocks (2, 1), 64x64 input, 7
classes) gets seeded normal parameters with the layer scales and the norm
scales near 1: at the init scale of 1e-5 every block would be its input to
bf16 precision and any block would pass. The port loads them through
``state_dict_from_jax``. Bars: rel err < 1e-3 in f32 (the reference's own,
tests/test_golden_parity.py), with the block switch on (both packages
through their kernels: the JAX package its Pallas kernel in interpret mode)
and off; < 5e-2 in bf16.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfimm_tpu
import tfimm_tpu_torch
from tfimm_tpu.ops.norm import GroupNorm as JaxGroupNorm
from tfimm_tpu.ops.pallas.dispatch import capture_dispatches as jax_capture
from tfimm_tpu_torch.ops.kernels import dispatch
from tfimm_tpu_torch.ops.kernels.dispatch import capture_dispatches
from tfimm_tpu_torch.ops.norm import GroupNorm, norm_layer_factory
from tfimm_tpu_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(1)

NAME = "poolformer_s12"
SMALL = dict(input_size=(64, 64), embed_dim=(32, 64), nb_blocks=(2, 1),
             mlp_ratio=(4.0, 4.0), nb_classes=7)
GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "golden",
                      "poolformer.npz")


def _seeded(params, seed):
    rng = np.random.default_rng(seed)
    leaves, tree = jax.tree_util.tree_flatten_with_path(params)
    new = []
    for path, leaf in leaves:
        r = rng.normal(size=np.shape(leaf)).astype(np.float32)
        key = getattr(path[-1], "key", None)
        near_one = key == "scale" or key.startswith("layer_scale")
        new.append(jnp.asarray(1.0 + 0.1 * r if near_one else 0.1 * r))
    return jax.tree_util.tree_unflatten(tree, new)


def _pair(seed=0):
    jm = tfimm_tpu.create_model(NAME, **SMALL)
    params = _seeded(jm.params, seed)
    tm = tfimm_tpu_torch.create_model(NAME, device="cpu", **SMALL)
    tm.load_state_dict(state_dict_from_jax(params))  # strict: names match
    x = np.random.default_rng(seed + 1).normal(size=(2, 64, 64, 3))
    return jm, params, tm, x.astype(np.float32)


def _rel(got, want):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)


@pytest.mark.parametrize("switch", ["0", "1"])
def test_small_poolformer_matches_jax(monkeypatch, switch):
    monkeypatch.setenv("TFIMM_TPU_FUSED_POOLFORMER", switch)
    monkeypatch.setenv("TFIMM_TPU_PALLAS_INTERPRET", switch)
    jm, params, tm, x = _pair(seed=3)
    with jax_capture() as jax_seen:
        want, want_feats = jm.apply(params, jnp.asarray(x),
                                    return_features=True)
    expected = {"poolformer_block"} if switch == "1" else set()
    assert jax_seen == expected
    before = dispatch.launch_counts["poolformer_block"]
    with torch.inference_mode(), capture_dispatches() as seen:
        got, got_feats = tm(torch.from_numpy(x), return_features=True)
    assert seen == expected
    assert dispatch.launch_counts["poolformer_block"] == before  # CPU: plain
    assert list(got_feats) == list(tm.feature_names) == list(jm.feature_names)
    assert np.abs(np.asarray(want)).max() > 0
    assert _rel(got, want) < 1e-3
    for name in tm.feature_names:
        assert _rel(got_feats[name], want_feats[name]) < 1e-3, name


@pytest.mark.parametrize("switch", ["0", "1"])
def test_small_poolformer_bf16_matches_jax(monkeypatch, switch):
    monkeypatch.setenv("TFIMM_TPU_FUSED_POOLFORMER", switch)
    monkeypatch.setenv("TFIMM_TPU_PALLAS_INTERPRET", switch)
    jm, params, tm, x = _pair(seed=5)
    jm.params = params
    jm.cast(jnp.bfloat16)
    want = jm.apply(jm.params, jnp.asarray(x, jnp.bfloat16))
    got = tm.to(torch.bfloat16).predict(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    assert _rel(got, want) < 5e-2


def test_gradients_match_jax(monkeypatch):
    # In training every block runs its eager path (the kernel has no
    # backward), as the JAX package's gate declines in training.
    monkeypatch.setenv("TFIMM_TPU_FUSED_POOLFORMER", "1")
    jm, params, tm, x = _pair(seed=7)
    w = np.random.default_rng(8).normal(size=(2, 7)).astype(np.float32)

    def loss(p):
        return jnp.sum(jm.apply(p, jnp.asarray(x), training=True) * w)

    want = state_dict_from_jax(jax.grad(loss)(params))
    tm.train()
    with capture_dispatches() as seen:
        (tm(torch.from_numpy(x)) * torch.from_numpy(w)).sum().backward()
    assert seen == set()
    largest = max(float(g.abs().max()) for g in want.values())
    for name, p in tm.named_parameters():
        if name.endswith("norm1.bias"):
            # pool(y) - y does not see a shift of y: the true gradient of
            # norm1's bias is 0, and both packages give rounding noise.
            assert float(p.grad.abs().max()) < 1e-6 * largest, name
        else:
            assert _rel(p.grad, want[name].numpy()) < 1e-3, name


@pytest.mark.parametrize("switch", ["0", "1"])
def test_golden_poolformer(monkeypatch, switch):
    monkeypatch.setenv("TFIMM_TPU_FUSED_POOLFORMER", switch)
    data = np.load(GOLDEN)
    meta = json.loads(bytes(data["meta"]).decode())
    kwargs = {k: tuple(v) if isinstance(v, list) else v
              for k, v in meta["kwargs"].items()}
    sd = {k[len("sd::"):]: torch.from_numpy(data[k]) for k in data.files
          if k.startswith("sd::")}
    model = tfimm_tpu_torch.create_model(meta["model_name"], device="cpu",
                                         **kwargs)
    model.load_state_dict(sd)   # strict: the checkpoints' names as they are
    with capture_dispatches() as seen:
        out = model.predict(torch.from_numpy(data["input"]))
    assert seen == ({"poolformer_block"} if switch == "1" else set())
    assert _rel(out, data["output"]) < 1e-3


def test_registry_matches_jax(monkeypatch):
    monkeypatch.setenv("TFIMM_TPU_FUSED_POOLFORMER", "1")
    # The JAX suite registers test variants of its own; compare the
    # family's module.
    names = tfimm_tpu_torch.list_models(module="poolformer")
    assert names == tfimm_tpu.list_models(module="poolformer")
    assert len(names) == 5
    for name in names:
        want = tfimm_tpu.model_config(name)
        got = tfimm_tpu_torch.model_config(name)
        assert {f: getattr(got, f) for f in vars(want)} == vars(want), name
        # Every registered variant at its full widths, one block a stage, on
        # a 64x64 image: every block takes the kernel.
        model = tfimm_tpu_torch.create_model(
            name, device="cpu", input_size=(64, 64), nb_blocks=(1, 1, 1, 1))
        assert torch.all(model.network[0][0].layer_scale_1 == want.init_scale)
        with capture_dispatches() as seen:
            out = model.predict(torch.zeros(1, 64, 64, 3))
        assert out.shape == (1, 1000) and seen == {"poolformer_block"}


def test_state_dict_keys_follow_the_checkpoints():
    tm = tfimm_tpu_torch.create_model(NAME, device="cpu", **SMALL)
    sd = tm.state_dict()
    for key in ("patch_embed.proj.weight", "network.0.1.layer_scale_2",
                "network.0.0.mlp.fc1.weight", "network.1.proj.bias",
                "network.2.0.norm2.weight", "norm.weight", "head.weight"):
        assert key in sd, key
    assert tuple(sd["network.0.0.mlp.fc1.weight"].shape) == (128, 32, 1, 1)


@pytest.mark.parametrize("factory,groups", [("group_norm", 32),
                                            ("group_norm_1grp", 1)])
def test_group_norm_matches_jax(factory, groups):
    rng = np.random.default_rng(groups)
    x = (3.0 + 2.0 * rng.normal(size=(2, 5, 7, 64))).astype(np.float32)
    jl = JaxGroupNorm(64, nb_groups=groups)
    p = {"scale": jnp.asarray(1.0 + 0.1 * rng.normal(size=64)),
         "bias": jnp.asarray(0.1 * rng.normal(size=64))}
    tl = norm_layer_factory(factory)(64)
    assert isinstance(tl, GroupNorm) and tl.nb_groups == groups
    tl.load_state_dict(state_dict_from_jax(p))
    for dtype, bar in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        got = tl(torch.from_numpy(x).to(dtype)).detach()
        want = jl(p, jnp.asarray(x, getattr(jnp, str(dtype)[6:])))
        assert got.dtype == dtype
        assert _rel(got, want) < bar
