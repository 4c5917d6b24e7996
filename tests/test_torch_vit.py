"""Port parity for the slice: tfimm_tpu_torch's ViT/DeiT against the JAX
package and against the independent HuggingFace golden fixture.

The small ViT (64x64 input, patch 16, 2 blocks, D = 128, H = 2, 7 classes)
gets seeded normal parameters in JAX, so that its zero-initialised head is
non-zero, and the port loads them through ``state_dict_from_jax``. Bars: rel
err < 1e-4 in f32 against JAX; < 1e-3 against the golden (the bar of
tests/test_golden_parity.py); < 5e-2 in bf16 (a dozen bf16 roundings per
block, applied in different places by the two frameworks).
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
from tfimm_tpu.ops.pallas.dispatch import capture_dispatches as jax_capture
from tfimm_tpu_torch.ops.kernels.dispatch import capture_dispatches
from tfimm_tpu_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(1)

SMALL = dict(input_size=(64, 64), patch_size=16, embed_dim=128, nb_blocks=2,
             nb_heads=2, nb_classes=7)
GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "golden",
                      "hf_vit.npz")


def _seeded(params, seed):
    rng = np.random.default_rng(seed)
    leaves, tree = jax.tree_util.tree_flatten_with_path(params)
    new = []
    for path, leaf in leaves:
        r = rng.normal(size=np.shape(leaf)).astype(np.float32)
        is_scale = getattr(path[-1], "key", None) == "scale"
        new.append(jnp.asarray(1.0 + 0.1 * r if is_scale else 0.05 * r))
    return jax.tree_util.tree_unflatten(tree, new)


def _pair(name, seed=0, **overrides):
    """The JAX model with seeded parameters and the port with the same."""
    jm = tfimm_tpu.create_model(name, **overrides)
    params = _seeded(jm.params, seed)
    tm = tfimm_tpu_torch.create_model(name, device="cpu", **overrides)
    tm.load_state_dict(state_dict_from_jax(params))  # strict: names match
    x = np.random.default_rng(seed + 1).normal(size=(2, 64, 64, 3))
    return jm, params, tm, x.astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)


def test_small_vit_matches_jax_through_fused_mha(monkeypatch):
    monkeypatch.setenv("TFIMM_TPU_PALLAS_INTERPRET", "1")
    jm, params, tm, x = _pair("vit_base_patch16_224", **SMALL)
    with jax_capture() as jax_seen:
        want = jm.apply(params, jnp.asarray(x))
        want_feats = jm.apply(params, jnp.asarray(x), features_only=True)
    assert any(s.startswith("fused_mha[") for s in jax_seen), jax_seen
    with capture_dispatches() as seen:
        got = tm.predict(torch.from_numpy(x))
        with torch.no_grad():
            got_feats = tm(torch.from_numpy(x), features_only=True)
    assert seen == {"fused_mha"}
    assert np.abs(np.asarray(want)).max() > 0
    assert _rel(got, want) < 1e-4
    assert _rel(got_feats, want_feats) < 1e-4


def test_small_vit_features_match_jax():
    jm, params, tm, x = _pair("vit_base_patch16_224", seed=3, **SMALL)
    _, want = jm.apply(params, jnp.asarray(x), return_features=True)
    with torch.no_grad():
        _, got = tm(torch.from_numpy(x), return_features=True)
    assert list(got) == list(tm.feature_names)
    assert set(want) == set(got)
    for name in tm.feature_names:
        assert _rel(got[name], want[name]) < 1e-4, name


def test_small_vit_bf16_matches_jax(monkeypatch):
    monkeypatch.setenv("TFIMM_TPU_PALLAS_INTERPRET", "1")
    jm, params, tm, x = _pair("vit_base_patch16_224", seed=5, **SMALL)
    jm.params = params
    jm.cast(jnp.bfloat16)
    want = jm.apply(jm.params, jnp.asarray(x, jnp.bfloat16))
    got = tm.to(torch.bfloat16).predict(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    assert _rel(got.float(), want) < 5e-2


def test_distilled_deit_matches_jax():
    jm, params, tm, x = _pair("deit_base_distilled_patch16_224", seed=7,
                              **SMALL)
    want = jm.apply(params, jnp.asarray(x))
    got = tm.predict(torch.from_numpy(x))
    assert got.shape == (2, 2, 7)
    assert _rel(got, want) < 1e-4


def test_representation_layer_matches_jax():
    jm, params, tm, x = _pair("vit_large_patch32_224_in21k", seed=9,
                              **dict(SMALL, patch_size=32,
                                     representation_size=64))
    assert "pre_logits.fc.weight" in tm.state_dict()
    assert _rel(tm.predict(torch.from_numpy(x)),
                jm.apply(params, jnp.asarray(x))) < 1e-4


def test_golden_hf_vit():
    data = np.load(GOLDEN)
    meta = json.loads(bytes(data["meta"]).decode())
    kwargs = {k: tuple(v) if isinstance(v, list) else v
              for k, v in meta["kwargs"].items()}
    sd = {k[len("sd::"):]: torch.from_numpy(data[k]) for k in data.files
          if k.startswith("sd::")}
    model = tfimm_tpu_torch.create_model(meta["model_name"], device="cpu",
                                         **kwargs)
    model.load_state_dict(sd)
    out = model.predict(torch.from_numpy(data["input"]))
    assert _rel(out, data["output"]) < 1e-3


def test_registry_matches_jax():
    # Every variant of the JAX package's vit module; the vit_hybrid module's
    # variants (also named vit_*) wait for the vit_hybrid port.
    for pattern in ("vit_*", "deit_*"):
        assert (tfimm_tpu_torch.list_models(pattern)
                == tfimm_tpu.list_models(pattern, module="vit")), pattern
    assert len(tfimm_tpu_torch.list_models()) == 36


def test_factory_checks():
    with pytest.raises(ValueError, match="no field"):
        tfimm_tpu_torch.create_model("vit_tiny_patch16_224", device="cpu",
                                     not_a_field=1)
    with pytest.raises(ValueError, match="Unknown model"):
        tfimm_tpu_torch.create_model("no_such_model", device="cpu")
    with pytest.raises(NotImplementedError):
        tfimm_tpu_torch.create_model("vit_tiny_patch16_224", device="cpu",
                                     pretrained=True)
    a = tfimm_tpu_torch.create_model("vit_tiny_patch16_224", device="cpu",
                                     seed=1, nb_blocks=1)
    b = tfimm_tpu_torch.create_model("vit_tiny_patch16_224", device="cpu",
                                     seed=1, nb_blocks=1)
    assert all(torch.equal(a.state_dict()[k], v)
               for k, v in b.state_dict().items())


def test_preprocessing_matches_jax():
    img = np.random.default_rng(11).integers(0, 256, (2, 8, 8, 5), np.uint8)
    for name in ("vit_base_patch16_224", "deit_base_patch16_224"):
        got = tfimm_tpu_torch.create_preprocessing(
            name, in_channels=5, device="cpu")(torch.from_numpy(img))
        want = tfimm_tpu.create_preprocessing(name, in_channels=5)(img)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
