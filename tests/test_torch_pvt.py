"""Port parity for PVT and PVTv2: tfimm_tpu_torch's models against the JAX
package and against the independent golden fixtures (whai362/PVT), and the
layers they add: PatchEmbeddings with stride and padding, the adaptive
average pool and the ``linear`` activation.

The small models keep every stage's structure (one head at stage 1, where
``pvt_sra`` applies, the spatial reduction, PVT's class token in stage 4)
at narrow widths and 1-2 blocks a stage. Their parameters are seeded
normals, the norm scales near 1; the port loads them through
``state_dict_from_jax``. Bars: rel err < 1e-3 in f32 (the reference's own,
tests/test_golden_parity.py), with the SRA switch on (both packages through
their kernels: the JAX package its Pallas kernel in interpret mode) and off;
< 5e-2 in bf16.
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
from tfimm_tpu.ops.embed import PatchEmbeddings as JaxPatchEmbeddings
from tfimm_tpu.ops.norm import LayerNorm as JaxLayerNorm
from tfimm_tpu.ops.pallas.dispatch import capture_dispatches as jax_capture
from tfimm_tpu.ops.pool import adaptive_avg_pool_2d as jax_adaptive_pool
from tfimm_tpu_torch.ops.basic import act_layer_factory
from tfimm_tpu_torch.ops.embed import PatchEmbeddings
from tfimm_tpu_torch.ops.kernels import dispatch
from tfimm_tpu_torch.ops.kernels.dispatch import capture_dispatches
from tfimm_tpu_torch.ops.pool import adaptive_avg_pool_2d
from tfimm_tpu_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "fixtures", "golden")
SMALL = {
    "pvt": ("pvt_tiny", dict(input_size=(64, 64), embed_dim=(16, 32, 48, 64),
                             nb_heads=(1, 2, 3, 4), mlp_ratio=(2.0,) * 4,
                             nb_blocks=(2, 1, 1, 1), nb_classes=7)),
    "pvt_v2": ("pvt_v2_b0", dict(input_size=(64, 64), embed_dim=(16, 32),
                                 nb_heads=(1, 2), mlp_ratio=(4.0, 2.0),
                                 nb_blocks=(2, 1), sr_ratio=(4, 2),
                                 nb_classes=7)),
    "pvt_v2_linear": ("pvt_v2_b2_linear", dict(
        input_size=(64, 64), embed_dim=(16, 32), nb_heads=(1, 2),
        mlp_ratio=(4.0, 2.0), nb_blocks=(2, 1), sr_ratio=(4, 2),
        nb_classes=7)),
}


def _seeded(params, seed):
    rng = np.random.default_rng(seed)
    leaves, tree = jax.tree_util.tree_flatten_with_path(params)
    new = []
    for path, leaf in leaves:
        r = rng.normal(size=np.shape(leaf)).astype(np.float32)
        near_one = getattr(path[-1], "key", None) == "scale"
        new.append(jnp.asarray(1.0 + 0.1 * r if near_one else 0.1 * r))
    return jax.tree_util.tree_unflatten(tree, new)


def _pair(family, seed=0):
    name, cfg = SMALL[family]
    jm = tfimm_tpu.create_model(name, **cfg)
    params = _seeded(jm.params, seed)
    tm = tfimm_tpu_torch.create_model(name, device="cpu", **cfg)
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
@pytest.mark.parametrize("family", sorted(SMALL))
def test_small_model_matches_jax(monkeypatch, family, switch):
    monkeypatch.setenv("TFIMM_TPU_FUSED_PVT_SRA", switch)
    monkeypatch.setenv("TFIMM_TPU_PALLAS_INTERPRET", switch)
    jm, params, tm, x = _pair(family, seed=3)
    with jax_capture() as jax_seen:
        want, want_feats = jm.apply(params, jnp.asarray(x),
                                    return_features=True)
    expected = {"pvt_sra"} if switch == "1" else set()
    assert jax_seen == expected
    before = dispatch.launch_counts["pvt_sra"]
    with torch.inference_mode(), capture_dispatches() as seen:
        got, got_feats = tm(torch.from_numpy(x), return_features=True)
    assert seen == expected
    assert dispatch.launch_counts["pvt_sra"] == before   # CPU: plain version
    assert list(got_feats) == list(tm.feature_names) == list(jm.feature_names)
    assert np.abs(np.asarray(want)).max() > 0
    assert _rel(got, want) < 1e-3
    for name in tm.feature_names:
        assert _rel(got_feats[name], want_feats[name]) < 1e-3, name


@pytest.mark.parametrize("switch", ["0", "1"])
@pytest.mark.parametrize("family", sorted(SMALL))
def test_small_model_bf16_matches_jax(monkeypatch, family, switch):
    monkeypatch.setenv("TFIMM_TPU_FUSED_PVT_SRA", switch)
    monkeypatch.setenv("TFIMM_TPU_PALLAS_INTERPRET", switch)
    jm, params, tm, x = _pair(family, seed=5)
    jm.params = params
    jm.cast(jnp.bfloat16)
    want = jm.apply(jm.params, jnp.asarray(x, jnp.bfloat16))
    tm = tm.to(torch.bfloat16)
    got = tm.predict(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    assert _rel(got, want) < 5e-2


def test_training_runs_the_eager_attention(monkeypatch):
    monkeypatch.setenv("TFIMM_TPU_FUSED_PVT_SRA", "1")
    _, _, tm, x = _pair("pvt_v2", seed=7)
    tm.train()
    with capture_dispatches() as seen:
        tm(torch.from_numpy(x), generator=torch.Generator().manual_seed(0))
    assert seen == set()
    with capture_dispatches() as seen:
        tm.predict(torch.from_numpy(x))
    assert seen == {"pvt_sra"}


@pytest.mark.parametrize("fixture", ["pvt", "pvt_v2", "pvt_v2_linear"])
@pytest.mark.parametrize("switch", ["0", "1"])
def test_golden_fixture(monkeypatch, fixture, switch):
    monkeypatch.setenv("TFIMM_TPU_FUSED_PVT_SRA", switch)
    data = np.load(os.path.join(GOLDEN_DIR, f"{fixture}.npz"))
    meta = json.loads(bytes(data["meta"]).decode())
    kwargs = {k: tuple(v) if isinstance(v, list) else v
              for k, v in meta["kwargs"].items()}
    sd = {k[len("sd::"):]: torch.from_numpy(data[k]) for k in data.files
          if k.startswith("sd::")}
    model = tfimm_tpu_torch.create_model(meta["model_name"], device="cpu",
                                         **kwargs)
    model.load_state_dict(sd)   # strict: timm's names as they are
    with capture_dispatches() as seen:
        out = model.predict(torch.from_numpy(data["input"]))
    assert seen == ({"pvt_sra"} if switch == "1" else set())
    assert _rel(out, data["output"]) < 1e-3


def test_registry_matches_jax(monkeypatch):
    monkeypatch.setenv("TFIMM_TPU_FUSED_PVT_SRA", "1")
    # The JAX suite registers test variants of its own; compare the
    # families' modules.
    for module, count in (("pvt_v2", 7), ("pvt", 4)):
        names = tfimm_tpu_torch.list_models(module=module)
        assert names == tfimm_tpu.list_models(module=module)
        assert len(names) == count
    for name in tfimm_tpu_torch.list_models("pvt*"):
        want = tfimm_tpu.model_config(name)
        got = tfimm_tpu_torch.model_config(name)
        assert {f: getattr(got, f) for f in vars(want)} == vars(want), name
        # Every registered variant at its full widths, one block a stage, on
        # a 64x64 image: stage 1 has one head and takes the kernel.
        model = tfimm_tpu_torch.create_model(
            name, device="cpu", input_size=(64, 64), nb_blocks=(1, 1, 1, 1))
        with capture_dispatches() as seen:
            out = model.predict(torch.zeros(1, 64, 64, 3))
        assert out.shape == (1, 1000) and seen == {"pvt_sra"}


def test_interpolate_input_waits_for_its_port():
    """``interpolate_input`` (ported since): a 96x96 input resizes each
    stage's position table, the last with its class token kept, and the
    small PVT matches the JAX model within 1e-3, features included."""
    name, cfg = SMALL["pvt"]
    cfg = dict(cfg, interpolate_input=True)
    jm = tfimm_tpu.create_model(name, **cfg)
    params = _seeded(jm.params, 42)
    tm = tfimm_tpu_torch.create_model(name, device="cpu", **cfg)
    tm.load_state_dict(state_dict_from_jax(params))
    x = np.random.default_rng(43).normal(size=(2, 96, 96, 3)).astype(np.float32)
    want, want_feats = jm.apply(params, jnp.asarray(x), return_features=True)
    with torch.inference_mode():
        got, got_feats = tm(torch.from_numpy(x), return_features=True)
    assert got_feats["pos_embedding_3"].shape == (2, 1 + 3 * 3, 64)
    assert _rel(got, want) < 1e-3
    for name in tm.feature_names:
        assert _rel(got_feats[name], want_feats[name]) < 1e-3, name


@pytest.mark.parametrize("patch,stride,padding,flatten",
                         [(7, 4, 3, True), (3, 2, 1, True), (7, 4, 2, False),
                          (4, None, 0, True)])
def test_patch_embeddings_match_jax(patch, stride, padding, flatten):
    x = np.random.default_rng(patch).normal(size=(2, 19, 23, 5)).astype(np.float32)
    norm = (lambda d: JaxLayerNorm(d)) if flatten else None
    jl = JaxPatchEmbeddings(patch, 12, in_channels=5, stride=stride,
                            padding=padding if padding else "valid",
                            norm_layer=norm, flatten=flatten)
    p = jl.init(jax.random.PRNGKey(0))
    want, want_grid = jl(p, jnp.asarray(x))
    tl = PatchEmbeddings(patch, 12, in_channels=5,
                         norm_layer="layer_norm" if flatten else None,
                         stride=stride, padding=padding, flatten=flatten)
    tl.load_state_dict(state_dict_from_jax(p))
    got, grid = tl(torch.from_numpy(x))
    assert grid == tuple(want_grid)
    assert _rel(got.detach(), want) < 1e-5


@pytest.mark.parametrize("h,w,out", [(56, 56, 7), (14, 14, 7), (9, 13, 7),
                                     (5, 3, 7)])
def test_adaptive_avg_pool_matches_jax(h, w, out):
    x = np.random.default_rng(h * w).normal(size=(2, h, w, 6)).astype(np.float32)
    got = adaptive_avg_pool_2d(torch.from_numpy(x), out)
    assert _rel(got, jax_adaptive_pool(jnp.asarray(x), out)) < 1e-6


def test_linear_activation_is_the_identity():
    x = torch.randn(3, 4)
    assert act_layer_factory("linear")(x) is x
