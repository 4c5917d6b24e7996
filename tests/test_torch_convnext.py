"""Port parity for the ConvNeXt slice: tfimm_tpu_torch's ConvNeXt against the
JAX package and against the independent HuggingFace golden fixture.

The small ConvNeXt (widths (128, 256), depths (1, 1), 32x32 input, 7
classes) gets seeded normal parameters in JAX, with the layer-scale gammas
and the norm scales near 1: at gamma's init value 1e-6 the MLP branch would
vanish and any MLP would pass. The port loads them through
``state_dict_from_jax``. Bars: rel err < 1e-4 in f32 against JAX; < 1e-3
against the golden (the bar of tests/test_golden_parity.py); < 5e-2 in bf16
(the two packages round the MLP branch at different places).

Every test but one holds the default path, with ``TFIMM_TPU_FUSED_CONVNEXT``
pinned to 0 whatever the environment says. The one with the switch on runs
the JAX model through its fused block on the CPU: its gate tests
``jax.default_backend()`` itself, so the test reports the TPU backend and
runs the Pallas kernel in interpret mode, for that test only.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfimm_tpu
import tfimm_tpu.ops.pallas.convnext_block as jax_convnext_block
import tfimm_tpu_torch
from tfimm_tpu.ops.conv import DepthwiseConv2d as JaxDepthwiseConv2d
from tfimm_tpu.ops.mlp import ConvMLP as JaxConvMLP
from tfimm_tpu.ops.pallas.dispatch import capture_dispatches as jax_capture
from tfimm_tpu_torch.ops.conv import DepthwiseConv2d
from tfimm_tpu_torch.ops.kernels import dispatch
from tfimm_tpu_torch.ops.kernels.dispatch import capture_dispatches
from tfimm_tpu_torch.ops.mlp import ConvMLP
from tfimm_tpu_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(1)

NAME = "convnext_base"
SMALL = dict(input_size=(32, 32), embed_dim=(128, 256), nb_blocks=(1, 1),
             nb_classes=7, drop_path_rate=0.0)
GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "golden",
                      "hf_convnext.npz")


@pytest.fixture(autouse=True)
def _fused_block_off(monkeypatch):
    monkeypatch.setenv("TFIMM_TPU_FUSED_CONVNEXT", "0")


def _seeded(params, seed):
    rng = np.random.default_rng(seed)
    leaves, tree = jax.tree_util.tree_flatten_with_path(params)
    new = []
    for path, leaf in leaves:
        r = rng.normal(size=np.shape(leaf)).astype(np.float32)
        near_one = getattr(path[-1], "key", None) in ("scale", "gamma")
        new.append(jnp.asarray(1.0 + 0.1 * r if near_one else 0.05 * r))
    return jax.tree_util.tree_unflatten(tree, new)


def _pair(seed=0, **overrides):
    """The JAX model with seeded parameters, the port with the same, and a
    seeded (2, 32, 32, 3) input."""
    cfg = dict(SMALL, **overrides)
    jm = tfimm_tpu.create_model(NAME, **cfg)
    params = _seeded(jm.params, seed)
    tm = tfimm_tpu_torch.create_model(NAME, device="cpu", **cfg)
    tm.load_state_dict(state_dict_from_jax(params))  # strict: names match
    x = np.random.default_rng(seed + 1).normal(size=(2, 32, 32, 3))
    return jm, params, tm, x.astype(np.float32)


def _rel(got, want):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)


def _check_features(jm, params, tm, x, bar):
    _, want = jm.apply(params, jnp.asarray(x), return_features=True)
    with torch.no_grad():
        _, got = tm(torch.from_numpy(x), return_features=True)
    assert list(got) == list(tm.feature_names) == list(jm.feature_names)
    for name in tm.feature_names:
        assert _rel(got[name], want[name]) < bar, name


def test_small_convnext_matches_jax_through_convnext_mlp(monkeypatch):
    # Both sides take their fused LN+MLP: the JAX package its Pallas kernel
    # in interpret mode, the port its kernel's plain version.
    monkeypatch.setenv("TFIMM_TPU_PALLAS_INTERPRET", "1")
    jm, params, tm, x = _pair()
    with jax_capture() as jax_seen:
        want = jm.apply(params, jnp.asarray(x))
        _check_features(jm, params, tm, x, 1e-4)
    assert "convnext_mlp" in jax_seen, jax_seen
    before = dispatch.launch_counts["convnext_mlp"]
    with capture_dispatches() as seen:
        got = tm.predict(torch.from_numpy(x))
    assert seen == {"convnext_mlp"}
    assert dispatch.launch_counts["convnext_mlp"] == before  # CPU: plain version
    assert np.abs(np.asarray(want)).max() > 0
    assert _rel(got, want) < 1e-4


def test_small_convnext_matches_jax_on_default_paths():
    # The JAX package on a CPU takes its XLA composition.
    jm, params, tm, x = _pair(seed=3)
    with jax_capture() as jax_seen:
        want = jm.apply(params, jnp.asarray(x))
        _check_features(jm, params, tm, x, 1e-4)
    assert "convnext_mlp" not in jax_seen
    assert _rel(tm.predict(torch.from_numpy(x)), want) < 1e-4


def test_small_convnext_bf16_matches_jax(monkeypatch):
    monkeypatch.setenv("TFIMM_TPU_PALLAS_INTERPRET", "1")
    jm, params, tm, x = _pair(seed=5)
    jm.params = params
    jm.cast(jnp.bfloat16)
    xb = jnp.asarray(x, jnp.bfloat16)
    want, want_feats = jm.apply(jm.params, xb, return_features=True)
    tm = tm.to(torch.bfloat16)
    with torch.inference_mode():
        got, got_feats = tm(torch.from_numpy(x).bfloat16(), return_features=True)
    assert got.dtype == torch.bfloat16
    assert _rel(got, want) < 5e-2
    for name in tm.feature_names:
        assert _rel(got_feats[name], want_feats[name]) < 5e-2, name


def test_small_convnext_bf16_matches_jax_through_the_fused_block(monkeypatch):
    # Switched on, both packages run every block whole: the JAX package
    # through its Pallas kernel in interpret mode (its gate opened by the
    # TPU backend reported for this test), the port through convnext_block's
    # plain version.
    monkeypatch.setenv("TFIMM_TPU_FUSED_CONVNEXT", "1")
    monkeypatch.setenv("TFIMM_TPU_PALLAS_INTERPRET", "1")
    calls = []
    orig = jax_convnext_block.fused_convnext_block

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return functools.partial(orig, interpret=True)(*args, **kwargs)

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jax_convnext_block, "fused_convnext_block", counted)
    jm, params, tm, x = _pair(seed=15, embed_dim=(32, 64), nb_blocks=(2, 1))
    jm.params = params
    jm.cast(jnp.bfloat16)
    want, want_feats = jm.apply(jm.params, jnp.asarray(x, jnp.bfloat16),
                                return_features=True)
    assert len(calls) == sum(jm.cfg.nb_blocks) == 3
    tm = tm.to(torch.bfloat16)
    before = dict(dispatch.launch_counts)
    with torch.inference_mode(), capture_dispatches() as seen:
        got, got_feats = tm(torch.from_numpy(x).bfloat16(), return_features=True)
    assert seen == {"convnext_block"}
    assert dispatch.launch_counts == before   # CPU: plain version
    assert _rel(got, want) < 5e-2
    for name in tm.feature_names:
        assert _rel(got_feats[name], want_feats[name]) < 5e-2, name


def test_gradients_match_jax():
    # In training the block takes the eager composition (no kernel backward),
    # as the JAX package's gate does; drop-path 0 keeps both deterministic.
    jm, params, tm, x = _pair(seed=7)
    w = np.random.default_rng(8).normal(size=(2, 7)).astype(np.float32)

    def loss(p):
        return jnp.sum(jm.apply(p, jnp.asarray(x), training=True) * w)

    want = state_dict_from_jax(jax.grad(loss)(params))
    tm.train()
    with capture_dispatches() as seen:
        (tm(torch.from_numpy(x)) * torch.from_numpy(w)).sum().backward()
    assert "convnext_mlp" not in seen
    for name, p in tm.named_parameters():
        assert _rel(p.grad, want[name].numpy()) < 1e-4, name


def test_gate_takes_the_eager_composition_under_autograd():
    _, _, tm, x = _pair(seed=9)
    xt = torch.from_numpy(x)
    with capture_dispatches() as seen:
        tm(xt)                   # eval, but autograd records the parameters
    assert seen == set()
    with capture_dispatches() as seen, torch.no_grad():
        tm(xt)
    assert seen == {"convnext_mlp"}
    tm.requires_grad_(False)
    with capture_dispatches() as seen:
        tm(xt.clone().requires_grad_())  # autograd records the input
    assert seen == set()
    with capture_dispatches() as seen:
        tm.predict(xt)
    assert seen == {"convnext_mlp"}
    tm.train()
    with capture_dispatches() as seen, torch.no_grad():
        tm(xt, generator=torch.Generator().manual_seed(0))
    assert seen == set()


def test_state_dict_from_jax_matches_the_port():
    jm = tfimm_tpu.create_model(NAME, **SMALL)
    sd = state_dict_from_jax(jm.params)
    tm = tfimm_tpu_torch.create_model(NAME, device="cpu", **SMALL)
    want = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    dw = np.asarray(jm.params["stages"]["0"]["blocks"]["0"]["conv_dw"]["kernel"])
    assert dw.shape == (7, 7, 1, 128)
    got = sd["stages.0.blocks.0.conv_dw.weight"]
    assert got.shape == (128, 1, 7, 7)
    np.testing.assert_array_equal(got.numpy(), dw.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd["stages.1.blocks.0.gamma"].numpy(),
        np.asarray(jm.params["stages"]["1"]["blocks"]["0"]["gamma"]))


def test_golden_hf_convnext():
    data = np.load(GOLDEN)
    meta = json.loads(bytes(data["meta"]).decode())
    kwargs = {k: tuple(v) if isinstance(v, list) else v
              for k, v in meta["kwargs"].items()}
    sd = {k[len("sd::"):]: torch.from_numpy(data[k]) for k in data.files
          if k.startswith("sd::")}
    model = tfimm_tpu_torch.create_model(meta["model_name"], device="cpu",
                                         **kwargs)
    model.load_state_dict(sd)
    with capture_dispatches() as seen:
        out = model.predict(torch.from_numpy(data["input"]))
    assert seen == {"convnext_mlp"}  # C = 8, 12, 16, 20 all take it
    assert _rel(out, data["output"]) < 1e-3


def test_registry_matches_jax():
    names = tfimm_tpu_torch.list_models("convnext*")
    assert names == tfimm_tpu.list_models("convnext*", module="convnext")
    assert len(names) == 19
    for name in names:
        want = tfimm_tpu.model_config(name)
        got = tfimm_tpu_torch.model_config(name)
        assert (got.embed_dim, got.nb_blocks, got.input_size, got.nb_classes) \
            == (want.embed_dim, want.nb_blocks, want.input_size,
                want.nb_classes), name


def test_preprocessing_matches_jax():
    img = np.random.default_rng(11).integers(0, 256, (2, 8, 8, 3), np.uint8)
    got = tfimm_tpu_torch.create_preprocessing(NAME, device="cpu")(
        torch.from_numpy(img))
    want = tfimm_tpu.create_preprocessing(NAME)(img)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_depthwise_conv_matches_jax():
    rng = np.random.default_rng(12)
    x = rng.normal(size=(2, 9, 11, 24)).astype(np.float32)
    jl = JaxDepthwiseConv2d(24, 7, padding=3)
    p = jl.init(jax.random.PRNGKey(0))
    tl = DepthwiseConv2d(24, 7)
    tl.load_state_dict(state_dict_from_jax(p))
    got = tl(torch.from_numpy(x))
    assert got.shape == (2, 9, 11, 24)
    assert _rel(got.detach(), jl(p, jnp.asarray(x))) < 1e-5


def test_conv_mlp_matches_jax():
    rng = np.random.default_rng(13)
    x = rng.normal(size=(2, 5, 5, 16)).astype(np.float32)
    jl = JaxConvMLP(16, 64)
    p = jl.init(jax.random.PRNGKey(1))
    tl = ConvMLP(16, 64)
    tl.load_state_dict(state_dict_from_jax(p))
    assert tuple(tl.fc1.weight.shape) == (64, 16, 1, 1)
    assert _rel(tl(torch.from_numpy(x)).detach(), jl(p, jnp.asarray(x))) < 1e-5


def test_conv_mlp_block_takes_the_eager_path():
    # conv_mlp_block=True is no registered variant, but the config field is:
    # its block runs the 1x1-conv MLP, never the fused kernel.
    jm, params, tm, x = _pair(seed=14, conv_mlp_block=True)
    assert "stages.0.blocks.0.mlp.fc1.weight" in tm.state_dict()
    with capture_dispatches() as seen:
        got = tm.predict(torch.from_numpy(x))
    assert seen == set()
    assert _rel(got, jm.apply(params, jnp.asarray(x))) < 1e-4


def test_stem_and_downsample_biases_start_at_zero():
    tm = tfimm_tpu_torch.create_model(NAME, device="cpu", **SMALL)
    sd = tm.state_dict()
    for key in ("stem.0.bias", "stages.1.downsample.1.bias",
                "stages.0.blocks.0.conv_dw.bias"):
        assert not sd[key].any(), key
    assert torch.all(sd["stages.0.blocks.0.gamma"] == 1e-6)
