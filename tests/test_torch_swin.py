"""Port parity for the Swin slice: tfimm_tpu_torch's Swin against the JAX
package and against the independent HuggingFace golden fixture.

The small Swin (56x56 input, patch 4, embed_dim 64, heads (2, 4), blocks
(2, 2), window 7, 7 classes) gets seeded normal parameters in JAX, with the
LayerNorm scales near 1 and the relative-position bias tables at std 0.3
(a trunc-normal(0.02) table would hide an attention that drops it). Its
14x14 and 7x7 maps take the whole-block kernel at both stages on both sides
(the JAX package's Pallas kernel in interpret mode, the port's plain
version), so the module tests below are what hold ``window_mha`` in a
model. Bars: rel err < 1e-4 in f32 against JAX (1e-5 for one attention);
< 1e-3 against the golden (the bar of tests/test_golden_parity.py); < 5e-2
in bf16 (the two packages round at different places).
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
from tfimm_tpu.architectures.swin import (
    SwinTransformerBlock as JaxSwinBlock,
    SwinTransformerConfig as JaxSwinConfig,
)
from tfimm_tpu.core import Context as JaxContext
from tfimm_tpu.ops import window_gather as jax_gather
from tfimm_tpu.ops.pallas.dispatch import capture_dispatches as jax_capture
from tfimm_tpu_torch.architectures import swin as port_swin
from tfimm_tpu_torch.core import Context
from tfimm_tpu_torch.ops import window_gather
from tfimm_tpu_torch.ops.kernels import dispatch
from tfimm_tpu_torch.ops.kernels.dispatch import capture_dispatches
from tfimm_tpu_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(1)

NAME = "swin_tiny_patch4_window7_224"
SMALL = dict(input_size=(56, 56), embed_dim=64, nb_heads=(2, 4),
             nb_blocks=(2, 2), nb_classes=7, drop_path_rate=0.0)
GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "golden",
                      "hf_swin.npz")


def _seeded(params, seed):
    rng = np.random.default_rng(seed)
    leaves, tree = jax.tree_util.tree_flatten_with_path(params)
    new = []
    for path, leaf in leaves:
        r = rng.normal(size=np.shape(leaf)).astype(np.float32)
        key = getattr(path[-1], "key", None)
        if key == "scale":
            new.append(jnp.asarray(1.0 + 0.1 * r))
        elif key == "relative_position_bias_table":
            new.append(jnp.asarray(0.3 * r))
        else:
            new.append(jnp.asarray(0.05 * r))
    return jax.tree_util.tree_unflatten(tree, new)


def _pair(seed=0, **overrides):
    """The JAX model with seeded parameters, the port with the same, and a
    seeded (2, 56, 56, 3) input."""
    cfg = dict(SMALL, **overrides)
    jm = tfimm_tpu.create_model(NAME, **cfg)
    params = _seeded(jm.params, seed)
    tm = tfimm_tpu_torch.create_model(NAME, device="cpu", **cfg)
    tm.load_state_dict(state_dict_from_jax(params))  # strict: names match
    x = np.random.default_rng(seed + 1).normal(size=(2, 56, 56, 3))
    return jm, params, tm, x.astype(np.float32)


def _rel(got, want):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)


# -- window gather -----------------------------------------------------------

GEOMETRIES = [(14, 14, 7, 0), (14, 14, 7, 3), (56, 56, 7, 3), (8, 8, 4, 2),
              (24, 12, 12, 6)]


def _unpadded(rows, n, n_pad):
    """Port window-layout rows -> the JAX package's padded rows."""
    return (rows // n) * n_pad + rows % n


@pytest.mark.parametrize("h,w,ws,shift", GEOMETRIES)
def test_gather_indices_match_jax(h, w, ws, shift):
    n = ws * ws
    n_pad = jax_gather.padded_rows(n)
    real = np.arange(h * w // n * n_pad) % n_pad < n   # JAX rows that are not pad
    pack = window_gather.pack_indices(h, w, ws, shift)
    np.testing.assert_array_equal(pack, jax_gather.pack_indices(h, w, ws, shift)[real])
    unpack = window_gather.unpack_indices(h, w, ws, shift)
    np.testing.assert_array_equal(_unpadded(unpack, n, n_pad),
                                  jax_gather.unpack_indices(h, w, ws, shift))
    for to in (0, shift, ws // 2):
        repack = window_gather.repack_indices(h, w, ws, shift, to)
        np.testing.assert_array_equal(
            _unpadded(repack, n, n_pad),
            jax_gather.repack_indices(h, w, ws, shift, to)[real])


@pytest.mark.parametrize("h,w,ws,shift", GEOMETRIES)
def test_gathers_are_roll_and_partition(h, w, ws, shift):
    x = torch.randn(2, h * w, 5, generator=torch.Generator().manual_seed(h))
    xm = torch.roll(x.reshape(2, h, w, 5), (-shift, -shift), dims=(1, 2))
    want = port_swin.window_partition(xm, ws).reshape(2, -1, 5)
    packed = window_gather.pack_windows(x, h, w, ws, shift)
    torch.testing.assert_close(packed, want, rtol=0, atol=0)
    torch.testing.assert_close(window_gather.unpack_windows(packed, h, w, ws, shift),
                               x, rtol=0, atol=0)
    to = ws // 2 - shift if shift else ws // 2
    torch.testing.assert_close(
        window_gather.repack_windows(packed, h, w, ws, shift, to),
        window_gather.pack_windows(x, h, w, ws, to), rtol=0, atol=0)


# -- modules -----------------------------------------------------------------

def _jax_block(shift, c=64, heads=2, seed=0):
    cfg = JaxSwinConfig(name="t", window_size=7)
    blk = JaxSwinBlock(cfg, input_size=(14, 14), embed_dim=c, nb_heads=heads,
                       drop_path_rate=0.0, shift_size=shift)
    params = _seeded(blk.init(jax.random.PRNGKey(0)), seed)
    port = port_swin.SwinTransformerBlock(
        tfimm_tpu_torch.model_config(NAME), (14, 14), c, heads, 0.0, shift)
    port.load_state_dict(state_dict_from_jax(params))
    return blk, params, port


def _cast(params, dtype):
    return jax.tree_util.tree_map(lambda a: a.astype(dtype), params)


@pytest.mark.parametrize("dtype,bar", [("float32", 1e-5), ("bfloat16", 5e-2)])
@pytest.mark.parametrize("shift", [0, 3])
def test_window_attention_matches_jax(monkeypatch, shift, dtype, bar):
    blk, params, port = _jax_block(shift, seed=shift)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    p = _cast(params["attn"], jdt)
    port = port.to(tdt)
    x = np.random.default_rng(3).normal(size=(8, 49, 64)).astype(np.float32)
    jx, tx = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    mask = port.attn_mask
    # The JAX package on its XLA path against the port's eager composition
    # ...
    with jax_capture() as jax_seen:
        want = blk.attn(p, jx, mask=blk.attn_mask)
    assert not jax_seen
    with capture_dispatches() as seen:
        got = port.attn.forward_eager(tx, mask=mask)
    assert seen == set()
    assert _rel(got, want.astype(jnp.float32)) < bar
    # ... and through its window_mha kernel in interpret mode against the
    # port's kernel path (the plain version on the CPU).
    monkeypatch.setenv("TFIMM_TPU_PALLAS_INTERPRET", "1")
    with jax_capture() as jax_seen:
        want = blk.attn(p, jx, mask=blk.attn_mask)
    assert any(s.startswith("window_mha") for s in jax_seen), jax_seen
    with capture_dispatches() as seen, torch.no_grad():
        got = port.attn(tx, mask=mask)
    assert seen == {"window_mha"}
    assert _rel(got, want.astype(jnp.float32)) < bar


@pytest.mark.parametrize("shift", [0, 3])
def test_unfused_block_matches_jax(monkeypatch, shift):
    # In training (all rates 0, so deterministic) both packages run the
    # block per op with their attention through window_mha (the JAX
    # package: in interpret mode).
    blk, params, port = _jax_block(shift, seed=10 + shift)
    x = np.random.default_rng(4).normal(size=(2, 196, 64)).astype(np.float32)
    monkeypatch.setenv("TFIMM_TPU_PALLAS_INTERPRET", "1")
    with JaxContext(training=True), jax_capture() as jax_seen:
        want = blk(params, jnp.asarray(x))
    assert not any(s.startswith("swin_block") for s in jax_seen), jax_seen
    with Context(training=True), capture_dispatches() as seen, torch.no_grad():
        got = port(torch.from_numpy(x))
    assert seen == {"window_mha"}
    assert _rel(got, want) < 1e-4
    # The JAX XLA path against the port's eager composition.
    monkeypatch.delenv("TFIMM_TPU_PALLAS_INTERPRET")
    with JaxContext(training=False):
        want = blk(params, jnp.asarray(x))
    with capture_dispatches() as seen:
        got = port(torch.from_numpy(x))   # autograd records: per op
    assert seen == {"window_mha"}
    assert _rel(got, want) < 1e-4
    monkeypatch.setattr(port.attn, "forward", port.attn.forward_eager)
    with capture_dispatches() as seen:
        got = port(torch.from_numpy(x))
    assert seen == set()
    assert _rel(got, want) < 1e-4
    with capture_dispatches() as seen, torch.no_grad():
        fused = port(torch.from_numpy(x))
    assert seen == {"swin_block"}
    assert _rel(fused, want) < 1e-4


# -- the model ---------------------------------------------------------------

def _check_features(jm, params, tm, x, bar):
    _, want = jm.apply(params, jnp.asarray(x), return_features=True)
    with torch.no_grad(), capture_dispatches() as seen:
        _, got = tm(torch.from_numpy(x), return_features=True)
    assert seen == {"swin_block"}      # capture: per block, no resident stage
    assert list(got) == list(tm.feature_names) == list(jm.feature_names)
    for name in tm.feature_names:
        assert _rel(got[name], want[name]) < bar, name


def test_small_swin_matches_jax_through_swin_block(monkeypatch):
    monkeypatch.setenv("TFIMM_TPU_PALLAS_INTERPRET", "1")
    jm, params, tm, x = _pair()
    with jax_capture() as jax_seen:
        want = jm.apply(params, jnp.asarray(x))
        _check_features(jm, params, tm, x, 1e-4)
    assert "swin_window_resident_stage" in jax_seen, jax_seen
    before = dict(dispatch.launch_counts)
    with capture_dispatches() as seen:
        got = tm.predict(torch.from_numpy(x))
    assert seen == {"swin_window_resident_stage", "swin_block"}
    assert dispatch.launch_counts == before  # CPU: plain versions
    assert np.abs(np.asarray(want)).max() > 0
    assert _rel(got, want) < 1e-4


def test_small_swin_matches_jax_on_default_paths():
    # The JAX package on a CPU takes its XLA composition.
    jm, params, tm, x = _pair(seed=3)
    with jax_capture() as jax_seen:
        want = jm.apply(params, jnp.asarray(x))
        _check_features(jm, params, tm, x, 1e-4)
    assert not jax_seen
    assert _rel(tm.predict(torch.from_numpy(x)), want) < 1e-4


@pytest.mark.parametrize("interpret", [True, False])
def test_small_swin_bf16_matches_jax(monkeypatch, interpret):
    if interpret:
        monkeypatch.setenv("TFIMM_TPU_PALLAS_INTERPRET", "1")
    jm, params, tm, x = _pair(seed=5)
    jm.params = params
    jm.cast(jnp.bfloat16)
    want, want_feats = jm.apply(jm.params, jnp.asarray(x, jnp.bfloat16),
                                return_features=True)
    tm = tm.to(torch.bfloat16)
    xt = torch.from_numpy(x).bfloat16()
    got = tm.predict(xt)
    with torch.inference_mode():
        _, got_feats = tm(xt, return_features=True)
    assert got.dtype == torch.bfloat16
    assert _rel(got, want) < 5e-2
    for name in tm.feature_names:
        assert _rel(got_feats[name], want_feats[name]) < 5e-2, name


def test_window_resident_stage_matches_per_block():
    _, _, tm, x = _pair(seed=7)
    xt = torch.from_numpy(x)
    with capture_dispatches() as seen:
        resident = tm.predict(xt)
    assert "swin_window_resident_stage" in seen
    with torch.no_grad(), capture_dispatches() as seen:
        per_block, _ = tm(xt, return_features=True)
    assert seen == {"swin_block"}
    torch.testing.assert_close(resident, per_block, rtol=0, atol=0)


def test_gradients_match_jax(monkeypatch):
    # In training every block runs per op in both packages, its attention
    # through window_mha and its backward kernel (the JAX package's Pallas
    # forward and backward in interpret mode, the port's plain versions);
    # rates 0 keep both deterministic. The bias tables' gradients are the
    # kernels' dbias, scattered through the relative-position index.
    monkeypatch.setenv("TFIMM_TPU_PALLAS_INTERPRET", "1")
    jm, params, tm, x = _pair(seed=9)
    w = np.random.default_rng(10).normal(size=(2, 7)).astype(np.float32)

    def loss(p):
        return jnp.sum(jm.apply(p, jnp.asarray(x), training=True) * w)

    with jax_capture() as jax_seen:
        want = state_dict_from_jax(jax.grad(loss)(params))
    assert any(s.startswith("window_mha") for s in jax_seen), jax_seen
    tm.train()
    counts = dict(dispatch.launch_counts)
    with capture_dispatches() as seen:
        (tm(torch.from_numpy(x)) * torch.from_numpy(w)).sum().backward()
    assert seen == {"window_mha"}
    assert dispatch.launch_counts == counts   # CPU: plain versions
    for name, p in tm.named_parameters():
        assert _rel(p.grad, want[name].numpy()) < 1e-4, name
    table = "layers.0.blocks.1.attn.relative_position_bias_table"
    assert np.abs(want[table].numpy()).max() > 0


def test_gate_takes_the_eager_composition_under_autograd():
    # Where autograd records, the block kernel (no backward) declines and
    # every block runs per op with its attention through window_mha, which
    # trains through its backward; only live attention dropout in training
    # sends the attention to the eager composition, as in the JAX package.
    _, _, tm, x = _pair(seed=11)
    xt = torch.from_numpy(x)
    with capture_dispatches() as seen:
        tm(xt)                   # eval, but autograd records the parameters
    assert seen == {"window_mha"}
    tm.requires_grad_(False)
    with capture_dispatches() as seen:
        out = tm(xt.clone().requires_grad_())  # autograd records the input
    assert seen == {"window_mha"} and out.grad_fn is not None
    with capture_dispatches() as seen, torch.no_grad():
        tm(xt)
    assert seen == {"swin_window_resident_stage", "swin_block"}
    tm.train()
    with capture_dispatches() as seen, torch.no_grad():
        tm(xt, generator=torch.Generator().manual_seed(0))
    assert seen == {"window_mha"}   # training: per op, attention kernel
    dropping = tfimm_tpu_torch.create_model(NAME, device="cpu",
                                            **dict(SMALL, attn_drop_rate=0.1))
    dropping.train()
    with capture_dispatches() as seen:
        dropping(xt, generator=torch.Generator().manual_seed(0))
    assert seen == set()
    dropping.eval()
    with capture_dispatches() as seen:
        dropping(xt)
    assert seen == {"window_mha"}


def test_swin_tiny_dispatch(monkeypatch):
    # Stages 1-3 take the whole-block kernel, stage 4 (14.2 MB of bf16
    # matrices) the per-op path with window_mha, as in the JAX package.
    calls = []

    def watch(name, fn):
        def wrapped(x, *args, **kwargs):
            calls.append((name, tuple(x.shape)))
            return fn(x, *args, **kwargs)
        monkeypatch.setattr(port_swin, name, wrapped)

    watch("swin_block", port_swin.swin_block)
    watch("window_mha_packed", port_swin.window_mha_packed)
    for dtype in (torch.float32, torch.bfloat16):
        calls.clear()
        tm = tfimm_tpu_torch.create_model(NAME, device="cpu", dtype=dtype)
        x = torch.randn(2, 224, 224, 3, generator=torch.Generator().manual_seed(0))
        with capture_dispatches() as seen:
            out = tm.predict(x.to(dtype))
        assert out.shape == (2, 1000)
        assert seen == {"swin_window_resident_stage", "swin_block", "window_mha"}
        assert calls == ([("swin_block", (128, 49, 96))] * 2
                         + [("swin_block", (32, 49, 192))] * 2
                         + [("swin_block", (8, 49, 384))] * 6
                         + [("window_mha_packed", (2, 49, 3 * 768))] * 2), dtype


def test_golden_hf_swin():
    # d = 8 and window 4 (N = 16): outside the TPU kernels' coverage, inside
    # the port's.
    data = np.load(GOLDEN)
    meta = json.loads(bytes(data["meta"]).decode())
    kwargs = {k: tuple(v) if isinstance(v, list) else v
              for k, v in meta["kwargs"].items()}
    sd = {k[len("sd::"):]: torch.from_numpy(data[k]) for k in data.files
          if k.startswith("sd::")}
    model = tfimm_tpu_torch.create_model(meta["model_name"], device="cpu",
                                         **kwargs)
    model.load_state_dict(sd)  # strict: no index or mask in the state dict
    with capture_dispatches() as seen:
        out = model.predict(torch.from_numpy(data["input"]))
    assert seen == {"swin_window_resident_stage", "swin_block"}
    assert _rel(out, data["output"]) < 1e-3


def test_state_dict_from_jax_matches_the_port():
    jm = tfimm_tpu.create_model(NAME, **SMALL)
    sd = state_dict_from_jax(jm.params)
    tm = tfimm_tpu_torch.create_model(NAME, device="cpu", **SMALL)
    want = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    assert "patch_embed.norm.weight" in want
    assert not any("index" in k or "mask" in k for k in want)
    table = jm.params["layers"]["1"]["blocks"]["0"]["attn"][
        "relative_position_bias_table"]
    np.testing.assert_array_equal(
        sd["layers.1.blocks.0.attn.relative_position_bias_table"].numpy(),
        np.asarray(table))     # no kernel leaf: carried unchanged
    red = np.asarray(jm.params["layers"]["0"]["downsample"]["reduction"]["kernel"])
    np.testing.assert_array_equal(
        sd["layers.0.downsample.reduction.weight"].numpy(), red.T)


def test_registry_matches_jax():
    names = tfimm_tpu_torch.list_models("swin*")
    assert names == tfimm_tpu.list_models("swin*", module="swin")
    assert len(names) == 10
    fields = ("input_size", "patch_size", "embed_dim", "nb_blocks", "nb_heads",
              "window_size", "nb_classes", "crop_pct", "mlp_ratio",
              "drop_path_rate", "norm_layer", "patch_norm")
    for name in names:
        want = tfimm_tpu.model_config(name)
        got = tfimm_tpu_torch.model_config(name)
        for field in fields:
            assert getattr(got, field) == getattr(want, field), (name, field)


def test_preprocessing_matches_jax():
    img = np.random.default_rng(12).integers(0, 256, (2, 8, 8, 3), np.uint8)
    got = tfimm_tpu_torch.create_preprocessing(NAME, device="cpu")(
        torch.from_numpy(img))
    want = tfimm_tpu.create_preprocessing(NAME)(img)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
