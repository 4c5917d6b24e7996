"""Port parity for the CaiT slice: tfimm_tpu_torch's CaiT against the JAX
package and against the reference-implementation golden fixture.

The small CaiT (32x32 input, patch 8, N = 16 tokens, embed 128, H = 4,
d = 32, 2 talking-head blocks, then the 2 class-attention blocks, 7
classes) gets seeded normal parameters in JAX: the LayerNorm scales and the
layer-scale gammas near 1 (at their init of 1e-5 a block is its shortcut,
and any attention, right or wrong, passes), the (H, H) head mixes random,
not symmetric, at std 0.5 and their biases at std 0.3, the rest at std
0.05. Embed 128 makes the JAX dispatcher take its Pallas kernel under
``TFIMM_TPU_PALLAS_INTERPRET=1`` (``cait_attention.py:515``); without it the
JAX package takes its XLA path on the CPU. The port takes the plain version
of its kernel on the CPU. Bars, as max|diff| / max|JAX|: 1e-4 in f32 (two
dozen layers summed in another order; gradients likewise); 1e-3 against the
golden (the bar of tests/test_golden_parity.py); 5e-2 in bf16 (the two
packages round at different places).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfimm_tpu
import tfimm_tpu_torch
from tfimm_tpu.ops.pallas.dispatch import capture_dispatches as jax_capture
from tfimm_tpu_torch.architectures import cait as port_cait
from tfimm_tpu_torch.ops.kernels import dispatch
from tfimm_tpu_torch.ops.kernels.dispatch import capture_dispatches
from tfimm_tpu_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
NAME = "cait_xxs24_224"
SMALL = dict(input_size=(32, 32), patch_size=8, embed_dim=128, nb_blocks=2,
             nb_heads=4, nb_classes=7)
GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "golden",
                      "ref_cait.npz")
JAX_KERNEL = "cait_talking_head"


def _seeded(params, seed):
    rng = np.random.default_rng(seed)
    leaves, tree = jax.tree_util.tree_flatten_with_path(params)
    new = []
    for path, leaf in leaves:
        r = rng.normal(size=np.shape(leaf)).astype(np.float32)
        keys = [getattr(p, "key", None) for p in path]
        if keys[-1] in ("scale", "gamma_1", "gamma_2"):
            new.append(jnp.asarray(1.0 + 0.1 * r))
        elif len(keys) > 1 and keys[-2] in ("proj_l", "proj_w"):
            new.append(jnp.asarray((0.5 if keys[-1] == "kernel" else 0.3) * r))
        else:
            new.append(jnp.asarray(0.05 * r))
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
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)


def _check_features(jm, params, tm, x, bar):
    _, want = jm.apply(params, jnp.asarray(x), return_features=True)
    with torch.no_grad(), capture_dispatches() as seen:
        _, got = tm(torch.from_numpy(x), return_features=True)
    assert seen == {"talking_head_attention"}
    assert list(got) == list(tm.feature_names) == list(jm.feature_names)
    for name in tm.feature_names:
        assert _rel(got[name], want[name]) < bar, name


@pytest.mark.parametrize("interpret", [True, False])
def test_small_cait_matches_jax(monkeypatch, interpret):
    if interpret:
        monkeypatch.setenv("TFIMM_TPU_PALLAS_INTERPRET", "1")
    jm, params, tm, x = _pair(seed=0 if interpret else 3)
    with jax_capture() as jax_seen:
        want = jm.apply(params, jnp.asarray(x))
        _check_features(jm, params, tm, x, 1e-4)
    assert (JAX_KERNEL in jax_seen) == interpret, jax_seen
    before = dict(dispatch.launch_counts)
    with capture_dispatches() as seen:
        got = tm.predict(torch.from_numpy(x))
    assert seen == {"talking_head_attention"}
    assert dispatch.launch_counts == before  # CPU: plain versions
    assert np.abs(np.asarray(want)).max() > 0
    assert _rel(got, want) < 1e-4


@pytest.mark.parametrize("interpret", [True, False])
def test_small_cait_bf16_matches_jax(monkeypatch, interpret):
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


@pytest.mark.parametrize("interpret", [True, False])
def test_gradients_match_jax(monkeypatch, interpret):
    # In training (all rates 0, so deterministic) both packages take their
    # talking-head paths: the JAX package's Pallas forward and backward in
    # interpret mode (or autodiff of its XLA path), the port's plain
    # versions through its autograd Function. Every parameter's gradient,
    # the head mixes' and their biases' included.
    if interpret:
        monkeypatch.setenv("TFIMM_TPU_PALLAS_INTERPRET", "1")
    jm, params, tm, x = _pair(seed=9)
    w = np.random.default_rng(10).normal(size=(2, 7)).astype(np.float32)

    def loss(p):
        return jnp.sum(jm.apply(p, jnp.asarray(x), training=True) * w)

    with jax_capture() as jax_seen:
        want = state_dict_from_jax(jax.grad(loss)(params))
    assert (JAX_KERNEL in jax_seen) == interpret, jax_seen
    tm.train()
    counts = dict(dispatch.launch_counts)
    with capture_dispatches() as seen:
        (tm(torch.from_numpy(x)) * torch.from_numpy(w)).sum().backward()
    assert seen == {"talking_head_attention"}
    assert dispatch.launch_counts == counts   # CPU: plain versions
    for name, p in tm.named_parameters():
        if name.endswith("proj_l.bias"):
            # Zero by softmax shift invariance: exact in the port (and in
            # the JAX kernel's VJP), f32 noise in JAX's autodiff.
            assert torch.equal(p.grad, torch.zeros_like(p.grad)), name
            assert np.abs(want[name].numpy()).max() < 1e-4, name
            continue
        if name.endswith("attn.k.bias"):
            # The class attention's key bias: one query, so its gradient
            # vanishes by the same invariance; both are f32 noise.
            assert p.grad.abs().max() < 1e-6
            assert np.abs(want[name].numpy()).max() < 1e-6, name
            continue
        assert _rel(p.grad, want[name].numpy()) < 1e-4, name
    assert np.abs(want["blocks.1.attn.proj_w.weight"].numpy()).max() > 0


def test_eager_path_matches_the_jax_xla_path():
    # The port's eager composition (attention dropout's path) against the
    # JAX package's XLA path, in f32 and bf16; a block of each kind.
    jm, params, tm, x = _pair(seed=11)
    jblk = jm.blocks[0]
    pblk = tm.blocks[0]
    t = np.random.default_rng(12).normal(size=(2, 16, 128)).astype(np.float32)
    for jdt, tdt, bar in ((jnp.float32, torch.float32, 1e-5),
                          (jnp.bfloat16, torch.bfloat16, 5e-2)):
        p = jax.tree_util.tree_map(lambda a: a.astype(jdt),
                                   params["blocks"]["0"]["attn"])
        want = jblk.attn(p, jnp.asarray(t, jdt))
        attn = pblk.attn.to(tdt)
        with capture_dispatches() as seen, torch.no_grad():
            got = attn.forward_eager(torch.from_numpy(t).to(tdt))
            kernel = attn(torch.from_numpy(t).to(tdt))
        assert seen == {"talking_head_attention"}
        assert _rel(got, np.asarray(want, np.float32)) < bar
        assert _rel(kernel, np.asarray(want, np.float32)) < bar
        attn.float()


def test_gate_takes_the_eager_path_only_under_attention_dropout():
    _, _, tm, x = _pair(seed=13)
    xt = torch.from_numpy(x)
    gen = torch.Generator().manual_seed(0)
    for training in (False, True):
        tm.train(training)
        with capture_dispatches() as seen:
            tm(xt, generator=gen)
        assert seen == {"talking_head_attention"}
    dropping = tfimm_tpu_torch.create_model(
        NAME, device="cpu", **dict(SMALL, attn_drop_rate=0.1))
    dropping.train()
    with capture_dispatches() as seen:
        out = dropping(xt, generator=gen)
    assert seen == set() and out.grad_fn is not None
    dropping.eval()
    with capture_dispatches() as seen:
        dropping(xt)
    assert seen == {"talking_head_attention"}
    # Drop path and projection dropout keep the kernel.
    other = tfimm_tpu_torch.create_model(
        NAME, device="cpu", **dict(SMALL, drop_path_rate=0.1, drop_rate=0.1))
    other.train()
    with capture_dispatches() as seen:
        other(xt, generator=gen)
    assert seen == {"talking_head_attention"}


def test_drop_path_is_constant_and_the_class_blocks_get_none():
    tm = tfimm_tpu_torch.create_model(NAME, device="cpu",
                                      **dict(SMALL, drop_path_rate=0.1))
    assert [b.drop_path_rate for b in tm.blocks] == [0.1, 0.1]
    assert [b.drop_path_rate for b in tm.blocks_token_only] == [0.0, 0.0]


def test_golden_ref_cait():
    # H = 2, d = 8: the port's kernels take it (the TPU's declines D = 16).
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
    assert seen == {"talking_head_attention"}
    assert _rel(out, data["output"]) < 1e-3


def test_state_dict_from_jax_matches_the_port():
    jm = tfimm_tpu.create_model(NAME, **SMALL)
    sd = state_dict_from_jax(jm.params)
    tm = tfimm_tpu_torch.create_model(NAME, device="cpu", **SMALL)
    want = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    assert want["cls_token"] == (1, 1, 128)
    assert want["pos_embed"] == (1, 16, 128)       # no class token
    p = jm.params
    for key, leaf in (("cls_token", p["cls_token"]),
                      ("pos_embed", p["pos_embed"]),
                      ("blocks.1.gamma_1", p["blocks"]["1"]["gamma_1"]),
                      ("blocks_token_only.0.gamma_2",
                       p["blocks_token_only"]["0"]["gamma_2"])):
        np.testing.assert_array_equal(sd[key].numpy(), np.asarray(leaf))
    # The (H, H) mixes: kernel (in, out) -> weight (out, in).
    params = _seeded(p, 14)
    sd = state_dict_from_jax(params)
    for mix in ("proj_l", "proj_w"):
        kernel = np.asarray(params["blocks"]["0"]["attn"][mix]["kernel"])
        assert np.abs(kernel - kernel.T).max() > 0.1
        np.testing.assert_array_equal(
            sd[f"blocks.0.attn.{mix}.weight"].numpy(), kernel.T)


def test_registry_matches_jax():
    names = tfimm_tpu_torch.list_models("cait*")
    assert names == tfimm_tpu.list_models("cait*", module="cait")
    assert len(names) == 10
    fields = ("input_size", "patch_size", "embed_dim", "nb_blocks", "nb_heads",
              "nb_classes", "crop_pct", "mlp_ratio", "init_scale",
              "drop_path_rate", "attn_drop_rate", "norm_layer", "mean", "std",
              "interpolation", "qkv_bias")
    for name in names:
        want = tfimm_tpu.model_config(name)
        got = tfimm_tpu_torch.model_config(name)
        for field in fields:
            assert getattr(got, field) == getattr(want, field), (name, field)
        cfg = got
        d = cfg.embed_dim // cfg.nb_heads
        assert port_cait.talking_head_attention_supports(
            cfg.nb_patches, cfg.embed_dim, cfg.nb_heads), name
        assert d == 48, name


def test_another_grid_raises():
    """Another input grid without ``interpolate_input`` cannot add the
    position table, as in the JAX package; with it the table (no class
    token in it) is resized, and the model matches the JAX model's
    interpolation within 1e-4 (48x48: a 6 x 6 grid from 4 x 4)."""
    tm = tfimm_tpu_torch.create_model(NAME, device="cpu", **SMALL)
    with pytest.raises(RuntimeError, match="size"):
        tm.predict(torch.zeros(1, 48, 48, 3))
    jm, params, tm, _ = _pair(seed=40, interpolate_input=True)
    x = np.random.default_rng(41).normal(size=(2, 48, 48, 3)).astype(np.float32)
    want = jm.apply(params, jnp.asarray(x))
    got = tm.predict(torch.from_numpy(x))
    assert np.abs(np.asarray(want)).max() > 0
    assert _rel(got, want) < 1e-4


def test_import_pulls_in_no_jax():
    code = ("import sys, tfimm_tpu_torch.architectures.cait, "
            "tfimm_tpu_torch.ops.kernels.cait_attention; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'tfimm_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
