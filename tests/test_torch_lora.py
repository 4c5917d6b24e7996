"""Port parity for LoRA: tfimm_tpu_torch's ``architectures/lora`` against
the JAX package's, on the CPU.

LoRA's B factor starts at zero, where a LoRA layer is its base layer and
any update, right or wrong, passes; so every test draws B (and every other
parameter) from a seed. The small LoRA-ConvNeXt has widths (128, 256), so
that both stages meet the JAX kernel gate's lane rule, and its layer-scale
gammas and norm scales near 1 (at gamma's init of 1e-6 the MLP, and with
it LoRA, would vanish). Bars: 1e-5 for single layers and one optimizer
step, 1e-4 through the model in f32, 5e-2 in bf16.

The JAX ConvNeXt block hands its Pallas kernels the raw ``kernel`` leaves,
so its kernel path drops the LoRA update that its XLA path applies; the
port hands its kernels the merged weights and computes what the XLA path
computes (``test_port_keeps_the_update_the_jax_kernel_path_drops``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tfimm_tpu
import tfimm_tpu.architectures.lora as jlora
import tfimm_tpu_torch
import tfimm_tpu_torch.architectures.lora as tlora
from tfimm_tpu.utils.tree import flatten_params, unflatten_params
from tfimm_tpu_torch.architectures.convnext import ConvNeXt
from tfimm_tpu_torch.ops.kernels import dispatch
from tfimm_tpu_torch.ops.kernels.dispatch import capture_dispatches
from tfimm_tpu_torch.utils.convert import jax_from_state_dict, state_dict_from_jax

torch.set_num_threads(1)

NAME = "convnext_base"
SMALL = dict(input_size=(32, 32), embed_dim=(128, 256), nb_blocks=(1, 1),
             nb_classes=7, drop_path_rate=0.0)
LORA = dict(lora_rank=2, lora_alpha=4.0)
_RENAMES = {"kernel": "weight", "scale": "weight",
            "kernel_lora_a": "weight_lora_a", "kernel_lora_b": "weight_lora_b"}


@pytest.fixture(autouse=True)
def _fused_block_off(monkeypatch):
    monkeypatch.setenv("TFIMM_TPU_FUSED_CONVNEXT", "0")


def _port_name(path):
    head, _, leaf = path.rpartition(".")
    return f"{head}.{_RENAMES.get(leaf, leaf)}"


def _seeded(params, seed):
    """Every leaf drawn anew: norm scales and gammas 1 + 0.1 N(0, 1), the
    rest (LoRA's A and B too) 0.05 N(0, 1)."""
    rng = np.random.default_rng(seed)
    new = {}
    for path, leaf in flatten_params(params).items():
        r = rng.normal(size=np.shape(leaf)).astype(np.float32)
        near_one = path.rpartition(".")[2] in ("scale", "gamma")
        new[path] = jnp.asarray(1.0 + 0.1 * r if near_one else 0.05 * r)
    return unflatten_params(new)


def _rel(got, want):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope="module")
def pair():
    """The JAX LoRA-ConvNeXt with seeded parameters (B nonzero), the port
    with the same, and a seeded (2, 32, 32, 3) input."""
    jm = jlora.create_model(NAME, **SMALL, **LORA)
    params = _seeded(jm.params, 0)
    tm = tlora.create_model(NAME, device="cpu", **SMALL, **LORA)
    tm.load_state_dict(state_dict_from_jax(params))   # strict: names match
    x = np.random.default_rng(1).normal(size=(2, 32, 32, 3)).astype(np.float32)
    return jm, params, tm, x


@pytest.mark.parametrize("module", ["registry", "layers", "factory",
                                    "convnext"])
def test_modules_export_what_the_jax_modules_export(module):
    import importlib

    want = importlib.import_module(f"tfimm_tpu.architectures.lora.{module}")
    got = importlib.import_module(f"tfimm_tpu_torch.architectures.lora.{module}")
    assert got.__all__ == want.__all__
    assert all(hasattr(got, name) for name in got.__all__)


# -- layers ------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 24), (2, 3, 24)])
def test_lora_dense_matches_jax(shape):
    layer = jlora.LoRADense(24, 40, lora_rank=3, lora_alpha=6.0)
    p = layer.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(2)
    p["kernel_lora_b"] = jnp.asarray(rng.normal(size=(3, 40)), jnp.float32)
    x = rng.normal(size=shape).astype(np.float32)
    port = tlora.LoRADense(24, 40, lora_rank=3, lora_alpha=6.0)
    port.load_state_dict(state_dict_from_jax(p))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    want = layer(p, jnp.asarray(x))
    base = jnp.dot(jnp.asarray(x), p["kernel"]) + p["bias"]
    assert _rel(got, want) < 1e-5
    assert _rel(want, base) > 1e-2   # B moves the layer


@pytest.mark.parametrize("stride,padding,groups", [
    (1, "same", 1), (2, "same", 1), (1, "symmetric", 2), (2, "same", 4)])
def test_lora_conv2d_matches_jax(stride, padding, groups):
    kw = dict(stride=stride, padding=padding, groups=groups)
    layer = jlora.LoRAConv2d(8, 12, 3, lora_rank=2, lora_alpha=2.0, **kw)
    p = layer.init(jax.random.PRNGKey(1))
    rng = np.random.default_rng(3)
    p["kernel_lora_b"] = jnp.asarray(rng.normal(size=(3, 3, 2, 12)),
                                     jnp.float32)
    x = rng.normal(size=(2, 9, 10, 8)).astype(np.float32)
    port = tlora.LoRAConv2d(8, 12, 3, lora_rank=2, lora_alpha=2.0, **kw)
    assert port.weight_lora_a.shape == (2, 8 // groups, 3, 3)
    assert port.weight_lora_b.shape == (12, 2, 3, 3)
    port.load_state_dict(state_dict_from_jax(p))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    want = layer(p, jnp.asarray(x))
    assert _rel(got, want) < 1e-5
    from tfimm_tpu.ops import Conv2d

    plain = Conv2d(8, 12, 3, **kw)
    base = plain({"kernel": p["kernel"], "bias": p["bias"]}, jnp.asarray(x))
    assert _rel(want, base) > 1e-2


def test_convert_to_lora_layer_keeps_the_conv_route():
    from tfimm_tpu_torch.ops.basic import Dense
    from tfimm_tpu_torch.ops.conv import Conv2d

    g = torch.Generator().manual_seed(0)
    for conv in (Conv2d(6, 8, 4, generator=g),                  # patchify
                 Conv2d(6, 8, 3, stride=2, padding="same", generator=g),
                 Conv2d(6, 8, 1, stride=1, padding="same", generator=g)):
        lora = tlora.convert_to_lora_layer(conv, lora_rank=2, generator=g)
        assert isinstance(lora, tlora.LoRAConv2d)
        assert (lora.padding, lora.patchify) == (conv.padding, conv.patchify)
        x = torch.randn(2, 8, 8, 6, generator=g)
        with torch.no_grad():
            assert torch.equal(lora(x), conv(x))   # B = 0
    dense = Dense(6, 5, generator=g)
    lora = tlora.convert_to_lora_layer(dense, lora_rank=3, generator=g)
    assert lora.weight_lora_a.shape == (3, 6) and not lora.weight_lora_b.any()
    assert torch.equal(lora.weight, dense.weight)
    with pytest.raises(ValueError):
        tlora.convert_to_lora_layer(torch.nn.Identity())


def test_state_dict_conversion_round_trip(pair):
    jm, params, tm, _ = pair
    want = {k: np.asarray(v) for k, v in flatten_params(params).items()}
    back = jax_from_state_dict(tm)
    assert set(back) == set(want)
    for k in want:
        assert back[k].shape == want[k].shape, k
        np.testing.assert_array_equal(back[k], want[k])


# -- the model ---------------------------------------------------------------------

def test_small_lora_convnext_matches_jax_xla_path_through_convnext_mlp(pair):
    jm, params, tm, x = pair
    want = jm.apply(params, jnp.asarray(x))
    before = dispatch.launch_counts["convnext_mlp"]
    with capture_dispatches() as seen:
        got = tm.predict(torch.from_numpy(x))
    assert seen == {"convnext_mlp"}
    assert dispatch.launch_counts["convnext_mlp"] == before   # CPU: plain
    assert _rel(got, want) < 1e-4


def test_small_lora_convnext_bf16_through_the_fused_block(pair, monkeypatch):
    jm, params, tm, x = pair
    monkeypatch.setenv("TFIMM_TPU_FUSED_CONVNEXT", "1")
    p16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)
    want = jm.apply(p16, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32)
    want32 = jm.apply(params, jnp.asarray(x))
    tm16 = tlora.create_model(NAME, device="cpu", dtype=torch.bfloat16,
                              **SMALL, **LORA)
    tm16.load_state_dict(state_dict_from_jax(params))
    with capture_dispatches() as seen:
        got = tm16.predict(torch.from_numpy(x).bfloat16())
    assert seen == {"convnext_block"}
    assert _rel(got, want) < 5e-2
    assert _rel(got, want32) < 5e-2


def test_port_keeps_the_update_the_jax_kernel_path_drops(pair, monkeypatch):
    """The departure: in interpret mode the JAX kernel path gives the
    result of B = 0, the JAX XLA path and the port apply B."""
    jm, params, tm, x = pair
    xla = jm.apply(params, jnp.asarray(x))
    flat = flatten_params(params)
    zero_b = unflatten_params({k: jnp.zeros_like(v) if k.endswith("kernel_lora_b")
                               else v for k, v in flat.items()})
    monkeypatch.setenv("TFIMM_TPU_PALLAS_INTERPRET", "1")
    from tfimm_tpu.ops.pallas.dispatch import capture_dispatches as jax_capture

    with jax_capture() as jax_seen:
        kernel_path = jm.apply(params, jnp.asarray(x))
    no_update = jm.apply(zero_b, jnp.asarray(x))
    assert "convnext_mlp" in jax_seen
    assert _rel(kernel_path, no_update) < 1e-5    # the update is dropped
    got = tm.predict(torch.from_numpy(x))
    assert _rel(got, xla) < 1e-4
    assert _rel(got, kernel_path) > 100 * 1e-4    # the port keeps it


# -- the factory ---------------------------------------------------------------------

def test_create_model_with_zero_b_is_the_base_model():
    tm = tlora.create_model(NAME, device="cpu", seed=3, **SMALL, **LORA)
    base = tfimm_tpu_torch.create_model(NAME, device="cpu", seed=3, **SMALL)
    assert isinstance(tm, tlora.LoRAConvNeXt) and not tm.training
    sd, base_sd = tm.state_dict(), base.state_dict()
    assert set(sd) - set(base_sd) == {
        k for k in sd if k.rpartition(".")[2] in tlora.LORA_WEIGHT_NAMES}
    for k, v in base_sd.items():
        assert torch.equal(sd[k], v), k
    with torch.no_grad():   # seeded gammas near 1, so the MLPs count
        for block in [b for s in tm.stages for b in s.blocks] + [
                b for s in base.stages for b in s.blocks]:
            block.gamma.fill_(1.0)
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(4))
    assert torch.equal(tm.predict(x), base.predict(x))
    assert tm.cfg.lora_rank == 2 and tm.cfg.lora_alpha == 4.0
    with pytest.raises(ValueError):
        tlora.lora_architecture(int)
    assert tlora.lora_architecture(ConvNeXt) is tlora.LoRAConvNeXt
    assert tlora.lora_base_architecture(tlora.LoRAConvNeXt) is ConvNeXt
    assert tlora.lora_config(ConvNeXt) is tlora.LoRAConvNeXtConfig


def test_merge_and_convert_to_regular_match_jax(pair):
    jm, params, tm, x = pair
    jm.params = params
    want = state_dict_from_jax(jlora.merge_lora_weights(jm))
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    got = tlora.merge_lora_weights(tm)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-6,
                                   err_msg=k)
    for k, v in tm.state_dict().items():   # the model is unchanged
        assert torch.equal(v, before[k])
    regular = tlora.convert_to_regular_model(tm)
    jregular = jlora.convert_to_regular_model(jm)
    assert type(regular) is ConvNeXt and type(jregular).__name__ == "ConvNeXt"
    assert set(regular.state_dict()) == set(
        state_dict_from_jax(jregular.params))
    got = regular.predict(torch.from_numpy(x))
    assert _rel(got, jregular(jnp.asarray(x))) < 1e-4
    assert _rel(got, tm.predict(torch.from_numpy(x))) < 1e-5
    assert all(p.device.type == "cpu" for p in regular.parameters())


def test_convert_to_lora_model_matches_jax():
    jbase = tfimm_tpu.create_model(NAME, **SMALL)
    jbase.params = _seeded(jbase.params, 5)
    base = tfimm_tpu_torch.create_model(NAME, device="cpu", **SMALL)
    base.load_state_dict(state_dict_from_jax(jbase.params))
    jm = jlora.convert_to_lora_model(jbase, lora_rank=2)
    tm = tlora.convert_to_lora_model(base, lora_rank=2)
    assert isinstance(tm, tlora.LoRAConvNeXt) and tm.cfg.lora_rank == 2
    assert set(tm.state_dict()) == set(state_dict_from_jax(jm.params))
    x = np.random.default_rng(6).normal(size=(2, 32, 32, 3)).astype(np.float32)
    got = tm.predict(torch.from_numpy(x))
    assert _rel(got, jm(jnp.asarray(x))) < 1e-4
    assert torch.equal(got, base.predict(torch.from_numpy(x)))


@pytest.mark.parametrize("train_bias,layers", [
    ("none", None), ("all", None), ("lora_only", None), ("none", ["stem"]),
    ("lora_only", ["stem", "head.fc"])])
def test_trainable_lists_match_jax(pair, train_bias, layers):
    jm, _, tm, _ = pair
    for fn in ("lora_trainable_weights", "lora_non_trainable_weights"):
        want = sorted(_port_name(p) for p in getattr(jlora, fn)(
            jm, train_bias=train_bias, trainable_layers=layers))
        assert getattr(tlora, fn)(tm, train_bias=train_bias,
                                  trainable_layers=layers) == want
    mask = tlora.lora_trainable_mask(tm, train_bias, layers)
    jmask = flatten_params(jlora.lora_trainable_mask(jm, train_bias, layers))
    assert mask == {_port_name(k): bool(v) for k, v in jmask.items()}
    assert tm.trainable_weights == sorted(
        _port_name(p) for p in jm.trainable_weights)
    assert tm.non_trainable_weights == sorted(
        _port_name(p) for p in jm.non_trainable_weights)
    with pytest.raises(ValueError):
        tlora.lora_trainable_weights(tm, train_bias="some")


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_lora_optimizer_step_matches_optax(pair, optimizer):
    """One step on a seeded batch: the trainable parameters within 1e-5 of
    optax's, the frozen ones bit for bit unchanged (no update, no weight
    decay). eps 1e-3 keeps Adam's first step off sign(g) for tiny g."""
    jm, params, _, x = pair
    if optimizer == "sgd":
        tx, make = optax.sgd(0.1), functools.partial(torch.optim.SGD, lr=0.1)
    else:
        tx = optax.adamw(1e-2, eps=1e-3, weight_decay=0.05)
        make = functools.partial(torch.optim.AdamW, lr=1e-2, eps=1e-3,
                                 weight_decay=0.05)
    labels = np.array([0, 5])
    jtx = jlora.lora_optimizer(tx, jm, train_bias="lora_only")

    def loss_fn(p):
        logits = jm.apply(p, jnp.asarray(x), training=False)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(labels)).mean()

    grads = jax.grad(loss_fn)(params)
    updates, _ = jtx.update(grads, jtx.init(params), params)
    want = state_dict_from_jax(optax.apply_updates(params, updates))

    tm = tlora.create_model(NAME, device="cpu", **SMALL, **LORA)
    tm.load_state_dict(state_dict_from_jax(params))
    before = {k: v.detach().clone() for k, v in tm.named_parameters()}
    opt = tlora.lora_optimizer(make, tm, train_bias="lora_only")
    trainable = set(tlora.lora_trainable_weights(tm, train_bias="lora_only"))
    assert {id(p) for g in opt.param_groups for p in g["params"]} == {
        id(p) for k, p in tm.named_parameters() if k in trainable}
    loss = torch.nn.functional.cross_entropy(tm(torch.from_numpy(x)),
                                             torch.from_numpy(labels))
    loss.backward()
    opt.step()
    assert abs(loss.item() - float(loss_fn(params))) < 1e-5
    for k, p in tm.named_parameters():
        if k in trainable:
            assert p.requires_grad
            np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                       atol=1e-5, err_msg=k)
            assert not torch.equal(p, before[k]), k
        else:
            assert not p.requires_grad and p.grad is None
            assert torch.equal(p, before[k]), k
