"""Port parity for ResNet and the ops it brings: tfimm_tpu_torch against the
JAX package on the CPU.

Both packages get the same numpy inputs and parameters, made from a seed:
every conv and Dense kernel normal with He's std sqrt(2 / fan in), every
norm scale near 1 (``zero_init_last_bn`` would make every block the
identity and any block pass), running variances in [1, 1.5], the rest
at std 0.1. The port loads them with ``state_dict_from_jax``. The JAX model
is built without its eager initialiser (``jax.eval_shape`` gives the tree)
and runs under ``jax.jit``. Bars, as max|diff| / max|JAX|: 1e-5 for one
op in f32 and 2e-2 in bf16; 1e-3 for a model in f32 (every captured
feature, the logits, the gradients) and 5e-2 in bf16; the goldens 1e-3.
A gradient parts where a ReLU input or a max-pool pair sits within f32
rounding of its kink in one package and not the other (a ResNet-RS stem
at 80x80 here: 6e-3 in one stem weight, the JAX package nearer float64);
the variants held below give 1e-5 at 1, 2 and 4 threads.

The helpers ``jax_pair``, ``jitted`` and ``rel`` serve
``test_torch_vgg_convmixer.py`` and ``test_torch_pit.py`` too.
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

import tfimm_tpu
import tfimm_tpu.train as jtrain
import tfimm_tpu_torch
import tfimm_tpu_torch.train as ttrain
from tfimm_tpu.models import registry as jax_registry
from tfimm_tpu.ops import classifier as jcls
from tfimm_tpu.ops import conv as jconv
from tfimm_tpu.ops import norm as jnorm
from tfimm_tpu.ops import pool as jpool
from tfimm_tpu.ops import se as jse
from tfimm_tpu.utils.tree import flatten_params
from tfimm_tpu_torch.models import registry as torch_registry
from tfimm_tpu_torch.ops import classifier as tcls
from tfimm_tpu_torch.ops import pool as tpool
from tfimm_tpu_torch.ops import se as tse
from tfimm_tpu_torch.ops.conv import Conv2d
from tfimm_tpu_torch.ops.kernels.dispatch import capture_dispatches
from tfimm_tpu_torch.ops.norm import Affine, Identity, norm_layer_factory
from tfimm_tpu_torch.parallel.step import make_eval_step
from tfimm_tpu_torch.utils.convert import jax_from_state_dict, state_dict_from_jax
from tfimm_tpu_torch.utils.etc import make_divisible

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "golden")


# -- helpers ---------------------------------------------------------------------

def rel(got, want):
    """max|got - want| / max|want|, both as float32 numpy."""
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    got = np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def seeded(tree, seed):
    """Numpy parameters of ``tree``'s shapes, drawn from ``seed`` (see the
    module's docstring), as a tree of jnp arrays."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(tree)
    out = []
    for path, leaf in leaves:
        shape = tuple(leaf.shape)
        r = rng.normal(size=shape).astype(np.float32)
        key = getattr(path[-1], "key", None)
        if key == "kernel":
            v = r * np.sqrt(2.0 / max(int(np.prod(shape[:-1])), 1))
        elif key == "scale" or str(key).startswith("layer_scale"):
            v = 1.0 + 0.1 * r
        elif key == "var":
            v = 1.0 + 0.5 * rng.uniform(size=shape).astype(np.float32)
        else:
            v = 0.1 * r
        out.append(jnp.asarray(v))
    return jax.tree_util.tree_unflatten(treedef, out)


def jax_pair(name, seed=0, **kw):
    """The JAX model ``name`` with config overrides ``kw`` holding seeded
    parameters, those parameters, and the port's model holding them."""
    cfg = dataclasses.replace(jax_registry.model_config(name), **kw)
    jm = jax_registry.model_class(name)(cfg)
    params = seeded(jax.eval_shape(jm.init_params, jax.random.PRNGKey(0)),
                    seed)
    jm.params = params
    tm = tfimm_tpu_torch.create_model(name, device="cpu", **kw)
    tm.load_state_dict(state_dict_from_jax(params))   # strict: names match
    return jm, params, tm


@functools.lru_cache(maxsize=None)
def _jit_apply(jm, training, return_features):
    return jax.jit(functools.partial(jm.apply, training=training,
                                     return_features=return_features))


def jitted(jm, params, x, training=False, return_features=False):
    return _jit_apply(jm, training, return_features)(params, x)


def images(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


def check_model(jm, params, tm, x, bar=1e-3):
    """f32 logits and every captured feature of both models within ``bar``;
    the port launches nothing."""
    want, want_feats = jitted(jm, params, jnp.asarray(x), return_features=True)
    with torch.inference_mode(), capture_dispatches() as seen:
        got, got_feats = tm(torch.from_numpy(x), return_features=True)
    assert list(got_feats) == list(tm.feature_names) == list(jm.feature_names)
    assert np.abs(np.asarray(want)).max() > 0
    assert rel(got, want) < bar
    for name in tm.feature_names:
        assert rel(got_feats[name], want_feats[name]) < bar, name
    return seen


def check_bf16(jm, params, tm, x, bar=5e-2):
    cast = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), params)
    want = jitted(jm, cast, jnp.asarray(x, jnp.bfloat16))
    got = tm.to(torch.bfloat16).predict(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    assert rel(got, want) < bar


def check_gradients(jm, params, tm, x, bar=1e-3, norm_stats=True):
    """The gradients of sum(logits * w) in training mode (BatchNorm on the
    batch's statistics), every parameter, and with ``norm_stats`` the
    running statistics' update."""
    out_shape = jitted(jm, params, jnp.asarray(x)).shape
    w = images(out_shape, 99)

    def loss(p):
        out, updates = jm.apply(p, jnp.asarray(x), training=True,
                                mutable=True)
        return jnp.sum(out * w), updates

    (_, updates), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    want = state_dict_from_jax(grads)
    tm.train()
    (tm(torch.from_numpy(x)) * torch.from_numpy(w)).sum().backward()
    largest = max(float(g.abs().max()) for g in want.values())
    for name, p in tm.named_parameters():
        if float(want[name].abs().max()) < 1e-5 * largest:
            # A conv bias before a training BatchNorm: its true gradient is
            # 0 (the norm removes the mean), both packages give noise.
            assert float(p.grad.abs().max()) < 1e-5 * largest, name
        else:
            assert rel(p.grad, want[name].numpy()) < bar, name
    stats = state_dict_from_jax(updates)
    assert bool(stats) == norm_stats
    sd = tm.state_dict()
    for name, value in stats.items():
        assert rel(sd[name], value.numpy()) < 1e-5, name


def check_registry(module, count):
    names = tfimm_tpu_torch.list_models(module=module)
    assert names == tfimm_tpu.list_models(module=module)
    assert len(names) == count
    for name in names:
        want = tfimm_tpu.model_config(name)
        got = tfimm_tpu_torch.model_config(name)
        assert type(got).__name__ == type(want).__name__
        assert {f: getattr(got, f) for f in vars(want)} == vars(want), name


def check_golden(fixture):
    data = np.load(os.path.join(GOLDEN, fixture))
    meta = json.loads(bytes(data["meta"]).decode())
    kwargs = {k: tuple(v) if isinstance(v, list) else v
              for k, v in meta["kwargs"].items()}
    sd = {k[len("sd::"):]: torch.from_numpy(data[k]) for k in data.files
          if k.startswith("sd::")}
    model = tfimm_tpu_torch.create_model(meta["model_name"], device="cpu",
                                         **kwargs)
    model.load_state_dict(sd)   # strict: the checkpoint's names as they are
    return model, data


# -- ops -------------------------------------------------------------------------

_CONVS = {
    # name: (in, out, kernel, stride, padding, dilation, groups, H, W)
    "3x3": (8, 12, 3, 1, 1, 1, 1, 9, 7),
    "7x7_s2": (3, 16, 7, 2, 3, 1, 1, 19, 20),
    "1x1_s2": (8, 16, 1, 2, 0, 1, 1, 9, 9),
    "grouped": (16, 32, 3, 2, 1, 1, 4, 11, 8),
    "depthwise_same": (8, 8, 5, 1, "same", 1, 8, 9, 6),
    "same_s2_odd": (4, 8, 3, 2, "same", 1, 1, 9, 10),
    "dilated": (4, 6, 3, 1, "symmetric", 2, 1, 12, 12),
    "valid": (8, 16, 7, 1, "valid", 1, 1, 9, 7),
    "pit_pool": (8, 16, 3, 2, 1, 1, 8, 7, 7),
}


@pytest.mark.parametrize("case", sorted(_CONVS))
def test_conv2d_matches_jax(case):
    cin, cout, k, s, pad, dil, groups, h, w = _CONVS[case]
    jl = jconv.Conv2d(cin, cout, k, stride=s, padding=pad, dilation=dil,
                      groups=groups)
    p = seeded(jax.eval_shape(jl.init, jax.random.PRNGKey(0)), 1)
    tl = Conv2d(cin, cout, k, stride=s, padding=pad, dilation=dil,
                groups=groups)
    assert not tl.patchify
    tl.load_state_dict(state_dict_from_jax(p))
    x = images((2, h, w, cin), 2)
    for dtype, bar in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
        got = tl(torch.from_numpy(x).to(dtype))
        want = jl(p, jnp.asarray(x, jdtype))
        assert got.dtype == dtype and got.is_contiguous()
        assert rel(got, want) < bar, dtype


def test_conv2d_patchify_route_is_kept():
    """Stride = kernel, no padding: the reshape into F.linear, as before
    (ViT's, ConvNeXt's and ConvMixer's stems, the 1x1 convs)."""
    for k in (1, 4, (7, 7)):
        tl = Conv2d(3, 8, k)
        assert tl.patchify
        jl = jconv.Conv2d(3, 8, k, stride=k, padding="valid")
        p = seeded(jax.eval_shape(jl.init, jax.random.PRNGKey(0)), 3)
        tl.load_state_dict(state_dict_from_jax(p))
        x = images((2, 15, 14, 3), 4)
        assert rel(tl(torch.from_numpy(x)), jl(p, jnp.asarray(x))) < 1e-5


def test_pools_match_jax():
    x = images((2, 9, 7, 6), 5)
    for window, stride, pad in ((2, 2, "SAME"), (2, 2, "VALID"),
                                (3, 2, "SAME"), (3, 1, "SAME")):
        assert rel(tpool.avg_pool_2d(torch.from_numpy(x), window, stride, pad),
                   jpool.avg_pool_2d(jnp.asarray(x), window, stride, pad)) < 1e-6
        assert rel(tpool.max_pool_2d(torch.from_numpy(x), window, stride, pad),
                   jpool.max_pool_2d(jnp.asarray(x), window, stride, pad)) == 0
    # The average pool counts the pads in its divisor (the JAX function's
    # rule, not timm's): the last row of a 9-row map is half a window.
    got = tpool.avg_pool_2d(torch.ones(1, 9, 9, 1), 2, 2, "SAME")
    assert float(got[0, -1, 0, 0]) == 0.5


@pytest.mark.parametrize("size", [(8, 8), (9, 7)])
def test_blur_pool_matches_jax(size):
    x = images((2, *size, 6), 6)
    tl = tpool.BlurPool2d(6, stride=2)
    assert tl.state_dict() == {}   # the kernel is no state-dict key
    for dtype, bar in ((torch.float32, 1e-6), (torch.bfloat16, 1e-2)):
        jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
        got = tl.to(dtype)(torch.from_numpy(x).to(dtype))
        assert rel(got, jpool.BlurPool2d(6, stride=2)({}, jnp.asarray(x, jdtype))) < bar


@pytest.mark.parametrize("kind", ["se", "eca"])
def test_channel_attention_matches_jax(kind):
    c = 64 if kind == "se" else 200   # ECA: kernel 5 from log2(200)
    jl = (jse.SEModule(c, rd_ratio=0.25) if kind == "se"
          else jse.EcaModule(c))
    tl = (tse.SEModule(c, rd_ratio=0.25) if kind == "se"
          else tse.EcaModule(c))
    if kind == "eca":
        assert jl.kernel_size == 5 and tuple(tl.conv.weight.shape) == (1, 1, 5)
    else:
        assert tuple(tl.fc1.weight.shape) == (16, 64, 1, 1)
    p = seeded(jax.eval_shape(jl.init, jax.random.PRNGKey(0)), 7)
    tl.load_state_dict(state_dict_from_jax(p))
    x = images((2, 5, 6, c), 8)
    assert rel(tl(torch.from_numpy(x)), jl(p, jnp.asarray(x))) < 1e-5
    back = jax_from_state_dict(tl)
    assert set(back) == set(flatten_params(p))
    for key, value in flatten_params(p).items():
        np.testing.assert_array_equal(back[key], np.asarray(value))
    assert tse.attn_layer_factory("")(c) is None


def test_make_divisible_matches_jax():
    from tfimm_tpu.utils.etc import make_divisible as jax_make_divisible

    for value in (3.0, 7.9, 16.0, 23.5, 100.0, 1000.0 / 3):
        for divisor in (1, 4, 8):
            for limit in (0.0, 0.9):
                assert (make_divisible(value, divisor, round_limit=limit)
                        == jax_make_divisible(value, divisor, round_limit=limit))


def test_affine_identity_and_head_match_jax():
    x = images((2, 3, 4, 10), 9)
    p = {"scale": jnp.asarray(images((10,), 10) + 1.0),
         "bias": jnp.asarray(images((10,), 11))}
    tl = norm_layer_factory("affine")(10)
    assert isinstance(tl, Affine)
    tl.load_state_dict(state_dict_from_jax(p))
    assert rel(tl(torch.from_numpy(x)), jnorm.Affine(10)(p, jnp.asarray(x))) < 1e-6
    assert set(jax_from_state_dict(tl)) == {"scale", "bias"}
    ident = norm_layer_factory("")(10)
    assert isinstance(ident, Identity) and ident(torch.ones(2)).tolist() == [1, 1]
    for pool in ("avg", "max", ""):
        jh = jcls.ClassifierHead(7, 10, pool_type=pool)
        hp = seeded(jax.eval_shape(jh.init, jax.random.PRNGKey(0)), 12)
        th = tcls.ClassifierHead(7, 10, pool_type=pool)
        th.load_state_dict(state_dict_from_jax(hp))
        xin = x if pool else x[:, 0, 0]
        assert rel(th(torch.from_numpy(xin)), jh(hp, jnp.asarray(xin))) < 1e-5
    assert tcls.ClassifierHead(0, 10)(torch.from_numpy(x)).shape == (2, 10)


# -- the family ------------------------------------------------------------------

_SMALL = dict(input_size=(48, 48), nb_blocks=(1, 1, 1, 1),
              nb_channels=(8, 8, 16, 16), nb_classes=7)
_RESNETS = {
    # variant: (registered name, overrides)
    "basic": ("resnet18", dict(_SMALL, nb_blocks=(2, 1, 1, 1))),
    # The deep stem and the average-pool shortcut; at 80x80 stage 4 comes
    # from a 5x5 map, where the SAME pool's divisor counts the pad.
    "deep_avg_odd": ("resnet50d", dict(_SMALL, input_size=(80, 80))),
    "tiered": ("resnet26t", dict(_SMALL)),
    "blur": ("resnetblur50", dict(_SMALL)),
    "se_resnext": ("seresnext26t_32x4d",
                   dict(_SMALL, nb_channels=(32, 32, 64, 64), cardinality=8)),
    "eca": ("ecaresnet50d", dict(_SMALL)),
    "rs_stem_pool": ("resnetrs50", dict(_SMALL)),
    "group_norm": ("resnet50_gn", dict(_SMALL, nb_channels=(32, 32, 32, 32))),
}


@pytest.mark.parametrize("variant", sorted(_RESNETS))
def test_small_resnet_matches_jax(variant):
    name, kw = _RESNETS[variant]
    jm, params, tm = jax_pair(name, seed=1, **kw)
    x = images((2, *kw["input_size"], 3), 2)
    assert check_model(jm, params, tm, x) == set()


@pytest.mark.parametrize("variant", ["deep_avg_odd", "se_resnext"])
def test_small_resnet_bf16_matches_jax(variant):
    name, kw = _RESNETS[variant]
    jm, params, tm = jax_pair(name, seed=3, **kw)
    check_bf16(jm, params, tm, images((2, *kw["input_size"], 3), 4))


@pytest.mark.parametrize("variant", ["deep_avg_odd", "eca", "basic"])
def test_small_resnet_gradients_match_jax(variant):
    name, kw = _RESNETS[variant]
    jm, params, tm = jax_pair(name, seed=5, **kw)
    check_gradients(jm, params, tm, images((4, *kw["input_size"], 3), 6))


def test_state_dict_follows_timm_and_round_trips():
    name, kw = _RESNETS["deep_avg_odd"]
    jm, params, tm = jax_pair(name, seed=7, **kw)
    sd = tm.state_dict()
    for key in ("conv1.0.weight", "conv1.4.running_var", "conv1.6.weight",
                "layer2.0.downsample.1.weight", "layer2.0.downsample.2.bias",
                "layer1.0.bn3.weight", "fc.weight"):
        assert key in sd, key
    back = jax_from_state_dict(tm)
    flat = flatten_params(params)
    assert set(back) == set(flat)
    for key, value in flat.items():
        np.testing.assert_array_equal(back[key], np.asarray(value))
    # A timm state dict carries num_batches_tracked: dropped on load.
    sd = {k: v.clone() for k, v in sd.items()}
    sd["bn1.num_batches_tracked"] = torch.tensor(5)
    tm.load_state_dict(sd)


def test_zero_init_last_bn_and_eca_weight():
    tm = tfimm_tpu_torch.create_model("ecaresnet50d", device="cpu", **_SMALL)
    block = tm.layer1[0]
    assert torch.all(block.bn3.weight == 0) and torch.all(block.bn2.weight == 1)
    assert tuple(block.se.conv.weight.shape) == (1, 1, 3)
    gn = tfimm_tpu_torch.create_model("resnet50_gn", device="cpu",
                                      **dict(_SMALL, nb_channels=(32,) * 4))
    assert torch.all(gn.layer1[0].bn3.weight == 0)


def test_golden_resnet():
    model, data = check_golden("hf_resnet.npz")
    assert rel(model.predict(torch.from_numpy(data["input"])), data["output"]) < 1e-3


def test_registry_matches_jax():
    check_registry("resnet", 60)
    # Every variant builds at its full widths (one block a stage, 64x64).
    for name in tfimm_tpu_torch.list_models(module="resnet"):
        model = tfimm_tpu_torch.create_model(
            name, device="cpu", input_size=(64, 64), nb_blocks=(1, 1, 1, 1))
        out = model.predict(torch.zeros(1, 64, 64, 3))
        assert out.shape == (1, 1000), name


# -- training: run(), the running statistics, the EMA ------------------------------

TRAIN_NAME = "train_parity_resnet"
# 64x64: stage 4 normalises over 2x2 maps. At 32x32 its 1x1 maps give
# BatchNorm four values a channel at batch 4, and the two packages' f32
# roundings of that variance part by 3e-5 in the third step's loss.
TRAIN_SMALL = dict(input_size=(64, 64), nb_blocks=(1, 1, 1, 1),
                   nb_channels=(8, 8, 16, 16), nb_classes=7, block="bottleneck",
                   attn_layer="eca", stem_type="deep", stem_width=8,
                   downsample_mode="avg")


# At lr 0.05 the third step's stem weights part by 7e-4 between the
# packages: some max-pool windows and ReLUs sit on near-ties, whose sides
# f32 roundings of 1e-6 pick differently (the gradients at the same
# parameters agree to 2e-6). At 0.01 and 0.02 every leaf agrees to 2e-6.
LR = 0.01


@pytest.fixture
def small_resnet(monkeypatch):
    """A small ECA-ResNet-D under TRAIN_NAME in both model registries, for
    one test."""
    for reg, name in ((jax_registry, "resnet50d"), (torch_registry, "resnet50d")):
        monkeypatch.setitem(reg._model_class, TRAIN_NAME, reg.model_class(name))
        monkeypatch.setitem(reg._model_config, TRAIN_NAME, dataclasses.replace(
            reg.model_config(name), name=TRAIN_NAME, **TRAIN_SMALL))
    return TRAIN_NAME


def _train_problems(ema_decay, seed, lr=LR):
    """Both classification problems (SGD with momentum, L2 weight decay),
    holding the same seeded parameters and statistics."""
    cfgs = []
    for pkg in (jtrain, ttrain):
        opt = pkg.OptimizerConfig(
            optimizer="sgd", lr_schedule_class="LRConstFactory",
            lr_schedule=pkg.get_cfg_class("LRConstConfig")(lr=lr))
        cfgs.append(pkg.ClassificationConfig(
            model=pkg.ModelConfig(model_name=TRAIN_NAME),
            model_class="ModelFactory", optimizer=opt,
            optimizer_class="OptimizerFactory", weight_decay=1e-3,
            ema_decay=ema_decay))
    tk = dict(nb_epochs=1, batch_size=4, nb_samples_per_epoch=12)
    jp = jtrain.ClassificationProblem(cfgs[0], timekeeping=jtrain.Timekeeping(**tk))
    params = seeded(jp.params, seed)
    jp.params = jp.model.params = params
    jp.opt_state = jp.tx.init(params)
    if ema_decay:
        jp.ema_params = params
    tp = ttrain.ClassificationProblem(cfgs[1], timekeeping=ttrain.Timekeeping(**tk),
                                      device="cpu")
    tp.set_state({"params": state_dict_from_jax(params)}, model_only=True)
    return jp, tp


def _batches(seed, nb):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(0, 255, size=(4, 64, 64, 3)).astype(np.float32),
             rng.integers(0, 7, size=(4,))) for _ in range(nb)]


def test_train_steps_match_jax_with_running_statistics(small_resnet):
    """Three SGD steps: the losses (1e-5), then every parameter and running
    statistic (1e-4); BatchNorm's statistics are written in place by the
    port's forward where the JAX step merges its updates after the
    optimizer (``merge_state_updates``), to the same values."""
    jp, tp = _train_problems(0.0, seed=1)
    start = dict(tp.model.state_dict())
    start = {k: v.clone() for k, v in start.items()}
    for it, batch in enumerate(_batches(2, 3)):
        want, _ = jp.train_step(batch, it)
        got, _ = tp.train_step(batch, it)
        assert rel(got, want) < 1e-5, it
    want = state_dict_from_jax(jp.params)
    got = tp.model.state_dict()
    assert set(got) == set(want)
    for name, value in got.items():
        assert rel(value, want[name].numpy()) < 1e-4, name
    moved = [k for k in got if k.endswith("running_var")
             and not torch.equal(got[k], start[k])]
    assert len(moved) == sum(k.endswith("running_var") for k in got)
    # The eval step: running statistics, no gradient, as the JAX one.
    x = tp.preprocessing(torch.from_numpy(_batches(3, 1)[0][0]))
    logits = make_eval_step(tp.model)(x)
    assert not tp.model.training and not logits.requires_grad
    ref = jp._eval_step(jp.params, jnp.asarray(_batches(3, 1)[0][0]))
    assert rel(logits, ref) < 1e-4


def test_ema_holds_the_running_statistics(small_resnet):
    """With ``ema_decay``, the JAX package averages BatchNorm's mean and var
    with the parameters and validates on the averages; the port likewise:
    after three steps the averaged statistics, the validation logits and
    the accuracy agree, and they are not the live statistics'."""
    jp, tp = _train_problems(0.5, seed=3)
    batches = _batches(4, 3)
    for it, batch in enumerate(batches):
        jp.train_step(batch, it)
        tp.train_step(batch, it)
    want = state_dict_from_jax(jp.ema_params)
    assert set(tp.ema_params) == set(want)
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert stats
    for name in want:
        assert rel(tp.ema_params[name], want[name].numpy()) < 1e-4, name
    live = tp.model.state_dict()
    assert any(not torch.allclose(tp.ema_params[k], live[k]) for k in stats)
    images_, labels = batches[0]
    x = tp.preprocessing(torch.from_numpy(images_))
    tp.model.eval()
    with torch.no_grad():
        got = functional_call(tp.model, tp.ema_params, (x,))
    ref = jp._eval_step(jp.ema_params, jnp.asarray(images_))
    assert rel(got, ref) < 1e-4
    assert tp.validation([(images_, labels)]) == jp.validation([(images_, labels)])
    # set_state keeps the averaged statistics.
    state = tp.state
    tp.set_state(state)
    for k in stats:
        assert torch.equal(tp.ema_params[k], state["ema_params"][k])


def test_run_trains_resnet_step_for_step_with_jax(small_resnet, monkeypatch):
    """run() from the same config dict in both packages: the same per-step
    losses and validation accuracies through the training statistics and
    the running ones. The port starts from the JAX model's parameters."""
    jm = jtrain.ModelFactory(jtrain.ModelConfig(model_name=TRAIN_NAME))()[0]
    init = state_dict_from_jax(seeded(jm.params, 9))
    make = ttrain.ModelFactory.__call__
    jmake = jtrain.ModelFactory.__call__

    def make_with_init(self, device):
        model, pp = make(self, device)
        model.load_state_dict(init)
        return model, pp

    def jmake_with_init(self):
        model, pp = jmake(self)
        model.params = seeded(model.params, 9)
        return model, pp

    monkeypatch.setattr(ttrain.ModelFactory, "__call__", make_with_init)
    monkeypatch.setattr(jtrain.ModelFactory, "__call__", jmake_with_init)
    seen = {"jax": [], "torch": []}
    for key, pkg in (("jax", jtrain), ("torch", ttrain)):
        cls = pkg.ClassificationProblem

        def record(method, key=key):
            def wrapped(self, *args):
                out = method(self, *args)
                seen[key].append(out[0] if isinstance(out, tuple) else out)
                return out
            return wrapped

        monkeypatch.setattr(cls, "train_step", record(cls.train_step))
        monkeypatch.setattr(cls, "validation", record(cls.validation))
    data = {"batch_size": 4, "nb_samples": 8, "input_size": (64, 64),
            "nb_classes": 7, "seed": 1}
    cfg = {
        "trainer_class": "Trainer",
        "trainer": {"validation_before_training": True,
                    "display_loss_every_it": 1},
        "problem_class": "ClassificationProblem",
        "problem": {"model_class": "ModelFactory",
                    "model": {"model_name": TRAIN_NAME},
                    "optimizer_class": "OptimizerFactory",
                    "optimizer": {"optimizer": "sgd", "lr_warmup": 1,
                                  "lr_schedule_class": "LRCosineDecayFactory",
                                  "lr_schedule": {"lr": 0.05}},
                    "weight_decay": 1e-4, "ema_decay": 0.9},
        "train_dataset_class": "SyntheticDataset", "train_dataset": data,
        "val_dataset_class": "SyntheticDataset", "val_dataset": data,
        "timekeeping_class": "Timekeeping",
        "timekeeping": {"nb_epochs": 3, "batch_size": 4,
                        "nb_samples_per_epoch": 8},
    }
    jtrain.run(cfg, parse_cmdline_args=False)
    with capture_dispatches() as port_seen:
        ttrain.run(dict(cfg, device="cpu"), parse_cmdline_args=False)
    assert port_seen == set()
    assert len(seen["torch"]) == len(seen["jax"]) == 6 + 4
    for got, want in zip(seen["torch"], seen["jax"]):
        if isinstance(want, dict):
            assert got == want
        else:
            assert rel(got, want) < 1e-5
