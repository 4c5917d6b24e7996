"""Port parity for the EfficientNet family (MobileNetV2, EfficientNet
B0-B8/L2, Edge-TPU, Lite, V2) and the ops it brings: tfimm_tpu_torch
against the JAX package on the CPU.

Parameters and inputs are made from a seed as in ``test_torch_resnet.py``
(He-scaled kernels, norm scales near 1, running variances in [1, 1.5]) and
carried by ``state_dict_from_jax``. Bars, as max|diff| / max|JAX|: 1e-5 for
one op or block in f32 and 2e-2 in bf16; 1e-3 for a small model in f32
(every captured feature, the logits, the training-mode gradients) and
5e-2 in bf16; the golden 1e-3. The small models are the golden's cut:
channels x0.25, depth x0.5, 64x64, stem 8, 320 features.
"""

import dataclasses
import itertools
from copy import deepcopy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfimm_tpu
import tfimm_tpu_torch
from tfimm_tpu.architectures import efficientnet_blocks as jblocks
from tfimm_tpu.architectures import efficientnet_builder as jbuilder
from tfimm_tpu.models import registry as jax_registry
from tfimm_tpu.ops import basic as jbasic
from tfimm_tpu.ops import conv as jconv
from tfimm_tpu.utils.tree import flatten_params
from tfimm_tpu_torch.architectures import efficientnet_blocks as tblocks
from tfimm_tpu_torch.architectures import efficientnet_builder as tbuilder
from tfimm_tpu_torch.models import registry as torch_registry
from tfimm_tpu_torch.ops.basic import act_layer_factory
from tfimm_tpu_torch.ops.conv import Conv2d
from tfimm_tpu_torch.utils import convert
from tfimm_tpu_torch.utils.convert import jax_from_state_dict, state_dict_from_jax
from tests.test_torch_resnet import (
    check_bf16,
    check_golden,
    check_gradients,
    check_model,
    check_registry,
    images,
    jax_pair,
    rel,
    seeded,
)

torch.set_num_threads(2)


# -- ops -------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["swish", "silu", "relu6", "sigmoid", "relu"])
def test_activations_match_jax(name):
    # Values around both of ReLU6's kinks and beyond.
    x = 4.0 * images((3, 50), 1)
    for dtype, bar in ((torch.float32, 1e-6), (torch.bfloat16, 1e-2)):
        jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
        got = act_layer_factory(name)(torch.from_numpy(x).to(dtype))
        want = jbasic.act_layer_factory(name)(jnp.asarray(x, jdtype))
        assert got.dtype == dtype
        assert rel(got, want) < bar, dtype
    if name == "relu6":
        assert float(act_layer_factory(name)(torch.tensor(9.0))) == 6.0


def test_fanout_init_and_the_depthwise_round_trip():
    """``fanout_init``: normal with std sqrt(2 / (kh kw out / groups)), as
    the JAX ``FanoutInitializer``; a depthwise kernel (kh, kw, 1, C) is
    (C, 1, kh, kw) in the port and goes back unchanged."""
    g = torch.Generator().manual_seed(0)
    for cin, cout, k, groups in ((64, 256, 3, 1), (512, 512, 5, 512),
                                 (96, 192, 3, 4)):
        conv = Conv2d(cin, cout, k, stride=1, groups=groups, use_bias=False,
                      fanout_init=True, generator=g)
        std = float(conv.weight.detach().std())
        assert abs(std / np.sqrt(2.0 / (k * k * cout // groups)) - 1) < 0.05
    jl = jconv.DepthwiseConv2d(24, 5, stride=2, padding="same",
                               use_bias=False)
    p = seeded(jax.eval_shape(jl.init, jax.random.PRNGKey(0)), 2)
    assert p["kernel"].shape == (5, 5, 1, 24)
    tl = tblocks.create_conv2d(24, kernel_size=5, strides=2, padding="same",
                               depthwise=True)
    tl.load_state_dict(state_dict_from_jax(p))
    assert tuple(tl.weight.shape) == (24, 1, 5, 5) and tl.bias is None
    back = jax_from_state_dict(tl)
    assert set(back) == {"kernel"}
    np.testing.assert_array_equal(back["kernel"], np.asarray(p["kernel"]))
    x = images((2, 10, 9, 24), 3)
    for dtype, bar in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
        got = tl.to(dtype)(torch.from_numpy(x).to(dtype))
        assert got.is_contiguous()
        assert rel(got, jl(p, jnp.asarray(x, jdtype))) < bar


def test_same_padding_at_stride_one_is_resolved():
    """SAME at stride 1 pads d (k - 1) whatever the map: a 1x1 conv takes
    the reshape route into F.linear, a 3x3 pads (1, 1), an even kernel
    stays SAME (its pads are uneven); each matches the JAX conv."""
    cases = ((1, 1, (0, 0), True), (3, 1, (1, 1), False),
             (3, 2, (2, 2), False), (2, 1, "same", False))
    for k, dil, pads, patchify in cases:
        tl = Conv2d(8, 12, k, stride=1, padding="same", dilation=dil)
        assert tl.padding == pads and tl.patchify == patchify
        jl = jconv.Conv2d(8, 12, k, stride=1, padding="same", dilation=dil)
        p = seeded(jax.eval_shape(jl.init, jax.random.PRNGKey(0)), 4)
        tl.load_state_dict(state_dict_from_jax(p))
        x = images((2, 7, 6, 8), 5)
        assert rel(tl(torch.from_numpy(x)), jl(p, jnp.asarray(x))) < 1e-5


# -- the blocks ------------------------------------------------------------------

_BLOCKS = {
    # name: (block string, in channels, activation)
    "conv_bn_act": ("cn_r1_k3_s{s}_e1_c16_skip", 16, "swish"),
    "ds_se": ("ds_r1_k3_s{s}_e1_c16_se0.25", 16, "swish"),
    "ds_relu6": ("ds_r1_k3_s{s}_c24", 24, "relu6"),
    "dsa_pw_act": ("dsa_r1_k5_s{s}_c16", 16, "relu"),
    "ir_se_k5": ("ir_r1_k5_s{s}_e6_c16_se0.25", 16, "swish"),
    "ir_k3_widen": ("ir_r1_k3_s{s}_e4_c24", 16, "relu6"),
    "er_se": ("er_r1_k3_s{s}_e4_c16_se0.25", 16, "swish"),
    "er_fc": ("er_r1_k3_s{s}_e4_c24_fc24_noskip", 16, "relu"),
}


@pytest.mark.parametrize("padding", ["same", "symmetric"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("block", sorted(_BLOCKS))
def test_block_matches_jax(block, stride, padding):
    """Each block type at stride 1 (with its skip where the widths allow)
    and 2, TF SAME (a 10x9 map: pads (0, 1) on H at stride 2) and
    symmetric padding, built by both builders from one block string."""
    string, cin, act = _BLOCKS[block]
    ba = jbuilder.BlockArgs.decode(string.format(s=stride))
    kw = dict(padding=padding, act_layer=act,
              norm_layer="batch_norm_tf" if padding == "same" else "batch_norm")
    jb = jbuilder.EfficientNetBuilder(**kw)._make_block(deepcopy(ba), cin, 0, 1)
    tba = tblocks.BlockArgs.decode(string.format(s=stride))
    assert dataclasses.asdict(tba) == dataclasses.asdict(ba)
    tb = tbuilder.EfficientNetBuilder(**kw)._make_block(tba, cin, 0, 1, None)
    assert type(tb).__name__ == type(jb).__name__
    assert tb.skip == jb.skip
    p = seeded(jax.eval_shape(jb.init, jax.random.PRNGKey(0)), 6)
    tb.load_state_dict(state_dict_from_jax(p))   # strict: timm's names
    x = images((2, 10, 9, cin), 7)
    for dtype, bar in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
        cast = jax.tree_util.tree_map(lambda a: a.astype(jdtype), p)
        got = tb.to(dtype)(torch.from_numpy(x).to(dtype))
        want = jb(cast, jnp.asarray(x, jdtype))
        assert got.dtype == dtype
        assert rel(got, want) < bar, dtype


def test_squeeze_excite_rounds_as_python():
    """The reduced width is Python's banker's round of C * ratio: 2.5 -> 2,
    3.5 -> 4 (``torch.round`` would agree here, ``int(x + 0.5)`` not)."""
    for channels, ratio, want in ((10, 0.25, 2), (14, 0.25, 4), (96, 0.25 / 6, 4)):
        se = tblocks.SqueezeExcite(channels, rd_ratio=ratio)
        assert se.conv_reduce.out_channels == want
        assert jblocks.SqueezeExcite(channels, rd_ratio=ratio).conv_reduce.out_channels == want


def test_condconv_raises_as_in_jax():
    ba = tblocks.BlockArgs.decode("ir_r1_k3_s1_e6_c16_cc4")
    assert ba.nb_experts == 4
    with pytest.raises(NotImplementedError):
        tbuilder.EfficientNetBuilder(act_layer="swish",
                                     norm_layer="batch_norm")._make_block(
            ba, 16, 0, 1, None)


class _Stub:
    """A block that keeps only the builder's bookkeeping (its width)."""

    def __init__(self, ba, in_channels, **kw):
        self.out_channels = ba.filters


def _built_args(module, cfg, monkeypatch):
    """The BlockArgs of ``cfg`` as ``module`` decodes them, and as its
    builder leaves them after the trunk's walk (widths, strides,
    dilations, SE ratios, drop-path rates), with the trunk's width; the
    blocks themselves are stubs."""
    for cls in ("ConvBnAct", "DepthwiseSeparableConv", "EdgeResidual",
                "InvertedResidual"):
        monkeypatch.setattr(module, cls, _Stub)
    arch = module.decode_architecture(
        cfg.architecture, depth_multiplier=cfg.depth_multiplier,
        fix_first_last=cfg.fix_first_last)
    decoded = [dataclasses.asdict(ba) for stage in arch for ba in stage]
    builder = module.EfficientNetBuilder(
        channel_multiplier=cfg.channel_multiplier, padding=cfg.padding,
        act_layer=cfg.act_layer, norm_layer=cfg.norm_layer,
        drop_path_rate=cfg.drop_path_rate)
    blocks, out = builder(arch, cfg.stem_size)
    built = [dataclasses.asdict(ba) for stage in arch for ba in stage]
    return decoded, built, list(blocks), out


def test_decode_architecture_matches_jax_for_every_config(monkeypatch):
    """Pure Python: the decoded BlockArgs of every registered config, and
    the strides and dilations of the builder's walk, equal the JAX
    package's field for field."""
    names = tfimm_tpu.list_models(module="efficientnet")
    assert len(names) == 61
    for name in names:
        cfg = jax_registry.model_config(name)
        assert (_built_args(tbuilder, cfg, monkeypatch)
                == _built_args(jbuilder, cfg, monkeypatch)), name


def _scaled_depths(module, repeats, multiplier, trunc):
    args = [module.BlockArgs.decode(f"ir_r{r}_k3_s1_e6_c16") for r in repeats]
    return len(module._scale_stage_depth(args, multiplier, trunc))


def test_scale_stage_depth_matches_jax():
    for repeats, multiplier, trunc in itertools.product(
            ((1,), (2, 3), (4, 1, 2)), (0.5, 1.1, 1.8, 2.5, 3.1, 5.3),
            ("ceil", "round")):
        assert (_scaled_depths(tbuilder, repeats, multiplier, trunc)
                == _scaled_depths(jbuilder, repeats, multiplier, trunc))


# -- the family ------------------------------------------------------------------

_SMALL = dict(input_size=(64, 64), stem_size=8, nb_features=320,
              channel_multiplier=0.25, depth_multiplier=0.5, nb_classes=10,
              drop_rate=0.0, drop_path_rate=0.0)
# TF SAME with batch_norm_tf and SE + swish; symmetric PT padding; Lite
# (ReLU6, fixed stem and head depths); Edge-TPU (EdgeResidual with fc,
# ReLU); V2 (ConvBnAct, EdgeResidual, SE); MobileNetV2 (ReLU6, symmetric).
_MODELS = ["efficientnet_b0", "pt_efficientnet_b0", "efficientnet_lite0",
           "efficientnet_es", "efficientnet_v2_s", "mobilenet_v2_100"]


@pytest.mark.parametrize("name", _MODELS)
def test_small_model_matches_jax(name):
    jm, params, tm = jax_pair(name, seed=1, **_SMALL)
    x = images((2, 64, 64, 3), 2)
    assert check_model(jm, params, tm, x) == set()


@pytest.mark.parametrize("name", _MODELS)
def test_small_model_bf16_matches_jax(name):
    jm, params, tm = jax_pair(name, seed=3, **_SMALL)
    check_bf16(jm, params, tm, images((2, 64, 64, 3), 4))


@pytest.mark.parametrize("name", _MODELS)
def test_small_model_gradients_match_jax(name):
    """Training mode (BatchNorm on the batch's statistics, drop rates 0):
    every parameter's gradient and the running statistics' update."""
    jm, params, tm = jax_pair(name, seed=5, **_SMALL)
    check_gradients(jm, params, tm, images((4, 64, 64, 3), 6))


def test_state_dict_follows_timm_and_round_trips():
    jm, params, tm = jax_pair("efficientnet_v2_s", seed=7, **_SMALL)
    sd = tm.state_dict()
    for key in ("conv_stem.weight", "bn1.running_var", "blocks.0.0.conv.weight",
                "blocks.1.0.conv_exp.weight", "blocks.3.0.se.conv_reduce.bias",
                "blocks.3.0.conv_dw.weight", "blocks.3.0.bn3.weight",
                "conv_head.weight", "classifier.weight"):
        assert key in sd, key
    back = jax_from_state_dict(tm)
    flat = flatten_params(params)
    assert set(back) == set(flat)
    for key, value in flat.items():
        np.testing.assert_array_equal(back[key], np.asarray(value))
    assert tm.feature_names == jm.feature_names
    assert "stage_3/block_0" in tm.feature_names


def test_golden_efficientnet():
    model, data = check_golden("hf_efficientnet.npz")
    assert rel(model.predict(torch.from_numpy(data["input"])), data["output"]) < 1e-3


def jax_shapes(model):
    """The JAX parameter paths and shapes of a port model's parameters and
    buffers (``convert``'s rules, on shapes alone)."""
    out = {}
    for prefix, module in model.named_modules():
        tensors = itertools.chain(module.named_parameters(recurse=False),
                                  module.named_buffers(recurse=False))
        for name, t in tensors:
            leaf, perm = convert._jax_leaf(module, name)
            shape = tuple(t.shape)
            if perm is not None:
                shape = tuple(shape[i] for i in perm)
            out[f"{prefix}.{leaf}" if prefix else leaf] = shape
    return out


def check_registry_shapes(module, count, trunk_fields):
    """Every registered variant at its full widths and depths: the port's
    model (built on the meta device, no storage) has the JAX parameter
    tree's paths and shapes. Variants whose configs agree on
    ``trunk_fields`` share one JAX tree (``jax.eval_shape`` of the whole
    init takes seconds for the largest); the classifier's shapes come from
    each variant's own ``nb_classes``."""
    check_registry(module, count)
    trees = {}
    for name in tfimm_tpu_torch.list_models(module=module):
        cfg = jax_registry.model_config(name)
        head = cfg.classifier
        key = tuple(getattr(cfg, f) for f in trunk_fields)
        if key not in trees:
            jm = jax_registry.model_class(name)(cfg)
            trees[key] = {k: tuple(v.shape) for k, v in flatten_params(
                jax.eval_shape(jm.init_params, jax.random.PRNGKey(0))).items()}
        want = dict(trees[key])
        features = want[f"{head}.kernel"][0]
        want.update({f"{head}.kernel": (features, cfg.nb_classes),
                     f"{head}.bias": (cfg.nb_classes,)})
        with torch.device("meta"):
            tm = torch_registry.model_class(name)(
                torch_registry.model_config(name))
        assert jax_shapes(tm) == want, name


def test_registry_matches_jax():
    check_registry_shapes("efficientnet", 61, (
        "architecture", "channel_multiplier", "depth_multiplier",
        "fix_first_last", "stem_size", "nb_features", "in_channels"))
    # A few variants run, at their full widths on a small map.
    for name in ("efficientnet_b3", "efficientnet_lite2", "efficientnet_em",
                 "efficientnet_v2_b1", "mobilenet_v2_110d"):
        model = tfimm_tpu_torch.create_model(name, device="cpu",
                                             input_size=(64, 64))
        assert model.predict(torch.zeros(1, 64, 64, 3)).shape == (1, 1000)
