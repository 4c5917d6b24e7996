"""Port parity for int8 quantization: tfimm_tpu_torch's ``quant.py``, the
int8 ``Dense`` and convs, the kernel gates' int8 checks and the models API
on quantized models, against the JAX package's, on the CPU.

The int8 products equal the JAX package's bit for bit, in f32 and in bf16
(the same roundings in the same order; integer sums are exact in any
order). ``quantize_int8`` converts the same layers with the same int8
weights and float32 scales, for a small model of every ported family and
at full width for ViT-B/16, ConvNeXt-B, Swin-T and ResNet-50.

Through a whole model the two packages differ as their float layers do
(about 1e-7 in f32), and a dynamic quantizer turns such a difference, where
it lands on a rounding boundary, into one quantization step of one
activation: that moves an output row by about 1/127 of its input's range,
and the blocks after it carry the step on (measured on these small models:
up to 4e-2 of the logits in f32 and 7e-2 in bf16, or 0 where no rounding
flips). So a quantized model is held step by step (``stepwise``): the JAX
int8 model runs and records the input of each int8 product; the port runs
with each int8 layer handed the JAX package's input, where its own input
must agree with it within 1e-3 of its largest value in f32 and 5e-2 in
bf16 (``tests/test_golden_parity.py``'s bars), its output must equal the
JAX int8 function's on that input bit for bit, and the logits must agree
within the same bars.
"""

import copy
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfimm_tpu
import tfimm_tpu.architectures.lora as jlora
import tfimm_tpu.architectures.segment_anything  # noqa: F401  (registers SAM)
import tfimm_tpu.quant as jq
import tfimm_tpu_torch
import tfimm_tpu_torch.architectures.lora as tlora
import tfimm_tpu_torch.quant as tq
from tfimm_tpu.models import registry as jax_registry
from tfimm_tpu.utils.tree import flatten_params, tree_cast
from tfimm_tpu_torch.models import registry as torch_registry
from tfimm_tpu_torch.ops.basic import Dense
from tfimm_tpu_torch.ops.conv import Conv2d, StdConv2d
from tfimm_tpu_torch.parallel.step import l2_weights
from tfimm_tpu_torch.utils.convert import jax_from_state_dict, state_dict_from_jax
from tests.test_torch_models_api import SAM_TINY
from tests.test_torch_resnet import jax_pair, seeded

torch.set_num_threads(1)

# The logits of a quantized model run free (``stepwise`` has the bars).
MODEL_TOL = 5e-2
STEP_TOL = {torch.float32: 1e-3, torch.bfloat16: 5e-2}

# family -> (registered name, small config): one model of every ported
# family, widths at least 4 so that min_features=4 converts every Dense.
FAMILIES = {
    "vit": ("vit_base_patch16_224",
            dict(input_size=(64, 64), embed_dim=64, nb_blocks=2, nb_heads=2,
                 nb_classes=7)),
    "deit": ("deit_tiny_distilled_patch16_224",
             dict(input_size=(64, 64), embed_dim=64, nb_blocks=2, nb_heads=2,
                  nb_classes=7)),
    "convnext": ("convnext_tiny",
                 dict(input_size=(32, 32), embed_dim=(32, 64), nb_blocks=(1, 1),
                      nb_classes=7, drop_path_rate=0.0)),
    "swin": ("swin_tiny_patch4_window7_224",
             dict(input_size=(56, 56), embed_dim=32, nb_heads=(2, 4),
                  nb_blocks=(2, 2), nb_classes=7)),
    "cait": ("cait_xxs24_224",
             dict(input_size=(32, 32), patch_size=8, embed_dim=64, nb_blocks=2,
                  nb_heads=4, nb_classes=7)),
    "pvt": ("pvt_tiny",
            dict(input_size=(64, 64), embed_dim=(16, 32, 48, 64),
                 nb_heads=(1, 2, 3, 4), mlp_ratio=(2.0,) * 4,
                 nb_blocks=(2, 1, 1, 1), nb_classes=7)),
    "pvt_v2": ("pvt_v2_b0",
               dict(input_size=(64, 64), embed_dim=(16, 32), nb_heads=(1, 2),
                    mlp_ratio=(4.0, 2.0), nb_blocks=(2, 1), sr_ratio=(4, 2),
                    nb_classes=7)),
    "poolformer": ("poolformer_s12",
                   dict(input_size=(64, 64), embed_dim=(32, 64),
                        nb_blocks=(2, 1), mlp_ratio=(4.0, 4.0), nb_classes=7)),
    "mixer": ("mixer_b16_224",
              dict(input_size=(64, 64), patch_size=16, embed_dim=32,
                   nb_blocks=2, nb_classes=7, mlp_ratio=(0.5, 2.0))),
    "resmlp": ("resmlp_12_224",
               dict(input_size=(64, 64), patch_size=8, embed_dim=32,
                    nb_blocks=2, nb_classes=7, mlp_ratio=(2.0, 2.0))),
    "gmlp": ("gmlp_s16_224",
             dict(input_size=(64, 64), patch_size=16, embed_dim=32,
                  nb_blocks=2, nb_classes=7, mlp_ratio=(2.0, 2.0))),
    "pit": ("pit_ti_224",
            dict(input_size=(48, 48), embed_dim=(32, 64, 128),
                 nb_blocks=(1, 1, 1), nb_heads=(1, 2, 4), mlp_ratio=2.0,
                 nb_classes=7)),
    "resnet": ("resnet50d", dict(input_size=(48, 48), nb_blocks=(1, 1, 1, 1),
                                 nb_channels=(8, 8, 16, 16), nb_classes=7)),
    "seresnext": ("seresnext26t_32x4d",
                  dict(input_size=(48, 48), nb_blocks=(1, 1, 1, 1),
                       nb_channels=(32, 32, 64, 64), cardinality=8,
                       nb_classes=7)),
    "vgg": ("vgg11", dict(input_size=(32, 32), nb_classes=7,
                          nb_features=64)),
    "convmixer": ("convmixer_768_32",
                  dict(input_size=(56, 70), embed_dim=16, depth=2,
                       nb_classes=7)),
    "efficientnet": ("efficientnet_b0",
                     dict(input_size=(64, 64), stem_size=8, nb_features=320,
                          channel_multiplier=0.25, depth_multiplier=0.5,
                          nb_classes=10, drop_rate=0.0, drop_path_rate=0.0)),
    "resnetv2": ("resnetv2_50x1_bitm",
                 dict(input_size=(64, 64), nb_blocks=(1, 1),
                      nb_channels=(128, 256), nb_classes=7)),
    "vit_hybrid": ("vit_small_r26_s32_224",
                   dict(input_size=(64, 64), patch_nb_blocks=(1, 1),
                        embed_dim=64, nb_blocks=2, nb_heads=2, mlp_ratio=2.0,
                        nb_classes=7)),
    "sam": ("sam_vit_b", SAM_TINY),
}
# The families whose layers feed a hand-written kernel's gate, or read a
# kernel's output (tests/test_quant.py's _GATED).
GATED = ["vit", "swin", "cait", "convnext", "poolformer", "pvt", "pvt_v2",
         "mixer", "pit"]
RULES = {
    "dense": dict(min_features=4),
    "convs": dict(min_features=4, convs=True, min_conv_features=4),
    "skip": dict(min_features=4, skip=jq.DEFAULT_SKIP + ("fc1", "qkv")),
}


def rel(got, want):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else jnp.asarray(got, jnp.float32), np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / np.abs(want).max()


def exact(got, want) -> bool:
    got = got.detach()
    want = np.asarray(want)
    if got.dtype == torch.bfloat16:
        got = got.float()
        want = np.asarray(jnp.asarray(want, jnp.float32))
    return got.shape == want.shape and np.array_equal(got.numpy(), want)


@functools.lru_cache(maxsize=None)
def pair(family):
    """(JAX model, its seeded parameters, the port's model holding them)."""
    name, kw = FAMILIES[family]
    return jax_pair(name, seed=3, **kw)


def images(family, seed=2, dtype=np.float32):
    size = FAMILIES[family][1]["input_size"]
    return np.random.default_rng(seed).normal(
        size=(2, *size, 3)).astype(dtype)


def same_trees(jax_tree, port_model):
    """The JAX tree and the port's model hold the same leaves: keys, dtypes
    and values."""
    want = flatten_params(jax_tree)
    got = jax_from_state_dict(port_model)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        value = np.asarray(value)
        assert got[key].dtype == value.dtype, key
        assert np.array_equal(got[key], value), key


def int8_paths(tree):
    return sorted(k[:-len(".kernel_q")] for k in flatten_params(tree)
                  if k.endswith(".kernel_q"))


def dense_tensors(rng, k, n):
    """(JAX {kernel_q, kernel_scale}, the port's (weight_q, weight_scale))
    of a seeded (k, n) kernel."""
    w = jnp.asarray(rng.normal(size=(k, n)).astype(np.float32) * 0.05)
    p = jq.quantize_int8({"d": {"kernel": w}}, min_features=1)["d"]
    return p, (torch.from_numpy(np.asarray(p["kernel_q"]).T.copy()),
               torch.from_numpy(np.array(p["kernel_scale"])))


def conv_tensors(rng, kh, kw, cin, cout):
    w = jnp.asarray(rng.normal(size=(kh, kw, cin, cout)).astype(np.float32)
                    * 0.05)
    p = jq.quantize_int8({"c": {"kernel": w}}, convs=True,
                         min_conv_features=1)["c"]
    return p, (torch.from_numpy(np.asarray(p["kernel_q"]).transpose(3, 2, 0, 1)
                                .copy()),
               torch.from_numpy(np.array(p["kernel_scale"])))


JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
DTYPES = [torch.float32, torch.bfloat16]


# -- the module ----------------------------------------------------------------

def test_module_exports_what_the_jax_module_exports():
    assert tq.__all__ == jq.__all__
    assert all(hasattr(tq, name) for name in tq.__all__)
    assert tq.DEFAULT_SKIP == jq.DEFAULT_SKIP
    assert tfimm_tpu_torch.quantize_int8 is tq.quantize_int8


# -- the int8 products -----------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,n", [((2, 197, 96), 288), ((5, 100), 36),
                                     ((3, 4, 5, 24), 40), ((1, 8), 8)])
def test_int8_dense_matmul_equals_jax_bit_for_bit(dtype, shape, n):
    rng = np.random.default_rng(0)
    p, tensors = dense_tensors(rng, shape[-1], n)
    x = rng.normal(size=shape).astype(np.float32) * 3
    want = jq.int8_dense_matmul(p, jnp.asarray(x, JDT[dtype]))
    got = tq.int8_dense_matmul(tensors, torch.from_numpy(x).to(dtype))
    assert got.dtype == dtype
    assert exact(got, want)
    layer = Dense(shape[-1], n, use_bias=False)
    tq.set_int8(layer, *tensors)
    assert exact(layer(torch.from_numpy(x).to(dtype)), want)


@pytest.mark.parametrize("m,k,n", [(5, 100, 36), (16, 8, 8), (17, 7, 9),
                                   (40, 64, 24)])
def test_int_mm_pads_to_the_shapes_torch_int_mm_takes_on_the_card(
        monkeypatch, m, k, n):
    """Every call reaches ``torch._int_mm`` with more than 16 rows, K and N
    multiples of 8, and the weight as the transpose of a contiguous (N, K)
    matrix; the result is the exact integer product."""
    calls = []
    real = torch._int_mm

    def recorded(a, b):
        calls.append((tuple(a.shape), tuple(b.shape), b.stride(),
                      a.is_contiguous()))
        return real(a, b)

    monkeypatch.setattr(torch, "_int_mm", recorded)
    g = torch.Generator().manual_seed(m * k + n)
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
    got = tq.int_mm(a, w)
    assert got.dtype == torch.int32
    assert torch.equal(got, (a.long() @ w.long().t()).int())
    (am, ak), (bk, bn), stride, contiguous = calls[0]
    assert am > 16 and ak % 8 == 0 and bn % 8 == 0 and ak == bk
    assert stride == (1, bk) and contiguous


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", [
    # (kh, kw, cin, cout, (B, H, W), strides, padding, dilation)
    (3, 3, 16, 24, (2, 9, 11), (1, 1), "SAME", (1, 1)),
    (3, 3, 16, 24, (2, 9, 11), (2, 2), "SAME", (1, 1)),      # uneven pads
    (3, 2, 16, 24, (2, 9, 11), (2, 1), ((1, 2), (0, 1)), (2, 1)),
    (2, 2, 16, 32, (2, 8, 8), (2, 2), "VALID", (1, 1)),       # PVT's sr
    (3, 3, 5, 7, (1, 6, 5), (1, 1), ((1, 1), (1, 1)), (1, 1)),  # padded K, N
])
def test_int8_conv_equals_jax_bit_for_bit(dtype, case):
    kh, kw, cin, cout, bhw, strides, padding, dilation = case
    rng = np.random.default_rng(1)
    p, tensors = conv_tensors(rng, kh, kw, cin, cout)
    x = rng.normal(size=(*bhw, cin)).astype(np.float32) * 2
    want = jq.int8_conv(p, jnp.asarray(x, JDT[dtype]), strides, padding,
                        dilation)
    got = tq.int8_conv(tensors, torch.from_numpy(x).to(dtype), strides,
                       padding, dilation)
    assert got.dtype == dtype
    assert exact(got, want)


def _module(**layers):
    """An ``nn.Module`` holding ``layers`` under their names."""
    m = torch.nn.Module()
    for name, layer in layers.items():
        setattr(m, name, layer)
    return m


# (name, JAX layer, port layer, input (B, H, W, C), the int8 route the JAX
# layer takes: "dense", "conv" or None for the dequantized float conv)
def _conv_cases():
    from tfimm_tpu.ops.conv import Conv2d as JConv2d
    from tfimm_tpu.ops.conv import StdConv2d as JStdConv2d

    return [
        ("fc1", JConv2d(16, 32, 1), Conv2d(16, 32, 1), (2, 5, 6, 16), "dense"),
        ("conv", JConv2d(16, 24, 3, stride=2, padding="same"),
         Conv2d(16, 24, 3, stride=2, padding="same"), (2, 9, 9, 16), "conv"),
        ("conv", JConv2d(16, 24, 3, stride=1, padding="symmetric", dilation=2),
         Conv2d(16, 24, 3, stride=1, padding="symmetric", dilation=2), (2, 9, 9, 16),
         "conv"),
        ("sr", JConv2d(16, 16, 4, stride=4, padding="valid"),
         Conv2d(16, 16, 4),
         (2, 8, 8, 16), "conv"),
        ("conv", JConv2d(16, 24, 3, padding="symmetric", groups=2),
         Conv2d(16, 24, 3, stride=1, padding="symmetric", groups=2),
         (2, 7, 7, 16),
         None),
        ("fc1", JConv2d(16, 32, 1, stride=2), Conv2d(16, 32, 1, stride=2),
         (2, 6, 6, 16), None),
        ("conv", JStdConv2d(16, 24, 3, padding="symmetric", use_bias=False),
         StdConv2d(16, 24, 3, stride=1, padding="symmetric", use_bias=False),
         (2, 7, 7, 16), None),
    ]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("index", range(7))
def test_quantized_convs_take_the_jax_layers_route(monkeypatch, dtype, index):
    """Each quantized conv takes the JAX layer's route (a 1x1 matmul, the
    KxK int8 conv, a stride-K patchify conv included, or the dequantized
    float conv for a grouped conv, a strided 1x1 and StdConv2d) and gives
    its output: bit for bit on the int8 routes, within 1e-5 in f32 and
    2e-2 in bf16 (summed in another order) on the float one."""
    name, jlayer, tlayer, shape, route = _conv_cases()[index]
    p = jlayer.init(jax.random.PRNGKey(index))
    p = {k: jnp.asarray(np.random.default_rng(index).normal(size=v.shape)
                        .astype(np.float32) * 0.1) for k, v in p.items()}
    rules = dict(min_features=1, convs=True, min_conv_features=1)
    jp = jq.quantize_int8({name: p}, **rules)
    tm = _module(**{name: tlayer})
    tm.load_state_dict(state_dict_from_jax({name: p}))
    tm = tq.quantize_int8(tm, **rules)
    same_trees(jp, tm)
    routes = {"jax": [], "port": []}
    for side, module in (("jax", jq), ("port", tq)):
        for fn in ("int8_dense_matmul", "int8_conv"):
            real = getattr(module, fn)

            def counted(*a, _real=real, _side=side, _fn=fn, **k):
                routes[_side].append(_fn)
                return _real(*a, **k)

            monkeypatch.setattr(module, fn, counted)
    x = np.random.default_rng(9).normal(size=shape).astype(np.float32)
    want = jlayer(jp[name], jnp.asarray(x, JDT[dtype]))
    with torch.no_grad():
        got = getattr(tm, name)(torch.from_numpy(x).to(dtype))
    expect = {"dense": ["int8_dense_matmul"], "conv": ["int8_conv"],
              None: []}[route]
    assert routes["jax"] == routes["port"] == expect
    if route is None:
        assert rel(got, want) < (1e-5 if dtype == torch.float32 else 2e-2)
    else:
        assert exact(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_dense_straight_through_gradient_matches_jax(dtype):
    from tfimm_tpu.ops.basic import Dense as JDense

    rng = np.random.default_rng(4)
    layer = JDense(64, 96)
    p = {k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32) * 0.1)
         for k, v in layer.init(jax.random.PRNGKey(0)).items()}
    jp = jq.quantize_int8({"d": p}, min_features=64)
    tm = _module(d=Dense(64, 96))
    tm.load_state_dict(state_dict_from_jax({"d": p}))
    tm = tq.quantize_int8(tm, min_features=64).to(dtype)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    r = rng.normal(size=(3, 5, 96)).astype(np.float32)

    def loss(xx, bias):
        y = layer({**jp["d"], "bias": bias}, xx)
        return jnp.sum(y.astype(jnp.float32) * r)

    gx, gb = jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(x, JDT[dtype]), jnp.asarray(jp["d"]["bias"], JDT[dtype]))
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    (tm.d(xt).float() * torch.from_numpy(r)).sum().backward()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert float(jnp.abs(gx).max()) > 0
    assert rel(xt.grad, gx) < tol
    assert rel(tm.d.bias.grad, gb) < tol
    assert not tm.d.weight_q.requires_grad
    assert not tm.d.weight_scale.requires_grad
    assert "weight" not in dict(tm.named_parameters())


@pytest.mark.parametrize("dtype", DTYPES)
def test_conv_straight_through_gradient_matches_jax(dtype):
    from tfimm_tpu.ops.conv import Conv2d as JConv2d

    rng = np.random.default_rng(5)
    layer = JConv2d(16, 24, 3, stride=2, padding="same")
    p = {k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32) * 0.1)
         for k, v in layer.init(jax.random.PRNGKey(0)).items()}
    rules = dict(convs=True, min_conv_features=16)
    jp = jq.quantize_int8({"c": p}, **rules)
    tm = _module(c=Conv2d(16, 24, 3, stride=2, padding="same"))
    tm.load_state_dict(state_dict_from_jax({"c": p}))
    tm = tq.quantize_int8(tm, **rules).to(dtype)
    x = rng.normal(size=(2, 9, 10, 16)).astype(np.float32)
    r = rng.normal(size=(2, 5, 5, 24)).astype(np.float32)
    gx = jax.grad(lambda xx: jnp.sum(layer(jp["c"], xx).astype(jnp.float32)
                                     * r))(jnp.asarray(x, JDT[dtype]))
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    (tm.c(xt).float() * torch.from_numpy(r)).sum().backward()
    assert float(jnp.abs(gx).max()) > 0
    assert rel(xt.grad, gx) < (1e-5 if dtype == torch.float32 else 2e-2)


# -- quantize_int8 ---------------------------------------------------------------

@pytest.mark.parametrize("rules", sorted(RULES))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_quantize_int8_converts_what_the_jax_package_converts(family, rules):
    """The same layers in int8, with the same int8 weights and float32
    scales, and every other tensor untouched; the argument unchanged."""
    jm, params, tm = pair(family)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    want = jq.quantize_int8(params, **RULES[rules])
    got = tq.quantize_int8(tm, **RULES[rules])
    same_trees(want, got)
    assert tq.is_quantized(got) == bool(int8_paths(want))
    assert not tq.is_quantized(tm)
    assert all(torch.equal(v, before[k]) for k, v in tm.state_dict().items())


def test_lora_layers_stay_float():
    """LoRA layers read their base weight raw: never converted (the JAX
    tree's ``kernel_lora_a`` rule), whatever the thresholds."""
    kw = dict(input_size=(32, 32), embed_dim=(8, 8), nb_blocks=(1, 1),
              nb_classes=5, lora_rank=2)
    jm = jlora.create_model("convnext_tiny", **kw)
    params = seeded(jm.params, 4)
    tm = tlora.create_model("convnext_tiny", device="cpu", **kw)
    tm.load_state_dict(state_dict_from_jax(params))
    rules = dict(min_features=1, skip=(), convs=True, min_conv_features=1)
    want = jq.quantize_int8(params, **rules)
    got = tq.quantize_int8(tm, **rules)
    same_trees(want, got)
    lora_layers = [n for n, m in got.named_modules()
                   if "weight_lora_a" in m._parameters]
    assert lora_layers and not any(tq.any_quantized(got.get_submodule(n))
                                   for n in lora_layers)
    assert int8_paths(want)   # the convs, outside the LoRA layers
    with torch.no_grad():
        assert torch.isfinite(got(torch.randn(1, 32, 32, 3))).all()


def _tree_and_module(spec):
    """A JAX tree of seeded kernels {path: JAX-layout shape} and a port
    module with the same layers (Dense for 2-D, Conv2d for 4-D)."""
    rng = np.random.default_rng(6)
    tree, root = {}, torch.nn.Module()
    for path, shape in spec.items():
        *parents, leaf = path.split(".")
        node, mod = tree, root
        for part in parents:
            node = node.setdefault(part, {})
            if not hasattr(mod, part):
                setattr(mod, part, torch.nn.Module())
            mod = getattr(mod, part)
        node[leaf] = {"kernel": jnp.asarray(
            rng.normal(size=shape).astype(np.float32))}
        if len(shape) == 2:
            layer = Dense(*shape, use_bias=False)
        else:
            layer = Conv2d(shape[2], shape[3], shape[:2], use_bias=False)
        setattr(mod, leaf, layer)
    root.load_state_dict(state_dict_from_jax(tree))
    return tree, root


def test_se_gates_stay_float_and_conv_mlps_convert():
    """SEModule's 1x1 gate convs are named fc1/fc2 too, reduce then
    expand: never converted; a ConvMLP (expand then contract) is."""
    tree, root = _tree_and_module({
        "se.fc1": (1, 1, 512, 64), "se.fc2": (1, 1, 64, 512),
        "mlp.fc1": (1, 1, 64, 512), "mlp.fc2": (1, 1, 512, 64)})
    want = jq.quantize_int8(tree, min_features=64)
    got = tq.quantize_int8(root, min_features=64)
    same_trees(want, got)
    assert int8_paths(want) == ["mlp.fc1", "mlp.fc2"]
    assert got.mlp.fc1.weight_q.shape == (512, 64)   # stored 2-D (out, in)


def test_a_layer_named_fc_stays_float():
    """timm's CNN heads are named exactly "fc": never converted, with
    convs=True too, while fc1/fc2 still are."""
    tree, root = _tree_and_module({
        "fc": (512, 1000), "blocks.0.mlp.fc1": (512, 2048),
        "blocks.0.mlp.fc2": (2048, 512)})
    want = jq.quantize_int8(tree, convs=True)
    got = tq.quantize_int8(root, convs=True)
    same_trees(want, got)
    assert int8_paths(want) == ["blocks.0.mlp.fc1", "blocks.0.mlp.fc2"]


def test_kxk_convs_are_opt_in_and_gated_by_width():
    tree, root = _tree_and_module({
        "big": (3, 3, 128, 128), "small": (3, 3, 64, 64),
        "stem": (7, 7, 3, 128)})
    assert not tq.is_quantized(tq.quantize_int8(root))
    want = jq.quantize_int8(tree, convs=True)
    got = tq.quantize_int8(root, convs=True)
    same_trees(want, got)
    assert int8_paths(want) == ["big"]
    assert got.big.weight_q.shape == (128, 128, 3, 3)


def test_a_bf16_model_quantizes_its_bf16_values():
    """The weights are cast to float32 first: a bf16 model's int8 weights
    are those of its bf16 values, as the JAX package's of a cast tree."""
    jm, params, tm = pair("vit")
    want = jq.quantize_int8(tree_cast(params, jnp.bfloat16), min_features=4)
    got = tq.quantize_int8(copy.deepcopy(tm).to(torch.bfloat16),
                           min_features=4)
    for key, value in flatten_params(want).items():
        if key.endswith(("kernel_q", "kernel_scale")):
            assert np.array_equal(jax_from_state_dict(got)[key],
                                  np.asarray(value)), key


# (registered name, rules, int8 layers, the layers that stay float of those
# the default rules could take): what phase 46 of chip_smoke.py counts on.
FULL_WIDTH = [
    ("vit_base_patch16_224", {}, 48, ()),
    ("convnext_base", {}, 66, ("stages.0.blocks",)),
    ("swin_tiny_patch4_window7_224", {}, 34,
     ("layers.0.blocks", "layers.1.blocks", "layers.0.downsample")),
    ("resnet50", dict(convs=True), 13, ("layer1",)),
]


@pytest.mark.parametrize("name,rules,count,floats", FULL_WIDTH)
def test_quantize_int8_at_full_width(name, rules, count, floats):
    """At the registered widths and the default thresholds: the same
    layers, int8 weights and scales as the JAX package (``jax.eval_shape``
    of the JAX init, seeded leaves; the port's model built on the meta
    device and given them)."""
    cfg = jax_registry.model_config(name)
    jm = jax_registry.model_class(name)(cfg)
    params = seeded(jax.eval_shape(jm.init_params, jax.random.PRNGKey(0)), 5)
    with torch.device("meta"):
        tm = torch_registry.model_class(name)(torch_registry.model_config(name))
    tm.load_state_dict(state_dict_from_jax(params), assign=True)
    want = jq.quantize_int8(params, **rules)
    got = tq.quantize_int8(tm, **rules)
    paths = int8_paths(want)
    assert len(paths) == count
    assert not any(p.startswith(floats) for p in paths)
    assert sorted(n for n, m in got.named_modules()
                  if tq.any_quantized(m)) == paths
    flat = flatten_params(want)
    state = jax_from_state_dict(got)
    for path in paths:
        for leaf in ("kernel_q", "kernel_scale"):
            key = f"{path}.{leaf}"
            assert state[key].dtype == np.asarray(flat[key]).dtype, key
            assert np.array_equal(state[key], np.asarray(flat[key])), key


# -- quantized models ------------------------------------------------------------

def stepwise(jm, jtree, qm, x, dtype):
    """The port's quantized model ``qm`` against the JAX model ``jm`` on
    ``jtree``, int8 product by int8 product: returns (the largest distance
    of a layer's own input from the JAX input, whether every int8 product
    equals the JAX one bit for bit, the logits' distance, the number of
    int8 products)."""
    cast = tree_cast(jtree, JDT[dtype])
    paths = {}
    jax_io = {k[:-len(".kernel_q")]: [] for k in flatten_params(cast)
              if k.endswith(".kernel_q")}

    def run(tree, xx):
        # The layers receive the traced leaves themselves: name them.
        paths.update({id(v): k[:-len(".kernel_q")]
                      for k, v in flatten_params(tree).items()
                      if k.endswith(".kernel_q")})
        return jm.apply(tree, xx)

    xj = jnp.asarray(x, JDT[dtype])
    with pytest.MonkeyPatch.context() as mp:
        for fn in ("int8_dense_matmul", "int8_conv"):
            real = getattr(jq, fn)

            def recorded(p, xx, *a, _real=real):
                path = paths[id(p["kernel_q"])]
                out = _real(p, xx, *a)
                jax.debug.callback(
                    lambda v, o, path=path: jax_io[path].append(
                        (np.array(v, np.float32), np.array(o, np.float32))),
                    xx, out, ordered=True)
                return out

            mp.setattr(jq, fn, recorded)
        # XLA would otherwise skip a bf16 rounding between fused ops, which
        # the JAX package's eager ops and the port make.
        want = jax.jit(run).lower(cast, xj).compile(
            {"xla_allow_excess_precision": False})(cast, xj)
        jax.effects_barrier()
    calls = sum(len(v) for v in jax_io.values())

    names = {id(m): n for n, m in qm.named_modules() if tq.any_quantized(m)}
    steps, outputs = [], []
    with pytest.MonkeyPatch.context() as mp:
        for fn in ("int8_dense_matmul", "int8_conv"):
            real = getattr(tq, fn)

            def checked(layer, xx, *a, _real=real):
                given, out = jax_io[names[id(layer)]].pop(0)
                steps.append(rel(xx, given))
                y = _real(layer, torch.from_numpy(given).to(dtype), *a)
                outputs.append(exact(y, out))
                return y

            mp.setattr(tq, fn, checked)
        with torch.inference_mode():
            got = qm(torch.from_numpy(x).to(dtype))
    assert not any(jax_io.values()) and len(steps) == calls
    assert got.dtype == dtype and torch.isfinite(got).all()
    return max(steps, default=0.0), all(outputs), rel(got, want), calls


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("family", GATED)
def test_quantized_models_match_the_jax_int8_models(family, dtype):
    jm, params, tm = pair(family)
    jtree = jq.quantize_int8(params, min_features=4)
    qm = tq.quantize_int8(tm, min_features=4).to(dtype)
    step, exact_outputs, logits, calls = stepwise(
        jm, jtree, qm, images(family), dtype)
    assert calls >= len(int8_paths(jtree))
    assert exact_outputs
    assert step < STEP_TOL[dtype]
    assert logits < STEP_TOL[dtype]


def test_casts_keep_int8_weights_and_float32_scales():
    jm, params, tm = pair("vit")
    qm = tq.quantize_int8(tm, min_features=4)
    layer = qm.blocks[0].attn.qkv
    layer.weight_scale[0] = 1.0 + 2 ** -12           # not a bf16 value
    wq, ws = layer.weight_q.clone(), layer.weight_scale.clone()
    for cast in (lambda m: m.to(torch.bfloat16), lambda m: m.half(),
                 lambda m: m.to(dtype=torch.bfloat16, device="cpu"),
                 lambda m: m.float()):
        cast(qm)
        assert layer.weight_q.dtype == torch.int8
        assert layer.weight_scale.dtype == torch.float32
        assert torch.equal(layer.weight_q, wq)
        assert torch.equal(layer.weight_scale, ws)
    qm.to(torch.bfloat16)
    assert layer.bias.dtype == torch.bfloat16
    with torch.inference_mode():
        out = qm(torch.from_numpy(images("vit")).to(torch.bfloat16))
    assert torch.isfinite(out).all()


def test_head_fine_tunes_on_an_int8_backbone():
    """A float head trained on a frozen int8 backbone: its gradient (the
    JAX package's within MODEL_TOL) and one step lower the loss."""
    jm, params, tm = pair("vit")
    jtree = jq.quantize_int8(params, min_features=4)
    qm = tq.quantize_int8(tm, min_features=4)
    x = images("vit")
    y = np.array([0, 3])

    def jloss(head):
        import optax

        logits = jm.apply({**jtree, "head": head}, jnp.asarray(x))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean()

    gw = jax.grad(jloss)(jtree["head"])["kernel"]

    def tloss():
        return torch.nn.functional.cross_entropy(qm(torch.from_numpy(x)),
                                                 torch.from_numpy(y))

    loss = tloss()
    loss.backward()
    assert rel(qm.head.weight.grad.t(), gw) < MODEL_TOL
    with torch.no_grad():
        for p in qm.head.parameters():
            p -= 0.5 * p.grad
        assert tloss() < loss
    assert not any(tq.any_quantized(m) and m.weight_q.grad is not None
                   for m in qm.modules())


def test_l2_penalty_leaves_int8_layers_out():
    """The JAX penalty takes the leaves named ``kernel``; ``kernel_q`` is
    none of them."""
    jm, params, tm = pair("vit")
    qm = tq.quantize_int8(tm, min_features=4)
    want = [k for k in flatten_params(jq.quantize_int8(params, min_features=4))
            if k.endswith("kernel")]
    assert len(l2_weights(qm)) == len(want) < len(l2_weights(tm))


def test_transfer_weights_refuses_a_quantized_source():
    jm, params, tm = pair("vit")
    qm = tq.quantize_int8(tm, min_features=4)
    name, kw = FAMILIES["vit"]
    dst = tfimm_tpu_torch.create_model(name, device="cpu",
                                       **dict(kw, nb_classes=3))
    with pytest.raises(ValueError, match="quantized"):
        tfimm_tpu_torch.transfer_weights(qm, dst)


def _jax_model_with(jm, params):
    other = jm.__class__(jm.cfg)
    other.params = params
    return other


# -- save and load ---------------------------------------------------------------

@pytest.mark.parametrize("family", ["vit", "resnet"])
def test_save_load_keeps_int8_within_the_port(family, tmp_path):
    jm, params, tm = pair(family)
    rules = RULES["convs"]
    qm = tq.quantize_int8(tm, **rules).to(torch.bfloat16)
    tfimm_tpu_torch.save_model(qm, str(tmp_path / "m"))
    with np.load(tmp_path / "m" / "params.npz") as data:
        saved = {k: data[k].dtype for k in data.files}
    assert {saved[f"{p}.kernel_q"] for p in int8_paths(
        jq.quantize_int8(params, **rules))} == {np.dtype(np.int8)}
    assert {v for k, v in saved.items() if k.endswith("kernel_scale")} \
        == {np.dtype(np.float32)}
    loaded = tfimm_tpu_torch.load_model(str(tmp_path / "m"), device="cpu")
    assert next(loaded.parameters()).dtype == torch.bfloat16
    a, b = qm.state_dict(), loaded.state_dict()
    assert sorted(a) == sorted(b)
    assert all(a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a)
    x = torch.from_numpy(images(family)).to(torch.bfloat16)
    with torch.inference_mode():
        assert torch.equal(qm(x), loaded(x))


def test_a_quantized_save_crosses_both_packages(tmp_path):
    """A JAX-saved int8 model loads in the port, and the port's loads in
    the JAX package, with int8 weights and float32 scales bit for bit."""
    jm, params, tm = pair("vit")
    jtree = jq.quantize_int8(params, min_features=4)
    jsaved = _jax_model_with(jm, jtree)
    tfimm_tpu.save_model(jsaved, str(tmp_path / "jax"))
    loaded = tfimm_tpu_torch.load_model(str(tmp_path / "jax"), device="cpu")
    same_trees(jtree, loaded)
    assert next(loaded.parameters()).dtype == torch.float32
    qm = tq.quantize_int8(tm, min_features=4)
    tfimm_tpu_torch.save_model(qm, str(tmp_path / "port"))
    back = tfimm_tpu.load_model(str(tmp_path / "port"))
    same_trees(back.params, qm)
    with torch.inference_mode():
        assert torch.isfinite(loaded(torch.from_numpy(images("vit")))).all()
    assert tfimm_tpu_torch.create_model(
        FAMILIES["vit"][0], model_path=str(tmp_path / "jax"), device="cpu",
        **FAMILIES["vit"][1]).blocks[0].attn.qkv.quantized


def test_a_bf16_jax_save_keeps_its_scales_float32(tmp_path):
    jm, params, tm = pair("vit")
    jsaved = _jax_model_with(
        jm, tree_cast(jq.quantize_int8(params, min_features=4), jnp.bfloat16))
    tfimm_tpu.save_model(jsaved, str(tmp_path / "m"))
    loaded = tfimm_tpu_torch.load_model(str(tmp_path / "m"), device="cpu")
    assert next(loaded.parameters()).dtype == torch.bfloat16
    layer = loaded.blocks[0].attn.qkv
    assert layer.weight_scale.dtype == torch.float32
    assert np.array_equal(
        layer.weight_scale.numpy(),
        np.asarray(jsaved.params["blocks"]["0"]["attn"]["qkv"]["kernel_scale"]))


# -- the kernel gates --------------------------------------------------------------

# Port dispatch name -> the JAX package's kernel entry points (module,
# function); a call that returns an array took the kernel.
_JAX_KERNELS = {
    "convnext_mlp": [("convnext_mlp", "convnext_mlp_or_none")],
    "convnext_block": [("convnext_block", "fused_convnext_block")],
    "window_mha": [("window_mha", "window_mha_or_none")],
    "swin_block": [("swin_block", "swin_block_or_none"),
                   ("swin_block", "swin_block_padded_or_none")],
    "talking_head_attention": [("cait_attention",
                                "talking_head_attention_or_none")],
    "pvt_sra": [("pvt_sra", "sra_attention_or_none")],
    "poolformer_block": [("poolformer_block", "poolformer_block_or_none")],
}
_PORT_MODULES = ["convnext", "swin", "cait", "pvt", "poolformer"]

# (family, config overrides, env, dtype, rules, the port's kernel calls
# with the float model and with the quantized one): each quantizes a part
# of the model the gates must see. Swin at 56x56 with embed 64: min_features
# 128 leaves stage 1 float and converts stage 2 (Swin-T's split at the
# default thresholds: its stage-2 blocks decline swin_block and window_mha
# both); skip lists that leave qkv, fc1 or proj float. ConvNeXt with widths
# (128, 256) at min_features 256: stage 1 keeps its kernel (ConvNeXt-B's
# split). CaiT's (H, H) head mixes int8 at min_features 4, float at 8.
GATE_CASES = {
    "swin_stage2": ("swin", dict(embed_dim=64), {}, "float32",
                    dict(min_features=128),
                    [{"swin_block": 4}, {"swin_block": 2}]),
    "swin_qkv_float": ("swin", dict(embed_dim=64), {}, "float32",
                       dict(min_features=1, skip=jq.DEFAULT_SKIP + ("qkv",)),
                       [{"swin_block": 4}, {"window_mha": 4}]),
    "swin_fc1_float": ("swin", dict(embed_dim=64), {}, "float32",
                       dict(min_features=1, skip=jq.DEFAULT_SKIP + ("fc1",)),
                       [{"swin_block": 4}, {}]),
    "swin_proj_float": ("swin", dict(embed_dim=64), {}, "bfloat16",
                        dict(min_features=1, skip=jq.DEFAULT_SKIP + ("proj",)),
                        [{"swin_block": 4}, {}]),
    "convnext_stage2": ("convnext", dict(embed_dim=(128, 256)), {}, "float32",
                        dict(min_features=256),
                        [{"convnext_mlp": 2}, {"convnext_mlp": 1}]),
    "convnext_fc2_only": ("convnext", dict(embed_dim=(128, 256)), {},
                          "float32", dict(min_features=1,
                                          skip=jq.DEFAULT_SKIP + ("fc1",)),
                          [{"convnext_mlp": 2}, {}]),
    "convnext_fused": ("convnext", dict(embed_dim=(128, 256)),
                       {"TFIMM_TPU_FUSED_CONVNEXT": "1"}, "bfloat16",
                       dict(min_features=256),
                       [{"convnext_block": 2}, {"convnext_block": 1}]),
    "cait_mixes": ("cait", dict(embed_dim=128), {}, "float32",
                   dict(min_features=4),
                   [{"talking_head_attention": 2}, {}]),
    "cait_mixes_float": ("cait", dict(embed_dim=128), {}, "float32",
                         dict(min_features=8),
                         [{"talking_head_attention": 2},
                          {"talking_head_attention": 2}]),
    "pvt_q": ("pvt", {}, {"TFIMM_TPU_FUSED_PVT_SRA": "1"}, "float32",
              dict(min_features=16, skip=jq.DEFAULT_SKIP + ("proj",)),
              [{"pvt_sra": 2}, {}]),
    "pvt_v2_proj": ("pvt_v2", {}, {"TFIMM_TPU_FUSED_PVT_SRA": "1"},
                    "float32", dict(min_features=16,
                                    skip=jq.DEFAULT_SKIP + ("q",)),
                    [{"pvt_sra": 2}, {}]),
    "poolformer_fc2": ("poolformer", {}, {"TFIMM_TPU_FUSED_POOLFORMER": "1"},
                       "float32", dict(min_features=64,
                                       skip=jq.DEFAULT_SKIP + ("fc1",)),
                       [{"poolformer_block": 3}, {"poolformer_block": 2}]),
}


def _count_jax_kernels(monkeypatch, counts):
    for name, entries in _JAX_KERNELS.items():
        for module, fn in entries:
            mod = importlib.import_module(f"tfimm_tpu.ops.pallas.{module}")
            real = getattr(mod, fn)
            if fn == "fused_convnext_block":
                real = functools.partial(real, interpret=True)

            def counted(*a, _real=real, _name=name, **k):
                out = _real(*a, **k)
                if out is not None:
                    counts[_name] = counts.get(_name, 0) + 1
                return out

            monkeypatch.setattr(mod, fn, counted)


def _count_port_kernels(monkeypatch, counts):
    for module in _PORT_MODULES:
        mod = importlib.import_module(
            f"tfimm_tpu_torch.architectures.{module}")

        def logged(name):
            if name in _JAX_KERNELS:
                counts[name] = counts.get(name, 0) + 1

        monkeypatch.setattr(mod, "log_dispatch", logged)


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_kernel_gates_decline_where_the_jax_gates_do(monkeypatch, case):
    """The port's and the JAX package's kernels taken as often (the JAX
    kernels in interpret mode), on a model quantized in part, and the
    same model float; outputs within MODEL_TOL."""
    family, overrides, env, dtype, rules, expected = GATE_CASES[case]
    monkeypatch.setenv("TFIMM_TPU_PALLAS_INTERPRET", "1")
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    if "TFIMM_TPU_FUSED_CONVNEXT" in env:
        monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    name, kw = FAMILIES[family]
    jm, params, tm = jax_pair(name, seed=7, **dict(kw, **overrides))
    jtree = jq.quantize_int8(params, **rules)
    qm = tq.quantize_int8(tm, **rules)
    assert int8_paths(jtree)
    same_trees(jtree, qm)
    tdt = getattr(torch, dtype)
    x = np.random.default_rng(8).normal(
        size=(2, *kw["input_size"], 3)).astype(np.float32)
    seen = []
    for tree, model in ((params, tm), (jtree, qm)):
        jax_counts, port_counts = {}, {}
        _count_jax_kernels(monkeypatch, jax_counts)
        _count_port_kernels(monkeypatch, port_counts)
        step, exact_outputs, logits, _ = stepwise(jm, tree, model.to(tdt),
                                                  x, tdt)
        assert port_counts == jax_counts
        assert exact_outputs and step < STEP_TOL[tdt] \
            and logits < STEP_TOL[tdt]
        seen.append(port_counts)
    assert seen == expected


# -- ADVICE.md's three cases -------------------------------------------------------

def test_sam_upscaling_converts_and_raises_as_in_jax():
    """With convs=True and min_conv_features <= 64 both packages convert
    SAM's transposed upscaling conv, and both decoders then fail."""
    jm, params, tm = pair("sam")
    rules = dict(convs=True, min_conv_features=8)
    want = jq.quantize_int8(params, **rules)
    got = tq.quantize_int8(tm, **rules)
    same_trees(want, got)
    assert any("output_upscaling" in p for p in int8_paths(want))
    layer = got.get_submodule("mask_decoder.output_upscaling.0")
    x = torch.zeros(1, 4, 4, layer.weight_q.shape[0])
    with pytest.raises(NotImplementedError, match="output_upscaling"):
        layer(x)
    with pytest.raises(KeyError):
        jm.mask_decoder.output_upscaling(
            want["mask_decoder"]["output_upscaling"], jnp.asarray(x.numpy()))


def test_a_grouped_conv_converts_and_dequantizes_as_in_jax():
    """A grouped KxK conv whose group width clears min_conv_features
    converts in both packages and then convolves in float, its weight
    dequantized: SE-ResNeXt's 3x3s at min_conv_features=4."""
    jm, params, tm = pair("seresnext")
    rules = RULES["convs"]
    want = jq.quantize_int8(params, **rules)
    got = tq.quantize_int8(tm, **rules)
    grouped = [n for n, m in got.named_modules()
               if tq.any_quantized(m) and getattr(m, "groups", 1) > 1]
    assert grouped and set(grouped) <= set(int8_paths(want))
    x = images("seresnext")
    with torch.inference_mode():
        out = got(torch.from_numpy(x))
    assert rel(out, jax.jit(jm.apply)(want, jnp.asarray(x))) < MODEL_TOL


def test_the_conv_scale_spans_the_batch_as_in_jax():
    """One scale for the whole batch: an image's int8 conv output depends
    on the other images, in both packages alike, bit for bit."""
    rng = np.random.default_rng(10)
    p, tensors = conv_tensors(rng, 3, 3, 16, 16)
    x = rng.normal(size=(2, 6, 6, 16)).astype(np.float32)
    loud = x.copy()
    loud[1] *= 10.0
    outs = []
    for batch in (x, loud):
        want = jq.int8_conv(p, jnp.asarray(batch), (1, 1), "SAME", (1, 1))
        got = tq.int8_conv(tensors, torch.from_numpy(batch), (1, 1), "SAME",
                           (1, 1))
        assert exact(got, want)
        outs.append(got[0])
    assert not torch.equal(outs[0], outs[1])
