"""Port parity for ResNetV2 (BiT) and its weight-standardised conv:
tfimm_tpu_torch against the JAX package and the golden (Hugging Face's
independent BiT), on the CPU.

Parameters and inputs are made from a seed as in ``test_torch_resnet.py``
(He-scaled kernels, GroupNorm scales near 1) and carried by
``state_dict_from_jax``. Bars, as max|diff| / max|JAX|: ``StdConv2d`` 1e-5
in f32 and 2e-2 in bf16, its gradients 1e-5; a small model 1e-3 in f32
(logits, every feature, gradients) and 5e-2 in bf16; the golden 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import tfimm_tpu
import tfimm_tpu_torch
from tests.test_torch_efficientnet import check_registry_shapes
from tests.test_torch_resnet import (
    check_bf16,
    check_golden,
    check_gradients,
    check_model,
    images,
    jax_pair,
    rel,
    seeded,
)
from tfimm_tpu.architectures import resnetv2 as jresnetv2
from tfimm_tpu.ops import conv as jconv
from tfimm_tpu.utils.tree import flatten_params
from tfimm_tpu_torch.architectures import resnetv2 as tresnetv2
from tfimm_tpu_torch.ops.conv import StdConv2d
from tfimm_tpu_torch.utils.convert import jax_from_state_dict, state_dict_from_jax

torch.set_num_threads(2)


# -- StdConv2d ---------------------------------------------------------------------

@pytest.mark.parametrize("padding", ["symmetric", "same"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("kernel", [1, 3, 7])
def test_std_conv2d_matches_jax(kernel, stride, padding):
    """The forward on an even and an odd map (SAME pads unevenly on one of
    them at stride 2) in f32 and bf16, and the gradients of x and the raw
    weight against ``jax.vjp``; 1x1 at stride 1 takes the reshape into
    ``F.linear``, the rest cuDNN's route (``F.conv2d`` on the CPU)."""
    cin, cout = 8, 12
    jl = jconv.StdConv2d(cin, cout, kernel, stride=stride, padding=padding,
                         use_bias=False)
    p = seeded(jax.eval_shape(jl.init, jax.random.PRNGKey(0)), kernel)
    tl = StdConv2d(cin, cout, kernel, stride=stride, padding=padding,
                   use_bias=False)
    tl.load_state_dict(state_dict_from_jax(p))
    assert tl.patchify == (kernel == 1 and stride == 1)
    for size in ((10, 12), (9, 11)):
        x = images((2, *size, cin), kernel + stride)
        for dtype, bar in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
            got = tl(torch.from_numpy(x).to(dtype))
            want = jl(p, jnp.asarray(x, jdtype))
            assert got.dtype == dtype
            assert rel(got, want) < bar, (size, dtype)

        w = images(tuple(jl(p, jnp.asarray(x)).shape), 7)
        out, vjp = jax.vjp(lambda q, xx: jl(q, xx), p, jnp.asarray(x))
        want_p, want_x = vjp(jnp.asarray(w))
        xt = torch.from_numpy(x).requires_grad_()
        tl.zero_grad()
        (tl(xt) * torch.from_numpy(w)).sum().backward()
        assert rel(xt.grad, want_x) < 1e-5, size
        want_w = state_dict_from_jax(want_p)["weight"]
        assert rel(tl.weight.grad, want_w.numpy()) < 1e-5, size


def test_std_conv2d_standardises_at_every_call():
    """The weight is standardised from its current value at each call (no
    cache that an optimizer step would leave stale), with the population
    variance and eps 1e-8, per output channel over (in / groups, kh, kw)."""
    tl = StdConv2d(4, 6, 3, stride=1, padding="symmetric", use_bias=False)
    x = torch.randn(1, 5, 5, 4, generator=torch.Generator().manual_seed(0))
    before = tl(x)
    with torch.no_grad():
        tl.weight[0].mul_(3.0).add_(1.0)   # standardised away: channel 0 keeps
        tl.weight[1].copy_(torch.randn(4, 3, 3,
                                       generator=torch.Generator().manual_seed(1)))
    after = tl(x)
    torch.testing.assert_close(after[..., 0], before[..., 0], rtol=1e-5,
                               atol=1e-5)
    assert not torch.allclose(after[..., 1], before[..., 1])
    w = tl.weight.detach().double()
    mean = w.mean(dim=(1, 2, 3), keepdim=True)
    var = ((w - mean) ** 2).mean(dim=(1, 2, 3), keepdim=True)
    torch.testing.assert_close(tl._kernel(torch.float64),
                               ((w - mean) / torch.sqrt(var + 1e-8)),
                               rtol=1e-6, atol=1e-6)


# -- the family --------------------------------------------------------------------

_RESNETV2S = {
    # variant: (registered name, overrides). Widths multiples of 128, so
    # that every bottleneck's middle width takes GroupNorm's 32 groups.
    "preact_fixed": ("resnetv2_50x1_bitm",
                     dict(input_size=(64, 64), nb_blocks=(1, 2),
                          nb_channels=(128, 256), nb_classes=7)),
    # The hybrids' backbone form: non-preact, XLA SAME everywhere, on an
    # odd map (uneven SAME pads in the stem and the strided convs).
    "same_odd": ("resnetv2_50x1_bitm",
                 dict(input_size=(69, 69), nb_blocks=(2, 1),
                      nb_channels=(128, 256), nb_classes=7, preact=False,
                      stem_type="same", conv_padding="same")),
}


@pytest.mark.parametrize("variant", sorted(_RESNETV2S))
def test_small_resnetv2_matches_jax(variant):
    name, kw = _RESNETV2S[variant]
    jm, params, tm = jax_pair(name, seed=1, **kw)
    x = images((2, *kw["input_size"], 3), 2)
    assert check_model(jm, params, tm, x) == set()


@pytest.mark.parametrize("variant", sorted(_RESNETV2S))
def test_small_resnetv2_bf16_matches_jax(variant):
    name, kw = _RESNETV2S[variant]
    jm, params, tm = jax_pair(name, seed=3, **kw)
    check_bf16(jm, params, tm, images((2, *kw["input_size"], 3), 4))


@pytest.mark.parametrize("variant", sorted(_RESNETV2S))
def test_small_resnetv2_gradients_match_jax(variant):
    name, kw = _RESNETV2S[variant]
    jm, params, tm = jax_pair(name, seed=5, **kw)
    check_gradients(jm, params, tm, images((2, *kw["input_size"], 3), 6),
                    norm_stats=False)


def test_fixed_stem_pads_with_zeros():
    """The BiT stem's pool pads with zeros: a border window whose values are
    all negative maxes to 0, where -inf pads (PyTorch's max pool, the "same"
    stem's) keep the largest negative. Held against the JAX stem."""
    jstem = jresnetv2.ResNetV2Stem(3, "fixed", 64, "symmetric", True, "relu",
                                   "group_norm")
    p = seeded(jax.eval_shape(jstem.init, jax.random.PRNGKey(0)), 9)
    tstem = tresnetv2.ResNetV2Stem(3, "fixed", 64, "symmetric", True, "relu",
                                   "group_norm")
    tstem.load_state_dict(state_dict_from_jax(p))
    x = images((2, 20, 20, 3), 10)
    got = tstem(torch.from_numpy(x))
    assert rel(got, jstem(p, jnp.asarray(x))) < 1e-5
    conv = tstem.conv(torch.from_numpy(x)).permute(0, 3, 1, 2)
    inf_padded = F.max_pool2d(conv, 3, 2, padding=1).permute(0, 2, 3, 1)
    apart = got != inf_padded
    assert bool(apart.any())
    assert bool((got[apart] == 0).all()) and bool((inf_padded[apart] < 0).all())


def test_state_dict_follows_timm_and_round_trips():
    for variant, keys in (
            ("preact_fixed", ("stem.conv.weight",
                              "stages.0.blocks.0.downsample.conv.weight",
                              "stages.1.blocks.1.norm1.weight",
                              "stages.1.blocks.1.conv3.weight", "norm.bias",
                              "head.fc.weight")),
            ("same_odd", ("stem.conv.weight", "stem.norm.weight",
                          "stages.1.blocks.0.downsample.norm.bias",
                          "stages.0.blocks.1.norm3.weight", "head.fc.bias"))):
        name, kw = _RESNETV2S[variant]
        jm, params, tm = jax_pair(name, seed=7, **kw)
        sd = tm.state_dict()
        for key in keys:
            assert key in sd, (variant, key)
        assert ("norm.weight" in sd) == (variant == "preact_fixed")
        back = jax_from_state_dict(tm)
        flat = flatten_params(params)
        assert set(back) == set(flat)
        for key, value in flat.items():
            np.testing.assert_array_equal(back[key], np.asarray(value))


def test_golden_bit():
    model, data = check_golden("hf_bit.npz")
    assert rel(model.predict(torch.from_numpy(data["input"])), data["output"]) < 1e-3


def test_make_divisible_is_the_modules_own():
    for v in (16.0, 30.0, 64 * 0.25, 2048 * 0.25 * 3, 100.0, 7.0):
        assert tresnetv2._make_divisible(v) == jresnetv2._make_divisible(v)


def test_registry_matches_jax():
    check_registry_shapes("resnetv2", 15, (
        "nb_blocks", "nb_channels", "width_factor", "stem_width", "preact",
        "in_channels"))
    # Two widths run, one block a stage on a small map.
    for name in ("resnetv2_50x1_bitm", "resnetv2_50x3_bitm_in21k"):
        model = tfimm_tpu_torch.create_model(name, device="cpu",
                                             input_size=(64, 64),
                                             nb_blocks=(1, 1, 1, 1))
        out = model.predict(torch.zeros(1, 64, 64, 3))
        assert out.shape == (1, tfimm_tpu.model_config(name).nb_classes), name
