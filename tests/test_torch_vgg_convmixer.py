"""Port parity for VGG and ConvMixer: tfimm_tpu_torch against the JAX
package and the goldens (the reference's TensorFlow implementation), on
the CPU.

Parameters and inputs are made from a seed as in ``test_torch_resnet.py``
(He-scaled kernels, norm scales near 1) and carried by
``state_dict_from_jax``. Bars, as max|diff| / max|JAX|: 1e-3 in f32 for
the logits, every captured feature and the gradients, 5e-2 in bf16, 1e-3
for the goldens.
"""

import jax
import numpy as np
import pytest
import torch

import tfimm_tpu_torch
from tfimm_tpu.models import registry as jax_registry
from tfimm_tpu.utils.tree import flatten_params
from tests.test_torch_resnet import (
    check_bf16,
    check_golden,
    check_gradients,
    check_model,
    check_registry,
    images,
    jax_pair,
    rel,
)

torch.set_num_threads(2)

_MODELS = {
    # VGG-11's layer spec cut to three convs and two pools; the 7x7 valid
    # conv of pre_logits then sees a 7x7 map at 28x28.
    "vgg": ("vgg11", dict(input_size=(28, 28), layers=(8, "M", 16, 16, "M"),
                          nb_features=32, mlp_ratio=2.0, nb_classes=7)),
    "vgg_bn": ("vgg13_bn", dict(input_size=(32, 32),
                                layers=(8, "M", 16, "M"), nb_features=24,
                                nb_classes=7)),
    # A larger map than 7x7 before pre_logits: fc1 gives a 2x2 map and the
    # head pools it.
    "vgg_pooled_head": ("vgg11", dict(input_size=(32, 32), layers=(8, "M"),
                                      nb_features=16, nb_classes=7)),
    "convmixer_relu": ("convmixer_768_32", dict(input_size=(35, 35),
                                                embed_dim=32, depth=2,
                                                kernel_size=5, nb_classes=7)),
    # GELU and a patch of 14 on a map whose SAME pads are symmetric (k 9).
    "convmixer_gelu": ("convmixer_1024_20_ks9_p14",
                       dict(input_size=(56, 70), embed_dim=16, depth=2,
                            nb_classes=7)),
}


@pytest.mark.parametrize("variant", sorted(_MODELS))
def test_small_model_matches_jax(variant):
    name, kw = _MODELS[variant]
    jm, params, tm = jax_pair(name, seed=1, **kw)
    x = images((2, *kw["input_size"], 3), 2)
    assert check_model(jm, params, tm, x) == set()


@pytest.mark.parametrize("variant", ["vgg_bn", "convmixer_gelu"])
def test_small_model_bf16_matches_jax(variant):
    name, kw = _MODELS[variant]
    jm, params, tm = jax_pair(name, seed=3, **kw)
    check_bf16(jm, params, tm, images((2, *kw["input_size"], 3), 4))


@pytest.mark.parametrize("variant", ["vgg_bn", "convmixer_relu"])
def test_gradients_match_jax(variant):
    name, kw = _MODELS[variant]
    jm, params, tm = jax_pair(name, seed=5, **kw)
    check_gradients(jm, params, tm, images((4, *kw["input_size"], 3), 6))


def test_state_dicts_follow_timm():
    sd = tfimm_tpu_torch.create_model("vgg13_bn", device="cpu",
                                      **_MODELS["vgg_bn"][1]).state_dict()
    # conv 0, its norm 1, act 2, pool 3, conv 4, norm 5, act 6, pool 7.
    for key in ("features.0.weight", "features.1.running_var",
                "features.4.bias", "features.5.weight", "pre_logits.fc1.weight",
                "pre_logits.fc2.bias", "head.fc.weight"):
        assert key in sd, key
    assert tuple(sd["pre_logits.fc1.weight"].shape) == (24, 16, 7, 7)
    sd = tfimm_tpu_torch.create_model("convmixer_768_32", device="cpu",
                                      **_MODELS["convmixer_relu"][1]).state_dict()
    for key in ("stem.0.weight", "stem.2.running_mean", "blocks.1.0.fn.0.weight",
                "blocks.1.0.fn.2.bias", "blocks.1.1.weight", "blocks.1.3.weight",
                "head.weight"):
        assert key in sd, key
    assert tuple(sd["blocks.0.0.fn.0.weight"].shape) == (32, 1, 5, 5)


@pytest.mark.parametrize("fixture", ["ref_vgg.npz", "ref_convmixer.npz"])
def test_golden(fixture):
    model, data = check_golden(fixture)
    assert rel(model.predict(torch.from_numpy(data["input"])), data["output"]) < 1e-3


_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
               "var": "running_var"}


def test_registry_matches_jax():
    check_registry("vgg", 8)
    check_registry("convmixer", 3)
    # VGG at its full widths, built on the meta device (a full model is not
    # run on the CPU): the state dict's keys and sizes are the JAX tree's.
    for name in tfimm_tpu_torch.list_models(module="vgg"):
        jm = jax_registry.model_class(name)(jax_registry.model_config(name))
        tree = jax.eval_shape(jm.init_params, jax.random.PRNGKey(0))
        want = {}
        for path, leaf in flatten_params(tree).items():
            head, _, tail = path.rpartition(".")
            want[f"{head}.{_LEAF_NAMES.get(tail, tail)}"] = int(np.prod(leaf.shape))
        with torch.device("meta"):
            model = tfimm_tpu_torch.model_class(name)(
                tfimm_tpu_torch.model_config(name))
        assert {k: v.numel() for k, v in model.state_dict().items()} == want
    # ConvMixer at its full widths, cut to two blocks, serves an image.
    for name in tfimm_tpu_torch.list_models(module="convmixer"):
        model = tfimm_tpu_torch.create_model(name, device="cpu", depth=2)
        assert model.predict(torch.zeros(1, 56, 56, 3)).shape == (1, 1000)
