"""Port parity for MLP-Mixer, ResMLP and gMLP and the gated MLPs they
bring: tfimm_tpu_torch against the JAX package and the goldens (the
reference's TensorFlow implementation), on the CPU.

Parameters and inputs are made from a seed as in ``test_torch_resnet.py``
(He-scaled kernels, norm scales near 1; ResMLP's ``ls1`` and ``ls2`` and
gMLP's gate bias at std 0.1) and carried by ``state_dict_from_jax``. Bars,
as max|diff| / max|JAX|: 1e-5 for one op in f32 and 2e-2 in bf16; 1e-3
for a small model in f32 (every captured feature, the logits, the
gradients) and 5e-2 in bf16; the goldens 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfimm_tpu_torch
from tfimm_tpu.ops import mlp as jmlp
from tfimm_tpu.utils.tree import flatten_params
from tfimm_tpu_torch.ops import mlp as tmlp
from tfimm_tpu_torch.utils.convert import jax_from_state_dict, state_dict_from_jax
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

torch.set_num_threads(2)


# -- ops -------------------------------------------------------------------------

_OPS = {
    # name: (JAX layer, port layer, input shape)
    "glu_mlp_swish": (lambda: jmlp.GluMLP(24, 48, act_layer="swish"),
                      lambda: tmlp.GluMLP(24, 48, act_layer="swish"),
                      (2, 10, 24)),
    "glu_mlp_sigmoid": (lambda: jmlp.GluMLP(24, 32),
                        lambda: tmlp.GluMLP(24, 32), (2, 10, 24)),
    "spatial_gating": (lambda: jmlp.SpatialGatingUnit(32, 12),
                       lambda: tmlp.SpatialGatingUnit(32, 12), (2, 12, 32)),
    "gated_mlp": (lambda: jmlp.GatedMLP(16, 48, seq_len=12),
                  lambda: tmlp.GatedMLP(16, 48, 12), (2, 12, 16)),
}


@pytest.mark.parametrize("op", sorted(_OPS))
def test_gated_mlps_match_jax(op):
    make_jax, make_port, shape = _OPS[op]
    jl, tl = make_jax(), make_port()
    p = seeded(jax.eval_shape(jl.init, jax.random.PRNGKey(0)), 1)
    tl.load_state_dict(state_dict_from_jax(p))   # strict: timm's names
    back = jax_from_state_dict(tl)
    assert set(back) == set(flatten_params(p))
    x = images(shape, 2)
    for dtype, bar in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
        cast = jax.tree_util.tree_map(lambda a: a.astype(jdtype), p)
        got = tl.to(dtype)(torch.from_numpy(x).to(dtype))
        assert got.dtype == dtype
        assert rel(got, jl(cast, jnp.asarray(x, jdtype))) < bar, dtype


def test_spatial_gating_starts_as_the_identity_gate():
    """proj starts near zero with its bias at one: the unit then gives the
    first half of the channels, as the JAX unit's init does."""
    tl = tmlp.SpatialGatingUnit(32, 12,
                                generator=torch.Generator().manual_seed(0))
    assert float(tl.proj.weight.detach().abs().max()) <= 2e-6
    assert torch.all(tl.proj.bias == 1)
    x = torch.from_numpy(images((2, 12, 32), 3))
    torch.testing.assert_close(tl(x), x[..., :16], atol=1e-4, rtol=0)
    jl = jmlp.SpatialGatingUnit(32, 12)
    jp = jl.init(jax.random.PRNGKey(0))
    assert float(jnp.abs(jp["proj"]["kernel"]).max()) <= 2e-6
    assert bool(jnp.all(jp["proj"]["bias"] == 1))


# -- the family ------------------------------------------------------------------

_SMALL = dict(input_size=(64, 64), patch_size=16, embed_dim=32, nb_blocks=2,
              nb_classes=7)
_MODELS = {
    "mixer": ("mixer_b16_224", dict(_SMALL, mlp_ratio=(0.5, 2.0))),
    # Patch 8: N = 64 tokens for the token Dense.
    "resmlp": ("resmlp_12_224", dict(_SMALL, patch_size=8, mlp_ratio=(2.0, 2.0))),
    "gmlp": ("gmlp_s16_224", dict(_SMALL, mlp_ratio=(2.0, 2.0))),
    "gmixer": ("gmixer_12_224", dict(_SMALL, mlp_ratio=(1.0, 2.0))),
}


@pytest.mark.parametrize("variant", sorted(_MODELS))
def test_small_model_matches_jax(variant):
    name, kw = _MODELS[variant]
    jm, params, tm = jax_pair(name, seed=1, **kw)
    x = images((2, 64, 64, 3), 2)
    assert check_model(jm, params, tm, x) == set()


@pytest.mark.parametrize("variant", sorted(_MODELS))
def test_small_model_bf16_matches_jax(variant):
    name, kw = _MODELS[variant]
    jm, params, tm = jax_pair(name, seed=3, **kw)
    check_bf16(jm, params, tm, images((2, 64, 64, 3), 4))


@pytest.mark.parametrize("variant", sorted(_MODELS))
def test_small_model_gradients_match_jax(variant):
    name, kw = _MODELS[variant]
    jm, params, tm = jax_pair(name, seed=5, **kw)
    check_gradients(jm, params, tm, images((3, 64, 64, 3), 6),
                    norm_stats=False)


def test_state_dict_follows_timm_and_round_trips():
    for variant, keys in (
            ("resmlp", ("stem.proj.weight", "blocks.0.ls1", "blocks.1.ls2",
                        "blocks.0.norm1.weight", "blocks.0.linear_tokens.weight",
                        "blocks.0.mlp_channels.fc2.bias", "head.weight")),
            ("gmlp", ("blocks.0.mlp_channels.gate.proj.weight",
                      "blocks.0.mlp_channels.gate.norm.bias", "norm.weight"))):
        name, kw = _MODELS[variant]
        jm, params, tm = jax_pair(name, seed=7, **kw)
        sd = tm.state_dict()
        for key in keys:
            assert key in sd, key
        back = jax_from_state_dict(tm)
        flat = flatten_params(params)
        assert set(back) == set(flat)
        for key, value in flat.items():
            np.testing.assert_array_equal(back[key], np.asarray(value))


@pytest.mark.parametrize("fixture", ["ref_mixer.npz", "ref_gmlp.npz"])
def test_golden(fixture):
    model, data = check_golden(fixture)
    assert rel(model.predict(torch.from_numpy(data["input"])), data["output"]) < 1e-3


def test_registry_matches_jax():
    check_registry_shapes("mlp_mixer", 26, (
        "input_size", "patch_size", "embed_dim", "nb_blocks", "mlp_ratio",
        "block_layer", "mlp_layer", "norm_layer", "stem_norm", "in_channels"))
    miil = tfimm_tpu_torch.model_config("mixer_b16_224_miil")
    assert miil.interpolation == "bilinear"
    pp = tfimm_tpu_torch.create_preprocessing("mixer_b16_224_miil", device="cpu")
    img = torch.full((1, 2, 2, 3), 51.0)
    torch.testing.assert_close(pp(img), torch.full((1, 2, 2, 3), 0.2))
