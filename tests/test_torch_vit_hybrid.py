"""Port parity for the hybrid ViTs (a ResNetV2 stem, or stem and stages,
under the ViT's patch projection): tfimm_tpu_torch against the JAX package
and the golden (the reference's TensorFlow implementation), on the CPU,
and training through ``run()`` step for step with the JAX package.

Parameters and inputs are made from a seed as in ``test_torch_resnet.py``
and carried by ``state_dict_from_jax``. The port's blocks take
``fused_mha`` (its plain version on the CPU; under autograd its backward's
plain version). Bars, as max|diff| / max|JAX|: 1e-3 in f32 (logits, every
feature, gradients), 5e-2 in bf16, 1e-3 for the golden; through ``run()``
1e-5 for each step's loss and 1e-4 for every parameter after three steps.

``run_step_for_step`` serves ``test_torch_pit.py`` too.
"""

import dataclasses

import jax.numpy as jnp
import pytest
import torch

import tfimm_tpu
import tfimm_tpu.train as jtrain
import tfimm_tpu_torch
import tfimm_tpu_torch.train as ttrain
from tests.test_torch_efficientnet import check_registry_shapes
from tests.test_torch_resnet import (
    check_bf16,
    check_golden,
    check_gradients,
    check_model,
    images,
    jax_pair,
    jitted,
    rel,
    seeded,
)
from tfimm_tpu.models import registry as jax_registry
from tfimm_tpu_torch.architectures.resnetv2 import ResNetV2, ResNetV2Stem
from tfimm_tpu_torch.models import registry as torch_registry
from tfimm_tpu_torch.ops.kernels.dispatch import capture_dispatches
from tfimm_tpu_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(2)

_HYBRIDS = {
    # variant: (registered name, overrides). The stem-only form: a 128x128
    # image, stem to 32x32, patches of 8: a 4x4 grid.
    "stem_only": ("vit_tiny_r_s16_p8_224",
                  dict(input_size=(128, 128), embed_dim=64, nb_blocks=2,
                       nb_heads=2, mlp_ratio=2.0, nb_classes=7)),
    # Stem and two stages (256 and 512 channels): 64 / 8, an 8x8 grid; the
    # 1x1 projection takes the reshape into F.linear.
    "backbone": ("vit_small_r26_s32_224",
                 dict(input_size=(64, 64), patch_nb_blocks=(1, 1),
                      embed_dim=64, nb_blocks=2, nb_heads=2, mlp_ratio=2.0,
                      nb_classes=7)),
}


@pytest.mark.parametrize("variant", sorted(_HYBRIDS))
def test_small_hybrid_matches_jax(variant):
    """Logits and every feature: the ViT's names alone, none of the
    backbone's. (Capturing the attention weights sends the blocks to the
    plain attention; ``predict`` takes fused_mha, below.)"""
    name, kw = _HYBRIDS[variant]
    jm, params, tm = jax_pair(name, seed=1, **kw)
    backbone = tm.patch_embed.backbone
    assert isinstance(backbone, ResNetV2Stem if variant == "stem_only"
                      else ResNetV2)
    x = images((2, *kw["input_size"], 3), 2)
    assert check_model(jm, params, tm, x) == {"attention[plain]"}
    with capture_dispatches() as seen:
        assert rel(tm.predict(torch.from_numpy(x)),
                   jitted(jm, params, jnp.asarray(x))) < 1e-3
    assert seen == {"fused_mha"}
    assert tm.feature_names[0] == "patch_embedding"
    assert not any(n.startswith("stem") for n in tm.feature_names)
    assert tm.cfg.grid_size == ((4, 4) if variant == "stem_only" else (8, 8))


@pytest.mark.parametrize("variant", sorted(_HYBRIDS))
def test_small_hybrid_bf16_matches_jax(variant):
    name, kw = _HYBRIDS[variant]
    jm, params, tm = jax_pair(name, seed=3, **kw)
    check_bf16(jm, params, tm, images((2, *kw["input_size"], 3), 4))


@pytest.mark.parametrize("variant", sorted(_HYBRIDS))
def test_small_hybrid_gradients_match_jax(variant):
    """Training: the backbone's StdConv2d and GroupNorm under autograd, the
    blocks through fused_mha's autograd function. (With images from seed 6
    the backbone form puts a ReLU input of the backbone within f32 rounding
    of its kink in the JAX package: the stem's and stage 0's gradients part
    by up to 3e-2, where the port agrees with its own float64 to 5e-6 and
    the JAX package misses it by 3e-2. With images from seed 16, and with
    three other seeds of parameters and images, both agree to 1e-5, as
    ``test_torch_resnet.py`` describes.)"""
    name, kw = _HYBRIDS[variant]
    jm, params, tm = jax_pair(name, seed=5, **kw)
    with capture_dispatches() as seen:
        check_gradients(jm, params, tm, images((2, *kw["input_size"], 3), 16),
                        norm_stats=False)
    assert seen == {"fused_mha"}


def test_drop_path_reaches_the_backbone():
    name, kw = _HYBRIDS["backbone"]
    tm = tfimm_tpu_torch.create_model(name, device="cpu", drop_path_rate=0.2,
                                      **kw)
    rates = [b.drop_path_rate for st in tm.patch_embed.backbone.stages
             for b in st.blocks]
    jm = tfimm_tpu.create_model(name, drop_path_rate=0.2, **kw)
    want = [b.dpr for st in jm.patch_embed.backbone.stages for b in st]
    assert rates == pytest.approx(want) and rates[-1] == pytest.approx(0.2)
    assert tm.blocks[0].drop_path_rate == 0.2


@pytest.mark.parametrize("variant", sorted(_HYBRIDS))
def test_interpolate_input_and_transfer_match_jax(variant):
    name, kw = _HYBRIDS[variant]
    kw = dict(kw, interpolate_input=True)
    jm, params, tm = jax_pair(name, seed=7, **kw)
    h, w = kw["input_size"]
    x = images((2, h + 32, w, 3), 8)   # a taller grid than the table's
    want = jitted(jm, params, jnp.asarray(x))
    assert rel(tm.predict(torch.from_numpy(x)), want) < 1e-3
    # transfer_weights carries the table to another input size through the
    # model's hook, as the JAX package's does.
    big = dict(kw, input_size=(h + 64, w + 64))
    jbig = tfimm_tpu.create_model(name, **big)
    tfimm_tpu.transfer_weights(jm, jbig)
    tbig = tfimm_tpu_torch.create_model(name, device="cpu", **big)
    tfimm_tpu_torch.transfer_weights(tm, tbig)
    assert tbig.pos_embed.shape == tuple(jbig.params["pos_embed"].shape)
    assert tbig.pos_embed.shape[1] > tm.pos_embed.shape[1]
    assert rel(tbig.pos_embed, jbig.params["pos_embed"]) < 1e-5
    assert rel(tbig.patch_embed.proj.weight,
               state_dict_from_jax(jbig.params)["patch_embed.proj.weight"]
               .numpy()) == 0


def test_golden_vit_hybrid():
    model, data = check_golden("ref_vit_hybrid.npz")
    assert rel(model.predict(torch.from_numpy(data["input"])), data["output"]) < 1e-3


def test_registry_matches_jax():
    check_registry_shapes("vit_hybrid", 11, (
        "patch_nb_blocks", "patch_size", "embed_dim", "nb_blocks", "nb_heads",
        "input_size", "representation_size", "in_channels"))
    for name in tfimm_tpu_torch.list_models(module="vit_hybrid"):
        cfg = tfimm_tpu_torch.model_config(name)
        assert cfg.grid_size == tfimm_tpu.model_config(name).grid_size
        assert cfg.first_conv in {"patch_embed.backbone.conv",
                                  "patch_embed.backbone.stem.conv"}
    # The three trunks run at full width, one block, on a small image.
    for name in ("vit_tiny_r_s16_p8_224", "vit_small_r26_s32_224",
                 "vit_base_r50_s16_224_in21k"):
        model = tfimm_tpu_torch.create_model(name, device="cpu", nb_blocks=1,
                                             input_size=(64, 64))
        with capture_dispatches() as seen:
            out = model.predict(torch.zeros(1, 64, 64, 3))
        assert seen == {"fused_mha"}
        assert out.shape == (1, model.cfg.nb_classes), name


# -- training through run() ----------------------------------------------------------

TRAIN_NAME = "train_parity_hybrid"


def run_step_for_step(monkeypatch, registered, overrides, seed):
    """``run()`` from one config dict in both packages, a small copy of
    ``registered`` (with ``overrides``) under TRAIN_NAME in both registries:
    SGD with momentum at a constant lr of 0.01, L2 weight decay 1e-4, three
    steps of batch 4, a validation before training and after each epoch.
    Both models start from the same seeded parameters. Every step's loss
    within 1e-5, the validation accuracies equal, every parameter after the
    three steps within 1e-4. Returns the kernels the port dispatched."""
    for reg in (jax_registry, torch_registry):
        monkeypatch.setitem(reg._model_class, TRAIN_NAME,
                            reg.model_class(registered))
        monkeypatch.setitem(reg._model_config, TRAIN_NAME, dataclasses.replace(
            reg.model_config(registered), name=TRAIN_NAME, **overrides))
    jm = jtrain.ModelFactory(jtrain.ModelConfig(model_name=TRAIN_NAME))()[0]
    jinit = seeded(jm.params, seed)
    init = state_dict_from_jax(jinit)
    jfactory, tfactory = jtrain.ModelFactory.__call__, ttrain.ModelFactory.__call__

    def jax_with_init(self):
        model, pp = jfactory(self)
        model.params = jinit
        return model, pp

    def torch_with_init(self, device):
        model, pp = tfactory(self, device)
        model.load_state_dict(init)
        return model, pp

    monkeypatch.setattr(jtrain.ModelFactory, "__call__", jax_with_init)
    monkeypatch.setattr(ttrain.ModelFactory, "__call__", torch_with_init)
    seen = {"jax": [], "torch": []}
    problems = {}
    for key, pkg in (("jax", jtrain), ("torch", ttrain)):
        cls = pkg.ClassificationProblem

        def record(method, key=key):
            def wrapped(self, *args):
                problems[key] = self
                out = method(self, *args)
                seen[key].append(out[0] if isinstance(out, tuple) else out)
                return out
            return wrapped

        monkeypatch.setattr(cls, "train_step", record(cls.train_step))
        monkeypatch.setattr(cls, "validation", record(cls.validation))
    size = tuple(overrides["input_size"])
    data = {"batch_size": 4, "nb_samples": 4, "input_size": size,
            "nb_classes": overrides["nb_classes"], "seed": 1}
    cfg = {
        "trainer_class": "Trainer",
        "trainer": {"validation_before_training": True,
                    "display_loss_every_it": 1},
        "problem_class": "ClassificationProblem",
        "problem": {"model_class": "ModelFactory",
                    "model": {"model_name": TRAIN_NAME},
                    "optimizer_class": "OptimizerFactory",
                    "optimizer": {"optimizer": "sgd",
                                  "lr_schedule_class": "LRConstFactory",
                                  "lr_schedule": {"lr": 0.01}},
                    "weight_decay": 1e-4},
        "train_dataset_class": "SyntheticDataset", "train_dataset": data,
        "val_dataset_class": "SyntheticDataset", "val_dataset": data,
        "timekeeping_class": "Timekeeping",
        "timekeeping": {"nb_epochs": 3, "batch_size": 4,
                        "nb_samples_per_epoch": 4},
    }
    jtrain.run(cfg, parse_cmdline_args=False)
    with capture_dispatches() as port_seen:
        ttrain.run(dict(cfg, device="cpu"), parse_cmdline_args=False)
    assert len(seen["torch"]) == len(seen["jax"]) == 3 + 4
    for got, want in zip(seen["torch"], seen["jax"]):
        if isinstance(want, dict):
            assert got == want
        else:
            assert rel(got, want) < 1e-5
    want = state_dict_from_jax(problems["jax"].params)
    got = problems["torch"].model.state_dict()
    assert set(got) == set(want)
    for name, value in got.items():
        assert rel(value, want[name].numpy()) < 1e-4, name
    assert any(not torch.equal(got[k], init[k]) for k in got)
    return port_seen


def test_run_trains_hybrid_step_for_step_with_jax(monkeypatch):
    """The backbone form: StdConv2d and GroupNorm under autograd, the blocks
    through fused_mha and its backward (their plain versions here)."""
    name, kw = _HYBRIDS["backbone"]
    seen = run_step_for_step(monkeypatch, name, kw, seed=9)
    assert seen == {"fused_mha"}
