"""Port parity for the training path: tfimm_tpu_torch.train and
tfimm_tpu_torch.parallel.step against the JAX package's train/ and
parallel/step.py, on the CPU.

Both packages get the same numpy inputs, made from a seed, and the same
parameters (the JAX model's, loaded into the port with
``state_dict_from_jax``). A small ViT (64x64, patch 16, D = 128, H = 2,
d = 64, 2 blocks, 7 classes) is registered in both registries for the
length of a test. Bars, as max|diff| / max|JAX|: 1e-6 for losses and
optimizer updates (the same f32 formulas); 1e-5 for per-step losses and
1e-4 for parameters after 3 steps of a whole ViT (f32 sums in another
order through a dozen layers); 2e-2 for a bf16 mixed-precision loss (bf16
rounds in other places in the two frameworks).
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

import tfimm_tpu
import tfimm_tpu.architectures.segment_anything  # noqa: F401
import tfimm_tpu.train as jtrain
import tfimm_tpu_torch
import tfimm_tpu_torch.train as ttrain
from tfimm_tpu.architectures.cait import CaiT as JaxCaiT
from tfimm_tpu.architectures.cait import CaiTConfig as JaxCaiTConfig
from tfimm_tpu.architectures.convnext import ConvNeXt as JaxConvNeXt
from tfimm_tpu.architectures.convnext import ConvNeXtConfig as JaxConvNeXtConfig
from tfimm_tpu.architectures.swin import SwinTransformer as JaxSwin
from tfimm_tpu.architectures.swin import SwinTransformerConfig as JaxSwinConfig
from tfimm_tpu.architectures.vit import ViT as JaxViT
from tfimm_tpu.architectures.vit import ViTConfig as JaxViTConfig
from tfimm_tpu.models import registry as jax_registry
from tfimm_tpu.ops.pallas.dispatch import capture_dispatches as jax_capture
from tfimm_tpu.parallel.step import cross_entropy_loss as jax_ce
from tfimm_tpu.train import optimizers as jopt
from tfimm_tpu.train import transforms as jtransforms
from tfimm_tpu.utils.tree import flatten_params
from tfimm_tpu_torch.architectures.cait import CaiT, CaiTConfig
from tfimm_tpu_torch.architectures.convnext import ConvNeXt, ConvNeXtConfig
from tfimm_tpu_torch.architectures.swin import SwinTransformer
from tfimm_tpu_torch.architectures.swin import SwinTransformerConfig
from tfimm_tpu_torch.architectures.vit import ViT, ViTConfig
from tfimm_tpu_torch.models import registry as torch_registry
from tfimm_tpu_torch.ops.kernels import dispatch
from tfimm_tpu_torch.parallel.step import (
    cross_entropy_loss,
    l2_weights,
    make_train_step,
)
from tfimm_tpu_torch.train import optimizers as topt
from tfimm_tpu_torch.train import transforms as ttransforms
from tfimm_tpu_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
NAME = "train_parity_vit"
SMALL = dict(input_size=(64, 64), patch_size=16, embed_dim=128, nb_blocks=2,
             nb_heads=2, nb_classes=7)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


@pytest.fixture
def small_vit(monkeypatch):
    """The small ViT under NAME in both model registries, for one test."""
    for reg, cls, cfg_cls in ((jax_registry, JaxViT, JaxViTConfig),
                              (torch_registry, ViT, ViTConfig)):
        monkeypatch.setitem(reg._model_class, NAME, cls)
        monkeypatch.setitem(reg._model_config, NAME, cfg_cls(name=NAME, **SMALL))
    return NAME


def _seeded(params, seed):
    rng = np.random.default_rng(seed)
    leaves, tree = jax.tree_util.tree_flatten_with_path(params)
    new = []
    for path, leaf in leaves:
        r = rng.normal(size=np.shape(leaf)).astype(np.float32)
        is_scale = getattr(path[-1], "key", None) == "scale"
        new.append(jnp.asarray(1.0 + 0.1 * r if is_scale else 0.05 * r))
    return jax.tree_util.tree_unflatten(tree, new)


# -- (c) loss, optimizers, schedules ---------------------------------------------

@pytest.mark.parametrize("case", ["int", "smooth", "soft", "distilled"])
def test_cross_entropy_matches_optax(case):
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(6, 2, 5) if case == "distilled" else (6, 5)) * 3
    labels = rng.integers(0, 5, size=(6,))
    if case == "soft":
        labels = rng.dirichlet(np.ones(5), size=6)
    smoothing = 0.1 if case == "smooth" else 0.0
    logits = logits.astype(np.float32)
    want = jax_ce(jnp.asarray(logits), jnp.asarray(labels),
                  label_smoothing=smoothing)
    got = cross_entropy_loss(torch.from_numpy(logits),
                             torch.from_numpy(labels).to(
                                 torch.float32 if case == "soft" else torch.int64),
                             label_smoothing=smoothing)
    assert _rel(got, want) < 1e-6


_TK = dict(nb_epochs=5, batch_size=1, nb_samples_per_epoch=1)  # 1 step / epoch

_OPT_CASES = {
    "sgd-default-momentum": dict(optimizer="sgd", lr_schedule_class="LRConstFactory",
                                 lr_schedule=dict(lr=0.05)),
    "sgd-no-momentum-clipvalue": dict(optimizer="sgd", betas=(0.0, 0.999),
                                      clipvalue=0.3,
                                      lr_schedule_class="LRConstFactory",
                                      lr_schedule=dict(lr=0.05)),
    "adam-cosine-warmup": dict(optimizer="adam", lr_warmup=2,
                               lr_schedule_class="LRCosineDecayFactory",
                               lr_schedule=dict(lr=1e-2, alpha=0.1)),
    "adam-clipnorm-multisteps": dict(optimizer="adam", clipnorm=0.5,
                                     lr_schedule_class="LRMultiStepsFactory",
                                     lr_schedule=dict(lr_boundaries=(2, 4),
                                                      lr_values=(1e-2, 5e-3, 1e-3))),
    "adamw-expdecay": dict(optimizer="adamw", weight_decay=0.05,
                           lr_schedule_class="LRExpDecayFactory",
                           lr_schedule=dict(lr=1e-2, lr_decay_rate=0.5,
                                            staircase=False)),
    "adamw-expdecay-staircase-warmup": dict(
        optimizer="adamw", weight_decay=0.05, lr_warmup=1,
        lr_schedule_class="LRExpDecayFactory",
        lr_schedule=dict(lr=1e-2, lr_decay_rate=0.5, lr_decay_frequency=2)),
}


def _factories(spec):
    """The same optimizer config in both packages."""
    out = []
    for pkg in (jtrain, ttrain):
        spec_ = dict(spec)
        sched_cls = pkg.get_cfg_class(spec_["lr_schedule_class"])
        spec_["lr_schedule"] = sched_cls(**spec_["lr_schedule"])
        out.append(pkg.OptimizerFactory(pkg.OptimizerConfig(**spec_),
                                        timekeeping=pkg.Timekeeping(**_TK)))
    return out


@pytest.mark.parametrize("case", sorted(_OPT_CASES))
def test_optimizer_and_schedule_match_optax(case):
    jax_factory, torch_factory = _factories(_OPT_CASES[case])
    rng = np.random.default_rng(2)
    init = {"w": rng.normal(size=(4, 3)).astype(np.float32),
            "b": rng.normal(size=(3,)).astype(np.float32)}
    grads = [{k: (rng.normal(size=v.shape) * 0.5).astype(np.float32)
              for k, v in init.items()} for _ in range(5)]

    tx, jax_schedule = jax_factory()
    params = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(params)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in init.items()}
    opt, schedule = torch_factory(tparams.values())
    for step, g in enumerate(grads):
        assert _rel(schedule(step), jax_schedule(step)) < 1e-6, step
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, params)
        params = optax.apply_updates(params, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        for k in init:
            assert _rel(tparams[k].detach(), params[k]) < 1e-6, (step, k)


def test_clipnorm_scales_as_optax_does():
    # The global norm of these gradients is 5: clipped to 2, they are scaled
    # by exactly 2 / 5 (no epsilon, as in optax.clip_by_global_norm).
    p = torch.nn.Parameter(torch.zeros(2))
    opt = topt.Optimizer(torch.optim.SGD([p], lr=1.0), topt.constant_schedule(1.0),
                         clipnorm=2.0)
    p.grad = torch.tensor([3.0, 4.0])
    opt.step()
    torch.testing.assert_close(p.detach(), torch.tensor([-1.2, -1.6]))
    assert opt.step_count == 1


@pytest.mark.parametrize("spec", [dict(optimizer=o) for o in
                                  ("rmsprop", "adamax", "adadelta", "adagrad")]
                         + [dict(optimizer="adam", accum_steps=2)])
def test_optimizers_not_ported_raise(spec):
    factory = topt.OptimizerFactory(
        topt.OptimizerConfig(lr_schedule_class="LRConstFactory",
                             lr_schedule=topt.LRConstConfig(), **spec),
        timekeeping=ttrain.Timekeeping(**_TK))
    with pytest.raises(NotImplementedError, match="item 16"):
        factory([torch.nn.Parameter(torch.zeros(1))])


def test_optimizer_defaults_follow_the_jax_package():
    factory = topt.OptimizerFactory(
        topt.OptimizerConfig(lr_schedule_class="LRConstFactory",
                             lr_schedule=topt.LRConstConfig()),
        timekeeping=ttrain.Timekeeping(**_TK))
    opt, _ = factory([torch.nn.Parameter(torch.zeros(1))])
    group = opt.optimizer.param_groups[0]
    assert isinstance(opt.optimizer, torch.optim.SGD)
    assert group["momentum"] == 0.9 and group["dampening"] == 0
    assert not group["nesterov"]
    assert topt.OptimizerConfig().epsilon == jopt.OptimizerConfig().epsilon == 1e-7


# -- (d)-(f) the problem and run() -----------------------------------------------

def _problem_cfgs(optimizer, lr, weight_decay, mixed_precision=False):
    """Configs of both packages. adamw gets epsilon 1e-3: with the default
    1e-7, Adam turns the rounding noise of gradients that vanish in exact
    arithmetic (the key bias: softmax ignores a per-query constant) into
    steps of full size and random sign, in each package differently."""
    out = []
    for pkg in (jtrain, ttrain):
        adamw = optimizer == "adamw"
        opt = pkg.OptimizerConfig(
            optimizer=optimizer, weight_decay=0.05 if adamw else 0.0,
            epsilon=1e-3 if adamw else 1e-7,
            lr_schedule_class="LRConstFactory",
            lr_schedule=pkg.get_cfg_class("LRConstConfig")(lr=lr))
        out.append(pkg.ClassificationConfig(
            model=pkg.ModelConfig(model_name=NAME), model_class="ModelFactory",
            optimizer=opt, optimizer_class="OptimizerFactory",
            weight_decay=weight_decay, mixed_precision=mixed_precision))
    return out


def _problems(optimizer, lr, weight_decay, mixed_precision=False, seed=0):
    """Both problems, holding the same seeded parameters."""
    jcfg, tcfg = _problem_cfgs(optimizer, lr, weight_decay, mixed_precision)
    tk = dict(nb_epochs=1, batch_size=4, nb_samples_per_epoch=12)
    jp = jtrain.ClassificationProblem(jcfg, timekeeping=jtrain.Timekeeping(**tk))
    params = _seeded(jp.params, seed)
    jp.params = jp.model.params = params
    jp.opt_state = jp.tx.init(params)
    tp = ttrain.ClassificationProblem(tcfg, timekeeping=ttrain.Timekeeping(**tk),
                                      device="cpu")
    tp.model.load_state_dict(state_dict_from_jax(params))
    return jp, tp


def _batches(seed, nb):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(0, 255, size=(4, 64, 64, 3)).astype(np.float32),
             rng.integers(0, 7, size=(4,))) for _ in range(nb)]


@pytest.mark.parametrize("optimizer,lr", [("sgd", 0.05), ("adamw", 1e-3)])
def test_train_step_matches_jax(small_vit, optimizer, lr):
    jp, tp = _problems(optimizer, lr, weight_decay=1e-3)
    with dispatch.capture_dispatches() as seen:
        for it, batch in enumerate(_batches(3, 3)):
            want, _ = jp.train_step(batch, it)
            got, logs = tp.train_step(batch, it)
            assert _rel(got, want) < 1e-5, it
    assert seen == {"fused_mha"}
    assert set(logs) == {"train/loss", "train/accuracy"}
    want_params = state_dict_from_jax(jp.params)
    for name, p in tp.model.state_dict().items():
        assert _rel(p, want_params[name]) < 1e-4, name
    # The blocks moved: their gradients went through the attention backward.
    start = state_dict_from_jax(_seeded(jp.model.params, 0))
    assert not torch.equal(tp.model.state_dict()["blocks.0.attn.qkv.weight"],
                           start["blocks.0.attn.qkv.weight"])


def test_mixed_precision_step_matches_jax(small_vit):
    jp, tp = _problems("sgd", 0.05, weight_decay=0.0, mixed_precision=True,
                       seed=4)
    batch = _batches(5, 1)[0]
    want, _ = jp.train_step(batch, 0)
    got, _ = tp.train_step(batch, 0)
    assert _rel(got, want) < 2e-2
    assert all(p.dtype == torch.float32 for p in tp.model.parameters())


def _l2_model(family):
    """A small model of every ported family: (registered name, overrides)."""
    return {
    "vit": ("vit_tiny_patch16_224", dict(SMALL)),
    "convnext": ("convnext_tiny", dict(input_size=(32, 32), embed_dim=(32, 64),
                                       nb_blocks=(1, 1), nb_classes=7)),
    "swin": ("swin_tiny_patch4_window7_224", dict(SWIN_SMALL)),
    "cait": ("cait_xxs24_224", dict(input_size=(32, 32), patch_size=8,
                                    embed_dim=128, nb_blocks=2, nb_heads=4,
                                    nb_classes=7)),
    "sam": ("sam_vit_b", dict(input_size=(64, 64), encoder_embed_dim=16,
                              encoder_nb_blocks=2, encoder_nb_heads=2,
                              embed_dim=16, encoder_global_attn_indices=(1,),
                              encoder_window_size=2, prompt_mask_hidden_dim=8,
                              decoder_nb_blocks=1, decoder_nb_heads=2,
                              decoder_mlp_channels=16,
                              decoder_iou_hidden_dim=8)),
    "pvt": ("pvt_tiny", dict(input_size=(64, 64), embed_dim=(8, 16, 24, 32),
                             nb_heads=(1, 2, 3, 4), mlp_ratio=(2.0,) * 4,
                             nb_blocks=(1, 1, 1, 1), nb_classes=7)),
    "pvt_v2": ("pvt_v2_b2_linear", dict(input_size=(64, 64), embed_dim=(8, 16),
                                        nb_heads=(1, 2), mlp_ratio=(2.0, 2.0),
                                        nb_blocks=(1, 1), sr_ratio=(4, 2),
                                        nb_classes=7)),
    "poolformer": ("poolformer_s12", dict(input_size=(64, 64),
                                          embed_dim=(16, 32), nb_blocks=(1, 1),
                                          nb_classes=7)),
    "resnet": ("ecaresnet50d", dict(input_size=(32, 32), nb_blocks=(1, 1, 1, 1),
                                    nb_channels=(8, 8, 16, 16), nb_classes=7)),
    "vgg": ("vgg11_bn", dict(input_size=(32, 32), layers=(8, "M", 16, "M"),
                             nb_features=16, nb_classes=7)),
    "convmixer": ("convmixer_768_32", dict(input_size=(28, 28), embed_dim=16,
                                           depth=1, kernel_size=3,
                                           nb_classes=7)),
    "pit": ("pit_ti_224", dict(input_size=(48, 48), embed_dim=(16, 32, 64),
                               nb_blocks=(1, 1, 1), nb_heads=(1, 2, 4),
                               nb_classes=7)),
    "efficientnet": ("efficientnet_v2_s", dict(
        input_size=(32, 32), stem_size=8, nb_features=64,
        channel_multiplier=0.25, depth_multiplier=0.25, nb_classes=7)),
    "mlp_mixer": ("gmlp_s16_224", dict(input_size=(32, 32), patch_size=8,
                                       embed_dim=16, nb_blocks=2,
                                       mlp_ratio=(2.0, 2.0), nb_classes=7)),
    "resnetv2": ("resnetv2_50x1_bitm", dict(input_size=(32, 32),
                                            nb_blocks=(1, 1),
                                            nb_channels=(128, 256),
                                            nb_classes=7)),
    "vit_hybrid": ("vit_small_r26_s32_224", dict(input_size=(32, 32),
                                                 patch_nb_blocks=(1, 1),
                                                 embed_dim=32, nb_blocks=1,
                                                 nb_heads=2, nb_classes=7)),
    }[family]


@pytest.mark.parametrize("family", ["cait", "convmixer", "convnext",
                                    "efficientnet", "mlp_mixer", "pit",
                                    "poolformer", "pvt", "pvt_v2", "resnet",
                                    "resnetv2", "sam", "swin", "vgg", "vit",
                                    "vit_hybrid"])
def test_l2_covers_the_jax_kernel_leaves(family):
    """The L2 penalty covers exactly the JAX package's ``kernel`` leaves
    (Dense, Conv2d and the depthwise convs of ConvNeXt and PVTv2; CaiT's
    proj_l and proj_w; SAM's transposed convs; ECA's 1-D conv, grouped
    convs; EfficientNet's depthwise and SE convs; gMLP's token proj; the
    raw weights of BiT's and the hybrids' standardised convs) and
    not the LayerNorm's, GroupNorm's or BatchNorm's ``weight``, nor SAM's
    embedding tables, position embedding and rel-pos tables: the same set
    of parameters and the same sum of squares on the same seeded weights,
    within 1e-6."""
    name, cfg = _l2_model(family)
    params = _seeded(tfimm_tpu.create_model(name, **cfg).params, 11)
    tm = tfimm_tpu_torch.create_model(name, device="cpu", **cfg)
    tm.load_state_dict(state_dict_from_jax(params))
    flat = flatten_params(params)
    kernels = {k[:-len("kernel")] + "weight" for k in flat if k.endswith("kernel")}
    decayed = l2_weights(tm)
    ids = {id(w) for w in decayed}
    chosen = {n for n, p in tm.named_parameters() if id(p) in ids}
    assert chosen == kernels
    assert "norm.weight" not in chosen
    want = sum(float(np.sum(np.square(np.asarray(w, np.float64))))
               for k, w in flat.items() if k.endswith("kernel"))
    got = sum(float(w.double().square().sum()) for w in decayed)
    assert _rel(got, want) < 1e-6


def test_ema_and_validation(small_vit):
    jcfg, tcfg = _problem_cfgs("sgd", 0.05, 0.0)
    tcfg = dataclasses.replace(tcfg, ema_decay=0.5)
    tp = ttrain.ClassificationProblem(
        tcfg, timekeeping=ttrain.Timekeeping(1, 4, 12), device="cpu")
    start = {k: v.clone() for k, v in tp.ema_params.items()}
    batch = _batches(6, 1)[0]
    tp.train_step(batch, 0)
    for name, p in tp.model.named_parameters():
        torch.testing.assert_close(tp.ema_params[name],
                                   0.5 * start[name] + 0.5 * p.detach())
    logs = tp.validation([batch])
    assert set(logs) == {"val/accuracy"} and 0.0 <= logs["val/accuracy"] <= 1.0
    state = tp.state
    assert set(state) == {"params", "opt_state", "epoch", "ema_params"}
    tp.set_state(state)


def _run_cfg():
    data = {"batch_size": 4, "nb_samples": 8, "input_size": (64, 64),
            "nb_classes": 7, "seed": 1}
    return {
        "trainer_class": "Trainer",
        "trainer": {"validation_before_training": True,
                    "display_loss_every_it": 1},
        "problem_class": "ClassificationProblem",
        "problem": {"model_class": "ModelFactory",
                    "model": {"model_name": NAME},
                    "optimizer_class": "OptimizerFactory",
                    # SGD with its default momentum: Adam would turn the
                    # rounding noise of vanishing gradients into full steps
                    # (see _problem_cfgs) and drift over the six steps.
                    "optimizer": {"optimizer": "sgd", "lr_warmup": 1,
                                  "lr_schedule_class": "LRCosineDecayFactory",
                                  "lr_schedule": {"lr": 0.05}},
                    "weight_decay": 1e-4},
        "train_dataset_class": "SyntheticDataset", "train_dataset": data,
        "val_dataset_class": "SyntheticDataset", "val_dataset": data,
        "timekeeping_class": "Timekeeping",
        "timekeeping": {"nb_epochs": 3, "batch_size": 4,
                        "nb_samples_per_epoch": 8},
    }


def test_run_matches_jax_step_for_step(small_vit, monkeypatch):
    """run() from the same config dict in both packages: the same per-step
    losses and validation accuracies. The port's model starts from the JAX
    model's initial parameters (the two frameworks draw different ones)."""
    init = state_dict_from_jax(jtrain.ModelFactory(
        jtrain.ModelConfig(model_name=NAME))()[0].params)
    make = ttrain.ModelFactory.__call__

    def make_with_jax_init(self, device):
        model, pp = make(self, device)
        model.load_state_dict(init)
        return model, pp

    monkeypatch.setattr(ttrain.ModelFactory, "__call__", make_with_jax_init)
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
    jtrain.run(_run_cfg(), parse_cmdline_args=False)
    ttrain.run(dict(_run_cfg(), device="cpu"), parse_cmdline_args=False)
    assert len(seen["torch"]) == len(seen["jax"]) == 6 + 4
    for got, want in zip(seen["torch"], seen["jax"]):
        if isinstance(want, dict):
            assert got == want
        else:
            assert _rel(got, want) < 1e-5


# -- mixup and cutmix ------------------------------------------------------------------

def _jax_draw(key, mixup, h, w):
    """The draws ``jtransforms.Mixup(key, ...)`` makes, as the port's
    ``MixupDraw``: the same key splits and the same jax.random calls."""
    k_apply, k_switch, k_lam, k_box = jax.random.split(key, 4)
    if mixup.cutmix_alpha == 0.0:
        use_cutmix = False
    elif mixup.mixup_alpha == 0.0:
        use_cutmix = True
    else:
        use_cutmix = bool(jax.random.bernoulli(k_switch, mixup.switch_prob))
    alpha = (mixup.cutmix_alpha if use_cutmix else mixup.mixup_alpha) or 1.0
    ky, kx = jax.random.split(k_box)
    return ttransforms.MixupDraw(
        apply=bool(jax.random.bernoulli(k_apply, mixup.prob)),
        use_cutmix=use_cutmix,
        lam=float(jax.random.beta(k_lam, alpha, alpha)),
        cy=float(jax.random.uniform(ky, (), minval=0.0, maxval=float(h))),
        cx=float(jax.random.uniform(kx, (), minval=0.0, maxval=float(w))))


_MIX_CASES = {"mixup": dict(mixup_alpha=0.8, cutmix_alpha=0.0),
              "cutmix": dict(mixup_alpha=0.0, cutmix_alpha=1.0),
              "both": dict(mixup_alpha=0.8, cutmix_alpha=1.0),
              "rarely": dict(mixup_alpha=0.8, cutmix_alpha=1.0, prob=0.3)}


@pytest.mark.parametrize("case", sorted(_MIX_CASES))
def test_mixup_matches_jax_given_the_same_draws(case):
    """The blend, the cutmix box, the exact box-fraction lambda and the
    smoothed soft labels, over 8 keys (so both modes, and with prob=0.3
    batches left alone, come up)."""
    kwargs = dict(_MIX_CASES[case], label_smoothing=0.1)
    jmix = jtransforms.Mixup(nb_classes=5, **kwargs)
    tmix = ttransforms.Mixup(nb_classes=5, **kwargs)
    rng = np.random.default_rng(4)
    images = rng.uniform(0, 255, size=(6, 12, 10, 3)).astype(np.float32)
    labels = rng.integers(0, 5, size=(6,))
    seen = set()
    for i in range(8):
        key = jax.random.PRNGKey(i)
        draw = _jax_draw(key, jmix, 12, 10)
        seen.add((draw.apply, draw.use_cutmix))
        want_x, want_y = jmix(key, jnp.asarray(images), jnp.asarray(labels))
        got_x, got_y = tmix.mix(torch.from_numpy(images),
                                torch.from_numpy(labels), draw)
        assert got_x.dtype == torch.float32 and got_y.shape == (6, 5)
        assert _rel(got_x, want_x) < 1e-6, (i, draw)
        assert _rel(got_y, want_y) < 1e-6, (i, draw)
    if case == "both":
        assert {(True, False), (True, True)} <= seen
    if case == "rarely":
        assert (False, True) in seen or (False, False) in seen


def test_box_mask_and_smooth_one_hot_match_jax():
    for i, lam in enumerate([0.05, 0.3, 0.5, 0.77, 0.99]):
        key = jax.random.PRNGKey(10 + i)
        want_mask, want_frac = jtransforms._box_mask(key, 14, 9,
                                                     jnp.float32(lam))
        ky, kx = jax.random.split(key)
        cy = float(jax.random.uniform(ky, (), minval=0.0, maxval=14.0))
        cx = float(jax.random.uniform(kx, (), minval=0.0, maxval=9.0))
        mask, frac = ttransforms.box_mask(14, 9, lam, cy, cx)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
        assert frac == float(want_frac) and 0.0 < frac < 1.0
    labels = np.array([0, 3, 4, 1])
    for smoothing in (0.0, 0.1):
        want = jtransforms.smooth_one_hot(jnp.asarray(labels), 5, smoothing)
        got = ttransforms.smooth_one_hot(torch.from_numpy(labels), 5, smoothing)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_random_flip_horizontal_flips_each_image_or_not():
    images = torch.arange(8 * 2 * 5 * 3, dtype=torch.float32).reshape(8, 2, 5, 3)
    got = ttransforms.random_flip_horizontal(images,
                                             torch.Generator().manual_seed(1))
    flipped = torch.rand(8, generator=torch.Generator().manual_seed(1)) < 0.5
    assert 0 < int(flipped.sum()) < 8
    for i in range(8):
        want = images[i].flip(1) if flipped[i] else images[i]
        torch.testing.assert_close(got[i], want, rtol=0, atol=0)


def test_mixup_train_step_matches_jax(small_vit, monkeypatch):
    """Mixup 0.8, cutmix 1.0 and label smoothing 0.1 in both problems, the
    port's draws set to the ones the JAX problem makes from its keys: the
    same losses over 4 steps, and the same parameters after them."""
    mix = dict(mixup_alpha=0.8, cutmix_alpha=1.0, label_smoothing=0.1)
    jcfg, tcfg = _problem_cfgs("sgd", 0.05, 0.0)
    tk = dict(nb_epochs=1, batch_size=4, nb_samples_per_epoch=12)
    jp = jtrain.ClassificationProblem(dataclasses.replace(jcfg, **mix),
                                      timekeeping=jtrain.Timekeeping(**tk))
    params = _seeded(jp.params, 6)
    jp.params = jp.model.params = params
    jp.opt_state = jp.tx.init(params)
    tp = ttrain.ClassificationProblem(dataclasses.replace(tcfg, **mix),
                                      timekeeping=ttrain.Timekeeping(**tk),
                                      device="cpu")
    tp.model.load_state_dict(state_dict_from_jax(params))
    # The JAX problem splits its key into (key, step, mixup) every step.
    keys, draws = [jax.random.PRNGKey(0)], []

    def jax_draw(self, rng, h, w):
        keys[0], _, mix_key = jax.random.split(keys[0], 3)
        draws.append(_jax_draw(mix_key, jp._mixup.__wrapped__, h, w))
        return draws[-1]

    monkeypatch.setattr(ttransforms.Mixup, "draw", jax_draw)
    for it, batch in enumerate(_batches(8, 4)):
        want, _ = jp.train_step(batch, it)
        got, logs = tp.train_step(batch, it)
        assert _rel(got, want) < 1e-5, (it, draws[-1])
    assert {d.use_cutmix for d in draws if d.apply} == {False, True}
    want_params = state_dict_from_jax(jp.params)
    for name, p in tp.model.state_dict().items():
        assert _rel(p, want_params[name]) < 1e-4, name


# -- Swin through run() ------------------------------------------------------------------

SWIN_NAME = "train_parity_swin"
SWIN_SMALL = dict(input_size=(56, 56), embed_dim=64, nb_heads=(2, 4),
                  nb_blocks=(2, 2), nb_classes=7, drop_path_rate=0.0)


@pytest.fixture
def small_swin(monkeypatch):
    """A small Swin under SWIN_NAME in both model registries, for one test."""
    for reg, cls, cfg_cls in ((jax_registry, JaxSwin, JaxSwinConfig),
                              (torch_registry, SwinTransformer,
                               SwinTransformerConfig)):
        monkeypatch.setitem(reg._model_class, SWIN_NAME, cls)
        monkeypatch.setitem(reg._model_config, SWIN_NAME,
                            cfg_cls(name=SWIN_NAME, **SWIN_SMALL))
    return SWIN_NAME


def test_run_trains_swin_step_for_step_with_jax(small_swin, monkeypatch):
    """run() of a small Swin from the same config dict in both packages,
    the JAX package's Pallas window_mha forward and backward in interpret
    mode, the port's plain versions through its autograd Function: the same
    per-step losses and validation accuracies, SGD with momentum, all rates
    0. The port starts from the JAX model's initial parameters with the
    bias tables redrawn at std 0.3 (their init of std 0.02 would hide
    them)."""
    monkeypatch.setenv("TFIMM_TPU_PALLAS_INTERPRET", "1")
    jm = jtrain.ModelFactory(jtrain.ModelConfig(model_name=SWIN_NAME))()[0]
    rng = np.random.default_rng(12)
    init = {k: (torch.from_numpy(0.3 * rng.normal(size=tuple(v.shape)).astype(
                np.float32)) if k.endswith("relative_position_bias_table")
                else v) for k, v in state_dict_from_jax(jm.params).items()}
    jinit = jm.params
    for j, stage in jinit["layers"].items():
        for i, blk in stage["blocks"].items():
            blk["attn"]["relative_position_bias_table"] = jnp.asarray(init[
                f"layers.{j}.blocks.{i}.attn.relative_position_bias_table"])
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
    cfg = _run_cfg()
    cfg["problem"]["model"]["model_name"] = SWIN_NAME
    for part in ("train_dataset", "val_dataset"):
        cfg[part] = dict(cfg[part], input_size=(56, 56))
    cfg["timekeeping"]["nb_epochs"] = 2
    with jax_capture() as jax_seen:
        jtrain.run(cfg, parse_cmdline_args=False)
    assert any(s.startswith("window_mha") for s in jax_seen), jax_seen
    with dispatch.capture_dispatches() as port_seen:
        ttrain.run(dict(cfg, device="cpu"), parse_cmdline_args=False)
    assert "window_mha" in port_seen
    assert len(seen["torch"]) == len(seen["jax"]) == 4 + 3
    for got, want in zip(seen["torch"], seen["jax"]):
        if isinstance(want, dict):
            assert got == want
        else:
            assert _rel(got, want) < 1e-5


# -- CaiT through run() ------------------------------------------------------------------

CAIT_NAME = "train_parity_cait"
CAIT_SMALL = dict(input_size=(32, 32), patch_size=8, embed_dim=128, nb_blocks=2,
                  nb_heads=4, nb_classes=7, init_scale=1.0)


@pytest.fixture
def small_cait(monkeypatch):
    """A small CaiT under CAIT_NAME in both model registries, for one test."""
    for reg, cls, cfg_cls in ((jax_registry, JaxCaiT, JaxCaiTConfig),
                              (torch_registry, CaiT, CaiTConfig)):
        monkeypatch.setitem(reg._model_class, CAIT_NAME, cls)
        monkeypatch.setitem(reg._model_config, CAIT_NAME,
                            cfg_cls(name=CAIT_NAME, **CAIT_SMALL))
    return CAIT_NAME


def test_run_trains_cait_step_for_step_with_jax(small_cait, monkeypatch):
    """run() of a small CaiT (embed 128, so that the JAX dispatcher takes its
    Pallas talking-head forward and backward in interpret mode) from the
    same config dict in both packages, the port's plain versions through its
    autograd Function: the same per-step losses and validation accuracies,
    SGD with momentum and L2 weight decay (which covers proj_l and proj_w),
    all rates 0. The port starts from the JAX model's initial parameters
    with the layer scales at 1 and the head mixes redrawn at std 0.5 (their
    init would hide the mixes)."""
    monkeypatch.setenv("TFIMM_TPU_PALLAS_INTERPRET", "1")
    jm = jtrain.ModelFactory(jtrain.ModelConfig(model_name=CAIT_NAME))()[0]
    rng = np.random.default_rng(13)
    jinit = jm.params
    for blk in jinit["blocks"].values():
        for mix in ("proj_l", "proj_w"):
            blk["attn"][mix]["kernel"] = jnp.asarray(
                0.5 * rng.normal(size=(4, 4)).astype(np.float32))
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
    cfg = _run_cfg()
    cfg["problem"]["model"]["model_name"] = CAIT_NAME
    for part in ("train_dataset", "val_dataset"):
        cfg[part] = dict(cfg[part], input_size=(32, 32))
    cfg["timekeeping"]["nb_epochs"] = 2
    with jax_capture() as jax_seen:
        jtrain.run(cfg, parse_cmdline_args=False)
    assert "cait_talking_head" in jax_seen, jax_seen
    with dispatch.capture_dispatches() as port_seen:
        ttrain.run(dict(cfg, device="cpu"), parse_cmdline_args=False)
    assert port_seen == {"talking_head_attention"}
    assert len(seen["torch"]) == len(seen["jax"]) == 4 + 3
    for got, want in zip(seen["torch"], seen["jax"]):
        if isinstance(want, dict):
            assert got == want
        else:
            assert _rel(got, want) < 1e-5


# -- ConvNeXt through run() --------------------------------------------------------------

CONVNEXT_NAME = "train_parity_convnext"
CONVNEXT_SMALL = dict(input_size=(32, 32), embed_dim=(32, 64), nb_blocks=(2, 1),
                      nb_classes=7, drop_path_rate=0.0, init_scale=1.0)


@pytest.fixture
def small_convnext(monkeypatch):
    """A small ConvNeXt under CONVNEXT_NAME in both model registries, for one
    test."""
    for reg, cls, cfg_cls in ((jax_registry, JaxConvNeXt, JaxConvNeXtConfig),
                              (torch_registry, ConvNeXt, ConvNeXtConfig)):
        monkeypatch.setitem(reg._model_class, CONVNEXT_NAME, cls)
        monkeypatch.setitem(reg._model_config, CONVNEXT_NAME,
                            cfg_cls(name=CONVNEXT_NAME, **CONVNEXT_SMALL))
    return CONVNEXT_NAME


def test_run_trains_convnext_step_for_step_with_jax(small_convnext, monkeypatch):
    """run() of a small ConvNeXt (widths 32 and 64, blocks 2 and 1, 32x32,
    the layer scales at 1) from the same config dict in both packages: the
    same per-step losses and validation accuracies, SGD with momentum and
    L2 weight decay (which covers the depthwise kernels), all rates 0. In
    training both packages run the blocks per op (no kernel has a
    backward); in validation the JAX package takes its XLA composition on
    the CPU and the port convnext_mlp's plain version. The port starts from
    the JAX model's initial parameters."""
    monkeypatch.delenv("TFIMM_TPU_FUSED_CONVNEXT", raising=False)
    jm = jtrain.ModelFactory(jtrain.ModelConfig(model_name=CONVNEXT_NAME))()[0]
    init = state_dict_from_jax(jm.params)
    assert all(torch.all(v == 1.0) for k, v in init.items()
               if k.endswith("gamma"))
    make = ttrain.ModelFactory.__call__

    def make_with_jax_init(self, device):
        model, pp = make(self, device)
        model.load_state_dict(init)
        return model, pp

    monkeypatch.setattr(ttrain.ModelFactory, "__call__", make_with_jax_init)
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
    cfg = _run_cfg()
    cfg["problem"]["model"]["model_name"] = CONVNEXT_NAME
    for part in ("train_dataset", "val_dataset"):
        cfg[part] = dict(cfg[part], input_size=(32, 32))
    with jax_capture() as jax_seen:
        jtrain.run(cfg, parse_cmdline_args=False)
    assert jax_seen == set(), jax_seen
    before = dict(dispatch.launch_counts)
    with dispatch.capture_dispatches() as port_seen:
        ttrain.run(dict(cfg, device="cpu"), parse_cmdline_args=False)
    assert port_seen == {"convnext_mlp"}   # validation only
    assert dispatch.launch_counts == before
    assert len(seen["torch"]) == len(seen["jax"]) == 6 + 4
    for got, want in zip(seen["torch"], seen["jax"]):
        if isinstance(want, dict):
            assert got == want
        else:
            assert _rel(got, want) < 1e-5


# -- (g) configs ---------------------------------------------------------------------

def _flat(pkg, cfg):
    return pkg.deep_to_flat(pkg.to_dict_format(cfg))


def test_parse_args_and_dump_config_match_jax(small_vit, tmp_path):
    args = ["--problem.optimizer.optimizer=adamw",
            "--problem.optimizer.lr_schedule_class=LRCosineDecayFactory",
            "--problem.optimizer.lr_schedule.alpha=0.1",
            "--problem.model.nb_classes=3", "--problem.mixed_precision=true",
            "--trainer.validation_every_it=5"]
    jcfg = jtrain.parse_args(_run_cfg(), cfg_class=jtrain.ExperimentConfig,
                             args=args)
    tcfg = ttrain.parse_args(_run_cfg(), cfg_class=ttrain.ExperimentConfig,
                             args=args + ["--device=cpu"])
    jflat, tflat = _flat(jtrain, jcfg), _flat(ttrain, tcfg)
    assert tflat.pop("device") == "cpu"
    assert tflat == jflat
    assert tflat["problem.optimizer.lr_schedule.alpha"] == 0.1

    jtrain.dump_config(jcfg, tmp_path / "jax.yaml")
    ttrain.dump_config(tcfg, tmp_path / "torch.yaml")
    with open(tmp_path / "jax.yaml") as f:
        jyaml = yaml.load(f, Loader=yaml.Loader)
    with open(tmp_path / "torch.yaml") as f:
        tyaml = yaml.load(f, Loader=yaml.Loader)
    assert tyaml.pop("device") == "cpu"
    assert tyaml == jyaml
    # A YAML file the JAX package wrote configures the port.
    again = ttrain.parse_args({}, cfg_class=ttrain.ExperimentConfig,
                              args=[f"--cfg_file={tmp_path / 'jax.yaml'}"])
    again_flat = _flat(ttrain, again)
    assert again_flat.pop("device") == "cuda"
    assert again_flat.pop("cfg_file") == str(tmp_path / "jax.yaml")
    assert again_flat == {k: v for k, v in jflat.items() if k != "cfg_file"}


# -- what is not ported, and what needs a card -----------------------------------------

def test_what_is_not_ported_raises(small_vit, monkeypatch):
    jcfg, tcfg = _problem_cfgs("sgd", 0.05, 0.0)
    tk = ttrain.Timekeeping(1, 4, 12)
    with pytest.raises(NotImplementedError, match="item 14"):
        ttrain.ClassificationProblem(tcfg, timekeeping=tk, mesh="data:1",
                                     device="cpu")
    for name in ("TFDSWrapper", "GrainDataset", "ImageFolderDataset"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ttrain.get_class(name)
    with pytest.raises(KeyError):
        ttrain.get_class("NoSuchClass")
    with pytest.raises(NotImplementedError, match="item 14"):
        make_train_step(torch.nn.Linear(1, 1), None, remat=True)
    ds = ttrain.ArrayDataset(ttrain.ArrayDatasetConfig(batch_size=2,
                                                       input_size=(8, 8)),
                             data=(np.zeros((4, 4, 4, 3)), np.zeros(4)))
    with pytest.raises(NotImplementedError, match="item 13"):
        next(iter(ds))
    with pytest.raises(NotImplementedError, match="item 14"):
        ttrain.run(dict(_run_cfg(), mesh="data:1", device="cpu"),
                   parse_cmdline_args=False)


@pytest.mark.parametrize("name", ["TFDSWrapper", "TFDSConfig", "GrainDataset",
                                  "GrainDatasetConfig", "ImageFolderDataset",
                                  "ImageFolderConfig"])
def test_the_datasets_still_raise(name):
    """The dataset pipelines wait for A13 (b); the rest of A13 resolves."""
    lookup = ttrain.get_cfg_class if name.endswith("Config") \
        else ttrain.get_class
    with pytest.raises(NotImplementedError, match="queue A, item 13"):
        lookup(name)
    for ported in ("DistillationProblem", "SavedModel",
                   "EmbeddingModelFactory"):
        assert ttrain.get_class(ported).__name__ == ported


def test_a_cuda_device_without_a_card_raises(small_vit, monkeypatch):
    from tfimm_tpu_torch.utils.profile import time_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _problem_cfgs("sgd", 0.05, 0.0)
    with pytest.raises(RuntimeError, match="is_available"):
        ttrain.ClassificationProblem(tcfg, timekeeping=ttrain.Timekeeping(1, 4, 12),
                                     device="cuda")
    with pytest.raises(RuntimeError, match="CUDA card"):
        time_model(NAME, target="backprop", batch_size=2)


# -- (h) imports -------------------------------------------------------------------

def test_import_pulls_in_no_jax():
    code = ("import sys, tfimm_tpu_torch.train, tfimm_tpu_torch.parallel.step, "
            "tfimm_tpu_torch.utils.profile, "
            "tfimm_tpu_torch.architectures.resnetv2, "
            "tfimm_tpu_torch.architectures.vit_hybrid; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'optax', 'orbax', 'tfimm_tpu', 'yaml')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
