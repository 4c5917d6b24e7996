"""Port parity for the distillation problem: tfimm_tpu_torch's
``DistillationProblem`` against the JAX package's, on the CPU.

A small ViT teacher (32x32, patch 8, N = 17) and a small ViT student
(patch 16, N = 5, no head), each one block of D = 32 with 2 heads of 16
and no dropout, are registered in both registries for a test. Both
problems get the same seeded teacher and student weights (the JAX
parameters moved with ``state_dict_from_jax``) and the same numpy batches.
Bars, as max|diff| /
max|JAX|: 1e-4 for the per-step loss and the student's parameters after 3
steps in f32 (f32 sums in another order through two ViTs and an optimizer);
with ``mixed_precision``, where bf16 rounds in other places in the two
frameworks, the bars of the bf16 training tests: 2e-2 for the loss and 1e-1
for what the 3 steps moved each parameter by (the gradients' bar; Adam's
update is a ratio of the gradient's moments, so it carries their error).
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfimm_tpu.train as jtrain
import tfimm_tpu_torch.train as ttrain
from tfimm_tpu.architectures.vit import ViT as JaxViT
from tfimm_tpu.architectures.vit import ViTConfig as JaxViTConfig
from tfimm_tpu.models import registry as jax_registry
from tfimm_tpu.train.optimizers import LRConstConfig as JaxLRConstConfig
from tfimm_tpu_torch.architectures.vit import ViT, ViTConfig
from tfimm_tpu_torch.models import registry as torch_registry
from tfimm_tpu_torch.ops.kernels import dispatch
from tfimm_tpu_torch.train.optimizers import LRConstConfig
from tfimm_tpu_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(1)

TEACHER, STUDENT = "distill_parity_teacher", "distill_parity_student"
SHAPES = {TEACHER: dict(input_size=(32, 32), patch_size=8, embed_dim=32,
                        nb_blocks=1, nb_heads=2, nb_classes=5),
          STUDENT: dict(input_size=(32, 32), patch_size=16, embed_dim=32,
                        nb_blocks=1, nb_heads=2, nb_classes=5)}


@pytest.fixture
def small_vits(monkeypatch):
    for name, shape in SHAPES.items():
        for reg, cls, cfg_cls in ((jax_registry, JaxViT, JaxViTConfig),
                                  (torch_registry, ViT, ViTConfig)):
            monkeypatch.setitem(reg._model_class, name, cls)
            monkeypatch.setitem(reg._model_config, name,
                                cfg_cls(name=name, **shape))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


def _seeded(params, seed):
    rng = np.random.default_rng(seed)
    leaves, tree = jax.tree_util.tree_flatten_with_path(params)
    new = []
    for path, leaf in leaves:
        r = rng.normal(size=np.shape(leaf)).astype(np.float32)
        is_scale = getattr(path[-1], "key", None) == "scale"
        new.append(jnp.asarray(1.0 + 0.1 * r if is_scale else 0.1 * r))
    return jax.tree_util.tree_unflatten(tree, new)


def _problems(optimizer, normalize, mixed, student=STUDENT,
              student_class="ModelFactory"):
    """The same config in both packages, and the same seeded weights."""
    tk = dict(nb_epochs=1, batch_size=4, nb_samples_per_epoch=12)
    out = []
    for pkg, lr_cfg, kw in ((jtrain, JaxLRConstConfig, {}),
                            (ttrain, LRConstConfig, {"device": "cpu"})):
        student_cfg = (pkg.ModelConfig(model_name=student, nb_classes=0)
                       if student_class == "ModelFactory" else
                       pkg.EmbeddingModelConfig(backbone_name=student,
                                                embed_dim=16))
        cfg = pkg.DistillationConfig(
            teacher=pkg.ModelConfig(model_name=TEACHER),
            teacher_class="ModelFactory",
            student=student_cfg, student_class=student_class,
            optimizer=pkg.OptimizerConfig(
                optimizer=optimizer, epsilon=1e-3,
                lr_schedule_class="LRConstFactory",
                lr_schedule=lr_cfg(lr=1e-2)),
            optimizer_class="OptimizerFactory",
            normalize_embeddings=normalize, mixed_precision=mixed)
        out.append(pkg.DistillationProblem(cfg, timekeeping=pkg.Timekeeping(
            **tk), **kw))
    jp, tp = out
    if student_class != "ModelFactory":
        return jp, tp
    jp.teacher.params = _seeded(jp.teacher.params, 0)
    jp.params = jp.student.params = _seeded(jp.params, 1)
    jp.opt_state = jp.tx.init(jp.params)
    tp.teacher.load_state_dict(state_dict_from_jax(jp.teacher.params))
    tp.student.load_state_dict(state_dict_from_jax(jp.params))
    return jp, tp


def _batches(seed, nb):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(0, 255, size=(4, 32, 32, 3)).astype(np.float32),
             rng.integers(0, 5, size=(4,))) for _ in range(nb)]


@pytest.mark.parametrize("optimizer,normalize,mixed", [
    ("sgd", True, False), ("adam", False, False), ("adam", True, True),
    ("sgd", False, True)])
def test_distillation_steps_match_jax(small_vits, optimizer, normalize, mixed):
    jp, tp = _problems(optimizer, normalize, mixed)
    loss_bar = 2e-2 if mixed else 1e-4
    start = {k: v.clone() for k, v in tp.student.state_dict().items()}
    dispatch.reset_launch_counts()
    with dispatch.capture_dispatches() as seen:
        for it, batch in enumerate(_batches(7, 3)):
            want, _ = jp.train_step(batch, it)
            got, logs = tp.train_step(batch, it)
            assert set(logs) == {"train/loss"}
            assert np.isfinite(got) and got > 0
            assert _rel(got, want) < loss_bar, (it, got, want)
    # The teacher's no-grad attention and the student's trained one both
    # dispatched to fused_mha (the plain version, on the CPU).
    assert seen == {"fused_mha"}
    want_params = state_dict_from_jax(jp.params)
    moved = tp.student.state_dict()
    for name, p in moved.items():
        if mixed:   # the update, at the bf16 gradients' bar
            err = _rel(p - start[name], want_params[name] - start[name])
            assert err < 1e-1, (name, err)
        else:
            assert _rel(p, want_params[name]) < 1e-4, name
    assert not torch.equal(moved["blocks.0.attn.qkv.weight"],
                           start["blocks.0.attn.qkv.weight"])
    assert all(p.dtype == torch.float32 for p in tp.student.parameters())


def test_state_and_save_model_follow_the_jax_problem(small_vits, tmp_path):
    import tfimm_tpu
    import tfimm_tpu_torch

    jp, tp = _problems("adam", True, False)
    for it, batch in enumerate(_batches(8, 2)):
        jp.train_step(batch, it)
        tp.train_step(batch, it)
    assert set(tp.state) == set(jp.state) == {"params", "opt_state", "epoch"}
    tp.save_model(str(tmp_path / "student"))
    # The JAX package loads the port's student; its forward features agree.
    loaded = tfimm_tpu.load_model(str(tmp_path / "student"))
    x = _batches(9, 1)[0][0] / 255.0
    want = loaded.apply(loaded.params, jnp.asarray(x), features_only=True)
    with torch.no_grad():
        got = tp.student(torch.from_numpy(x), features_only=True)
    assert _rel(got, want) < 1e-5
    fresh = tfimm_tpu_torch.load_model(str(tmp_path / "student"), device="cpu")
    state = copy.deepcopy(tp.state)
    tp.train_step(_batches(9, 1)[0], 2)
    tp.set_state(state)
    assert tp.optimizer.step_count == 2 and tp.epoch == 0
    for k, v in fresh.state_dict().items():
        assert torch.equal(tp.student.state_dict()[k], v), k


def test_an_embedding_model_student_raises_type_error_in_both(small_vits):
    jp, tp = _problems("sgd", True, False, student_class="EmbeddingModelFactory")
    batch = _batches(10, 1)[0]
    with pytest.raises(TypeError, match="features_only"):
        jp.train_step(batch, 0)
    with pytest.raises(TypeError, match="features_only"):
        tp.train_step(batch, 0)


def test_distillation_resolves_through_the_registry():
    assert ttrain.get_class("DistillationProblem") is ttrain.DistillationProblem
    assert ttrain.get_cfg_class("DistillationConfig") is ttrain.DistillationConfig
    fields = {f.name for f in dataclasses.fields(ttrain.DistillationConfig)}
    assert fields == {f.name for f in dataclasses.fields(
        jtrain.DistillationConfig)}
    with pytest.raises(NotImplementedError, match="item 14"):
        ttrain.DistillationProblem(ttrain.DistillationConfig(), mesh="data:1",
                                   device="cpu")
