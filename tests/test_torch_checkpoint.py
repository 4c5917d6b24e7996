"""Port parity for checkpoints: tfimm_tpu_torch/train/checkpoint.py and the
trainer's saves and restores against the JAX trainer's orbax manager, on
the CPU.

The orbax rules held here: a save at a step that is not above the latest
one is skipped (so the epoch-end save that falls on a ``ckpt_every_it``
step keeps the earlier epoch), and with the 12 h time rule the first
checkpoint, and one each 12 h after the last one that rule kept, stay
beside the ``max_to_keep`` newest. Both managers' clocks are moved by the
test, 5 h a training step. A small ViT (32x32, patch 8, D = 32, 2 heads,
1 block, 5 classes) is registered in both registries for a test; a small
ECA-ResNet (BatchNorm) for the EMA case.
"""

import dataclasses
import datetime
import os
import types

import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch
from orbax.checkpoint import checkpoint_manager as orbax_manager

import tfimm_tpu.train as jtrain
import tfimm_tpu_torch.train as ttrain
from tfimm_tpu.architectures.vit import ViT as JaxViT
from tfimm_tpu.architectures.vit import ViTConfig as JaxViTConfig
from tfimm_tpu.models import registry as jax_registry
from tfimm_tpu_torch.architectures.vit import ViT, ViTConfig
from tfimm_tpu_torch.models import registry as torch_registry
from tfimm_tpu_torch.train import checkpoint

torch.set_num_threads(1)

NAME = "ckpt_parity_vit"
SMALL = dict(input_size=(32, 32), patch_size=8, embed_dim=32, nb_blocks=1,
             nb_heads=2, nb_classes=5)
HOURS = 3600.0


@pytest.fixture
def small_vit(monkeypatch):
    for reg, cls, cfg_cls in ((jax_registry, JaxViT, JaxViTConfig),
                              (torch_registry, ViT, ViTConfig)):
        monkeypatch.setitem(reg._model_class, NAME, cls)
        monkeypatch.setitem(reg._model_config, NAME,
                            cfg_cls(name=NAME, **SMALL))
    return NAME


@pytest.fixture
def clock(monkeypatch):
    """One clock, in seconds, for orbax's manager (its ``datetime.now``)
    and the port's (``checkpoint.now``)."""
    now = [0.0]
    start = datetime.datetime(2026, 1, 1, tzinfo=datetime.timezone.utc)

    class Moved(datetime.datetime):
        @classmethod
        def now(cls, tz=None):
            return start + datetime.timedelta(seconds=now[0])

    shim = types.ModuleType("datetime")
    shim.__dict__.update(datetime.__dict__)
    shim.datetime = Moved
    monkeypatch.setattr(orbax_manager, "datetime", shim)
    monkeypatch.setattr(checkpoint, "now", lambda: now[0])
    return now


@pytest.fixture
def small_resnet(monkeypatch):
    """A small ECA-ResNet (BatchNorm) under a test name in the port's
    registry."""
    name = "ckpt_small_resnet"
    cfg = dataclasses.replace(
        torch_registry.model_config("ecaresnet50d"), name=name,
        input_size=(32, 32), nb_blocks=(1, 1, 1, 1),
        nb_channels=(8, 8, 16, 16), nb_classes=5)
    monkeypatch.setitem(torch_registry._model_class, name,
                        torch_registry.model_class("ecaresnet50d"))
    monkeypatch.setitem(torch_registry._model_config, name, cfg)
    return name


def _problem_and_trainer(cfg):
    """The problem of ``cfg`` on the CPU after its trainer's ``_load_ckpt``
    (what ``run`` does before the loop)."""
    exp = ttrain.parse_args(dict(cfg, device="cpu"),
                            cfg_class=ttrain.ExperimentConfig, args=[])
    problem = ttrain.ClassificationProblem(
        exp.problem, timekeeping=exp.timekeeping, device="cpu")
    ttrain.Trainer(problem, None, None, exp.timekeeping,
                   exp.trainer)._load_ckpt()
    return problem


def _steps(directory):
    return sorted(int(n) for n in os.listdir(directory) if n.isdigit())


def _run_cfg(ckpt_dir, nb_epochs, **trainer):
    data = {"batch_size": 2, "nb_samples": 6, "input_size": (32, 32),
            "nb_classes": 5, "seed": 1}
    return {
        "trainer_class": "Trainer",
        "trainer": {"validation_before_training": False,
                    "ckpt_dir": ckpt_dir, **trainer},
        "problem_class": "ClassificationProblem",
        "problem": {"model_class": "ModelFactory",
                    "model": {"model_name": NAME},
                    "optimizer_class": "OptimizerFactory",
                    "optimizer": {"optimizer": "adam",
                                  "lr_schedule_class": "LRConstFactory",
                                  "lr_schedule": {"lr": 1e-3}}},
        "train_dataset_class": "SyntheticDataset", "train_dataset": data,
        "timekeeping_class": "Timekeeping",
        "timekeeping": {"nb_epochs": nb_epochs, "batch_size": 2,
                        "nb_samples_per_epoch": 6},
        "log_level": "WARNING",
    }


def test_the_manager_keeps_and_skips_as_orbax(tmp_path, clock):
    """The same saves, one a step at 5 h a step, through orbax's manager
    and the port's: the same return values and the same steps kept."""
    options = ocp.CheckpointManagerOptions(
        max_to_keep=2, keep_time_interval=datetime.timedelta(hours=12))
    jmgr = ocp.CheckpointManager(str(tmp_path / "jax"), options=options)
    tmgr = checkpoint.CheckpointManager(str(tmp_path / "torch"), max_to_keep=2)
    assert checkpoint.KEEP_TIME_INTERVAL == 12 * HOURS
    got, want = [], []
    for step in (2, 4, 4, 6, 8, 8, 10, 11, 12, 13, 16, 20, 30):
        clock[0] = step * 5 * HOURS
        want.append(jmgr.save(step, args=ocp.args.StandardSave(
            {"epoch": step, "x": np.ones(3, np.float32)})))
        got.append(tmgr.save(step, {"epoch": step, "x": torch.ones(3)}))
        jmgr.wait_until_finished()
        assert _steps(tmp_path / "torch") == _steps(tmp_path / "jax"), step
    assert got == want
    assert got[:7] == [True, True, False, True, True, False, True]
    assert tmgr.latest_step() == jmgr.latest_step() == 30
    assert tmgr.restore(16, map_location="cpu")["epoch"] == 16


def test_steps_are_whole_directories(tmp_path, monkeypatch):
    """latest_step reads integer names only; a manager writes nothing
    before its first save; a save that raises leaves no step, and what a
    killed save left is ignored, not removed (as orbax's default); the
    state reads back with weights_only."""
    assert checkpoint.CheckpointManager(
        str(tmp_path / "missing")).latest_step() is None
    assert not (tmp_path / "missing").exists()
    mgr = checkpoint.CheckpointManager(str(tmp_path))
    assert mgr.latest_step() is None
    state = {"params": {"w": torch.arange(4.0)}, "epoch": 3,
             "opt": {"state": {0: {"step": torch.tensor(2.0)}},
                     "param_groups": [{"lr": 0.1, "betas": (0.9, 0.99),
                                       "params": [0]}]}}
    assert mgr.save(5, state)
    os.makedirs(tmp_path / "model")
    os.makedirs(tmp_path / "7.tmp")

    def disk_full(obj, f):
        raise OSError("disk full")

    with monkeypatch.context() as m:
        m.setattr(torch, "save", disk_full)
        with pytest.raises(OSError):
            mgr.save(9, state)
    assert mgr.latest_step() == 5
    assert sorted(os.listdir(tmp_path)) == ["5", "7.tmp", "model"]
    killed = tmp_path / f"{checkpoint._TMP_PREFIX}9-x"
    os.makedirs(killed)
    assert checkpoint.CheckpointManager(str(tmp_path)).all_steps() == [5]
    assert killed.exists()
    loaded = torch.load(tmp_path / "5" / "state.pt", weights_only=True)
    assert torch.equal(loaded["params"]["w"], state["params"]["w"])
    assert loaded["epoch"] == 3 and loaded["opt"]["param_groups"][0][
        "betas"] == (0.9, 0.99)


def test_trainer_keeps_the_steps_and_epochs_orbax_keeps(small_vit, clock,
                                                        tmp_path, monkeypatch):
    """The JAX trainer (orbax) and the port's, 4 epochs of 3 steps with
    ckpt_every_it=2 and ckpt_to_keep=2: the same step directories, each
    with the same epoch. Steps 6 and 12 keep the epoch of their mid-epoch
    save (the epoch-end save at the same step is skipped); step 2 is kept
    by the 12 h rule."""
    for pkg in (jtrain, ttrain):
        cls = pkg.ClassificationProblem
        step = cls.train_step

        def timed(self, data, it, step=step):
            out = step(self, data, it)
            clock[0] += 5 * HOURS
            return out

        monkeypatch.setattr(cls, "train_step", timed)
    trainer = dict(ckpt_every_it=2, ckpt_to_keep=2)
    clock[0] = 0.0
    jtrain.run(_run_cfg(str(tmp_path / "jax"), 4, **trainer),
               parse_cmdline_args=False)
    clock[0] = 0.0
    ttrain.run(dict(_run_cfg(str(tmp_path / "torch"), 4, **trainer),
                    device="cpu"), parse_cmdline_args=False)
    kept = _steps(tmp_path / "torch")
    assert kept == _steps(tmp_path / "jax") == [2, 6, 9, 10, 12]
    jmgr = ocp.CheckpointManager(str(tmp_path / "jax"))
    epochs = {}
    for step in kept:
        want = int(jmgr.restore(step, args=ocp.args.StandardRestore())["epoch"])
        got = torch.load(tmp_path / "torch" / str(step) / "state.pt",
                         weights_only=True)["epoch"]
        assert got == want, step
        epochs[step] = got
    assert epochs == {2: 0, 6: 1, 9: 3, 10: 3, 12: 3}
    for pkg in ("jax", "torch"):
        assert (tmp_path / pkg / "model" / "config.json").exists()


def test_crash_resume_equals_an_uninterrupted_run(small_vit, tmp_path):
    """Run A trains one epoch of 3 steps and saves at steps 2 and 3; run B
    resumes from A's directory for a second epoch; run C trains both
    epochs in a directory of its own. B restores the step count, the
    epoch and Adam's moments, and ends bit for bit where C ends."""
    a_dir, c_dir = str(tmp_path / "a"), str(tmp_path / "c")
    cfg = dict(ckpt_every_it=2, ckpt_to_keep=2)
    a = ttrain.run(dict(_run_cfg(a_dir, 1, **cfg), device="cpu"),
                   parse_cmdline_args=False)
    assert _steps(a_dir) == [2, 3] and a.problem.optimizer.step_count == 3
    saved = torch.load(os.path.join(a_dir, "3", "state.pt"), weights_only=True)

    resumed = _problem_and_trainer(_run_cfg(a_dir, 2, **cfg))
    assert resumed.epoch == 1 and resumed.optimizer.step_count == 3
    moments = resumed.optimizer.state_dict()["optimizer"]["state"]
    for idx, st in saved["opt_state"]["optimizer"]["state"].items():
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(moments[idx][key], st[key])
        assert moments[idx]["step"].device.type == "cpu"

    b = ttrain.run(dict(_run_cfg(a_dir, 2, **cfg), device="cpu"),
                   parse_cmdline_args=False)
    c = ttrain.run(dict(_run_cfg(c_dir, 2, **cfg), device="cpu"),
                   parse_cmdline_args=False)
    assert b.problem.epoch == c.problem.epoch == 2
    assert b.problem.optimizer.step_count == c.problem.optimizer.step_count == 6
    assert _steps(a_dir) == [2, 4, 6]   # 3 went: neither newest nor the first
    assert _steps(c_dir) == [2, 4, 6]
    sb, sc = b.problem.model.state_dict(), c.problem.model.state_dict()
    assert all(torch.equal(sb[k], sc[k]) for k in sc)
    ob = b.problem.optimizer.state_dict()["optimizer"]["state"]
    oc = c.problem.optimizer.state_dict()["optimizer"]["state"]
    assert all(torch.equal(ob[i][k], oc[i][k]) for i in oc for k in oc[i])
    start = ttrain.ModelFactory(ttrain.ModelConfig(model_name=NAME))(
        device="cpu")[0].state_dict()
    assert not torch.equal(sc["blocks.0.attn.qkv.weight"],
                           start["blocks.0.attn.qkv.weight"])


def test_init_ckpt_is_a_model_only_warm_start(small_vit, tmp_path):
    first = str(tmp_path / "first")
    a = ttrain.run(dict(_run_cfg(first, 1), device="cpu"),
                   parse_cmdline_args=False)
    cfg = _run_cfg("", 1)
    warm = ttrain.run(dict(cfg, device="cpu", trainer={
        **cfg["trainer"], "init_ckpt": first, "resume_from_ckpt": False},
        timekeeping={**cfg["timekeeping"], "nb_epochs": 0}),
        parse_cmdline_args=False)
    assert warm.problem.epoch == 0
    assert warm.problem.optimizer.step_count == 0
    assert not warm.problem.optimizer.optimizer.state
    sa, sw = a.problem.model.state_dict(), warm.problem.model.state_dict()
    assert all(torch.equal(sa[k], sw[k]) for k in sa)
    os.makedirs(tmp_path / "empty" / "model")
    for empty in ("empty", "mistyped"):
        with pytest.raises(ValueError, match="No checkpoint found"):
            ttrain.run(dict(cfg, device="cpu", trainer={
                **cfg["trainer"], "init_ckpt": str(tmp_path / empty)}),
                parse_cmdline_args=False)
    assert not (tmp_path / "mistyped").exists()
    assert sorted(os.listdir(tmp_path / "empty")) == ["model"]


def test_resume_restores_the_ema_and_batchnorm_statistics(small_resnet,
                                                          tmp_path):
    """The JAX trainer test's EMA case on a BatchNorm net: the EMA (its
    running statistics too) and the live weights and statistics ride the
    checkpoint through a resume."""
    cfg = _run_cfg(str(tmp_path / "ckpt"), 1)
    cfg["problem"].update(model={"model_name": small_resnet}, ema_decay=0.9)
    first = ttrain.run(dict(cfg, device="cpu"), parse_cmdline_args=False).problem
    second = _problem_and_trainer(cfg)
    stats = [k for k in first.ema_params if "running_" in k]
    assert stats
    live = first.model.state_dict()
    assert any(not torch.equal(first.ema_params[k], live[k]) for k in stats)
    for k, v in first.ema_params.items():
        assert torch.equal(second.ema_params[k], v), k
    restored = second.model.state_dict()
    assert all(torch.equal(restored[k], v) for k, v in live.items())
