"""Port parity for the deployment side of training: ``save_model`` of the
classification problem, ``utils/export.py`` (``torch.export``), and the
``SavedModel`` and ``EmbeddingModelFactory`` model factories, against the
JAX package on the CPU.

A small ViT (32x32, patch 8, D = 32, 2 heads of 16, 1 block, 5 classes)
is registered in both registries for a test; both problems start from the
same seeded weights (the JAX ones, moved with ``state_dict_from_jax``) and
train on the same numpy batches. Bars: parameters that went through a
saved directory equal bit for bit; the two packages' EMA weights after two
steps within 1e-5 of their largest value (f32 sums in another order); the
two exported programs' log-probabilities within 1e-4, as the same weights'
eager outputs are held elsewhere.
"""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfimm_tpu
import tfimm_tpu.train as jtrain
import tfimm_tpu_torch
import tfimm_tpu_torch.train as ttrain
from tfimm_tpu.architectures.vit import ViT as JaxViT
from tfimm_tpu.architectures.vit import ViTConfig as JaxViTConfig
from tfimm_tpu.models import registry as jax_registry
from tfimm_tpu.utils.export import load_exported as jax_load_exported
from tfimm_tpu_torch.architectures.vit import ViT, ViTConfig
from tfimm_tpu_torch.models import registry as torch_registry
from tfimm_tpu_torch.ops.kernels import dispatch
from tfimm_tpu_torch.utils.convert import state_dict_from_jax
from tfimm_tpu_torch.utils.export import export_model, load_exported

# The module, which its package's ``fused_mha`` function name shadows.
fused_mha_module = importlib.import_module(
    "tfimm_tpu_torch.ops.kernels.fused_mha")

torch.set_num_threads(1)

NAME = "export_parity_vit"
SMALL = dict(input_size=(32, 32), patch_size=8, embed_dim=32, nb_blocks=1,
             nb_heads=2, nb_classes=5)


@pytest.fixture
def small_vit(monkeypatch):
    for reg, cls, cfg_cls in ((jax_registry, JaxViT, JaxViTConfig),
                              (torch_registry, ViT, ViTConfig)):
        monkeypatch.setitem(reg._model_class, NAME, cls)
        monkeypatch.setitem(reg._model_config, NAME,
                            cfg_cls(name=NAME, **SMALL))
    return NAME


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


def _images(seed, n):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(n, 32, 32, 3)).astype(np.uint8)


def _trained_problems(ema_decay):
    """Both classification problems from the same seeded weights, after two
    SGD steps on the same batches."""
    tk = dict(nb_epochs=1, batch_size=4, nb_samples_per_epoch=8)
    cfgs = []
    for pkg in (jtrain, ttrain):
        cfgs.append(pkg.ClassificationConfig(
            model=pkg.ModelConfig(model_name=NAME), model_class="ModelFactory",
            optimizer=pkg.OptimizerConfig(
                optimizer="sgd", lr_schedule_class="LRConstFactory",
                lr_schedule=pkg.get_cfg_class("LRConstConfig")(lr=0.05)),
            optimizer_class="OptimizerFactory", ema_decay=ema_decay))
    jp = jtrain.ClassificationProblem(cfgs[0], timekeeping=jtrain.Timekeeping(**tk))
    params = _seeded(jp.params, 0)
    jp.params = jp.model.params = params
    jp.opt_state = jp.tx.init(params)
    if ema_decay:
        jp.ema_params = params
    tp = ttrain.ClassificationProblem(cfgs[1], timekeeping=ttrain.Timekeeping(**tk),
                                      device="cpu")
    tp.model.load_state_dict(state_dict_from_jax(params))
    if ema_decay:
        tp.ema_params = tp._param_copy()
    rng = np.random.default_rng(1)
    for it in range(2):
        batch = (rng.uniform(0, 255, size=(4, 32, 32, 3)).astype(np.float32),
                 rng.integers(0, 5, size=(4,)))
        jp.train_step(batch, it)
        tp.train_step(batch, it)
    return jp, tp


@pytest.mark.parametrize("ema_decay", [0.0, 0.5])
def test_save_model_writes_what_both_packages_load(small_vit, tmp_path,
                                                   ema_decay):
    """Each package's ``save_model`` writes the deployed weights (the EMA
    when averaging is on), which both packages load bit for bit; the port
    puts the live weights back; the two deployment artifacts give the same
    log-probabilities at two batch sizes."""
    jp, tp = _trained_problems(ema_decay)
    live = {k: v.clone() for k, v in tp.model.state_dict().items()}
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jp.save_model(jdir)
    tp.save_model(tdir)
    assert sorted(os.listdir(tdir)) == ["config.json", "model.pt2",
                                        "params.npz"]
    assert os.path.exists(os.path.join(jdir, "model.stablehlo"))
    deployed_t = tp.ema_params if ema_decay else live
    deployed_j = state_dict_from_jax(jp.ema_params if ema_decay else jp.params)
    for name, v in deployed_t.items():
        assert _rel(v, deployed_j[name]) < 1e-5, name
    assert all(torch.equal(tp.model.state_dict()[k], v) for k, v in live.items())
    if ema_decay:
        assert not torch.equal(deployed_t["head.weight"], live["head.weight"])

    for path, want in ((tdir, deployed_t), (jdir, deployed_j)):
        got = tfimm_tpu_torch.load_model(path, device="cpu").state_dict()
        assert all(torch.equal(got[k], want[k]) for k in want), path
        got = state_dict_from_jax(tfimm_tpu.load_model(path).params)
        assert all(torch.equal(got[k], want[k]) for k in want), path

    ported, reference = load_exported(os.path.join(tdir, "model.pt2")), \
        jax_load_exported(os.path.join(jdir, "model.stablehlo"))
    for n in (3, 8):
        images = _images(n, n)
        got = ported(images)
        assert got.dtype == torch.float32 and got.shape == (n, 5)
        want = np.asarray(reference(images))
        assert np.abs(got.numpy() - want).max() < 1e-4, n
        torch.testing.assert_close(got.exp().sum(-1), torch.ones(n))


def test_the_exported_graph_holds_the_fused_mha_op(small_vit, tmp_path,
                                                   monkeypatch):
    """The exported program calls ``tfimm_tpu_torch.fused_mha`` once a
    block, whose body (the kernel's wrapper; its plain version here) runs
    and logs its dispatch at run time, and matches the eager model; a fixed
    batch size exports a fixed shape."""
    model = tfimm_tpu_torch.create_model(NAME, device="cpu", seed=3)
    pp = tfimm_tpu_torch.create_preprocessing(NAME, device="cpu")
    path = str(tmp_path / "fixed.pt2")
    export_model(model, path, batch_size=4)
    exported = load_exported(path)
    ops = [n.target for n in exported.program.graph.nodes
           if n.op == "call_function"]
    assert ops.count(torch.ops.tfimm_tpu_torch.fused_mha.default) == 1
    calls = []
    forward = fused_mha_module._fused_mha_forward
    monkeypatch.setattr(fused_mha_module, "_fused_mha_forward",
                        lambda *a: calls.append(a[0].shape) or forward(*a))
    images = _images(4, 4)
    with dispatch.capture_dispatches() as seen:
        got = exported(images)
    assert seen == {"fused_mha"}   # logged by the op's body at run time
    assert calls == [(4, 17, 96)]
    with torch.no_grad():
        want = model(pp(torch.from_numpy(images)))
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(AssertionError, match="Guard failed"):
        exported(_images(5, 5))
    assert model.training is False


def test_saved_model_matches_jax(small_vit, tmp_path):
    """``SavedModel`` in both packages on one saved directory: the same
    weights, and the same preprocessing (no /255, as in the JAX package)
    and features, in f32 and with ``dtype="bfloat16"``."""
    jmodel = tfimm_tpu.create_model(NAME)
    jmodel.params = _seeded(jmodel.params, 4)
    tfimm_tpu.save_model(jmodel, str(tmp_path))
    images = _images(6, 2)
    for dtype in ("", "bfloat16"):
        kw = dict(path=str(tmp_path), dtype=dtype, mean=(10.0, 20.0, 30.0),
                  std=(50.0, 60.0, 70.0))
        jm, jpp = jtrain.SavedModel(jtrain.SavedModelConfig(**kw))()
        tm, tpp = ttrain.get_class("SavedModel")(
            ttrain.get_cfg_class("SavedModelConfig")(**kw))(device="cpu")
        x_t, x_j = tpp(images), jpp(images)
        assert x_t.dtype == (torch.bfloat16 if dtype else torch.float32)
        assert _rel(x_t.float(), np.asarray(x_j, np.float32)) < 1e-6
        sd = state_dict_from_jax(jm.params)
        assert all(torch.equal(v, sd[k]) for k, v in tm.state_dict().items())
        x = np.array(jpp(images), np.float32)
        want = jm.apply(jm.params, jnp.asarray(x), features_only=True)
        with torch.no_grad():
            got = tm(torch.from_numpy(x), features_only=True)
        assert _rel(got, want) < 1e-5


def test_embedding_model_factory_matches_jax(small_vit, tmp_path):
    """``EmbeddingModelFactory`` over a saved backbone in both packages:
    the same backbone weights bit for bit, the same head shapes and
    preprocessing; with the JAX head moved over, the same embeddings. The
    port draws its head from seed 0 every time."""
    jmodel = tfimm_tpu.create_model(NAME)
    jmodel.params = _seeded(jmodel.params, 5)
    tfimm_tpu.save_model(jmodel, str(tmp_path))
    kw = dict(backbone_name=NAME, embed_dim=16, model_path=str(tmp_path))
    jm, jpp = jtrain.EmbeddingModelFactory(jtrain.EmbeddingModelConfig(**kw))()
    make = ttrain.get_class("EmbeddingModelFactory")(
        ttrain.get_cfg_class("EmbeddingModelConfig")(**kw))
    tm, tpp = make(device="cpu")
    assert isinstance(tm, tfimm_tpu_torch.EmbeddingModel)
    assert tm.backbone.cfg.nb_classes == 0 and not tm.training
    want = state_dict_from_jax(jm.params)
    got = tm.state_dict()
    assert set(got) == set(want)
    backbone = [k for k in got if k.startswith("backbone.")]
    assert backbone and all(torch.equal(got[k], want[k]) for k in backbone)
    assert all(got[k].shape == want[k].shape for k in got)
    again = make(device="cpu")[0].state_dict()
    assert all(torch.equal(got[k], again[k]) for k in got)
    images = _images(7, 3)
    x = np.array(jpp(images))
    assert _rel(tpp(images), x) < 1e-6
    tm.load_state_dict(want)
    with torch.no_grad():
        emb = tm(torch.from_numpy(x))
    assert _rel(emb, jm.apply(jm.params, jnp.asarray(x))) < 1e-5
