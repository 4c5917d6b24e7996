"""The port's models API against the JAX package's, on the CPU:
``jax_from_state_dict``, save/load across the two packages, the model
cache, ``create_model(model_path=...)`` and ``pretrained=True``,
``transfer_weights`` (classifier, first conv, the ``transform_weights``
hooks), ``list_modules``, ``BatchNorm`` and ``EmbeddingModel``.

Every family the port has runs at a small config with seeded parameters,
which the port takes through ``state_dict_from_jax``. A directory written
by one package is read by the other; the parameters must come back bit for
bit, and both packages' ``forward_features`` on the loaded weights must
agree within 1e-5 of the largest value in f32 (the two frameworks sum in
another order). ``transfer_weights``: the port's destination state dict
against the JAX package's destination parameters, exactly where weights
are copied and within 1e-5 where a hook or the first-conv rule computes
them (SAM's bilinear resize as held in ``test_torch_resize.py``).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfimm_tpu
import tfimm_tpu.architectures.segment_anything  # noqa: F401  (registers SAM)
import tfimm_tpu_torch
from tfimm_tpu.models.registry import model_entrypoint
from tfimm_tpu.ops.norm import BatchNorm as JaxBatchNorm
from tfimm_tpu.utils.tree import flatten_params
from tfimm_tpu_torch.core import Context
from tfimm_tpu_torch.ops.norm import BatchNorm, norm_layer_factory
from tfimm_tpu_torch.utils import cache
from tfimm_tpu_torch.utils.convert import jax_from_state_dict, state_dict_from_jax

torch.set_num_threads(1)

SAM_TINY = dict(input_size=(64, 64), encoder_embed_dim=16, encoder_nb_blocks=2,
                encoder_nb_heads=2, embed_dim=32,
                encoder_global_attn_indices=(1,), encoder_window_size=2,
                prompt_mask_hidden_dim=16, decoder_nb_blocks=2,
                decoder_nb_heads=2, decoder_mlp_channels=32,
                decoder_iou_hidden_dim=16)
# family -> (registered name, small config, input side)
FAMILIES = {
    "vit": ("vit_base_patch16_224",
            dict(input_size=(64, 64), embed_dim=64, nb_blocks=2, nb_heads=2,
                 nb_classes=7), 64),
    "deit": ("deit_tiny_distilled_patch16_224",
             dict(input_size=(64, 64), embed_dim=64, nb_blocks=2, nb_heads=2,
                  nb_classes=7), 64),
    "convnext": ("convnext_tiny",
                 dict(input_size=(32, 32), embed_dim=(32, 64), nb_blocks=(1, 1),
                      nb_classes=7, drop_path_rate=0.0), 32),
    "swin": ("swin_tiny_patch4_window7_224",
             dict(input_size=(56, 56), embed_dim=32, nb_heads=(2, 4),
                  nb_blocks=(2, 2), nb_classes=7), 56),
    "cait": ("cait_xxs24_224",
             dict(input_size=(32, 32), patch_size=8, embed_dim=64, nb_blocks=2,
                  nb_heads=4, nb_classes=7), 32),
    "pvt": ("pvt_tiny",
            dict(input_size=(64, 64), embed_dim=(16, 32, 48, 64),
                 nb_heads=(1, 2, 3, 4), mlp_ratio=(2.0,) * 4,
                 nb_blocks=(2, 1, 1, 1), nb_classes=7), 64),
    "pvt_v2": ("pvt_v2_b0",
               dict(input_size=(64, 64), embed_dim=(16, 32), nb_heads=(1, 2),
                    mlp_ratio=(4.0, 2.0), nb_blocks=(2, 1), sr_ratio=(4, 2),
                    nb_classes=7), 64),
    "poolformer": ("poolformer_s12",
                   dict(input_size=(64, 64), embed_dim=(32, 64),
                        nb_blocks=(2, 1), mlp_ratio=(4.0, 4.0), nb_classes=7),
                   64),
    "sam": ("sam_vit_b", SAM_TINY, 64),
}


def _seeded(params, seed):
    """Every leaf drawn anew: norm scales, running variances and layer
    scales near 1, the rest 0.05 N(0, 1)."""
    rng = np.random.default_rng(seed)
    leaves, tree = jax.tree_util.tree_flatten_with_path(params)
    new = []
    for path, leaf in leaves:
        r = rng.normal(size=np.shape(leaf)).astype(np.float32)
        key = getattr(path[-1], "key", "")
        near_one = key in ("scale", "var") or key.startswith(
            ("gamma", "layer_scale"))
        new.append(jnp.asarray(1.0 + 0.1 * r if near_one else 0.05 * r))
    return jax.tree_util.tree_unflatten(tree, new)


def _jax_model(family, seed=0, **overrides):
    name, cfg, _ = FAMILIES[family]
    cls, base = model_entrypoint(name)
    jm = cls(dataclasses.replace(base, **dict(cfg, **overrides)))
    jm.init(seed)
    return jm


def _pair(family, seed=0, **overrides):
    """(JAX model with seeded parameters, the port with the same)."""
    name, cfg, _ = FAMILIES[family]
    jm = _jax_model(family, **overrides)
    jm.params = _seeded(jm.params, seed)
    tm = tfimm_tpu_torch.create_model(name, device="cpu",
                                      **dict(cfg, **overrides))
    tm.load_state_dict(state_dict_from_jax(jm.params))  # strict: names match
    return jm, tm


def _images(family, seed=1):
    side = FAMILIES[family][2]
    return np.random.default_rng(seed).normal(
        size=(2, side, side, 3)).astype(np.float32)


def _features(model, x):
    """forward_features of either package's model on numpy input, as f32
    numpy."""
    if isinstance(model, torch.nn.Module):
        with torch.no_grad():
            return model.forward_features(torch.from_numpy(x)).float().numpy()
    out = model.apply(model.params, jnp.asarray(x), features_only=True)
    return np.asarray(jnp.asarray(out, jnp.float32))


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _same_state(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k].to(got[k].dtype)), k


@pytest.mark.parametrize("family", list(FAMILIES))
def test_jax_from_state_dict_inverts_the_conversion(family):
    jm, tm = _pair(family)
    flat = jax_from_state_dict(tm)
    want = flatten_params(jm.params)
    assert sorted(flat) == sorted(want)
    for k, v in want.items():
        assert flat[k].shape == v.shape, k
        assert np.array_equal(flat[k], np.asarray(v)), k
    _same_state(state_dict_from_jax(flat), tm.state_dict())


@pytest.mark.parametrize("family", list(FAMILIES))
def test_a_jax_save_loads_in_the_port(family, tmp_path):
    jm, tm = _pair(family, seed=2)
    tfimm_tpu.save_model(jm, str(tmp_path))
    loaded = tfimm_tpu_torch.load_model(str(tmp_path), device="cpu")
    assert type(loaded) is type(tm) and loaded.cfg == tm.cfg
    assert not loaded.training
    _same_state(loaded.state_dict(), tm.state_dict())
    x = _images(family)
    _close(_features(loaded, x), _features(jm, x), 1e-5)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_a_port_save_loads_in_jax(family, tmp_path):
    jm, tm = _pair(family, seed=3)
    tfimm_tpu_torch.save_model(tm, str(tmp_path))
    loaded = tfimm_tpu.load_model(str(tmp_path))
    assert type(loaded).__name__ == type(tm).__name__
    assert dataclasses.asdict(loaded.cfg) == dataclasses.asdict(jm.cfg)
    got = flatten_params(loaded.params)
    for k, v in flatten_params(jm.params).items():
        assert np.array_equal(np.asarray(got[k]), np.asarray(v)), k
    x = _images(family)
    _close(_features(loaded, x), _features(tm, x), 1e-5)


def test_a_bf16_jax_save_loads_exactly(tmp_path):
    jm, _ = _pair("vit", seed=4)
    jm.cast(jnp.bfloat16)
    tfimm_tpu.save_model(jm, str(tmp_path))
    with np.load(tmp_path / "params.npz") as data:
        assert data["pos_embed"].dtype.kind == "V"   # numpy sees bytes
    loaded = tfimm_tpu_torch.load_model(str(tmp_path), device="cpu")
    assert loaded.pos_embed.dtype == torch.bfloat16
    want = state_dict_from_jax(
        {k: np.asarray(jnp.asarray(v, jnp.float32))
         for k, v in flatten_params(jm.params).items()})
    _same_state(loaded.state_dict(), want)
    as_f32 = tfimm_tpu_torch.load_model(str(tmp_path), device="cpu",
                                        dtype=torch.float32)
    jm.cast(jnp.float32)
    x = _images("vit")
    _close(_features(as_f32, x), _features(jm, x), 1e-5)


def test_a_bf16_port_save_writes_f32_and_comes_back_bf16(tmp_path):
    tm = tfimm_tpu_torch.create_model("vit_base_patch16_224", device="cpu",
                                      dtype=torch.bfloat16,
                                      **FAMILIES["vit"][1])
    tfimm_tpu_torch.save_model(tm, str(tmp_path))
    with np.load(tmp_path / "params.npz") as data:
        assert {data[k].dtype for k in data.files} == {np.dtype(np.float32)}
    payload = json.loads((tmp_path / "config.json").read_text())
    assert payload["format_version"] == 1 and payload["dtype"] == "bfloat16"
    loaded = tfimm_tpu_torch.load_model(str(tmp_path), device="cpu")
    _same_state(loaded.state_dict(), tm.state_dict())
    jax_loaded = tfimm_tpu.load_model(str(tmp_path))
    assert jax_loaded.params["pos_embed"].dtype == jnp.float32


def test_load_refuses_an_unknown_class(tmp_path):
    tm = tfimm_tpu_torch.create_model("vit_tiny_patch16_224", device="cpu")
    tfimm_tpu_torch.save_model(tm, str(tmp_path))
    payload = json.loads((tmp_path / "config.json").read_text())
    payload["class_name"] = "LoRAConvNeXt"   # a JAX class the port lacks
    (tmp_path / "config.json").write_text(json.dumps(payload))
    with pytest.raises(ValueError):
        tfimm_tpu_torch.load_model(str(tmp_path), device="cpu")


# -- transfer_weights ---------------------------------------------------------

def _transfer(family, tmp_path, **dst_overrides):
    """Transfer seeded source weights to a destination config in both
    packages; the port's destination starts from the JAX destination's
    initial parameters, so that weights left in place agree too. Returns
    (the port's destination state dict, the JAX one's)."""
    jsrc, tsrc = _pair(family, seed=5)
    jdst = _jax_model(family, **dst_overrides)
    tdst = tfimm_tpu_torch.create_model(
        FAMILIES[family][0], device="cpu",
        **dict(FAMILIES[family][1], **dst_overrides))
    tdst.load_state_dict(state_dict_from_jax(jdst.params))
    tfimm_tpu.transfer_weights(jsrc, jdst)
    tfimm_tpu_torch.transfer_weights(tsrc, tdst)
    return tdst.state_dict(), state_dict_from_jax(jdst.params), tsrc.state_dict()


def test_transfer_keeps_the_classifier_when_classes_change(tmp_path):
    got, want, src = _transfer("vit", tmp_path, nb_classes=5)
    _same_state(got, want)
    assert torch.equal(got["blocks.0.attn.qkv.weight"],
                       src["blocks.0.attn.qkv.weight"])
    assert not torch.equal(got["head.weight"][:5], src["head.weight"][:5])


def test_transfer_copies_the_classifier_when_classes_match(tmp_path):
    got, want, src = _transfer("deit", tmp_path)
    _same_state(got, want)
    _same_state(got, src)


@pytest.mark.parametrize("family", ["vit", "convnext"])
@pytest.mark.parametrize("in_channels", [1, 5])
def test_transfer_adapts_the_first_conv(family, in_channels, tmp_path):
    got, want, _ = _transfer(family, tmp_path, in_channels=in_channels)
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], 1e-6)


@pytest.mark.parametrize("family,size", [("vit", (96, 80)), ("deit", (96, 96)),
                                         ("cait", (48, 40)), ("pvt", (96, 96)),
                                         ("sam", (96, 128))])
def test_transfer_resizes_through_the_hooks(family, size, tmp_path):
    got, want, src = _transfer(family, tmp_path, input_size=size)
    assert sorted(got) == sorted(want)
    resized = [k for k in got if got[k].shape != src[k].shape]
    assert resized   # the hooks ran
    for k in want:
        _close(got[k], want[k], 1e-5)


def test_transfer_raises_on_a_shape_without_a_hook():
    _, src = _pair("swin")
    dst = tfimm_tpu_torch.create_model(
        FAMILIES["swin"][0], device="cpu",
        **dict(FAMILIES["swin"][1], embed_dim=48, nb_heads=(2, 4)))
    with pytest.raises(ValueError):
        tfimm_tpu_torch.transfer_weights(src, dst)


def test_transfer_ignores_the_listed_weights():
    _, src = _pair("vit", seed=6)
    name, cfg, _ = FAMILIES["vit"]
    dst = tfimm_tpu_torch.create_model(name, device="cpu", **cfg)
    before = dst.state_dict()["cls_token"].clone()
    tfimm_tpu_torch.transfer_weights(src, dst, weights_to_ignore=["cls_token"])
    assert torch.equal(dst.state_dict()["cls_token"], before)
    assert torch.equal(dst.pos_embed, src.pos_embed)


# -- create_model with saved weights; the cache ------------------------------

def test_create_model_from_a_path_with_overrides(tmp_path):
    jm, tm = _pair("vit", seed=7)
    tfimm_tpu_torch.save_model(tm, str(tmp_path))
    name, cfg, _ = FAMILIES["vit"]
    same = tfimm_tpu_torch.create_model(name, model_path=str(tmp_path),
                                        device="cpu", **cfg)
    _same_state(same.state_dict(), tm.state_dict())
    big = tfimm_tpu_torch.create_model(name, model_path=str(tmp_path),
                                       device="cpu", dtype=torch.bfloat16,
                                       **dict(cfg, input_size=(96, 96)))
    jbig = tfimm_tpu.create_model(name, model_path=str(tmp_path),
                                  **dict(cfg, input_size=(96, 96)))
    assert big.cfg.input_size == (96, 96) and big.pos_embed.dtype == torch.bfloat16
    want = state_dict_from_jax(jbig.params)
    for k, v in big.state_dict().items():
        _close(v.float(), want[k].to(torch.bfloat16).float(), 0.0)


def test_cache_env_and_overrides(tmp_path, monkeypatch):
    monkeypatch.setenv("TFIMM_TPU_HOME", str(tmp_path))
    assert cache.get_dir() == str(tmp_path)
    cache.set_dir(str(tmp_path / "other"))
    assert cache.get_dir() == str(tmp_path / "other")
    cache.set_dir(None)
    monkeypatch.delenv("TFIMM_TPU_HOME")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    assert cache.get_dir() == str(tmp_path / "xdg" / "tfimm_tpu")

    assert cache.cached_model_path("nope") is None
    cache.set_model_cache("mymodel", str(tmp_path / "m"))
    assert cache.cached_model_path("mymodel") == str(tmp_path / "m")
    assert "mymodel" in cache.list_cached_models()
    (tmp_path / "m").mkdir()
    cache.clear_model_cache("mymodel", delete_files=True)
    assert cache.cached_model_path("mymodel") is None
    assert not (tmp_path / "m").exists()


def test_pretrained_reads_the_cache_the_jax_package_writes(tmp_path,
                                                           monkeypatch):
    monkeypatch.setenv("TFIMM_TPU_HOME", str(tmp_path))
    name, cfg, _ = FAMILIES["vit"]
    with pytest.raises(NotImplementedError):
        tfimm_tpu_torch.create_model(name, pretrained=True, device="cpu", **cfg)
    jm, tm = _pair("vit", seed=8)
    tfimm_tpu.save_model(jm, os.path.join(str(tmp_path), name))
    assert name in tfimm_tpu_torch.list_cached_models()
    loaded = tfimm_tpu_torch.create_model(name, pretrained=True, device="cpu",
                                          **cfg)
    _same_state(loaded.state_dict(), tm.state_dict())


def test_list_modules_matches_jax():
    ported = tfimm_tpu_torch.list_modules()
    assert set(ported) <= set(tfimm_tpu.list_modules())
    assert ported == sorted(ported)
    for module in ported:
        want = [m for m in tfimm_tpu.list_models(module=module)
                if not m.endswith("_test_model")]
        assert tfimm_tpu_torch.list_models(module=module) == want, module
    for module in set(tfimm_tpu.list_modules()) - set(ported):
        assert not tfimm_tpu_torch.list_models(module=module)


def test_architecture_class_finds_every_family():
    from tfimm_tpu_torch.models.registry import architecture_class

    for family, (name, _, _) in FAMILIES.items():
        cls = tfimm_tpu_torch.model_class(name)
        assert architecture_class(cls.__name__) is cls
        assert dataclasses.is_dataclass(cls.cfg_class)
    assert architecture_class("NoSuchModel") is None


# -- BatchNorm and EmbeddingModel ----------------------------------------------

@pytest.mark.parametrize("use_scale,use_bias", [(True, True), (False, True),
                                                (True, False)])
@pytest.mark.parametrize("training", [False, True])
def test_batch_norm_matches_jax(use_scale, use_bias, training):
    rng = np.random.default_rng(9)
    x = rng.normal(size=(3, 4, 5, 8)).astype(np.float32) * 2 + 1
    jbn = JaxBatchNorm(8, use_scale=use_scale, use_bias=use_bias)
    params = {k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32) * 0.3
                             + (1.0 if k in ("scale", "var") else 0.0))
              for k, v in jbn.init(0).items()}
    tbn = BatchNorm(8, use_scale=use_scale, use_bias=use_bias)
    tbn.load_state_dict(state_dict_from_jax(params))
    ctx = tfimm_tpu.core.Context(training=training)
    ctx.index_params(params)
    with ctx:
        want = jbn(params, jnp.asarray(x))
    with Context(training=training):
        got = tbn(torch.from_numpy(x))
    _close(got.detach(), want, 1e-6)
    if training:
        updates = ctx.collect_state_updates()
        _close(tbn.running_mean, updates["mean"], 1e-6)
        _close(tbn.running_var, updates["var"], 1e-6)
    else:
        _same_state(tbn.state_dict(), state_dict_from_jax(params))


def test_batch_norm_factory_entries():
    assert norm_layer_factory("batch_norm")(4).eps == 1e-5
    bn = norm_layer_factory("batch_norm_tf")(4)
    assert bn.eps == 1e-3 and bn.momentum == 0.9


def _embedding_pair(family, seed=10):
    from tfimm_tpu import EmbeddingModel as JaxEmbeddingModel

    jb, tb = _pair(family, seed=seed)
    jm = JaxEmbeddingModel(jb, embed_dim=6)
    jm.params = _seeded(jm.params, seed + 1)
    jb.params = jm.params["backbone"]
    tm = tfimm_tpu_torch.EmbeddingModel(tb, embed_dim=6)
    tm.load_state_dict(state_dict_from_jax(jm.params))
    return jm, tm.eval()


@pytest.mark.parametrize("family", ["vit", "convnext"])
def test_embedding_model_matches_jax(family):
    jm, tm = _embedding_pair(family)
    x = _images(family)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    _close(got, jm(jnp.asarray(x)), 1e-5)

    want, updates = jm(jnp.asarray(x), training=True, mutable=True)
    tm.train()
    got, feats = tm(torch.from_numpy(x), return_features=True)
    assert feats["embeddings"] is got
    _close(got.detach(), want, 1e-4)
    _close(tm.bn.running_mean, updates["bn"]["mean"], 1e-5)
    _close(tm.bn.running_var, updates["bn"]["var"], 1e-5)


def test_embedding_model_saves_across_packages(tmp_path):
    from tfimm_tpu import EmbeddingModel as JaxEmbeddingModel

    jm, tm = _embedding_pair("vit", seed=12)
    x = _images("vit")
    tm.save(str(tmp_path / "port"))
    from_port = JaxEmbeddingModel.load(str(tmp_path / "port"))
    _close(from_port(jnp.asarray(x)), jm(jnp.asarray(x)), 1e-6)
    jm.save(str(tmp_path / "jax"))
    from_jax = tfimm_tpu_torch.EmbeddingModel.load(str(tmp_path / "jax"),
                                                   device="cpu")
    _same_state(from_jax.state_dict(), tm.state_dict())
    with torch.no_grad():
        _close(from_jax(torch.from_numpy(x)), tm(torch.from_numpy(x)), 0.0)
