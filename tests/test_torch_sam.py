"""Port parity for Segment Anything: tfimm_tpu_torch's SAM modules against
the JAX package's, at small widths, with the JAX parameters carried over
through ``state_dict_from_jax``.

Inputs and weights are made with numpy from a seed. The JAX package
initialises the rel-pos tables and the position embedding at zero and its
LayerNorms at one, which would hide a bias applied wrongly, so every
parameter is drawn anew (LayerNorm scales near 1, the tables and the
position embedding at std 0.5). Bars, as max|diff| / max|JAX| unless
stated: 1e-5 in f32 where both packages compute the same function in the
same order up to summation order (the port's attention takes its kernel's
plain version, the same f32 function as the JAX package's XLA path), 1e-4
through the whole encoder or model, whose many layers compound the f32
roundings; in bf16 2e-2 against the Pallas kernel in interpret mode (both
round p to bf16 before p @ v) and 5e-2 against the f32 model. Against the
golden fixture of Meta's own implementation, the JAX package's bars: 1e-4
(encoder, decoder) and 1e-5 (prompt encoder).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfimm_tpu.architectures.segment_anything  # noqa: F401
import tfimm_tpu_torch
from tfimm_tpu.architectures.segment_anything import image_encoder as jie
from tfimm_tpu.architectures.segment_anything import SAMPredictor as JaxPredictor
from tfimm_tpu.architectures.segment_anything.mask_decoder import (
    ConvTranspose2d as JaxConvTranspose2d,
)
from tfimm_tpu.architectures.segment_anything.predictor import (
    ImageResizer as JaxResizer,
)
from tfimm_tpu.architectures.segment_anything.prompt_encoder import (
    PositionalEmbeddingRandom as JaxPE,
)
from tfimm_tpu.architectures.segment_anything.transformer import (
    TwoWayTransformer as JaxTWT,
)
from tfimm_tpu.models.registry import model_entrypoint
from tfimm_tpu.utils.pt_convert import convert_pt_state_dict
from tfimm_tpu_torch.architectures.segment_anything import (
    ImageResizer,
    SAMPredictor,
)
from tfimm_tpu_torch.architectures.segment_anything import image_encoder as tie
from tfimm_tpu_torch.architectures.segment_anything.prompt_encoder import (
    PositionalEmbeddingRandom,
)
from tfimm_tpu_torch.architectures.segment_anything.transformer import (
    TwoWayTransformer,
)
from tfimm_tpu_torch.core import Context
from tfimm_tpu_torch.ops.conv import ConvTranspose2d
from tfimm_tpu_torch.ops.kernels import dispatch
from tfimm_tpu_torch.ops.kernels.dispatch import capture_dispatches
from tfimm_tpu_torch.ops.resize import resize_linear
from tfimm_tpu_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(1)

# The golden fixture's widths, but 32 output channels: the mask decoder's
# LayerNorms then normalise 8 channels and the prompt encoder's 4 (at 8
# output channels, 2 and 1: a one-pass variance over 2 values cancels, and
# the two packages' f32 roundings part by 1e-3).
TINY = dict(input_size=(64, 64), encoder_embed_dim=16, encoder_nb_blocks=2,
            encoder_nb_heads=2, embed_dim=32, encoder_global_attn_indices=(1,),
            encoder_window_size=2, prompt_mask_hidden_dim=16,
            decoder_nb_blocks=2, decoder_nb_heads=2, decoder_mlp_channels=32,
            decoder_iou_hidden_dim=16)
# Windowed blocks whose grid needs padding (10 x 10 tokens, window 4 -> 12)
# and one global block, at head dim 8.
PADDED = dict(TINY, input_size=(160, 160), encoder_embed_dim=32,
              encoder_nb_heads=4, encoder_nb_blocks=3,
              encoder_global_attn_indices=(1,), encoder_window_size=4)
# For gradients through the kernels of both packages: a 32 x 32 global grid
# (1024 tokens, which the JAX gate tiles into 512-key blocks) and 12 x 12
# windows (144 tokens, at least the 128 its gate asks for outside
# training; the grid padded to 36 x 36), head dim 16.
GRAD = dict(TINY, input_size=(512, 512), encoder_embed_dim=32,
            encoder_nb_heads=2, encoder_nb_blocks=2,
            encoder_global_attn_indices=(1,), encoder_window_size=12)
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "golden",
                       "sam.npz")


def _rel(got, want):
    got = np.asarray(got.detach().double() if isinstance(got, torch.Tensor)
                     else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / np.abs(want).max()


def _seeded(params, seed):
    """Every leaf drawn anew: LayerNorm scales 1 + 0.1 N(0, 1), the rel-pos
    tables and the position embedding 0.5 N(0, 1), the rest 0.2 N(0, 1)."""
    rng = np.random.default_rng(seed)
    leaves, tree = jax.tree_util.tree_flatten_with_path(params)
    new = []
    for path, leaf in leaves:
        key = getattr(path[-1], "key", None)
        r = rng.normal(size=np.shape(leaf)).astype(np.float32)
        if key == "scale":
            r = 1.0 + 0.1 * r
        elif key in ("rel_pos_h", "rel_pos_w", "pos_embed"):
            r = 0.5 * r
        else:
            r = 0.2 * r
        new.append(jnp.asarray(r))
    return jax.tree_util.tree_unflatten(tree, new)


def _models(seed=0, **overrides):
    """(JAX model with seeded params, port model with the same weights)."""
    cfg_kw = dict(TINY, **overrides)
    cls, cfg = model_entrypoint("sam_vit_b")
    jm = cls(dataclasses.replace(cfg, **cfg_kw))
    jm.init(0)
    jm.params = _seeded(jm.params, seed)
    tm = tfimm_tpu_torch.create_model("sam_vit_b", device="cpu", **cfg_kw)
    tm.load_state_dict(state_dict_from_jax(jm.params))
    return jm, tm


def _images(seed, b, h, w):
    return np.random.default_rng(seed).uniform(-1, 1, (b, h, w, 3)).astype(
        np.float32)


def _prompts(seed, n=1, nb_points=2, nb_boxes=1, nb_masks=1, mask_hw=16):
    rng = np.random.default_rng(seed)
    return {
        "points": rng.uniform(0, 64, (n, nb_points, 2)).astype(np.float32),
        "labels": rng.integers(0, 2, (n, nb_points)).astype(np.int32),
        "boxes": np.sort(rng.uniform(0, 64, (n, nb_boxes, 4)),
                         axis=-1).astype(np.float32),
        "masks": rng.normal(size=(n, nb_masks, mask_hw, mask_hw)).astype(
            np.float32),
    }


def _t(arrays):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in arrays.items()}


def _j(arrays):
    return {k: jnp.asarray(v) for k, v in arrays.items()}


# -- resize ------------------------------------------------------------------

@pytest.mark.parametrize("src,dst", [
    ((2, 37, 53, 3), (2, 20, 31, 3)),      # downscale, antialiased
    ((1, 3, 16, 16), (1, 3, 64, 48)),      # upscale (postprocess_logits)
    ((27, 8), (127, 8)),                   # a rel-pos table
    ((1, 60, 70, 2), (1, 60, 33, 2)),      # one axis only
    ((1, 4, 4, 16), (1, 6, 3, 16)),        # a position embedding
])
def test_resize_linear_matches_jax_image_resize(src, dst):
    x = np.random.default_rng(0).uniform(0, 255, src).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), dst, method="linear",
                            antialias=True)
    got = resize_linear(torch.from_numpy(x), dst)
    assert got.dtype == torch.float32
    assert _rel(got, want) < 1e-5


def test_scale_to_size_matches_jax_on_uint8_and_masks():
    """Images come back in their dtype (uint8 truncates, as numpy's cast
    does): at most one level apart where a value sits on an integer."""
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (37, 53, 3)).astype(np.uint8)
    want = JaxResizer.scale_to_size(img, (20, 29))
    got = ImageResizer.scale_to_size(img, (20, 29), device="cpu")
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert np.mean(got != want) < 0.01
    masks = rng.normal(size=(2, 3, 16, 16)).astype(np.float32)
    want = JaxResizer.scale_to_size(masks, (40, 56), channels_last=False)
    got = ImageResizer.scale_to_size(masks, (40, 56), channels_last=False,
                                     device="cpu")
    assert _rel(got, want) < 1e-5
    got_t = ImageResizer.scale_to_size(torch.from_numpy(masks), (40, 56),
                                       channels_last=False, device="cpu")
    assert isinstance(got_t, torch.Tensor) and _rel(got_t, want) < 1e-5


# -- image encoder -----------------------------------------------------------

@pytest.mark.parametrize("q_size,k_size,table,interpolate", [
    (7, 7, 13, False), (4, 8, 15, False), (8, 4, 15, False),
    (7, 7, 9, True), (6, 6, 21, True)])
def test_get_rel_pos_matches_jax(q_size, k_size, table, interpolate):
    rel_pos = np.random.default_rng(2).normal(size=(table, 8)).astype(
        np.float32)
    want = jie.get_rel_pos(q_size, k_size, jnp.asarray(rel_pos), interpolate)
    got = tie.get_rel_pos(q_size, k_size, torch.from_numpy(rel_pos),
                          interpolate)
    assert _rel(got, want) < 1e-6


def _attention_pair(grid, dim=16, heads=2, fixed=True, seed=3):
    jm = jie.RelPosAttention(fixed, dim, heads, True, True, 0.0, 0.0, grid)
    params = _seeded(jm.init(jax.random.PRNGKey(0)), seed)
    tm = tie.RelPosAttention(fixed, dim, heads, True, True, 0.0, 0.0, grid)
    tm.load_state_dict(state_dict_from_jax(params))
    return jm, params, tm


@pytest.mark.parametrize("grid", [(6, 7), (4, 4), (3, 8)])
def test_rel_pos_attention_matches_jax_f32(grid):
    """Outside autograd the port takes the kernel (its plain version on the
    CPU), the JAX package its XLA path: the same f32 function."""
    jm, params, tm = _attention_pair(grid)
    x = _images(4, 2, *grid)[..., :1].repeat(16, -1) * np.linspace(
        0.5, 1.5, 16, dtype=np.float32)
    x = x + np.random.default_rng(5).normal(size=x.shape).astype(np.float32)
    want = jm(params, jnp.asarray(x))
    with torch.no_grad(), capture_dispatches() as seen:
        got = tm(torch.from_numpy(x))
    assert seen == {"flash_attention_relpos"}
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("grid,heads,dim", [((32, 32), 2, 16),   # global
                                            ((12, 12), 2, 16)])  # a window
def test_rel_pos_attention_bf16_matches_the_pallas_kernel(grid, heads, dim,
                                                          monkeypatch):
    """bf16, against the JAX package's kernel path in interpret mode (its
    gate: N >= 1024 tiling into 512-key blocks, or a window of at least 128
    tokens outside training)."""
    monkeypatch.setenv("TFIMM_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("TFIMM_TPU_RELPOS_PAIRED", "0")
    jm, params, tm = _attention_pair(grid, dim, heads, seed=6)
    x = np.random.default_rng(7).normal(size=(1, *grid, dim)).astype(
        np.float32)
    params16 = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), params)
    from tfimm_tpu.ops.pallas.dispatch import capture_dispatches as jcap

    with jcap() as jseen:
        want = jm(params16, jnp.asarray(x, jnp.bfloat16))
    assert any(name.startswith("flash_attention_relpos") for name in jseen)
    tm = tm.to(torch.bfloat16)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert _rel(got.float(), np.asarray(want.astype(jnp.float32))) < 2e-2


def test_rel_pos_attention_eager_matches_jax_xla_path_bf16():
    """The eager composition (a window in training) against the JAX
    package's XLA path in bf16: the same roundings (scores and bias in
    bf16, softmax in f32)."""
    jm, params, tm = _attention_pair((4, 4), seed=8)
    x = np.random.default_rng(9).normal(size=(3, 4, 4, 16)).astype(np.float32)
    params16 = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), params)
    want = jm(params16, jnp.asarray(x, jnp.bfloat16))
    tm = tm.to(torch.bfloat16)
    with Context(training=True), capture_dispatches() as seen:
        got = tm(torch.from_numpy(x).to(torch.bfloat16))
    assert seen == set() and got.requires_grad
    assert _rel(got.float(), np.asarray(want.astype(jnp.float32))) < 1e-2


def test_gate():
    """Outside training every block with the rel-pos bias takes the kernel,
    with or without autograd (whose backward runs the kernel's plain
    backward on the CPU); in training a window takes the eager path and a
    global block (1024 tokens or more) the kernel; without the rel-pos
    bias, the eager path."""
    _, _, window = _attention_pair((4, 4))
    _, _, glob = _attention_pair((32, 32))
    x_w = torch.randn(1, 4, 4, 16)
    x_g = torch.randn(1, 32, 32, 16)
    for module, x, in_training in ((window, x_w, set()),
                                   (glob, x_g, {"flash_attention_relpos"})):
        with torch.no_grad(), capture_dispatches() as seen:
            module(x)
        assert seen == {"flash_attention_relpos"}
        for training, want in ((False, {"flash_attention_relpos"}),
                               (True, in_training)):
            module.zero_grad()
            with Context(training=training), capture_dispatches() as seen:
                y = module(x)
            assert seen == want
            y.sum().backward()
            assert module.rel_pos_h.grad is not None
            assert float(module.rel_pos_h.grad.abs().sum()) > 0
    plain = tie.RelPosAttention(True, 16, 2, True, False, 0.0, 0.0, (4, 4))
    with torch.no_grad(), capture_dispatches() as seen:
        plain(x_w)
    assert seen == set()


@pytest.mark.parametrize("cfg", ["tiny", "padded"])
def test_image_encoder_matches_jax_f32(cfg):
    overrides = {} if cfg == "tiny" else PADDED
    jm, tm = _models(10, **overrides)
    size = jm.cfg.input_size
    x = _images(11, 2, *size)
    want, jfeats = jm(_j({"images": x, **_prompts(0)}), return_features=True,
                      features_only=True)
    calls = []
    real = tie.flash_attention_relpos

    def counted(*args, **kwargs):
        calls.append(kwargs["grid_size"])
        return real(*args, **kwargs)

    tie.flash_attention_relpos = counted
    try:
        with torch.no_grad():
            got, tfeats = tm(torch.from_numpy(x), return_features=True,
                             features_only=True)
    finally:
        tie.flash_attention_relpos = real
    grid = (size[0] // 16, size[1] // 16)
    ws = jm.cfg.encoder_window_size
    assert len(calls) == jm.cfg.encoder_nb_blocks
    assert calls.count(grid) == len(jm.cfg.encoder_global_attn_indices)
    assert calls.count((ws, ws)) == (jm.cfg.encoder_nb_blocks
                                     - len(jm.cfg.encoder_global_attn_indices))
    assert set(tfeats) == set(tm.feature_names) == set(jfeats)
    for name in tm.feature_names:
        assert _rel(tfeats[name], jfeats[name]) < 1e-4, name
    assert _rel(got, want) < 1e-4


def test_image_encoder_interpolates_at_another_size():
    """A flexible-input model at 96 x 64: the position embedding is resized
    and the global block's rel-pos tables are interpolated."""
    jm, tm = _models(12, fixed_input_size=False)
    x = _images(13, 1, 96, 64)
    want = jm.image_encoder(jm.params["image_encoder"], jnp.asarray(x))
    with torch.no_grad():
        got = tm.image_encoder(torch.from_numpy(x))
    assert tuple(got.shape) == (1, 6, 4, 32)
    assert _rel(got, want) < 1e-4


def test_image_encoder_bf16_close_to_f32():
    jm, tm = _models(14)
    x = _images(15, 2, 64, 64)
    want = jm.image_encoder(jm.params["image_encoder"], jnp.asarray(x))
    tm = tm.to(torch.bfloat16)
    with torch.no_grad():
        got = tm.image_encoder(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert _rel(got.float(), want) < 5e-2


def _same_gradients(module, jax_grads, prefix=""):
    """Every parameter's gradient in ``module`` against the JAX gradient of
    the same name (``state_dict_from_jax`` of the gradient tree), within
    1e-3 of max|JAX|, the reference's bar (tests/test_golden_parity.py);
    where the JAX gradient is zero, a zero gradient or none; a key
    projection's bias, whose true gradient is zero, within 1e-6 of the
    largest gradient of the model. Returns the names compared."""
    want = state_dict_from_jax(jax_grads)
    top = max(float(np.abs(w).max()) for w in want.values())
    names = []
    for name, p in module.named_parameters():
        w = np.asarray(want[prefix + name])
        if np.abs(w).max() == 0:    # a prompt embedding no prompt used
            assert p.grad is None or float(p.grad.abs().max()) == 0, name
            continue
        if name.endswith("k_proj.bias"):
            # The softmax ignores a shift of a query's scores, so the true
            # gradient of a key bias is 0: both packages give noise.
            assert float(p.grad.abs().max()) < 1e-6 * top, name
            continue
        assert _rel(p.grad, w) < 1e-3, name
        names.append(name)
    return names


@pytest.mark.parametrize("training", [True, False])
def test_image_encoder_gradients_match_jax(training, monkeypatch):
    """f32 gradients of the mean embedding with respect to every encoder
    parameter, the rel-pos tables among them, against ``jax.grad`` of the
    JAX encoder with its Pallas kernels in interpret mode (their custom
    VJP). In training the window runs eager in the port and through XLA in
    the JAX package, and the global block takes the kernels in both; in
    eval both blocks take them (the JAX window its single-pass backward)."""
    from tfimm_tpu.ops.pallas.dispatch import capture_dispatches as jcap

    monkeypatch.setenv("TFIMM_TPU_PALLAS_INTERPRET", "1")
    jm, tm = _models(30, **GRAD)
    x = _images(31, 1, 512, 512)

    def loss(p):
        return jm.apply(p, jnp.asarray(x), training=training,
                        features_only=True).astype(jnp.float32).mean()

    with jcap() as jseen:
        want = jax.jit(jax.grad(loss))(jm.params)
    jkernel = {n for n in jseen if n.startswith("flash_attention_relpos")}
    assert jkernel
    tm.train(training)
    with capture_dispatches() as seen:
        tm(torch.from_numpy(x), features_only=True).float().mean().backward()
    assert seen == {"flash_attention_relpos"}
    names = _same_gradients(tm.image_encoder, want,
                            "image_encoder.")
    assert {"blocks.0.attn.rel_pos_h", "blocks.1.attn.rel_pos_w",
            "pos_embed"} <= set(names)


def test_image_encoder_gate_in_training_and_eval():
    """The encoder of the GRAD config routes its blocks as the JAX gate
    does: in training the global block alone takes the kernel, in eval
    both, under autograd in both cases."""
    _, tm = _models(32, **GRAD)
    x = torch.from_numpy(_images(33, 1, 512, 512))
    calls = []
    real = tie.flash_attention_relpos

    def counted(*args, **kwargs):
        calls.append(kwargs["grid_size"])
        return real(*args, **kwargs)

    tie.flash_attention_relpos = counted
    try:
        for training, want in ((True, [(32, 32)]),
                               (False, [(12, 12), (32, 32)])):
            calls.clear()
            tm.train(training)
            tm(x, features_only=True).mean().backward()
            assert calls == want
    finally:
        tie.flash_attention_relpos = real


# -- prompt encoder, transformer, mask decoder -------------------------------

def test_positional_embedding_random_matches_jax():
    jm = JaxPE(16)
    params = jm.init(jax.random.PRNGKey(3))
    tm = PositionalEmbeddingRandom(16)
    tm.load_state_dict(state_dict_from_jax(params))
    pts = np.random.default_rng(2).uniform(0, 64, (3, 4, 2)).astype(np.float32)
    assert _rel(tm.embed_points(torch.from_numpy(pts), (64, 48)),
                jm.embed_points(params, jnp.asarray(pts), (64, 48))) < 1e-5
    assert _rel(tm.embed_grid((5, 7)), jm.embed_grid(params, (5, 7))) < 1e-5


@pytest.mark.parametrize("case", ["empty", "points", "box", "mask",
                                  "points_box_mask"])
def test_prompt_encoder_matches_jax(case):
    jm, tm = _models(16)
    p = _prompts(17, n=2)
    if case == "empty":
        p = _prompts(17, n=2, nb_points=0, nb_boxes=0, nb_masks=0)
    elif case == "points":
        p = _prompts(17, n=2, nb_boxes=0, nb_masks=0)
    elif case == "box":
        p = _prompts(17, n=2, nb_points=0, nb_masks=0)
    elif case == "mask":
        p = _prompts(17, n=2, nb_points=0, nb_boxes=0)
    want_s, want_d = jm.prompt_encoder(jm.params["prompt_encoder"], _j(p))
    with torch.no_grad():
        got_s, got_d = tm.prompt_encoder(_t(p))
    assert tuple(got_s.shape) == tuple(want_s.shape)
    if got_s.numel():
        assert _rel(got_s, want_s) < 1e-5
    assert _rel(got_d, want_d) < 1e-5


def test_two_way_transformer_matches_jax():
    jm = JaxTWT(8, 2, 2, 16, attention_downsample_rate=2, act_layer="relu")
    params = _seeded(jm.init(jax.random.PRNGKey(0)), 18)
    tm = TwoWayTransformer(8, 2, 2, 16, 2, "relu")
    tm.load_state_dict(state_dict_from_jax(params))
    rng = np.random.default_rng(19)
    pe, emb, ipe = (rng.normal(size=s).astype(np.float32)
                    for s in ((2, 5, 8), (2, 4, 4, 8), (2, 4, 4, 8)))
    wq, wk = jm(params, jnp.asarray(pe), jnp.asarray(emb), jnp.asarray(ipe))
    with torch.no_grad():
        tq, tk = tm(*(torch.from_numpy(a) for a in (pe, emb, ipe)))
    assert _rel(tq, wq) < 1e-5
    assert _rel(tk, wk) < 1e-5


def test_conv_transpose_matches_jax_without_a_flip():
    jm = JaxConvTranspose2d(6, 4, 2, 2)
    params = _seeded(jm.init(jax.random.PRNGKey(1)), 20)
    tm = ConvTranspose2d(6, 4, 2, 2)
    sd = state_dict_from_jax({"output_upscaling": {"0": params}})
    tm.load_state_dict({k.split(".", 2)[-1]: v for k, v in sd.items()})
    x = np.random.default_rng(21).normal(size=(2, 3, 5, 6)).astype(np.float32)
    want = jm(params, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert _rel(got, want) < 1e-5
    # A kernel taken flipped, as lax.conv_transpose needs it, would differ.
    with torch.no_grad():
        tm.weight.copy_(tm.weight.flip(2, 3))
        assert _rel(tm(torch.from_numpy(x)), want) > 0.1


@pytest.mark.parametrize("multimask", [False, True])
def test_mask_decoder_matches_jax(multimask):
    jm, tm = _models(22)
    rng = np.random.default_rng(23)
    inputs = {"image_embeddings": rng.normal(size=(2, 4, 4, 32)),
              "image_pe": rng.normal(size=(2, 4, 4, 32)),
              "sparse_embeddings": rng.normal(size=(2, 3, 32)),
              "dense_embeddings": rng.normal(size=(2, 4, 4, 32))}
    inputs = {k: v.astype(np.float32) for k, v in inputs.items()}
    wm, wi = jm.mask_decoder(jm.params["mask_decoder"], _j(inputs),
                             multimask_output=multimask)
    with torch.no_grad():
        tmasks, tiou = tm.mask_decoder(_t(inputs), multimask_output=multimask)
    assert tuple(tmasks.shape) == (2, 3 if multimask else 1, 16, 16)
    assert _rel(tmasks, wm) < 1e-5
    assert _rel(tiou, wi) < 1e-5


# -- the whole model ---------------------------------------------------------

@pytest.mark.parametrize("multimask", [False, True])
def test_sam_forward_matches_jax(multimask):
    jm, tm = _models(24)
    inputs = {"images": _images(25, 2, 64, 64), **_prompts(26, n=2)}
    wmasks, wscores, wlogits = jm(_j(inputs), multimask_output=multimask,
                                  return_logits=True)
    with torch.no_grad():
        tmasks, tscores, tlogits = tm(_t(inputs), multimask_output=multimask,
                                      return_logits=True)
    assert _rel(tlogits, wlogits) < 1e-4
    assert _rel(tscores, wscores) < 1e-4
    assert _rel(tmasks, wmasks) < 1e-4
    with torch.no_grad():
        bools, _, _ = tm(_t(inputs), multimask_output=multimask)
    assert bools.dtype == torch.bool
    assert torch.equal(bools, tmasks > 0.0)


def test_sam_fine_tuning_gradients_match_jax(monkeypatch):
    """Whole-model fine-tuning, f32, in training mode: two images with one
    box prompt each, ``multimask_output=False``, binary cross-entropy of
    the low-resolution logits against a seeded target mask. Every
    parameter's gradient (encoder, prompt encoder, mask decoder) against
    ``jax.grad`` of the JAX model, the global block through the Pallas
    kernels in interpret mode. The Fourier matrix of the prompt encoder is
    a frozen buffer in the port (and in Meta's model) and gets none."""
    monkeypatch.setenv("TFIMM_TPU_PALLAS_INTERPRET", "1")
    jm, tm = _models(34, **GRAD)
    inputs = {"images": _images(35, 2, 512, 512),
              **_prompts(36, n=2, nb_points=0, nb_masks=0, mask_hw=128)}
    inputs["boxes"] *= 8.0          # the prompts are drawn for 64 x 64
    target = (np.random.default_rng(37).uniform(size=(2, 1, 128, 128))
              > 0.5).astype(np.float32)

    def bce(x, t):
        return jnp.mean(jnp.maximum(x, 0) - x * t
                        + jnp.log1p(jnp.exp(-jnp.abs(x))))

    def loss(p):
        _, _, logits = jm.apply(p, _j(inputs), training=True,
                                multimask_output=False, return_logits=True)
        return bce(logits, jnp.asarray(target))

    want = jax.jit(jax.grad(loss))(jm.params)
    tm.train()
    _, _, logits = tm(_t(inputs), multimask_output=False, return_logits=True)
    assert tuple(logits.shape) == (2, 1, 128, 128)
    torch.nn.functional.binary_cross_entropy_with_logits(
        logits, torch.from_numpy(target)).backward()
    names = _same_gradients(tm, want)
    assert any(n.startswith("image_encoder.") for n in names)
    assert any(n.startswith("mask_decoder.") for n in names)
    assert any(n.startswith("prompt_encoder.") for n in names)


def test_sam_features_and_registry():
    jm, tm = _models(27)
    assert tm.feature_names == jm.feature_names
    assert tfimm_tpu_torch.list_models("sam*") == sorted(
        ["sam_vit_b", "sam_vit_l", "sam_vit_h"])
    for name in ("sam_vit_b", "sam_vit_l", "sam_vit_h"):
        _, jcfg = model_entrypoint(name)
        tcfg = tfimm_tpu_torch.model_config(name)
        for field in dataclasses.fields(tcfg):
            assert getattr(tcfg, field.name) == getattr(jcfg, field.name), (
                name, field.name)
    with pytest.raises(NotImplementedError):
        tfimm_tpu_torch.create_model("sam_vit_b", device="cpu",
                                     pretrained=True)
    pp = tfimm_tpu_torch.create_preprocessing("sam_vit_b", device="cpu")
    img = np.full((1, 2, 2, 3), 255, np.uint8)
    want = (1.0 - np.array(jm.cfg.mean)) / np.array(jm.cfg.std)
    assert np.allclose(pp(img)[0, 0, 0].numpy(), want, atol=1e-6)


@pytest.fixture(scope="module")
def golden():
    data = np.load(FIXTURE)
    meta = json.loads(bytes(data["meta"]).decode())
    sd = {k[4:]: data[k] for k in data.files if k.startswith("sd::")}
    cls, cfg = model_entrypoint("sam_vit_b")
    kwargs = {k: tuple(v) if isinstance(v, list) else v
              for k, v in meta["config"].items()}
    jm = cls(dataclasses.replace(cfg, **kwargs))
    jm.init(0)
    params = convert_pt_state_dict(jm, sd)
    tm = tfimm_tpu_torch.create_model("sam_vit_b", device="cpu", **kwargs)
    tm.load_state_dict(state_dict_from_jax(params))
    return data, sd, tm


def test_golden_fixture(golden):
    """Meta's implementation (tests/fixtures/golden/sam.npz), its weights
    through the JAX package's ``convert_pt_state_dict`` and then
    ``state_dict_from_jax``; the port's parameter names are Meta's."""
    data, sd, tm = golden
    assert set(tm.state_dict()) == set(sd)
    with torch.no_grad():
        emb = tm.image_encoder(torch.from_numpy(data["input"]))
        assert _rel(emb.permute(0, 3, 1, 2), data["encoder_output"]) < 1e-4
        pe = tm.prompt_encoder.get_dense_pe((4, 4))
        assert _rel(pe.permute(2, 0, 1), data["dense_pe"][0]) < 1e-5

        def prompt(points=None, labels=None, boxes=None, masks=None):
            return tm.prompt_encoder({
                "points": torch.zeros(1, 0, 2) if points is None
                else torch.from_numpy(points),
                "labels": torch.zeros(1, 0, dtype=torch.int32)
                if labels is None else torch.from_numpy(labels),
                "boxes": torch.zeros(1, 0, 4) if boxes is None
                else torch.from_numpy(boxes),
                "masks": torch.zeros(1, 0, 16, 16) if masks is None
                else torch.from_numpy(masks)})

        sparse, dense = prompt(points=data["points_coords"],
                               labels=data["points_labels"])
        assert _rel(sparse, data["points_sparse"]) < 1e-5
        assert _rel(dense.permute(0, 3, 1, 2), data["points_dense"]) < 1e-5
        sparse, _ = prompt(boxes=data["boxes"].reshape(1, 1, 4))
        assert _rel(sparse, data["boxes_sparse"]) < 1e-5
        _, dense = prompt(masks=data["mask_input"])
        assert _rel(dense.permute(0, 3, 1, 2), data["mask_dense"]) < 1e-5
        sparse, dense = prompt()
        assert tuple(sparse.shape) == tuple(data["empty_sparse_shape"])
        assert _rel(dense.permute(0, 3, 1, 2), data["empty_dense"]) < 1e-5
        masks, iou = tm.mask_decoder({
            "image_embeddings": torch.from_numpy(
                data["encoder_output"].transpose(0, 2, 3, 1)),
            "image_pe": torch.from_numpy(data["dense_pe"].transpose(0, 2, 3, 1)),
            "sparse_embeddings": torch.from_numpy(data["points_sparse"]),
            "dense_embeddings": torch.from_numpy(
                data["points_dense"].transpose(0, 2, 3, 1))},
            multimask_output=True)
    assert _rel(masks, data["decoder_masks"]) < 1e-4
    assert _rel(iou, data["decoder_iou"]) < 1e-4


# -- the predictor -----------------------------------------------------------

def _predictors(fixed, size_bucket=None):
    jm, tm = _models(28, fixed_input_size=fixed)
    return (JaxPredictor(jm, size_bucket=size_bucket),
            SAMPredictor(tm, size_bucket=size_bucket))


def _same_prediction(jp, tp, **prompt):
    wm, ws, wl = jp(return_logits=True, **prompt)
    tmasks, ts, tl = tp(return_logits=True, **prompt)
    assert isinstance(tmasks, np.ndarray) and tmasks.shape == wm.shape
    assert _rel(tl, wl) < 1e-4
    assert _rel(ts, ws) < 1e-4
    assert _rel(tmasks, wm) < 1e-4
    bools, _, _ = tp(**prompt)
    assert bools.dtype == bool and bools.shape == wm.shape
    return tl


@pytest.mark.parametrize("fixed", [True, False])
def test_sam_predictor_matches_jax(fixed):
    """Mirrors tests/models/test_segment_anything.py::test_sam_predictor:
    points, a chained call with the last logits as the mask prompt, and
    batched boxes, each against the JAX predictor on the same image."""
    jp, tp = _predictors(fixed)
    img = np.random.default_rng(3).integers(0, 255, (40, 56, 3)).astype(
        np.uint8)
    jp.set_image(img)
    tp.set_image(img)
    assert tp.resizer.dst_size == jp.resizer.dst_size
    assert tp.mask_size() == jp.mask_size()
    emb = np.asarray(jp.image_embedding)
    assert _rel(tp.image_embedding, emb) < 1e-4
    pts, lab = np.array([[10.0, 20.0]]), np.array([1])
    logits = _same_prediction(jp, tp, points=pts, labels=lab)
    assert logits.shape[0] == 3
    _same_prediction(jp, tp, points=pts, labels=lab, masks=logits,
                     multimask_output=False)
    _same_prediction(jp, tp, boxes=np.array([[[2.0, 2.0, 30.0, 30.0]],
                                             [[5.0, 5.0, 20.0, 35.0]]]))
    mask_in = np.random.default_rng(4).normal(size=(1, 40, 56)).astype(
        np.float32)
    assert _rel(tp.preprocess_masks(mask_in), jp.preprocess_masks(mask_in)) < 1e-5
    tp.clear_image()
    with pytest.raises(ValueError):
        tp(points=pts, labels=lab)


def test_sam_predictor_size_bucketing_matches_jax():
    """Mirrors test_predictor_size_bucketing: nearby sizes share one padded
    input shape and masks come back at each image's size."""
    jp, tp = _predictors(False, size_bucket=32)
    rng = np.random.default_rng(11)
    dsts = []
    for size in [(33, 50), (40, 56), (62, 34)]:
        img = rng.integers(0, 255, (*size, 3)).astype(np.uint8)
        jp.set_image(img)
        tp.set_image(img)
        dsts.append(tp.resizer.dst_size)
        _same_prediction(jp, tp, points=np.array([[10.0, 12.0]]),
                         labels=np.array([1]))
        masks, _, _ = tp(points=np.array([[10.0, 12.0]]), labels=np.array([1]))
        assert masks.shape == (3, *size)
    assert dsts == [(64, 64), (64, 64), (64, 64)]
    with pytest.raises(ValueError):
        SAMPredictor(tp.model, size_bucket=17)


def test_predictor_runs_no_kernel_launch_on_the_cpu():
    _, tp = _predictors(True)
    counts = dict(dispatch.launch_counts)
    tp.set_image(np.zeros((30, 20, 3), np.uint8))
    tp(points=np.array([[3.0, 4.0]]), labels=np.array([0]))
    assert dispatch.launch_counts == counts
