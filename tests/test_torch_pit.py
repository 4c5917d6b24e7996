"""Port parity for PiT: tfimm_tpu_torch's PoolingVisionTransformer against
the JAX package and the golden (the reference's TensorFlow
implementation), on the CPU, and its attention's ``fused_mha``.

Parameters and inputs are made from a seed as in ``test_torch_resnet.py``
and carried by ``state_dict_from_jax``. The port's blocks take
``fused_mha`` (its plain version on the CPU). The JAX package's Pallas
``fused_mha`` takes only pairs of heads of d = 64: with
``TFIMM_TPU_PALLAS_INTERPRET=1`` a small PiT of such heads runs it in
interpret mode; at PiT-S's d = 48 the JAX blocks run their XLA attention
(the softmax unclamped, equal below the clamp). Bars, as max|diff| /
max|JAX|: 1e-3 in f32 (logits, every feature, gradients), 5e-2 in bf16,
1e-3 for the golden; the kernel's plain version 1e-5 in f32 and 2e-2 in
bf16, as ``test_torch_fused_mha.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfimm_tpu
import tfimm_tpu_torch
from tests.test_torch_resnet import (
    check_bf16,
    check_golden,
    check_gradients,
    check_model,
    check_registry,
    images,
    jax_pair,
    jitted,
    rel,
)
from tfimm_tpu.ops.pallas.dispatch import capture_dispatches as jax_capture
from tfimm_tpu.ops.pallas.fused_mha import _reference_mha, fused_mha
from tfimm_tpu_torch.ops.kernels import dispatch
from tfimm_tpu_torch.ops.kernels.dispatch import capture_dispatches
from tfimm_tpu_torch.ops.kernels.fused_mha import fused_mha_reference

torch.set_num_threads(2)

_PITS = {
    # Heads of d = 64 in pairs: the JAX package's Pallas fused_mha takes
    # every block (interpret mode).
    "pairs_d64": ("pit_b_224", dict(input_size=(35, 35), embed_dim=(128, 256),
                                    nb_blocks=(1, 1), nb_heads=(2, 4),
                                    mlp_ratio=2.0, nb_classes=7)),
    # PiT-S's head dim 48, distilled: (B, 2, classes).
    "distilled_d48": ("pit_s_distilled_224",
                      dict(input_size=(48, 48), embed_dim=(48, 96, 192),
                           nb_blocks=(1, 2, 1), nb_heads=(1, 2, 4),
                           mlp_ratio=2.0, nb_classes=7)),
}


@pytest.mark.parametrize("variant", sorted(_PITS))
def test_small_pit_matches_jax(monkeypatch, variant):
    monkeypatch.setenv("TFIMM_TPU_PALLAS_INTERPRET", "1")
    name, kw = _PITS[variant]
    jm, params, tm = jax_pair(name, seed=1, **kw)
    x = images((2, *kw["input_size"], 3), 2)
    with jax_capture() as jax_seen:
        jitted(jm, params, jnp.asarray(x))
    assert bool(jax_seen) == (variant == "pairs_d64"), jax_seen
    before = dict(dispatch.launch_counts)
    assert check_model(jm, params, tm, x) == {"fused_mha"}
    assert dispatch.launch_counts == before   # the CPU: the plain version
    out = tm.predict(torch.from_numpy(x))
    assert out.shape == ((2, 2, 7) if "distilled" in variant else (2, 7))


def test_small_pit_bf16_matches_jax():
    name, kw = _PITS["distilled_d48"]
    jm, params, tm = jax_pair(name, seed=3, **kw)
    check_bf16(jm, params, tm, images((2, *kw["input_size"], 3), 4))


def test_gradients_match_jax():
    # Training: the blocks take fused_mha's autograd function, whose
    # backward is fused_mha_bwd's plain version on the CPU.
    name, kw = _PITS["distilled_d48"]
    jm, params, tm = jax_pair(name, seed=5, **kw)
    with capture_dispatches() as seen:
        check_gradients(jm, params, tm, images((2, *kw["input_size"], 3), 6),
                        norm_stats=False)
    assert seen == {"fused_mha"}


def test_interpolate_input_and_transfer_match_jax():
    name, kw = _PITS["distilled_d48"]
    kw = dict(kw, interpolate_input=True)
    jm, params, tm = jax_pair(name, seed=7, **kw)
    x = images((2, 64, 56, 3), 8)     # a 7x6 grid against the table's 5x5
    want = jitted(jm, params, jnp.asarray(x))
    assert rel(tm.predict(torch.from_numpy(x)), want) < 1e-3
    # transfer_weights carries the table to another input size through
    # the model's hook, as the JAX package's does.
    big = dict(kw, input_size=(64, 64))
    jbig = tfimm_tpu.create_model(name, **big)
    tfimm_tpu.transfer_weights(jm, jbig)
    tbig = tfimm_tpu_torch.create_model(name, device="cpu", **big)
    tfimm_tpu_torch.transfer_weights(tm, tbig)
    assert tuple(tbig.pos_embed.shape) == (1, 48, 7, 7)
    assert rel(tbig.pos_embed, jbig.params["pos_embed"]) < 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_mha_plain_version_at_pit_shapes(dtype):
    """The kernel's plain version against the JAX package's kernels: the
    Pallas kernel in interpret mode at d = 64 (PiT-B's heads; N = 257 as
    its stage 2), and its XLA twin ``_reference_mha`` at d = 48 (PiT-S's
    heads, which the Pallas kernel does not take; N = 65 as its stage 3)."""
    tol = {"float32": 1e-5, "bfloat16": 2e-2}[dtype]
    for (b, n, h, d), pallas in (((2, 257, 2, 64), True),
                                 ((2, 65, 3, 48), False)):
        x = images((b, n, 3 * h * d), n)
        got = fused_mha_reference(torch.from_numpy(x).to(getattr(torch, dtype)),
                                  h, d ** -0.5).float().numpy()
        jx = jnp.asarray(x, getattr(jnp, dtype))
        twin = _reference_mha(jx, h, d ** -0.5)
        np.testing.assert_allclose(got, np.asarray(twin, np.float32),
                                   atol=tol, rtol=tol)
        if pallas:
            ref = fused_mha(jx, h, d ** -0.5, interpret=True)
            np.testing.assert_allclose(got, np.asarray(ref, np.float32),
                                       atol=tol, rtol=tol)


def test_golden_pit():
    model, data = check_golden("ref_pit.npz")
    assert rel(model.predict(torch.from_numpy(data["input"])), data["output"]) < 1e-3


def test_registry_matches_jax():
    check_registry("pit", 8)
    # Every variant at its full widths, one block a stage, on a 64x64
    # image: every block takes fused_mha.
    for name in tfimm_tpu_torch.list_models(module="pit"):
        model = tfimm_tpu_torch.create_model(name, device="cpu",
                                             input_size=(64, 64),
                                             nb_blocks=(1, 1, 1))
        with capture_dispatches() as seen:
            out = model.predict(torch.zeros(1, 64, 64, 3))
        assert seen == {"fused_mha"}
        assert out.shape == ((1, 2, 1000) if "distilled" in name else (1, 1000))


def test_state_dict_follows_timm():
    name, kw = _PITS["distilled_d48"]
    sd = tfimm_tpu_torch.create_model(name, device="cpu", **kw).state_dict()
    for key in ("patch_embed.conv.weight", "pos_embed", "cls_token",
                "transformers.0.blocks.0.attn.qkv.weight",
                "transformers.1.pool.conv.weight", "transformers.1.pool.fc.bias",
                "transformers.2.blocks.0.mlp.fc2.weight", "norm.weight",
                "head.weight", "head_dist.bias"):
        assert key in sd, key
    assert "transformers.0.pool.conv.weight" not in sd
    assert tuple(sd["pos_embed"].shape) == (1, 48, 5, 5)
    assert tuple(sd["cls_token"].shape) == (1, 2, 48)
    # The pool's grouped conv: one group an input channel, two outputs each.
    assert tuple(sd["transformers.1.pool.conv.weight"].shape) == (96, 1, 3, 3)


def test_run_trains_pit_step_for_step_with_jax(monkeypatch):
    """PiT-S (not distilled) through ``run()`` in both packages, three SGD
    steps at heads of d = 48: the blocks through fused_mha and its backward
    (their plain versions here), the pooling convs under autograd."""
    from tests.test_torch_vit_hybrid import run_step_for_step

    _, kw = _PITS["distilled_d48"]
    seen = run_step_for_step(monkeypatch, "pit_s_224", kw, seed=9)
    assert seen == {"fused_mha"}
