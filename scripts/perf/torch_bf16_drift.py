"""How far bf16 lies from f32 in deep BatchNorm nets with seeded weights,
in the port and in the JAX package, on the CPU: a ResNet's gradients and a
ConvMixer's logits.

    JAX_PLATFORMS=cpu python scripts/perf/torch_bf16_drift.py

Gradients. ResNet-50's depth at narrow widths (16, 32, 64, 128),
112x112, 100 classes, batch 32 in training mode (batch statistics),
seeded weights as ``tests/test_torch_resnet.py`` draws them, with the
last norm of every branch scaled by 1, 0.2 and 0
(``zero_init_last_bn``'s start). For each scale and a few parameters,
one JSON line: max|bf16 - f32| / max|f32| of the cross-entropy gradient
in each package (bf16 inputs, f32 parameters, as mixed precision runs),
and the port's f32 gradient against the JAX package's. It shows which
gradients a bf16-against-f32 check can hold: a conv's output feeds a
training BatchNorm, which makes the conv's cotangent orthogonal to that
output, so its weight gradient is a small difference of large sums that
bf16 moves by tens of percent in both packages.

Logits. ConvMixer-768/32's depth at width 64, with ``chip_smoke.py``'s
seeded weights and calibrated BatchNorm statistics (``calibrated_model``
on 16 seeded images): max|bf16 - f32| / max|f32| of the logits of 8 other
images in each package, and the port's f32 against the JAX package's.
One JSON line. Then the EfficientNets of ``chip_smoke.py``'s phase 39 at
their full widths and depths on smaller images (B0 and MobileNetV2 at
96x96, B4 and V2-S at 128x128), calibrated on 32 images, 16 others held:
the same three numbers, one JSON line each. About six minutes in all.

    JAX_PLATFORMS=cpu python scripts/perf/torch_bf16_drift.py efficientnet

runs the EfficientNets alone, and

    JAX_PLATFORMS=cpu python scripts/perf/torch_bf16_drift.py resnetv2 vit_hybrid

the logits of BiT-M R50x1 (``resnetv2_50x1_bitm``, 128x128), R101x3
(``resnetv2_101x3_bitm``, 96x96) and ViT-B/16-R50
(``vit_base_r50_s16_384``, 128x128), ``chip_smoke.py``'s phases 41 and 42,
at their full widths and depths on small images, with ``he_state_dict``'s
seeded weights (GroupNorm needs no calibration), 8 images held: the same
three numbers, one JSON line each (one to three minutes each).
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
import tfimm_tpu_torch  # noqa: E402
from tests.test_torch_resnet import jax_pair  # noqa: E402
from tfimm_tpu.models import registry as jax_registry  # noqa: E402
from tfimm_tpu.utils.tree import unflatten_params  # noqa: E402
from tfimm_tpu_torch.parallel.step import cross_entropy_loss  # noqa: E402
from tfimm_tpu_torch.utils.convert import (  # noqa: E402
    jax_from_state_dict,
    state_dict_from_jax,
)

NAMES = ("conv1.weight", "layer4.2.conv3.weight", "layer4.2.bn3.weight",
         "layer4.2.bn3.bias", "fc.weight", "fc.bias")


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def calibrated_logits(name, overrides, seed, calibrate, hold):
    """One JSON line: the logits' bf16 drift in the port and in the JAX
    package for ``name`` with config ``overrides``, its BatchNorm
    statistics set from ``calibrate`` seeded images and ``hold`` others
    held, and the port's f32 against the JAX package's."""
    size = overrides.get("input_size", (224, 224))
    create = tfimm_tpu_torch.create_model
    tfimm_tpu_torch.create_model = lambda n, **kw: create(n, **overrides, **kw)
    try:
        g = torch.Generator().manual_seed(1)
        images = torch.randint(0, 256, (calibrate + hold, *size, 3),
                               generator=g, dtype=torch.uint8)
        model32, sd = chip_smoke.calibrated_model(name, seed,
                                                  images[:calibrate],
                                                  device="cpu")
    finally:
        tfimm_tpu_torch.create_model = create
    model16 = create(name, device="cpu", dtype=torch.bfloat16, **overrides)
    model16.load_state_dict(sd)
    x = tfimm_tpu_torch.create_preprocessing(name, device="cpu")(
        images[calibrate:])
    with torch.inference_mode():
        port32 = model32(x).numpy()
        port16 = model16(x.bfloat16()).float().numpy()
    cfg = dataclasses.replace(jax_registry.model_config(name), **overrides)
    jm = jax_registry.model_class(name)(cfg)
    params = jax.tree_util.tree_map(
        jnp.asarray, unflatten_params(jax_from_state_dict(model32)))
    apply = jax.jit(jm.apply)
    jax32 = np.asarray(apply(params, jnp.asarray(x.numpy())))
    jax16 = np.asarray(apply(
        jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), params),
        jnp.asarray(x.numpy(), jnp.bfloat16)), np.float32)
    print(json.dumps({"model": name, "overrides": overrides,
                      "what": "logits",
                      "port_bf16_vs_f32": rel(port16, port32),
                      "jax_bf16_vs_f32": rel(jax16, jax32),
                      "port_f32_vs_jax_f32": rel(port32, jax32)}),
          flush=True)


def convmixer_logits():
    calibrated_logits("convmixer_768_32", dict(embed_dim=64), 37, 16, 8)


def efficientnet_logits():
    for name, side in (("efficientnet_b0", 96), ("efficientnet_b4", 128),
                       ("efficientnet_v2_s", 128), ("mobilenet_v2_100", 96)):
        calibrated_logits(name, dict(input_size=(side, side)), 39, 32, 16)


def resnet_gradients():
    kw = dict(input_size=(112, 112), nb_channels=(16, 32, 64, 128),
              nb_classes=100)
    jm, base, tm = jax_pair("resnet50", seed=3, **kw)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, 112, 112, 3)).astype(np.float32)
    labels = rng.integers(0, 100, size=(32,))

    for gamma in (1.0, 0.2, 0.0):
        def scaled(path, leaf):
            keys = [getattr(k, "key", None) for k in path]
            return leaf * gamma if keys[-2:] == ["bn3", "scale"] else leaf

        params = jax.tree_util.tree_map_with_path(scaled, base)

        def jax_grads(dtype):
            def loss(p):
                out, updates = jm.apply(p, jnp.asarray(x, dtype),
                                        training=True, mutable=True)
                return optax.softmax_cross_entropy_with_integer_labels(
                    out.astype(jnp.float32), labels).mean(), updates

            grads = jax.jit(jax.grad(loss, has_aux=True))(params)[0]
            return state_dict_from_jax(grads)

        def port_grads(dtype):
            tm.load_state_dict(state_dict_from_jax(params))
            tm.train()
            tm.zero_grad(set_to_none=True)
            out = tm(torch.from_numpy(x).to(dtype))
            cross_entropy_loss(out.float(), torch.from_numpy(labels)).backward()
            return {n: p.grad.clone() for n, p in tm.named_parameters()}

        j32, j16 = jax_grads(jnp.float32), jax_grads(jnp.bfloat16)
        t32, t16 = port_grads(torch.float32), port_grads(torch.bfloat16)

        for name in NAMES:
            print(json.dumps({
                "last_norm_scale": gamma, "param": name,
                "port_bf16_vs_f32": rel(t16[name], t32[name]),
                "jax_bf16_vs_f32": rel(j16[name], j32[name]),
                "port_f32_vs_jax_f32": rel(t32[name], j32[name])}))


def resnetv2_logits():
    calibrated_logits("resnetv2_50x1_bitm", dict(input_size=(128, 128)), 41,
                      1, 8)
    calibrated_logits("resnetv2_101x3_bitm", dict(input_size=(96, 96)), 41,
                      1, 8)


def vit_hybrid_logits():
    calibrated_logits("vit_base_r50_s16_384", dict(input_size=(128, 128)), 42,
                      1, 8)


if __name__ == "__main__":
    torch.set_num_threads(8)
    parts = {"efficientnet": efficientnet_logits, "resnetv2": resnetv2_logits,
             "vit_hybrid": vit_hybrid_logits}
    if sys.argv[1:]:
        for part in sys.argv[1:]:
            parts[part]()
    else:
        resnet_gradients()
        convmixer_logits()
        efficientnet_logits()
