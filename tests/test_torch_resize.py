"""Port parity for the bicubic resize and the position-embedding
interpolation: ``ops/resize.py · cubic_weights`` against
``jax._src.image.scale.compute_weight_mat`` with the Keys cubic kernel
(antialiased, as ``jax.image.resize`` builds it) within 1e-6, upscaling and
downscaling; ``resize_cubic`` against ``jax.image.resize(method="bicubic")``
and ``interpolate_pos_embeddings`` against the JAX package's within 1e-5 of
max|JAX| (the same f32 weights, the two axes contracted in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.image import scale as jax_scale

from tfimm_tpu.ops.embed import (
    interpolate_pos_embeddings as jax_interpolate,
    interpolate_pos_embeddings_grid as jax_interpolate_grid,
)
from tfimm_tpu_torch.ops import (
    interpolate_pos_embeddings,
    interpolate_pos_embeddings_grid,
)
from tfimm_tpu_torch.ops.resize import cubic_weights, resize_cubic

torch.set_num_threads(1)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("src,dst", [(14, 32), (24, 32), (7, 14), (3, 11),
                                     (32, 24), (14, 7), (5, 3), (17, 4)])
def test_cubic_weights_match_jax(src, dst):
    scale = jnp.asarray([dst / src], jnp.float32)[0]
    want = jax_scale.compute_weight_mat(
        src, dst, scale, jnp.float32(0.0), jax_scale._fill_keys_cubic_kernel,
        True)
    got = cubic_weights(src, dst)
    assert got.dtype == torch.float32 and got.shape == (src, dst)
    assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-6


def test_cubic_weights_are_not_f_interpolate():
    """``F.interpolate`` bicubic (a = -0.75, no antialias) is another
    function: it misses the same grid by far."""
    x = np.random.default_rng(0).normal(size=(1, 1, 14, 14)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 1, 32, 32),
                                       method="bicubic"))
    theirs = torch.nn.functional.interpolate(
        torch.from_numpy(x), size=(32, 32), mode="bicubic",
        align_corners=False)
    assert _rel(resize_cubic(torch.from_numpy(x), (1, 1, 32, 32)), want) < 1e-5
    assert _rel(theirs, want) > 1e-2


@pytest.mark.parametrize("src,dst", [((14, 14, 8), (32, 32, 8)),
                                     ((24, 24, 8), (32, 20, 8)),
                                     ((14, 14, 8), (7, 7, 8)),
                                     ((6, 9, 8), (6, 5, 8))])
def test_resize_cubic_matches_jax_image_resize(src, dst):
    x = np.random.default_rng(1).normal(size=src).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), dst, method="bicubic")
    got = resize_cubic(torch.from_numpy(x), dst)
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("nb_tokens", [1, 2])
@pytest.mark.parametrize("src,dst", [((14, 14), (32, 32)),
                                     ((24, 24), (32, 32)),
                                     ((14, 14), (7, 7))])
def test_interpolate_pos_embeddings_matches_jax(src, dst, nb_tokens):
    table = np.random.default_rng(2).normal(
        size=(1, nb_tokens + src[0] * src[1], 16)).astype(np.float32)
    want = jax_interpolate(jnp.asarray(table), src, dst, nb_tokens)
    got = interpolate_pos_embeddings(torch.from_numpy(table), src, dst,
                                     nb_tokens)
    assert got.shape == (1, nb_tokens + dst[0] * dst[1], 16)
    assert torch.equal(got[:, :nb_tokens], torch.from_numpy(table[:, :nb_tokens]))
    assert _rel(got, want) < 1e-5


def test_interpolate_grid_keeps_the_dtype_and_takes_a_map():
    """An (H, W, D) bf16 map resizes in f32 and comes back in bf16, within
    a bf16 rounding of the JAX result."""
    grid = np.random.default_rng(3).normal(size=(6, 6, 8)).astype(np.float32)
    want = jax_interpolate_grid(jnp.asarray(grid, jnp.bfloat16), (6, 6),
                                (9, 9))
    got = interpolate_pos_embeddings_grid(
        torch.from_numpy(grid).bfloat16(), (6, 6), (9, 9))
    assert got.dtype == torch.bfloat16 and got.shape == (1, 81, 8)
    assert _rel(got.float(), np.asarray(want.astype(jnp.float32))) < 1e-2
