"""Port parity for SAM's automatic mask generator: tfimm_tpu_torch's
``amg.py`` against the JAX package's, on the tiny SAM of
tests/models/test_amg.py with every parameter drawn anew
(``test_torch_sam._seeded``) and carried across by ``state_dict_from_jax``.

The host helpers are copies and must give equal results. The device
post-process must agree to f32 rounding: a mask pixel may flip only where
the JAX logit lies within 1e-4 of the mask threshold, scores and boxes
within 1e-4. ``generate`` must give the same records in the same order:
equal boxes, areas, points and crop boxes, scores within 1e-4, and the
segmentations' differing pixels are counted and held to a small budget
(none differ at these seeds). The JAX runs are shared in module-scoped
fixtures.
"""

import importlib.util

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfimm_tpu_torch
from tests.models.test_amg import _tiny_sam
from tests.test_torch_sam import _seeded
from tfimm_tpu.architectures.segment_anything import amg as jamg
from tfimm_tpu_torch.architectures.segment_anything import amg as tamg
from tfimm_tpu_torch.architectures.segment_anything import (
    SAMAutomaticMaskGenerator,
)
from tfimm_tpu_torch.ops.kernels import dispatch
from tfimm_tpu_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(1)

# The tiny config's fields that differ from sam_vit_b's.
_TINY_FIELDS = ("input_size", "encoder_embed_dim", "encoder_nb_blocks",
                "encoder_nb_heads", "embed_dim", "encoder_global_attn_indices",
                "encoder_window_size", "prompt_mask_hidden_dim",
                "decoder_nb_blocks", "decoder_nb_heads", "decoder_mlp_channels",
                "decoder_iou_hidden_dim")
# Weights from seed 4 give two records in the permissive setup, both of
# which the small-region pass changes at an area of 30.
WEIGHT_SEED = 4
PERMISSIVE = dict(points_per_side=4, points_per_batch=8, pred_iou_thresh=0.0,
                  stability_score_thresh=0.0, box_nms_thresh=0.9)
CROPS = dict(points_per_side=2, points_per_batch=4, pred_iou_thresh=0.0,
             stability_score_thresh=0.0, crop_n_layers=1,
             output_mode="uncompressed_rle")
SMALL_REGIONS = dict(PERMISSIVE, min_mask_region_area=30)
# Mask pixels that may differ between the packages, a record.
PIXEL_BUDGET = 2


def _image(seed, shape):
    return np.random.default_rng(seed).integers(0, 255, shape).astype(np.uint8)


@pytest.fixture(scope="module")
def models():
    """(JAX model, port model) with the same seeded weights, in f32."""
    jm = _tiny_sam()
    jm.params = _seeded(jm.params, WEIGHT_SEED)
    tm = tfimm_tpu_torch.create_model(
        "sam_vit_b", device="cpu",
        **{f: getattr(jm.cfg, f) for f in _TINY_FIELDS})
    tm.load_state_dict(state_dict_from_jax(jm.params))
    return jm, tm


def _segmentation(rec):
    seg = rec["segmentation"]
    return tamg.rle_to_mask(seg) if isinstance(seg, dict) else seg


def _same_records(want, got):
    assert len(got) == len(want) > 0
    for w, g in zip(want, got):
        assert g["bbox"] == w["bbox"]
        assert g["area"] == w["area"]
        assert g["point_coords"] == w["point_coords"]
        assert g["crop_box"] == w["crop_box"]
        assert abs(g["predicted_iou"] - w["predicted_iou"]) < 1e-4
        assert abs(g["stability_score"] - w["stability_score"]) < 1e-4
        seg_w, seg_g = _segmentation(w), _segmentation(g)
        assert seg_g.shape == seg_w.shape and seg_g.dtype == bool
        assert int((seg_g != seg_w).sum()) <= PIXEL_BUDGET
        if isinstance(g["segmentation"], dict):
            assert g["segmentation"]["size"] == w["segmentation"]["size"]
            assert g["area"] == tamg.area_from_rle(g["segmentation"])


# -- the host helpers ----------------------------------------------------------

@pytest.mark.parametrize("n", [1, 4, 7, 32])
def test_point_grids_equal_jax(n):
    np.testing.assert_array_equal(tamg.build_point_grid(n),
                                  jamg.build_point_grid(n))
    for layers, scale in [(0, 1), (2, 2), (3, 3)]:
        want = jamg.build_all_layer_point_grids(n, layers, scale)
        got = tamg.build_all_layer_point_grids(n, layers, scale)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("size,layers,overlap", [
    ((100, 150), 1, 0.2), ((768, 1024), 2, 512 / 1500), ((37, 23), 3, 0.5)])
def test_crop_boxes_equal_jax(size, layers, overlap):
    assert (tamg.generate_crop_boxes(size, layers, overlap)
            == jamg.generate_crop_boxes(size, layers, overlap))


@pytest.mark.parametrize("seed", range(3))
def test_rle_helpers_equal_jax(seed):
    rng = np.random.default_rng(seed)
    for mask in (rng.uniform(size=(17, 23)) > 0.6, np.ones((5, 3), bool),
                 np.zeros((4, 6), bool), np.zeros((0, 3), bool)):
        rle = tamg.mask_to_rle(mask)
        assert rle == jamg.mask_to_rle(mask)
        np.testing.assert_array_equal(tamg.rle_to_mask(rle),
                                      jamg.rle_to_mask(rle))
        assert tamg.area_from_rle(rle) == jamg.area_from_rle(rle)


@pytest.mark.parametrize("seed", range(3))
def test_nms_and_crop_edge_filter_equal_jax(seed):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 80, (40, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(1, 40, (40, 2))], 1)
    boxes = boxes.astype(np.float32)
    scores = rng.uniform(size=40).astype(np.float32)
    for thresh in (0.3, 0.7, 0.95):
        np.testing.assert_array_equal(tamg.nms(boxes, scores, thresh),
                                      jamg.nms(boxes, scores, thresh))
    assert tamg.nms(np.zeros((0, 4)), np.zeros(0), 0.5).size == 0
    crop, orig = [20, 10, 100, 90], [0, 0, 120, 90]
    np.testing.assert_array_equal(
        tamg._is_box_near_crop_edge(boxes, crop, orig),
        jamg._is_box_near_crop_edge(boxes, crop, orig))


@pytest.mark.parametrize("mode", ["holes", "islands"])
def test_remove_small_regions_equals_jax(mode):
    pytest.importorskip("cv2")
    mask = np.random.default_rng(3).uniform(size=(40, 48)) > 0.45
    for area in (3, 30, 3000):
        got, changed = tamg.remove_small_regions(mask, area, mode)
        want, want_changed = jamg.remove_small_regions(mask, area, mode)
        assert changed == want_changed
        np.testing.assert_array_equal(got, want)


# -- the device post-process -----------------------------------------------------

def test_stability_score_matches_jax():
    rng = np.random.default_rng(5)
    logits = rng.normal(scale=2.0, size=(6, 12, 10)).astype(np.float32)
    logits[4] = 10.0    # full at both cutoffs
    logits[5] = -10.0   # empty: the union is clamped to 1
    for threshold, offset in [(0.0, 1.0), (0.5, 0.25)]:
        got = tamg.calculate_stability_score(torch.from_numpy(logits),
                                             threshold, offset)
        want = jamg.calculate_stability_score(jnp.asarray(logits), threshold,
                                              offset)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert got[4] == 1.0 and got[5] == 0.0


def test_batched_mask_to_box_equals_jax():
    rng = np.random.default_rng(6)
    masks = rng.uniform(size=(2, 5, 9, 11)) > 0.93
    masks[0, 0] = False            # empty
    masks[0, 1] = True             # full
    masks[1, 0] = False
    masks[1, 0, 8, 10] = True      # the last pixel alone
    got = tamg.batched_mask_to_box(torch.from_numpy(masks))
    want = np.asarray(jamg.batched_mask_to_box(jnp.asarray(masks)))
    assert got.dtype == torch.float32 and got.shape == (2, 5, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[0, 0].numpy(), [0, 0, 0, 0])
    np.testing.assert_array_equal(got[0, 1].numpy(), [0, 0, 11, 9])
    np.testing.assert_array_equal(got[1, 0].numpy(), [10, 8, 11, 9])


def test_process_points_matches_jax_batch(models):
    """One batch of grid points decoded against one embedding: the port's
    ``_process_points`` against the JAX ``_process_points_device``, with
    the crop smaller than the model input (padding cropped, a resize)."""
    jm, tm = models
    img = _image(7, (44, 36, 3))
    jgen = jamg.SAMAutomaticMaskGenerator(jm, **PERMISSIVE)
    tgen = SAMAutomaticMaskGenerator(tm, **PERMISSIVE)
    jgen.predictor.set_image(img)
    tgen.predictor.set_image(img)
    points = (jamg.build_point_grid(3) * np.array([36, 44], np.float32))
    scaled = tgen.predictor.resizer.scale_points(points.astype(np.float32))
    crop = (44, 36)
    jm_masks, j_iou, j_stab, j_boxes = (
        np.asarray(a) for a in jgen._process_points_device(
            jm.params, jgen.predictor.image_embedding, jnp.asarray(scaled),
            crop))
    t_masks, t_iou, t_stab, t_boxes = tgen._process_points(
        torch.from_numpy(scaled), crop)
    assert t_masks.shape == jm_masks.shape == (27, *crop)
    assert t_masks.dtype == torch.bool

    # The JAX logits behind its masks, to find pixels near the threshold.
    jp = jgen.predictor
    n = len(scaled)
    up, _, _ = jp._decode(
        jm.params, jp.image_embedding, jnp.asarray(scaled)[:, None],
        jnp.ones((n, 1), jnp.int32), jnp.zeros((n, 0, 4)),
        jnp.zeros((n, 0, *jp.mask_size())), multimask_output=True)
    rh, rw = jp.resizer.rescaled_size
    logits = jax.image.resize(up.reshape(-1, *up.shape[2:])[:, :rh, :rw],
                              (3 * n, *crop), method="linear")
    near = np.abs(np.asarray(logits) - jm.mask_threshold) < 1e-4
    differ = t_masks.numpy() != jm_masks
    assert not (differ & ~near).any()
    same = ~differ.any(axis=(1, 2))
    np.testing.assert_allclose(t_iou.numpy(), j_iou, atol=1e-4)
    np.testing.assert_allclose(t_stab.numpy(), j_stab, atol=1e-4)
    np.testing.assert_array_equal(t_boxes.numpy()[same], j_boxes[same])


# -- generate ------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_records(models):
    """The JAX generator's records in the three setups."""
    jm, _ = models
    return {
        "permissive": jamg.SAMAutomaticMaskGenerator(jm, **PERMISSIVE).generate(
            _image(0, (48, 40, 3))),
        "crops": jamg.SAMAutomaticMaskGenerator(jm, **CROPS).generate(
            _image(1, (40, 40, 3))),
    }


def test_generate_matches_jax_permissive(models, jax_records):
    _, tm = models
    counts = dict(dispatch.launch_counts)
    got = SAMAutomaticMaskGenerator(tm, **PERMISSIVE).generate(
        _image(0, (48, 40, 3)))
    assert dispatch.launch_counts == counts   # the CPU: no kernel launch
    _same_records(jax_records["permissive"], got)
    for rec in got:   # test_generate_end_to_end's invariants
        seg = rec["segmentation"]
        assert rec["area"] == int(seg.sum())
        ys, xs = np.nonzero(seg)
        x, y, w, h = rec["bbox"]
        assert (x, y) == (xs.min(), ys.min())
        assert (w, h) == (xs.max() + 1 - xs.min(), ys.max() + 1 - ys.min())
        assert rec["crop_box"] == [0.0, 0.0, 40.0, 48.0]


def test_generate_matches_jax_with_crops(models, jax_records):
    _, tm = models
    got = SAMAutomaticMaskGenerator(tm, **CROPS).generate(_image(1, (40, 40, 3)))
    _same_records(jax_records["crops"], got)
    assert (0.0, 0.0, 40.0, 40.0) in {tuple(r["crop_box"]) for r in got}
    assert len({tuple(r["crop_box"]) for r in got}) > 1


def test_generate_matches_jax_removing_small_regions(models):
    pytest.importorskip("cv2")
    jm, tm = models
    img = _image(0, (48, 40, 3))
    want = jamg.SAMAutomaticMaskGenerator(jm, **SMALL_REGIONS).generate(img)
    got = SAMAutomaticMaskGenerator(tm, **SMALL_REGIONS).generate(img)
    _same_records(want, got)
    plain = SAMAutomaticMaskGenerator(tm, **PERMISSIVE).generate(img)
    assert any(not np.array_equal(a["segmentation"], b["segmentation"])
               for a, b in zip(got, plain))   # the pass changed a mask


def test_coco_rle_needs_pycocotools_in_both_packages(models):
    jm, tm = models
    img = _image(2, (32, 32, 3))
    kw = dict(points_per_side=2, points_per_batch=4, pred_iou_thresh=0.0,
              stability_score_thresh=0.0, output_mode="coco_rle")
    if importlib.util.find_spec("pycocotools") is None:
        with pytest.raises(ImportError):
            jamg.SAMAutomaticMaskGenerator(jm, **kw).generate(img)
        with pytest.raises(ImportError):
            SAMAutomaticMaskGenerator(tm, **kw).generate(img)
    else:
        want = jamg.SAMAutomaticMaskGenerator(jm, **kw).generate(img)
        got = SAMAutomaticMaskGenerator(tm, **kw).generate(img)
        assert [r["segmentation"] for r in got] == [
            r["segmentation"] for r in want]


def test_generator_knobs_and_errors(models):
    _, tm = models
    gen = SAMAutomaticMaskGenerator(tm)
    assert (gen.points_per_batch, gen.pred_iou_thresh,
            gen.stability_score_thresh, len(gen.point_grids[0])) == (
                64, 0.88, 0.95, 1024)
    with pytest.raises(ValueError):
        SAMAutomaticMaskGenerator(tm, points_per_side=None)
    with pytest.raises(ValueError):
        SAMAutomaticMaskGenerator(tm, output_mode="png")
    assert tamg.__all__ == jamg.__all__
