"""Automatic mask generation: segment everything in an image; mirror of
tfimm_tpu/architectures/segment_anything/amg.py.

Each crop of the image gets one ``SAMPredictor.set_image`` (the encoder,
through ``flash_attention_relpos`` on the card). Its grid points are then
decoded in batches on the model's device: prompt decode, mask upscale,
crop to the crop's size (``resize_linear``, the JAX package's
``jax.image.resize(..., "linear")``), stability score, binarisation and
mask -> box, all as tensors. The host receives the per-mask vectors and
only the masks that pass the filters, and does the dynamic-size work:
boolean filtering, greedy NMS and run-length encoding, in numpy, as the
JAX package does.

Two departures from the JAX package, both TPU layout there: the last short
batch of points is decoded as it is, not padded to ``points_per_batch``
for jit's static shapes; and only the kept masks are copied to the host,
not every mask of the batch.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from tfimm_tpu_torch.ops.resize import resize_linear

__all__ = [
    "SAMAutomaticMaskGenerator",
    "build_point_grid",
    "build_all_layer_point_grids",
    "generate_crop_boxes",
    "mask_to_rle",
    "rle_to_mask",
    "area_from_rle",
    "nms",
]


# ---------------------------------------------------------------------------
# Point grids and crop boxes (host, numpy)
# ---------------------------------------------------------------------------

def build_point_grid(n_per_side: int) -> np.ndarray:
    """(n^2, 2) grid of evenly spaced (x, y) points in [0, 1]^2, placed at
    cell centres."""
    offset = 1 / (2 * n_per_side)
    coords = np.linspace(offset, 1 - offset, n_per_side)
    xs, ys = np.meshgrid(coords, coords)
    return np.stack([xs.reshape(-1), ys.reshape(-1)], axis=-1)


def build_all_layer_point_grids(n_per_side: int, n_layers: int,
                                scale_per_layer: int) -> List[np.ndarray]:
    return [build_point_grid(max(1, n_per_side // (scale_per_layer ** i)))
            for i in range(n_layers + 1)]


def generate_crop_boxes(
    im_size: Tuple[int, int], n_layers: int, overlap_ratio: float
) -> Tuple[List[List[int]], List[int]]:
    """XYXY crop boxes per layer: layer 0 is the full image; layer i tiles
    the image with 2^i overlapping crops a side."""
    h, w = im_size
    boxes: List[List[int]] = [[0, 0, w, h]]
    layer_idxs: List[int] = [0]
    short_side = min(h, w)

    def crop_len(orig_len, n_crops, overlap):
        return int(np.ceil((overlap * (n_crops - 1) + orig_len) / n_crops))

    for layer in range(n_layers):
        n_per_side = 2 ** (layer + 1)
        overlap = int(overlap_ratio * short_side * (2 / n_per_side))
        cw = crop_len(w, n_per_side, overlap)
        ch = crop_len(h, n_per_side, overlap)
        x0s = [int((cw - overlap) * i) for i in range(n_per_side)]
        y0s = [int((ch - overlap) * i) for i in range(n_per_side)]
        for y0 in y0s:
            for x0 in x0s:
                boxes.append([x0, y0, min(x0 + cw, w), min(y0 + ch, h)])
                layer_idxs.append(layer + 1)
    return boxes, layer_idxs


# ---------------------------------------------------------------------------
# Run-length encoding (host, numpy; COCO convention: column-major, counts
# start with the number of leading zeros)
# ---------------------------------------------------------------------------

def mask_to_rle(mask: np.ndarray) -> Dict[str, Any]:
    """Binary (H, W) mask -> uncompressed RLE."""
    h, w = mask.shape
    flat = np.asarray(mask, bool).transpose().reshape(-1)  # column-major
    if flat.size == 0:
        return {"size": [h, w], "counts": []}
    change = np.nonzero(flat[1:] != flat[:-1])[0] + 1
    idx = np.concatenate([[0], change, [flat.size]])
    counts = np.diff(idx).tolist()
    if flat[0]:  # counts must start with a (possibly empty) run of zeros
        counts = [0] + counts
    return {"size": [h, w], "counts": counts}


def rle_to_mask(rle: Dict[str, Any]) -> np.ndarray:
    h, w = rle["size"]
    flat = np.zeros(h * w, dtype=bool)
    pos = 0
    value = False
    for count in rle["counts"]:
        flat[pos:pos + count] = value
        pos += count
        value = not value
    return flat.reshape(w, h).transpose()


def area_from_rle(rle: Dict[str, Any]) -> int:
    return sum(rle["counts"][1::2])


def coco_encode_rle(rle: Dict[str, Any]) -> Dict[str, Any]:
    from pycocotools import mask as mask_utils  # gated optional dependency

    h, w = rle["size"]
    encoded = mask_utils.frPyObjects(rle, h, w)
    encoded["counts"] = encoded["counts"].decode("utf-8")
    return encoded


def remove_small_regions(mask: np.ndarray, area_thresh: float,
                         mode: str) -> Tuple[np.ndarray, bool]:
    """Remove small disconnected regions ("islands") or holes ("holes").
    Requires opencv (gated)."""
    import cv2  # gated optional dependency

    assert mode in ("holes", "islands")
    correct_holes = mode == "holes"
    working = (correct_holes ^ mask).astype(np.uint8)
    n_labels, regions, stats, _ = cv2.connectedComponentsWithStats(working, 8)
    sizes = stats[:, -1][1:]
    small = [i + 1 for i, s in enumerate(sizes) if s < area_thresh]
    if not small:
        return mask, False
    fill = [0] + small
    if not correct_holes:
        fill = [i for i in range(n_labels) if i not in fill] or [
            int(np.argmax(sizes)) + 1
        ]
    mask = np.isin(regions, fill)
    return mask, True


# ---------------------------------------------------------------------------
# Box utilities
# ---------------------------------------------------------------------------

def nms(boxes: np.ndarray, scores: np.ndarray, iou_thresh: float) -> np.ndarray:
    """Greedy NMS over XYXY boxes; returns kept indices sorted by score."""
    if len(boxes) == 0:
        return np.zeros(0, dtype=np.int64)
    boxes = boxes.astype(np.float64)
    areas = np.maximum(boxes[:, 2] - boxes[:, 0], 0) * np.maximum(
        boxes[:, 3] - boxes[:, 1], 0)
    order = np.argsort(scores)[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        rest = order[1:]
        xx0 = np.maximum(boxes[i, 0], boxes[rest, 0])
        yy0 = np.maximum(boxes[i, 1], boxes[rest, 1])
        xx1 = np.minimum(boxes[i, 2], boxes[rest, 2])
        yy1 = np.minimum(boxes[i, 3], boxes[rest, 3])
        inter = np.maximum(xx1 - xx0, 0) * np.maximum(yy1 - yy0, 0)
        union = areas[i] + areas[rest] - inter
        iou = np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)
        order = rest[iou <= iou_thresh]
    return np.asarray(keep, dtype=np.int64)


def _is_box_near_crop_edge(boxes, crop_box, orig_box, atol: float = 20.0):
    """True for boxes touching the crop edge but not the original image
    edge (those are artefacts of cropping, not real object boundaries)."""
    crop = np.asarray(crop_box, np.float32)
    orig = np.asarray(orig_box, np.float32)
    near_crop = np.isclose(boxes, crop[None], atol=atol, rtol=0)
    near_orig = np.isclose(boxes, orig[None], atol=atol, rtol=0)
    return np.any(near_crop & ~near_orig, axis=1)


# ---------------------------------------------------------------------------
# Device-side batch post-processing
# ---------------------------------------------------------------------------

def calculate_stability_score(logits: torch.Tensor, mask_threshold: float,
                              offset: float) -> torch.Tensor:
    """IoU between the masks binarised at threshold +/- offset, in f32.
    High when the mask is insensitive to the exact cutoff."""
    dims = (-2, -1)
    inter = (logits > (mask_threshold + offset)).sum(dim=dims,
                                                      dtype=torch.float32)
    union = (logits > (mask_threshold - offset)).sum(dim=dims,
                                                      dtype=torch.float32)
    return inter / union.clamp(min=1.0)


def batched_mask_to_box(masks: torch.Tensor) -> torch.Tensor:
    """(..., H, W) bool -> (..., 4) float32 XYXY boxes (exclusive right and
    bottom); empty masks give [0, 0, 0, 0]. Plain reductions, no gathers."""
    h, w = masks.shape[-2:]
    rows = masks.any(dim=-1)
    cols = masks.any(dim=-2)
    ridx = torch.arange(h, device=masks.device)
    cidx = torch.arange(w, device=masks.device)
    top = torch.where(rows, ridx, h).amin(dim=-1)
    bottom = torch.where(rows, ridx, -1).amax(dim=-1) + 1
    left = torch.where(cols, cidx, w).amin(dim=-1)
    right = torch.where(cols, cidx, -1).amax(dim=-1) + 1
    box = torch.stack([left, top, right, bottom], dim=-1)
    empty = ~rows.any(dim=-1)
    return torch.where(empty[..., None], 0, box).float()


# ---------------------------------------------------------------------------
# The generator
# ---------------------------------------------------------------------------

class SAMAutomaticMaskGenerator:
    """Segment everything: grid prompts -> masks -> quality filters -> NMS.

    The same knobs and output records as the JAX package's generator.
    ``min_mask_region_area > 0`` requires opencv and
    ``output_mode="coco_rle"`` pycocotools (both gated imports: a missing
    package raises ``ImportError`` when its option is used).
    """

    def __init__(
        self,
        model,
        points_per_side: Optional[int] = 32,
        points_per_batch: int = 64,
        pred_iou_thresh: float = 0.88,
        stability_score_thresh: float = 0.95,
        stability_score_offset: float = 1.0,
        box_nms_thresh: float = 0.7,
        crop_n_layers: int = 0,
        crop_nms_thresh: float = 0.7,
        crop_overlap_ratio: float = 512 / 1500,
        crop_n_points_downscale_factor: int = 1,
        point_grids: Optional[List[np.ndarray]] = None,
        min_mask_region_area: int = 0,
        output_mode: str = "binary_mask",
    ):
        from tfimm_tpu_torch.architectures.segment_anything.predictor import (
            SAMPredictor,
        )

        if (points_per_side is None) == (point_grids is None):
            raise ValueError(
                "Provide exactly one of points_per_side / point_grids.")
        if points_per_side is not None:
            self.point_grids = build_all_layer_point_grids(
                points_per_side, crop_n_layers, crop_n_points_downscale_factor)
        else:
            self.point_grids = point_grids
        if output_mode not in ("binary_mask", "uncompressed_rle", "coco_rle"):
            raise ValueError(f"Unknown output_mode: {output_mode}")

        self.predictor = SAMPredictor(model)
        self.points_per_batch = points_per_batch
        self.pred_iou_thresh = pred_iou_thresh
        self.stability_score_thresh = stability_score_thresh
        self.stability_score_offset = stability_score_offset
        self.box_nms_thresh = box_nms_thresh
        self.crop_n_layers = crop_n_layers
        self.crop_nms_thresh = crop_nms_thresh
        self.crop_overlap_ratio = crop_overlap_ratio
        self.min_mask_region_area = min_mask_region_area
        self.output_mode = output_mode

    # -- device-side batch ---------------------------------------------------
    def _process_points(self, points: torch.Tensor,
                        crop_size: Tuple[int, int]):
        """points (N, 2) on the model's device, in model-input coordinates
        -> per-mask binary masks at the crop's size, IoU predictions,
        stability scores and XYXY boxes, tensors on the device: decode,
        crop the padding, resize, score, binarise, box."""
        pred = self.predictor
        n, device = points.shape[0], points.device
        labels = torch.ones((n, 1), dtype=torch.int32, device=device)
        no_boxes = torch.zeros((n, 0, 4), dtype=torch.float32, device=device)
        no_masks = torch.zeros((n, 0, *pred.mask_size()), dtype=torch.float32,
                               device=device)
        upscaled, scores, _ = pred._decode(points[:, None, :], labels,
                                           no_boxes, no_masks,
                                           multimask_output=True)
        threshold = pred.model.mask_threshold
        with torch.inference_mode():
            m = upscaled.shape[1]
            logits = upscaled.reshape(n * m, *upscaled.shape[2:])
            # Crop away the padding, resize to the crop's own size.
            rh, rw = pred.resizer.rescaled_size
            logits = logits[:, :rh, :rw].float()
            logits = resize_linear(logits, (n * m, *crop_size))
            stability = calculate_stability_score(
                logits, threshold, self.stability_score_offset)
            masks = logits > threshold
            boxes = batched_mask_to_box(masks)
        return masks, scores.reshape(n * m), stability, boxes

    # -- host orchestration ----------------------------------------------------
    def generate(self, image: np.ndarray) -> List[Dict[str, Any]]:
        """HWC uint8/float image -> list of mask records with keys
        segmentation / bbox (XYWH) / area / predicted_iou / point_coords /
        stability_score / crop_box (XYWH)."""
        orig_size = image.shape[:2]
        crop_boxes, layer_idxs = generate_crop_boxes(
            orig_size, self.crop_n_layers, self.crop_overlap_ratio)

        data: Dict[str, list] = {k: [] for k in (
            "rles", "boxes", "iou_preds", "points", "stability_score",
            "crop_boxes")}
        for crop_box, layer_idx in zip(crop_boxes, layer_idxs):
            self._process_crop(image, crop_box, layer_idx, orig_size, data)

        boxes = np.asarray(data["boxes"], np.float32).reshape(-1, 4)
        if len(crop_boxes) > 1 and len(boxes) > 0:
            # Prefer masks from smaller crops when deduplicating across crops.
            cb = np.asarray(data["crop_boxes"], np.float32)
            crop_areas = (cb[:, 2] - cb[:, 0]) * (cb[:, 3] - cb[:, 1])
            keep = nms(boxes, 1.0 / np.maximum(crop_areas, 1.0),
                       self.crop_nms_thresh)
            data = _filter(data, keep)
            boxes = boxes[keep]

        if self.min_mask_region_area > 0:
            data, boxes = self._postprocess_small_regions(
                data, boxes, self.min_mask_region_area,
                max(self.box_nms_thresh, self.crop_nms_thresh))

        records = []
        for i, rle in enumerate(data["rles"]):
            if self.output_mode == "binary_mask":
                segmentation: Any = rle_to_mask(rle)
            elif self.output_mode == "coco_rle":
                segmentation = coco_encode_rle(rle)
            else:
                segmentation = rle
            x0, y0, x1, y1 = data["boxes"][i]
            cx0, cy0, cx1, cy1 = data["crop_boxes"][i]
            records.append({
                "segmentation": segmentation,
                "area": area_from_rle(rle),
                "bbox": [float(x0), float(y0), float(x1 - x0), float(y1 - y0)],
                "predicted_iou": float(data["iou_preds"][i]),
                "point_coords": [list(map(float, data["points"][i]))],
                "stability_score": float(data["stability_score"][i]),
                "crop_box": [float(cx0), float(cy0), float(cx1 - cx0),
                             float(cy1 - cy0)],
            })
        return records

    def _process_crop(self, image, crop_box, layer_idx, orig_size, data):
        x0, y0, x1, y1 = crop_box
        cropped = image[y0:y1, x0:x1, :]
        crop_size = cropped.shape[:2]
        self.predictor.set_image(cropped)

        points_scale = np.array(crop_size, np.float32)[None, ::-1]  # (1, [w,h])
        points = self.point_grids[layer_idx] * points_scale

        crop_data: Dict[str, list] = {k: [] for k in (
            "rles", "boxes", "iou_preds", "points", "stability_score")}
        for start in range(0, len(points), self.points_per_batch):
            batch_points = points[start:start + self.points_per_batch]
            self._process_batch(batch_points, crop_size, crop_box, orig_size,
                                crop_data)
        self.predictor.clear_image()

        boxes = np.asarray(crop_data["boxes"], np.float32).reshape(-1, 4)
        keep = nms(boxes, np.asarray(crop_data["iou_preds"], np.float32),
                   self.box_nms_thresh)
        crop_data = _filter(crop_data, keep)

        offset = np.array([x0, y0, x0, y0], np.float32)
        for i in range(len(crop_data["rles"])):
            data["rles"].append(crop_data["rles"][i])
            data["boxes"].append(crop_data["boxes"][i] + offset)
            data["iou_preds"].append(crop_data["iou_preds"][i])
            data["points"].append(crop_data["points"][i] + offset[:2])
            data["stability_score"].append(crop_data["stability_score"][i])
            data["crop_boxes"].append(list(crop_box))

    def _process_batch(self, points, crop_size, crop_box, orig_size, out):
        # The real points only: no padding to points_per_batch.
        points = np.asarray(points, np.float32)
        n = len(points)
        scaled = self.predictor.resizer.scale_points(points)
        masks, iou_preds, stability, boxes = self._process_points(
            torch.as_tensor(scaled, device=self.predictor.device),
            tuple(crop_size))
        m = len(iou_preds) // n
        iou_preds = iou_preds.float().cpu().numpy()
        stability = stability.cpu().numpy()
        boxes = boxes.cpu().numpy()

        keep = np.ones(n * m, bool)
        if self.pred_iou_thresh > 0.0:
            keep = keep & (iou_preds > self.pred_iou_thresh)
        if self.stability_score_thresh > 0.0:
            keep = keep & (stability >= self.stability_score_thresh)
        # Crop-edge artefacts: drop boxes that touch the crop boundary unless
        # it's also the original image boundary. Boxes are in crop coords.
        ch, cw = crop_size
        near_edge = _is_box_near_crop_edge(
            boxes + np.array([crop_box[0], crop_box[1]] * 2, np.float32),
            crop_box, [0, 0, orig_size[1], orig_size[0]])
        keep = keep & ~near_edge

        idx = np.nonzero(keep)[0]
        if idx.size == 0:
            return
        # Only the kept masks leave the device, in one copy.
        masks = masks[torch.as_tensor(idx, device=masks.device)].cpu().numpy()
        x0, y0 = crop_box[0], crop_box[1]
        for mask, i in zip(masks, idx):
            # Uncrop: place the mask in the original image frame.
            full = np.zeros(orig_size, bool)
            full[y0:y0 + ch, x0:x0 + cw] = mask
            out["rles"].append(mask_to_rle(full))
            out["boxes"].append(boxes[i])
            out["iou_preds"].append(float(iou_preds[i]))
            out["points"].append(points[i // m])
            out["stability_score"].append(float(stability[i]))

    def _postprocess_small_regions(self, data, boxes, min_area, nms_thresh):
        """Fill small holes and drop small islands, then run NMS again."""
        if len(data["rles"]) == 0:
            return data, boxes
        new_masks, scores = [], []
        for rle in data["rles"]:
            mask = rle_to_mask(rle)
            mask, changed_h = remove_small_regions(mask, min_area, "holes")
            mask, changed_i = remove_small_regions(mask, min_area, "islands")
            new_masks.append(mask)
            # Prefer masks that didn't need fixing when deduplicating.
            scores.append(0.0 if (changed_h or changed_i) else 1.0)
        new_boxes = batched_mask_to_box(
            torch.from_numpy(np.stack(new_masks))).numpy()
        keep = nms(new_boxes, np.asarray(scores), nms_thresh)
        for i in keep:
            if scores[i] == 0.0:
                data["rles"][i] = mask_to_rle(new_masks[i])
                data["boxes"][i] = new_boxes[i]
        data = _filter(data, keep)
        return data, np.asarray(data["boxes"], np.float32).reshape(-1, 4)


def _filter(data: Dict[str, list], keep: np.ndarray) -> Dict[str, list]:
    return {k: [v[i] for i in keep] for k, v in data.items()}
