"""SAMPredictor: numpy in, numpy out, interactive; mirror of
tfimm_tpu/architectures/segment_anything/predictor.py.

``set_image`` computes the image embedding once (the encoder pass, where
the time goes) and keeps it on the model's device; each call then embeds
prompts and decodes masks against it. The JAX package jit-compiles both;
here they are plain calls under ``torch.inference_mode()`` on the model's
device. Images, prompts and results stay numpy arrays at the API; an
image goes to the device once, and the resizes and padding of images and
masks run there. Scores and logits come back as float32 (numpy has no
bfloat16).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tfimm_tpu_torch.ops.resize import resize_linear

__all__ = ["SAMPredictor", "ImageResizer"]


class SAMPredictor:
    def __init__(self, model, preprocessing: Optional[Callable] = None,
                 size_bucket: Optional[int] = None):
        """``preprocessing`` defaults to the model's ImageNet normalisation
        on its device, in its parameters' dtype. ``size_bucket``
        (flexible-input models only): round the padded input size up to a
        multiple of this many pixels, so images of similar sizes share one
        encoder input shape. Must be a multiple of the encoder patch size.
        The padding is zeros in the image (before the normalisation) and is
        cropped from the output masks."""
        from tfimm_tpu_torch.models.factory import create_preprocessing

        param = next(model.parameters())
        self.device, self.dtype = param.device, param.dtype
        if preprocessing is None:
            preprocessing = create_preprocessing(
                model.cfg.name, in_channels=model.cfg.in_channels,
                device=self.device, dtype=self.dtype)
        if size_bucket is not None and (
                size_bucket % model.cfg.encoder_patch_size != 0):
            raise ValueError(
                f"size_bucket must be a multiple of the encoder patch size "
                f"({model.cfg.encoder_patch_size}), got {size_bucket}")
        self.size_bucket = size_bucket
        self.model = model
        self.preprocessing = preprocessing
        self.resizer: Optional[ImageResizer] = None
        self.image_embedding: Optional[torch.Tensor] = None
        self.image_set = False

    # -- image ----------------------------------------------------------------
    def set_image(self, image: np.ndarray) -> None:
        """Compute and keep the embedding of an (H0, W0, C) uint8 or float
        image."""
        if self.model.cfg.fixed_input_size:
            self.resizer = ImageResizer(image.shape[:2],
                                        self.model.cfg.input_size,
                                        device=self.device)
        else:
            patch = self.model.cfg.encoder_patch_size
            dst = (patch * math.ceil(image.shape[0] / patch),
                   patch * math.ceil(image.shape[1] / patch))
            if self.size_bucket is not None:
                b = self.size_bucket
                dst = (b * math.ceil(dst[0] / b), b * math.ceil(dst[1] / b))
            self.resizer = ImageResizer(image.shape[:2], dst, pad_only=True,
                                        device=self.device)
        with torch.inference_mode():
            # One copy to the device; the resize and the padding run there.
            image = torch.as_tensor(image, device=self.device)
            image = self.resizer.pad_image(self.resizer.scale_image(image))
            x = self.preprocessing(image[None])
            self.image_embedding = self.model.image_encoder(x)
        self.image_set = True

    def clear_image(self) -> None:
        self.resizer = None
        self.image_embedding = None
        self.image_set = False

    def input_size(self) -> Tuple[int, int]:
        if self.image_set:
            return self.resizer.dst_size
        if self.model.cfg.fixed_input_size:
            return self.model.cfg.input_size
        raise ValueError("Set an image first (or use a fixed-input-size model).")

    def mask_size(self) -> Tuple[int, int]:
        return self.model.mask_size(self.input_size())

    def preprocess_masks(self, mask: np.ndarray) -> np.ndarray:
        """(N?, M, H0, W0) logit masks -> the model's mask-input size."""
        mask = self.resizer.scale_image(mask, channels_last=False)
        mask = self.resizer.pad_image(mask, channels_last=False)
        return self.resizer.scale_to_size(mask, self.mask_size(),
                                          channels_last=False,
                                          device=self.device)

    # -- prediction -----------------------------------------------------------
    def _decode(self, points: torch.Tensor, labels: torch.Tensor,
                boxes: torch.Tensor, masks: torch.Tensor,
                multimask_output: bool):
        """Prompts on the model's device, in model-input coordinates, with
        a leading batch axis -> (masks upscaled to the input size as f32
        logits, scores, low-resolution logits), tensors on the device."""
        with torch.inference_mode():
            n = points.shape[0]
            emb = self.image_embedding.expand(n, *self.image_embedding.shape[1:])
            logits, scores = self.model.forward_prompts(
                emb, {"points": points, "labels": labels, "boxes": boxes,
                      "masks": masks}, multimask_output)
            upscaled = self.model.postprocess_logits(
                logits, input_size=self.input_size(), return_logits=True)
        return upscaled, scores, logits

    def __call__(self, points=None, labels=None, boxes=None, masks=None,
                 multimask_output: bool = True, return_logits: bool = False):
        """Masks at the original image size (booleans, or logits with
        ``return_logits``), scores and low-resolution logits, for prompts in
        the original image's pixel coordinates. Prompts may carry a batch
        shape; all must carry the same one."""
        if not self.image_set:
            raise ValueError("Need to set image before calling predict().")
        points = np.asarray(points, np.float32) if points is not None else None
        labels = np.asarray(labels, np.int32) if labels is not None else None
        boxes = np.asarray(boxes, np.float32) if boxes is not None else None
        masks = np.asarray(masks, np.float32) if masks is not None else None

        batch_shape = self._batch_shape(points, labels, boxes, masks)
        if points is None:
            points = np.zeros(batch_shape + (0, 2), np.float32)
        if labels is None:
            labels = np.zeros(batch_shape + (0,), np.int32)
        if boxes is None:
            boxes = np.zeros(batch_shape + (0, 4), np.float32)
        if masks is None:
            masks = np.zeros(batch_shape + (0, *self.mask_size()), np.float32)
        if (points.shape[:-2] != batch_shape or labels.shape[:-1] != batch_shape
                or boxes.shape[:-2] != batch_shape
                or masks.shape[:-3] != batch_shape):
            raise ValueError("All prompts must have the same batch shape.")
        batched = batch_shape != ()
        if not batched:
            points, labels = points[None], labels[None]
            boxes, masks = boxes[None], masks[None]

        prompts = {"points": self.resizer.scale_points(points),
                   "labels": labels,
                   "boxes": self.resizer.scale_boxes(boxes),
                   "masks": masks}
        prompts = {k: torch.as_tensor(v, device=self.device)
                   for k, v in prompts.items()}
        upscaled, scores, logits = self._decode(multimask_output=multimask_output,
                                                **prompts)
        with torch.inference_mode():
            out_masks = self.resizer.postprocess_mask(upscaled)
            if not return_logits:
                out_masks = out_masks > self.model.mask_threshold
            out_masks = out_masks.cpu().numpy()
            scores = scores.float().cpu().numpy()
            logits = logits.float().cpu().numpy()
        if not batched:
            out_masks, scores, logits = out_masks[0], scores[0], logits[0]
        return out_masks, scores, logits

    @staticmethod
    def _batch_shape(points, labels, boxes, masks):
        if points is not None:
            return points.shape[:-2]
        if labels is not None:
            return labels.shape[:-1]
        if boxes is not None:
            return boxes.shape[:-2]
        if masks is not None:
            return masks.shape[:-3]
        return ()


class ImageResizer:
    """Longest-side scaling and padding, with the point, box and mask
    transforms. Resizes run on ``device``, the card unless the caller names
    another (numpy arrays go there and come back; tensors stay where they
    are)."""

    def __init__(self, src_size: Tuple[int, int], dst_size: Tuple[int, int],
                 pad_only: bool = False, device="cuda"):
        self.src_size = tuple(src_size)
        self.dst_size = tuple(dst_size)
        self.pad_only = pad_only
        self.device = device
        self.scale, self.rescaled_size = self._get_scale()

    def _get_scale(self):
        if self.pad_only:
            return 1.0, self.src_size
        h_scale = self.dst_size[0] / self.src_size[0]
        w_scale = self.dst_size[1] / self.src_size[1]
        if h_scale >= w_scale:
            scale = w_scale
            rescaled = (int(scale * self.src_size[0]), self.dst_size[1])
        else:
            scale = h_scale
            rescaled = (self.dst_size[0], int(scale * self.src_size[1]))
        rescaled = (min(rescaled[0], self.dst_size[0]),
                    min(rescaled[1], self.dst_size[1]))
        return scale, rescaled

    @staticmethod
    def scale_to_size(image, size: Tuple[int, int], channels_last: bool = True,
                      device="cuda"):
        """Resize the spatial axes of (N?, H, W, C) (or (N?, C, H, W)) to
        ``size`` in f32 with ``resize_linear``, and back to the input's
        dtype: a numpy array on ``device`` and back to numpy, a tensor on
        its own device."""
        is_numpy = isinstance(image, np.ndarray)
        x = torch.as_tensor(image, device=device) if is_numpy else image
        dtype = x.dtype
        h_axis = x.dim() - (3 if channels_last else 2)
        shape = list(x.shape)
        shape[h_axis:h_axis + 2] = size
        out = resize_linear(x.float(), shape)
        if is_numpy:
            return out.cpu().numpy().astype(image.dtype)
        return out.to(dtype)

    def scale_image(self, image, channels_last: bool = True):
        return self.scale_to_size(image, self.rescaled_size, channels_last,
                                  self.device)

    def unscale_image(self, image, channels_last: bool = True):
        return self.scale_to_size(image, self.src_size, channels_last,
                                  self.device)

    def pad_image(self, image, channels_last: bool = True):
        """Zero-pad the bottom and right of an image (numpy or tensor) to
        ``dst_size``."""
        h_axis = image.ndim - (3 if channels_last else 2)
        pad_h = self.dst_size[0] - image.shape[h_axis]
        pad_w = self.dst_size[1] - image.shape[h_axis + 1]
        if pad_h < 0 or pad_w < 0:
            raise ValueError("Cannot pad an image larger than dst_size.")
        if isinstance(image, torch.Tensor):
            pads = [0, 0] * (image.ndim - h_axis - 2) + [0, pad_w, 0, pad_h]
            return F.pad(image, pads)
        pads = [(0, 0)] * image.ndim
        pads[h_axis], pads[h_axis + 1] = (0, pad_h), (0, pad_w)
        return np.pad(image, pads)

    def scale_points(self, points):
        return self.scale * points

    def scale_boxes(self, boxes):
        return self.scale * boxes

    def postprocess_mask(self, mask, threshold: Optional[float] = None):
        """(..., H, W) masks at ``dst_size``: crop the padding, resize to
        ``src_size``, threshold if asked."""
        mask = mask[..., :self.rescaled_size[0], :self.rescaled_size[1]]
        mask = self.unscale_image(mask, channels_last=False)
        if threshold is not None:
            mask = mask > threshold
        return mask
