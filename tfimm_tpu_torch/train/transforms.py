"""Batch augmentation on the device: mixup, cutmix, random flip; mirror of
tfimm_tpu/train/transforms.py.

Semantics follow timm's ``Mixup`` in "batch" mode: one lambda and one box
per batch, each image blended with the batch's mirror image (``x[::-1]``),
the labels turned into soft targets ``lam * y + (1 - lam) * y[::-1]`` with
the label smoothing folded in; for cutmix lambda is the exact share of the
image outside the box, not the Beta draw.

The draws of a batch (whether to mix, mixup or cutmix, lambda, the box
centre) are a handful of scalars. They are made on the host from a
``numpy.random.Generator`` (``torch.distributions.Beta`` takes no
``torch.Generator``), and the blend runs on the images' device, so a step
gains no host-device synchronisation. The JAX package draws the same
quantities with ``jax.random`` inside its jitted step; the two streams
differ, so the tests hand both packages the same draws.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["Mixup", "MixupDraw", "random_flip_horizontal", "smooth_one_hot",
           "box_mask"]


def random_flip_horizontal(images: torch.Tensor,
                           generator: Optional[torch.Generator] = None
                           ) -> torch.Tensor:
    """Per-sample random horizontal flip of an NHWC batch, each image with
    probability 1/2, drawn from ``generator`` on the images' device."""
    flip = torch.rand(images.shape[0], generator=generator,
                      device=images.device) < 0.5
    return torch.where(flip[:, None, None, None], images.flip(2), images)


def smooth_one_hot(labels: torch.Tensor, nb_classes: int,
                   label_smoothing: float = 0.0) -> torch.Tensor:
    """Integer labels -> (B, C) f32 soft targets with label smoothing."""
    off = label_smoothing / nb_classes
    on = 1.0 - label_smoothing + off
    return F.one_hot(labels.long(), nb_classes).float() * (on - off) + off


def box_mask(h: int, w: int, lam: float, cy: float, cx: float,
             device=None) -> Tuple[torch.Tensor, float]:
    """Cutmix box mask (1, H, W, 1) covering about ``1 - lam`` of the image,
    centred at (cy, cx), and the exact covered share. The box arithmetic is
    the JAX package's, in f32 on the host."""
    f32 = np.float32
    ratio = np.sqrt(f32(1.0) - f32(lam))
    cut_h, cut_w = np.round(f32(h) * ratio), np.round(f32(w) * ratio)
    y0, y1 = (np.floor(np.clip(f32(cy) + sign * cut_h / f32(2), 0, h))
              for sign in (-1, 1))
    x0, x1 = (np.floor(np.clip(f32(cx) + sign * cut_w / f32(2), 0, w))
              for sign in (-1, 1))
    rows = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    cols = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    mask = ((rows >= float(y0)) & (rows < float(y1))
            & (cols >= float(x0)) & (cols < float(x1)))
    frac = f32((y1 - y0) * (x1 - x0)) / f32(h * w)
    return mask[None, :, :, None], float(frac)


@dataclass(frozen=True)
class MixupDraw:
    """The random choices of one batch: whether to mix at all, cutmix or
    mixup, the Beta draw lambda of the chosen mode, and the box centre
    (used by cutmix only)."""
    apply: bool
    use_cutmix: bool
    lam: float
    cy: float
    cx: float


class Mixup:
    """Mixup + cutmix with soft-label targets (timm-style, batch mode).

    ``alpha = 0`` disables the corresponding mode. ``mixup(rng, images,
    labels)`` returns ``(images, soft_labels)``; ``cross_entropy_loss``
    takes the soft labels as they are.
    """

    def __init__(self, nb_classes: int, mixup_alpha: float = 0.8,
                 cutmix_alpha: float = 1.0, prob: float = 1.0,
                 switch_prob: float = 0.5, label_smoothing: float = 0.0):
        if mixup_alpha == 0.0 and cutmix_alpha == 0.0:
            raise ValueError("Enable at least one of mixup/cutmix")
        self.nb_classes = nb_classes
        self.mixup_alpha = mixup_alpha
        self.cutmix_alpha = cutmix_alpha
        self.prob = prob
        self.switch_prob = switch_prob
        self.label_smoothing = label_smoothing

    def draw(self, rng: np.random.Generator, h: int, w: int) -> MixupDraw:
        """One batch's draws for (h, w) images, on the host."""
        apply = bool(rng.random() < self.prob)
        if self.cutmix_alpha == 0.0:
            use_cutmix = False
        elif self.mixup_alpha == 0.0:
            use_cutmix = True
        else:
            use_cutmix = bool(rng.random() < self.switch_prob)
        alpha = (self.cutmix_alpha if use_cutmix else self.mixup_alpha) or 1.0
        lam = float(np.float32(rng.beta(alpha, alpha)))
        cy, cx = (float(np.float32(rng.uniform(0.0, size))) for size in (h, w))
        return MixupDraw(apply, use_cutmix, lam, cy, cx)

    def mix(self, images: torch.Tensor, labels: torch.Tensor,
            draw: MixupDraw) -> Tuple[torch.Tensor, torch.Tensor]:
        """The batch blended as ``draw`` says, and its soft labels."""
        y = smooth_one_hot(labels, self.nb_classes, self.label_smoothing)
        if not draw.apply:
            return images, y
        flipped = images.flip(0)
        lam = np.float32(draw.lam)
        if draw.use_cutmix:
            _, h, w, _ = images.shape
            mask, frac = box_mask(h, w, draw.lam, draw.cy, draw.cx,
                                  images.device)
            out = torch.where(mask, flipped, images)
            lam = np.float32(1.0) - np.float32(frac)
        else:
            out = float(lam) * images + float(np.float32(1.0) - lam) * flipped
        soft = float(lam) * y + float(np.float32(1.0) - lam) * y.flip(0)
        return out.to(images.dtype), soft

    def __call__(self, rng: np.random.Generator, images: torch.Tensor,
                 labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        _, h, w, _ = images.shape
        return self.mix(images, labels, self.draw(rng, h, w))
