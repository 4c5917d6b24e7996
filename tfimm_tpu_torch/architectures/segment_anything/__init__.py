"""Segment Anything (SAM); mirror of
tfimm_tpu/architectures/segment_anything/__init__.py. The automatic mask
generator (``amg.py``) is not ported yet (ROADMAP.md, queue A, item 7)."""

__all__ = ["SegmentAnythingModel", "SegmentAnythingModelConfig",
           "ImageResizer", "SAMPredictor"]

from tfimm_tpu_torch.architectures.segment_anything.sam import (  # noqa: F401
    SegmentAnythingModel,
    SegmentAnythingModelConfig,
)
from tfimm_tpu_torch.architectures.segment_anything.predictor import (  # noqa: F401
    ImageResizer,
    SAMPredictor,
)
