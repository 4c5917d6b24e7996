"""Segment Anything (SAM); mirror of
tfimm_tpu/architectures/segment_anything/__init__.py: the model, the
interactive ``SAMPredictor`` and the automatic mask generator."""

__all__ = ["SegmentAnythingModel", "SegmentAnythingModelConfig",
           "ImageResizer", "SAMPredictor", "SAMAutomaticMaskGenerator"]

from tfimm_tpu_torch.architectures.segment_anything.sam import (  # noqa: F401
    SegmentAnythingModel,
    SegmentAnythingModelConfig,
)
from tfimm_tpu_torch.architectures.segment_anything.predictor import (  # noqa: F401
    ImageResizer,
    SAMPredictor,
)
from tfimm_tpu_torch.architectures.segment_anything.amg import (  # noqa: F401
    SAMAutomaticMaskGenerator,
)
