"""Config base class (mirror of tfimm_tpu/models/config.py).

Every architecture subclasses ``ModelConfig`` with a dataclass carrying all
hyper-parameters; registered model variants are config instances.
"""

from dataclasses import dataclass
from typing import Tuple


@dataclass
class ModelConfig:
    name: str = ""
    url: str = ""

    nb_classes: int = 1000
    in_channels: int = 3
    input_size: Tuple[int, int] = (224, 224)

    @property
    def transform_weights(self):
        """dict: state-dict key -> fn(src_model, weight, dst_cfg), the hooks
        ``transfer_weights`` runs for shape-dependent weights (e.g. a
        position embedding at another input size)."""
        return {}
