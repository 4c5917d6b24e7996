"""Training framework; mirror of tfimm_tpu/train.

Importing this package registers all @cfg_serializable classes, under the
JAX package's class names. Entry point: ``run(ExperimentConfig)`` ->
``Trainer`` (checkpoints, ``save_model`` at the end) -> the problem's
``train_step`` (``ClassificationProblem``, ``DistillationProblem``). The
TFDS/Grain/ImageFolder pipelines are not ported yet (ROADMAP.md, queue A,
item 13).
"""

from tfimm_tpu_torch.train.config import (  # noqa: F401
    deep_to_flat,
    dump_config,
    flat_to_deep,
    parse_args,
    pprint,
    to_dict_format,
)
from tfimm_tpu_torch.train.datasets import (  # noqa: F401
    ArrayDataset,
    ArrayDatasetConfig,
    SyntheticDataset,
    SyntheticDatasetConfig,
)
from tfimm_tpu_torch.train.interface import ProblemBase  # noqa: F401
from tfimm_tpu_torch.train.model import (  # noqa: F401
    EmbeddingModelConfig,
    EmbeddingModelFactory,
    ModelConfig,
    ModelFactory,
    SavedModel,
    SavedModelConfig,
)
from tfimm_tpu_torch.train.optimizers import (  # noqa: F401
    LRConstFactory,
    LRCosineDecayFactory,
    LRExpDecayFactory,
    LRMultiStepsFactory,
    Optimizer,
    OptimizerConfig,
    OptimizerFactory,
)
from tfimm_tpu_torch.train.problems import (  # noqa: F401
    ClassificationConfig,
    ClassificationProblem,
    DistillationConfig,
    DistillationProblem,
)
from tfimm_tpu_torch.train.registry import cfg_serializable, get_class, get_cfg_class  # noqa: F401
from tfimm_tpu_torch.train.timekeeping import Timekeeping  # noqa: F401
from tfimm_tpu_torch.train.train import ExperimentConfig, run  # noqa: F401
from tfimm_tpu_torch.train.trainer import SingleDeviceTrainer, Trainer, TrainerConfig  # noqa: F401
from tfimm_tpu_torch.train.utils import collect_tfrecord_files, setup_logging  # noqa: F401
