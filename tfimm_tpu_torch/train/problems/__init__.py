from tfimm_tpu_torch.train.problems.classification import (  # noqa: F401
    ClassificationConfig,
    ClassificationProblem,
)
from tfimm_tpu_torch.train.problems.distillation import (  # noqa: F401
    DistillationConfig,
    DistillationProblem,
)
