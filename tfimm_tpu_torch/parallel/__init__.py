"""Training steps; mirror of tfimm_tpu/parallel. Only the single-device step
is ported; meshes, shardings, pipelines and multi-host training wait for
ROADMAP.md, queue A, item 14."""

from tfimm_tpu_torch.parallel.step import (  # noqa: F401
    cross_entropy_loss,
    l2_weights,
    make_train_step,
)
