"""Shared dispatch helpers for the hand-written kernels.

Counterpart of ``tfimm_tpu/ops/pallas/dispatch.py``. A kernel wrapper runs
its kernel's plain PyTorch version when the tensor it is given lies on the
CPU, and launches the kernel (or raises) when it lies on a CUDA device.

- ``log_dispatch`` / ``capture_dispatches``: which path a dispatcher chose,
  recorded only inside a ``capture_dispatches`` block.
- ``launch_counts``: one plain integer per kernel, raised by its wrapper at
  each launch and nowhere else, so a run can show that its main path went
  through the kernel.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Set

import torch

__all__ = ["SOFTMAX_CLAMP", "softmax_nomax", "on_cuda", "log_dispatch",
           "capture_dispatches", "launch_counts", "count_launch",
           "reset_launch_counts"]

SOFTMAX_CLAMP = 80.0

_dispatch_log: Optional[Set[str]] = None

launch_counts = {"fused_mha": 0}


def count_launch(name: str) -> None:
    launch_counts[name] += 1


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def log_dispatch(name: str) -> None:
    """Record that a dispatcher committed to a path (no-op unless a
    ``capture_dispatches`` block is active)."""
    if _dispatch_log is not None:
        _dispatch_log.add(name)


@contextlib.contextmanager
def capture_dispatches(out: Optional[Set[str]] = None):
    """Collect ``log_dispatch`` names into ``out`` (a set) for the duration."""
    global _dispatch_log
    out = set() if out is None else out
    prev = _dispatch_log
    _dispatch_log = out
    try:
        yield out
    finally:
        _dispatch_log = prev


def on_cuda(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def softmax_nomax(s: torch.Tensor) -> torch.Tensor:
    """Softmax without the row-max subtraction, guarded by a clamp:
    ``exp(min(s, 80)) / rowsum``. Equals softmax whenever max(s) <= 80 and
    saturates (no NaN/Inf) above it; a row whose every logit is below about
    -87 underflows to 0/0, as in the reference (see the domain note of
    ``tfimm_tpu/ops/pallas/dispatch.py · softmax_nomax``)."""
    e = torch.exp(torch.clamp(s, max=SOFTMAX_CLAMP))
    return e / e.sum(dim=-1, keepdim=True)
