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

__all__ = ["SOFTMAX_CLAMP", "KERNEL_DTYPES", "softmax_nomax",
           "softmax_clamp_grad_mask", "on_cuda", "log_dispatch",
           "capture_dispatches", "launch_counts", "count_launch",
           "reset_launch_counts", "launch"]

SOFTMAX_CLAMP = 80.0

# The dtypes every hand-written kernel takes. A float16 model fails each
# gate and takes its layer's plain path (the port has no float16 kernel).
KERNEL_DTYPES = (torch.float32, torch.bfloat16)

_dispatch_log: Optional[Set[str]] = None

launch_counts = {"fused_mha": 0, "fused_mha_bwd": 0, "convnext_mlp": 0,
                 "window_mha": 0, "window_mha_bwd": 0, "swin_block": 0,
                 "talking_head_attention": 0, "talking_head_attention_bwd": 0,
                 "flash_attention_relpos": 0, "flash_attention_relpos_bwd": 0,
                 "pvt_sra": 0, "poolformer_block": 0, "convnext_block": 0,
                 "flash_attention": 0, "flash_attention_bwd": 0,
                 "ln_dense": 0, "ln_dense_bwd": 0}


def count_launch(name: str) -> None:
    launch_counts[name] += 1


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def launch(name: str, fn, *args) -> None:
    """Call kernel ``name``'s C entry point ``fn`` on the current stream of
    the first argument's device (tensors are passed as their data pointers),
    raise on a non-zero cudaError, and count the launch."""
    device = args[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                   for a in args), stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, cudaError {err}")
    count_launch(name)


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


def softmax_clamp_grad_mask(s: torch.Tensor, ds: torch.Tensor) -> torch.Tensor:
    """The exact VJP companion of ``softmax_nomax``: where the clamp
    saturated (``s >= 80``) the derivative with respect to ``s`` is zero, so
    the score cotangent ``ds`` is kept only where ``s < 80``."""
    return torch.where(s < SOFTMAX_CLAMP, ds, torch.zeros_like(ds))
