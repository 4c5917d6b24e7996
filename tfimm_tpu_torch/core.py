"""Forward-pass context: training flag, generator and feature capture.

Counterpart of ``tfimm_tpu/core.py``. ``Model.forward`` enters a
``Context`` for the duration of one forward pass. Layers ask it whether the
pass trains (dropout, drop-path and the attention dispatch read
``training``), which ``torch.Generator`` drives their noise, and whether
intermediate features are being captured (the ``return_features=True``
dictionary, keyed by ``Model.feature_names``).

Outside any ``Model.forward`` the default context is inference: not
training, no generator, no capture.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

import torch

__all__ = ["Context", "current_context", "capture_feature"]

_LOCAL = threading.local()


class Context:
    def __init__(self, *, training: bool = False,
                 generator: Optional[torch.Generator] = None,
                 capture_features: bool = False):
        self.training = training
        self.generator = generator
        self.capture_features = capture_features
        self.features: Dict[str, Any] = {}

    def capture(self, name: str, value: Any) -> None:
        if self.capture_features:
            self.features[name] = value

    def __enter__(self) -> "Context":
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _LOCAL.stack.pop()


_DEFAULT = Context(training=False)


def current_context() -> Context:
    stack = getattr(_LOCAL, "stack", None)
    return stack[-1] if stack else _DEFAULT


def capture_feature(name: str, value: Any) -> None:
    current_context().capture(name, value)
