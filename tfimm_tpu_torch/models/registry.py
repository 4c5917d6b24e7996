"""Model registry (mirror of tfimm_tpu/models/registry.py).

Architectures register named variants as zero-arg functions returning
``(model_class, config)``. The registry powers ``list_models`` (fnmatch
wildcards, module grouping, pretrained filtering) and the factory.
"""

from __future__ import annotations

import fnmatch
import sys
from collections import defaultdict
from copy import deepcopy
from typing import Callable, Dict, List, Set, Tuple, Union

__all__ = ["register_model", "list_models", "is_model", "model_class",
           "model_config"]

_model_class: Dict[str, type] = {}
_model_config: Dict[str, object] = {}
_model_module: Dict[str, str] = {}
_module_to_models: Dict[str, Set[str]] = defaultdict(set)


def register_model(fn: Callable[[], Tuple[type, object]]):
    """Decorator registering a model variant under the function's name."""
    cls, cfg = fn()
    name = fn.__name__
    if cfg.name and cfg.name != name:
        raise ValueError(f"Config name {cfg.name!r} != entrypoint {name!r}")
    cfg.name = name

    module = sys.modules[fn.__module__]
    module_name = fn.__module__.rsplit(".", 1)[-1]
    if hasattr(module, "__all__"):
        if name not in module.__all__:
            module.__all__.append(name)
    else:
        module.__all__ = [name]

    _model_class[name] = cls
    _model_config[name] = deepcopy(cfg)
    _model_module[name] = module_name
    _module_to_models[module_name].add(name)
    return fn


def list_models(
    name_filter: Union[str, List[str]] = "",
    module: str = "",
    pretrained: bool = False,
    exclude_filters: Union[str, List[str]] = "",
) -> List[str]:
    """List registered models, optionally filtered.

    ``name_filter``: fnmatch wildcard(s). ``module``: restrict to one
    architecture module. ``pretrained=True``: only models with weight URLs.
    """
    if module:
        models = sorted(_module_to_models[module])
    else:
        models = sorted(_model_class)

    if name_filter:
        filters = [name_filter] if isinstance(name_filter, str) else name_filter
        included: List[str] = []
        for f in filters:
            matched = fnmatch.filter(models, f)
            included.extend(m for m in matched if m not in included)
        models = included

    if exclude_filters:
        excludes = ([exclude_filters] if isinstance(exclude_filters, str)
                    else exclude_filters)
        for f in excludes:
            drop = set(fnmatch.filter(models, f))
            models = [m for m in models if m not in drop]

    if pretrained:
        models = [m for m in models if getattr(_model_config[m], "url", "")]
    return models


def is_model(name: str) -> bool:
    return name in _model_class


def model_class(name: str) -> type:
    if name not in _model_class:
        raise KeyError(f"Unknown model: {name}")
    return _model_class[name]


def model_config(name: str):
    if name not in _model_config:
        raise KeyError(f"Unknown model: {name}")
    return deepcopy(_model_config[name])
