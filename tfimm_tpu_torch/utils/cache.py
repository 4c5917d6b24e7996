"""Model cache; counterpart of tfimm_tpu/utils/cache.py.

Resolution order for the cache directory: ``set_dir()`` override →
``TFIMM_TPU_HOME`` env var → ``$XDG_CACHE_HOME/tfimm_tpu`` →
``~/.cache/tfimm_tpu``. Per-model path overrides via ``set_model_cache``.
The variable and the default directory are the JAX package's, because both
packages read and write one on-disk format (``models/serialization.py``).
"""

import os
import shutil
from typing import Dict, List, Optional

__all__ = ["get_dir", "set_dir", "set_model_cache", "clear_model_cache",
           "cached_model_path", "list_cached_models"]

_cache_dir: Optional[str] = None
_model_cache: Dict[str, str] = {}


def get_dir() -> str:
    if _cache_dir is not None:
        return _cache_dir
    home = os.environ.get("TFIMM_TPU_HOME")
    if home:
        return home
    xdg = os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache"))
    return os.path.join(xdg, "tfimm_tpu")


def set_dir(path: str) -> None:
    global _cache_dir
    _cache_dir = path


def set_model_cache(model_name: str, path: str) -> None:
    _model_cache[model_name] = path


def clear_model_cache(model_name: str, delete_files: bool = False) -> None:
    path = _model_cache.pop(model_name, None)
    if delete_files:
        path = path or os.path.join(get_dir(), model_name)
        if os.path.exists(path):
            shutil.rmtree(path)


def cached_model_path(model_name: str) -> Optional[str]:
    """Path to a cached model, or None. Checks overrides first, then cache dir."""
    if model_name in _model_cache:
        return _model_cache[model_name]
    path = os.path.join(get_dir(), model_name)
    return path if os.path.exists(path) else None


def list_cached_models() -> List[str]:
    names = set(_model_cache)
    cache = get_dir()
    if os.path.isdir(cache):
        names.update(d for d in os.listdir(cache)
                     if os.path.isdir(os.path.join(cache, d)))
    return sorted(names)
