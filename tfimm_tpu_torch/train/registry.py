"""Class registry for the training framework; mirror of
tfimm_tpu/train/registry.py.

``@cfg_serializable`` associates a class with its config dataclass so that
``<field>_class`` strings in experiment configs can be resolved to classes.
The class names are the JAX package's, so its configs and YAML files name
the same classes here.
"""

from __future__ import annotations

__all__ = ["cfg_serializable", "get_class", "get_cfg_class"]

_classes = {}
_cfg_classes = {}


def cfg_serializable(cls):
    """Register ``cls`` (with a ``cfg_class`` attribute) or a bare config
    dataclass so it can be referenced by name from configs."""
    name = cls.__name__
    if hasattr(cls, "cfg_class"):
        _classes[name] = cls
        _cfg_classes[name] = cls.cfg_class
        _cfg_classes[cls.cfg_class.__name__] = cls.cfg_class
    else:
        _cfg_classes[name] = cls
    return cls


# Classes of the JAX package's training framework that are not ported yet,
# with the ROADMAP.md item that brings them.
_NOT_PORTED = {
    **dict.fromkeys(("TFDSWrapper", "TFDSConfig", "GrainDataset",
                     "GrainDatasetConfig", "ImageFolderDataset",
                     "ImageFolderConfig"), "queue A, item 13"),
}


def _lookup(table, name: str):
    if name not in table and name in _NOT_PORTED:
        raise NotImplementedError(
            f"{name} is not ported yet (ROADMAP.md, {_NOT_PORTED[name]})")
    return table[name]


def get_class(name: str):
    return _lookup(_classes, name)


def get_cfg_class(name: str):
    return _lookup(_cfg_classes, name)
