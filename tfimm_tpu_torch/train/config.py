"""Experiment config system; mirror of tfimm_tpu/train/config.py.

The feature set is the reference's ``_class``-composition convention:

- A string field ``xyz_class`` names a registered class whose ``cfg_class``
  dataclass defines the schema of the nested ``xyz`` field.
- Configs round-trip between dataclasses, nested dicts, and flat dotted keys
  (``--problem.model.model_name=...``).
- ``parse_args`` iteratively builds an argparse parser: each round may reveal
  new ``_class`` choices and therefore new flags, so parsing repeats until all
  arguments are consumed.
- YAML files load via a ``cfg_file`` field and merge under CLI overrides.

PyYAML is imported only by the functions that read or write YAML.
"""

from __future__ import annotations

import argparse
import ast
import copy
import dataclasses
import logging
import sys
from pathlib import Path

from tfimm_tpu_torch.train.registry import get_cfg_class

__all__ = ["parse_args", "dump_config", "pprint", "to_dict_format",
           "deep_to_flat", "flat_to_deep", "str2bool"]

_MISSING = dataclasses.MISSING


def to_dict_format(cfg):
    """Recursively convert dataclasses inside a config to plain dicts."""
    if dataclasses.is_dataclass(cfg):
        return to_dict_format(dataclasses.asdict(cfg))
    out = {}
    for key, val in cfg.items():
        if dataclasses.is_dataclass(val):
            out[key] = to_dict_format(dataclasses.asdict(val))
        elif isinstance(val, dict):
            out[key] = to_dict_format(val)
        else:
            out[key] = val
    return out


def to_cls_format(cfg):
    """Instantiate nested dicts as config dataclasses per their ``_class``."""
    out = {}
    for key, val in cfg.items():
        if isinstance(val, dict):
            cls_name = cfg.get(f"{key}_class")
            if cls_name:
                out[key] = get_cfg_class(cls_name)(**to_cls_format(val))
            else:
                out[key] = None
        else:
            out[key] = val
    return out


def _normalize(cfg):
    """Enforce the nesting invariants: every nested dict has a ``_class``
    sibling; ``_class`` fields are strings ('' for unset); a ``xyz_class``
    field implies a (possibly empty) ``xyz`` dict."""
    out = {}
    for key, val in cfg.items():
        if key.endswith("_class"):
            if val is not None and not isinstance(val, str):
                raise ValueError(f"Value for key {key} should be a string.")
            out[key] = val or ""
            stem = key[: -len("_class")]
            if stem not in cfg:
                out[stem] = {}
        elif isinstance(val, dict):
            if f"{key}_class" not in cfg:
                raise ValueError(
                    f"Nesting only allowed if key `{key}_class` exists.")
            out[key] = _normalize(val)
        elif f"{key}_class" in cfg:
            if val is not None:
                raise ValueError(f"Value for key {key} has to be a dict.")
            out[key] = {}
        else:
            out[key] = val
    return out


def _field_types(cls):
    """Resolved field types (handles modules using
    ``from __future__ import annotations``, where field.type is a string)."""
    import typing

    try:
        hints = typing.get_type_hints(cls)
    except Exception:
        hints = {}
    out = {}
    for f in dataclasses.fields(cls):
        tp = hints.get(f.name, f.type)
        if isinstance(tp, str):
            tp = {"int": int, "float": float, "str": str, "bool": bool,
                  "tuple": tuple}.get(tp, str)
        origin = getattr(tp, "__origin__", None)
        if origin is not None:  # e.g. Tuple[int, int] / Optional[...]
            tp = tuple if origin is tuple else str
        if not callable(tp):
            tp = str
        out[f.name] = tp
    return out


def _to_typed(cfg):
    """Values -> (type, value) pairs; None/MISSING parse as str."""
    out = {}
    for key, val in cfg.items():
        if isinstance(val, dict):
            out[key] = _to_typed(val)
        else:
            tp = type(val) if val not in {None, _MISSING} else str
            out[key] = (tp, val)
    return out


def _expand_classes(cfg):
    """For every set ``xyz_class``, inject the fields of its cfg dataclass as
    defaults of the nested ``xyz`` dict (preserving user-supplied values)."""
    out = {}
    for key, val in cfg.items():
        if key.endswith("_class"):
            out[key] = val
            if val[1] == "":
                continue
            cls = get_cfg_class(val[1])
            stem = key[: -len("_class")]
            types = _field_types(cls)
            params = {f.name: (types[f.name], f.default)
                      for f in dataclasses.fields(cls)}
            existing = cfg.get(stem, {})
            if not isinstance(existing, dict):
                raise ValueError(f"cfg[{stem}] should be a dict.")
            params.update({k: v for k, v in existing.items() if k in params})
            out[stem] = _expand_classes(params)
        elif isinstance(val, dict) and f"{key}_class" not in cfg:
            out[key] = _expand_classes(val)
        elif f"{key}_class" not in cfg:
            out[key] = val
    return out


def _add_cls_defaults(cfg, cls):
    """Add missing top-level fields of ``cls`` to a typed config."""
    out = copy.deepcopy(cfg)
    if cls is None:
        return out
    types = _field_types(cls)
    params = {f.name: (types[f.name], f.default)
              for f in dataclasses.fields(cls)}
    for key, val in params.items():
        if f"{key}_class" in params:
            continue
        out.setdefault(key, val)
    return out


def deep_to_flat(cfg):
    """{"a": {"b": 1}} -> {"a.b": 1}."""
    out = {}
    for key, val in cfg.items():
        if isinstance(val, dict):
            for sub_key, sub_val in deep_to_flat(val).items():
                out[f"{key}.{sub_key}"] = sub_val
        else:
            out[key] = val
    return out


def flat_to_deep(cfg):
    """Inverse of deep_to_flat."""
    out = {}
    for key, val in cfg.items():
        if "." in key:
            root, rest = key.split(".", 1)
            out.setdefault(root, {})[rest] = val
        else:
            out[key] = val
    return {k: flat_to_deep(v) if isinstance(v, dict) else v
            for k, v in out.items()}


def dump_config(cfg, filename):
    """Save a config to YAML (nested dict format)."""
    import yaml

    cfg = to_dict_format(cfg)
    Path(filename).parent.mkdir(parents=True, exist_ok=True)
    with open(filename, "w") as f:
        yaml.dump(cfg, f, default_flow_style=False, sort_keys=False)


def _apply_cfg_file(cfg, args):
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg_file", default=cfg["cfg_file"])
    ns, _ = parser.parse_known_args(args)
    if not ns.cfg_file:
        return cfg
    import yaml

    with open(ns.cfg_file) as f:
        loaded = yaml.load(f, Loader=yaml.Loader)
    merged = deep_to_flat(cfg)
    merged.update(deep_to_flat(loaded))
    merged["cfg_file"] = ns.cfg_file
    return _normalize(flat_to_deep(merged))


def str2bool(v: str) -> bool:
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def _as_tuple(s: str):
    v = ast.literal_eval(s)
    if type(v) is not tuple:
        raise argparse.ArgumentTypeError(f"Argument {s} is not a tuple")
    return v


def _build_parser(flat_cfg):
    parser = argparse.ArgumentParser(
        description="Auto-generated config parser",
        argument_default=argparse.SUPPRESS,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    for arg, (tp, val) in flat_cfg.items():
        kwargs = {"dest": arg, "help": arg}
        if val is not _MISSING:
            kwargs["default"] = val
        if tp is bool:
            kwargs["type"] = str2bool
        elif tp is tuple:
            kwargs["type"] = _as_tuple
        else:
            kwargs["type"] = tp
        parser.add_argument(f"--{arg}", **kwargs)
    return parser


def parse_args(cfg, *, cfg_class=None, args=None):
    """Parse CLI args (and optional YAML file) into a config.

    Parsing iterates: each round resolves known ``_class`` fields, exposes
    their nested fields as flags, and re-parses, until no unparsed arguments
    remain. Returns ``cfg_class(**result)`` when a class is known.
    """
    if args is None:
        args = sys.argv[1:]
    if cfg_class is None:
        cfg_class = type(cfg) if dataclasses.is_dataclass(cfg) else None

    cfg = _normalize(to_dict_format(cfg))
    if cfg_class is not None and "cfg_file" not in cfg:
        fields = {f.name: f.default for f in dataclasses.fields(cfg_class)}
        if "cfg_file" in fields:
            default = fields["cfg_file"]
            cfg["cfg_file"] = default if default is not _MISSING else ""
    if "cfg_file" in cfg:
        cfg = _apply_cfg_file(cfg, args)

    unparsed = None
    nb_unparsed = len(args)
    continue_parsing = nb_unparsed > 0
    while continue_parsing:
        continue_parsing = unparsed is None or len(unparsed) > 0
        typed = _expand_classes(_to_typed(cfg))
        typed = _add_cls_defaults(typed, cfg_class)
        flat = deep_to_flat(typed)
        parsed, unparsed = _build_parser(flat).parse_known_args(args)
        parsed = vars(parsed)
        for key in flat:
            if key not in parsed:
                raise ValueError(f"Argument {key} was not supplied.")
        if continue_parsing and len(unparsed) >= nb_unparsed:
            raise ValueError(
                "Parsing made no progress; unknown arguments or a missing "
                f"'_class' field. Unparsed: {unparsed}"
            )
        nb_unparsed = len(unparsed)
        cfg = _normalize(flat_to_deep(parsed))

    cfg = to_cls_format(cfg)
    return cfg_class(**cfg) if cfg_class else cfg


def pprint(cfg, indent: int = 2):
    """Log a nested config."""
    cfg = to_dict_format(cfg)
    for key, val in cfg.items():
        if isinstance(val, dict):
            logging.info(" " * indent + f"{key}:")
            pprint(val, indent + 2)
        else:
            logging.info(" " * indent + f"{key}={val}")
