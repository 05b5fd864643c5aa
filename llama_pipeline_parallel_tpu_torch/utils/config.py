"""Config system: YAML + `_target_` factories + `${}` interpolation + CLI overrides.

A copy of llama_pipeline_parallel_tpu/utils/config.py (the port keeps its own):

- `load_config(path, overrides)` -> plain dict, with `${key.path}` strings
  resolved against the root and `key.path=value` overrides applied first.
- `instantiate(node, **extra)` -> import the dotted `_target_` and call it
  with the node's other keys (children instantiated recursively).
"""

from __future__ import annotations

import ast
import importlib
import re
from typing import Any

import yaml

_INTERP_RE = re.compile(r"\$\{([a-zA-Z0-9_.]+)\}")
# YAML 1.1 leaves exponent-form numbers without a dot ("1e-2") as strings.
_SCI_FLOAT_RE = re.compile(r"[+-]?(\d+\.?\d*|\.\d+)[eE][+-]?\d+")


def _get_path(root: Any, dotted: str) -> Any:
    node = root
    for part in dotted.split("."):
        if isinstance(node, list):
            node = node[int(part)]
        else:
            node = node[part]
    return node


def _set_path(root: dict, dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    node = root
    for part in parts[:-1]:
        node = node.setdefault(part, {})
    node[parts[-1]] = value


def _parse_scalar(text: str) -> Any:
    """Parse an override VALUE: YAML first (numbers, bools, lists, inline
    dicts), Python literal as fallback; dot-less exponent floats ('1e-4'),
    which YAML 1.1 leaves as strings, are coerced like file values."""
    try:
        value = yaml.safe_load(text)
    except yaml.YAMLError:
        try:
            return ast.literal_eval(text)
        except (ValueError, SyntaxError):
            return text
    if isinstance(value, str) and _SCI_FLOAT_RE.fullmatch(value):
        return float(value)
    return value


def _resolve(node: Any, root: Any, seen: tuple[str, ...] = ()) -> Any:
    if isinstance(node, dict):
        return {k: _resolve(v, root, seen) for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve(v, root, seen) for v in node]
    if isinstance(node, str):
        if _SCI_FLOAT_RE.fullmatch(node):
            return float(node)
        full = _INTERP_RE.fullmatch(node)
        if full:  # whole-string interpolation keeps the referee's type
            key = full.group(1)
            if key in seen:
                raise ValueError(f"interpolation cycle via ${{{key}}}")
            return _resolve(_get_path(root, key), root, seen + (key,))

        def sub(m: re.Match) -> str:
            key = m.group(1)
            if key in seen:
                raise ValueError(f"interpolation cycle via ${{{key}}}")
            return str(_resolve(_get_path(root, key), root, seen + (key,)))

        return _INTERP_RE.sub(sub, node)
    return node


def apply_overrides(cfg: dict, overrides: list[str] | None) -> dict:
    """Apply `a.b=c` override strings to a config dict IN PLACE (and return
    it); `--a.b=c` (torchrun style) is accepted too."""
    for ov in overrides or []:
        ov = ov.lstrip("-")
        if "=" not in ov:
            raise ValueError(f"override {ov!r} is not of the form key=value")
        key, _, val = ov.partition("=")
        _set_path(cfg, key.strip(), _parse_scalar(val.strip()))
    return cfg


def load_config(path: str, overrides: list[str] | None = None) -> dict:
    """Load YAML, apply `a.b=c` overrides, resolve `${}` interpolations."""
    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    if not isinstance(cfg, dict):
        raise ValueError(f"top-level config must be a mapping, got {type(cfg)}")
    apply_overrides(cfg, overrides)
    return _resolve(cfg, cfg)


def resolve_target(dotted: str) -> Any:
    """Import `pkg.mod.Attr[.attr2...]` — walking back over trailing attrs so
    classmethod/staticmethod targets like `...LlamaConfig.tiny` resolve."""
    if "." not in dotted:
        raise ValueError(f"_target_ {dotted!r} must be a dotted path")
    parts = dotted.split(".")
    last_err: Exception | None = None
    for split in range(len(parts) - 1, 0, -1):
        mod_name = ".".join(parts[:split])
        try:
            obj = importlib.import_module(mod_name)
        except ModuleNotFoundError as e:
            last_err = e
            continue
        for attr in parts[split:]:
            obj = getattr(obj, attr)
        return obj
    raise ModuleNotFoundError(f"cannot resolve _target_ {dotted!r}") from last_err


def instantiate(node: Any, **extra: Any) -> Any:
    """Hydra-style: dicts with `_target_` become calls; children first."""
    if isinstance(node, dict) and "_target_" in node:
        kwargs = {k: instantiate(v) for k, v in node.items() if k != "_target_"}
        kwargs.update(extra)
        return resolve_target(node["_target_"])(**kwargs)
    if isinstance(node, dict):
        return {k: instantiate(v) for k, v in node.items()}
    if isinstance(node, list):
        return [instantiate(v) for v in node]
    return node
