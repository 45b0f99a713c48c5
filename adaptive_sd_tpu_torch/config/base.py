"""Dataclass config system: YAML + env + deep-merge + validation.

Role parity: reference ``src/config/base.py`` (BaseConfig.from_yaml/from_dict/
from_env with typed env parsing under the ``ADAPTIVE_SD_`` prefix,
to_dict/save_yaml, deep merge, validate; ConfigManager with YAML→env→default
fallback and caching).

Own copy for the PyTorch port of ``adaptive_sd_tpu/config/base.py``. The
one departure: the card's machine has no PyYAML, so YAML files are read and
written by the port's own reader and writer (``config/yaml_lite.py``), which
give ``yaml.safe_load``'s values on the subset the configs use and raise
``ConfigurationError`` with the line number on anything else.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import threading
from dataclasses import dataclass, fields, is_dataclass
from typing import Any, Optional, Type, TypeVar, get_args, get_origin

from ..core.exceptions import ConfigurationError
from . import yaml_lite

ENV_PREFIX = "ADAPTIVE_SD_"
T = TypeVar("T", bound="BaseConfig")


def _coerce(value: Any, typ: Any) -> Any:
    """Coerce YAML/env scalars into the annotated type."""
    origin = get_origin(typ)
    if origin is not None:
        args = get_args(typ)
        if origin in (list, tuple):
            items = value if isinstance(value, (list, tuple)) else str(value).split(",")
            inner = args[0] if args else str
            coerced = [_coerce(v, inner) for v in items]
            return tuple(coerced) if origin is tuple else coerced
        if origin is dict:
            return dict(value)
        # Optional[X] / Union
        for a in args:
            if a is type(None):
                continue
            try:
                return _coerce(value, a)
            except (TypeError, ValueError):
                continue
        return value
    if is_dataclass(typ) and isinstance(value, dict):
        return _from_dict(typ, value)
    if typ is bool:
        if isinstance(value, bool):
            return value
        return str(value).lower() in ("1", "true", "yes", "on")
    if typ in (int, float, str):
        return typ(value)
    return value


def _from_dict(cls: Type[T], data: dict) -> T:
    known = {f.name: f for f in fields(cls)}
    kwargs = {}
    unknown = [k for k in data if k not in known]
    if unknown:
        raise ConfigurationError(
            f"{cls.__name__}: unknown keys {unknown}", details={"known": sorted(known)}
        )
    for name, f in known.items():
        if name in data:
            kwargs[name] = _coerce(data[name], f.type if not isinstance(f.type, str) else _resolve(cls, f))
    return cls(**kwargs)


def _resolve(cls, f) -> Any:
    """Resolve string annotations (from __future__ import annotations)."""
    import typing

    hints = typing.get_type_hints(cls)
    return hints.get(f.name, str)


@dataclass
class BaseConfig:
    """Inherit + add fields; get YAML/env/dict/merge/validate for free."""

    # -- constructors --------------------------------------------------------
    @classmethod
    def from_dict(cls: Type[T], data: dict) -> T:
        cfg = _from_dict(cls, data or {})
        cfg.validate()
        return cfg

    @classmethod
    def from_yaml(cls: Type[T], path: str | pathlib.Path) -> T:
        p = pathlib.Path(path)
        if not p.exists():
            raise ConfigurationError(f"config file not found: {p}")
        try:
            data = yaml_lite.load(p.read_text()) or {}
        except ConfigurationError as exc:
            raise ConfigurationError(f"bad YAML in {p}: {exc.message}",
                                     details=exc.details) from exc
        return cls.from_dict(data)

    @classmethod
    def from_env(cls: Type[T], prefix: str = ENV_PREFIX) -> T:
        """Flat env override: ADAPTIVE_SD_<FIELD>=value (nested fields via
        double underscore: ADAPTIVE_SD_SERVER__PORT=9000)."""
        data: dict[str, Any] = {}
        for key, val in os.environ.items():
            if not key.startswith(prefix):
                continue
            path = key[len(prefix):].lower().split("__")
            node = data
            for part in path[:-1]:
                node = node.setdefault(part, {})
            node[path[-1]] = val
        return cls.from_dict(data)

    # -- export --------------------------------------------------------------
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def save_yaml(self, path: str | pathlib.Path) -> None:
        p = pathlib.Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(yaml_lite.dump(self.to_dict()))

    # -- merge / validate ----------------------------------------------------
    def merge(self: T, other: dict) -> T:
        """Deep merge: dict fields merge recursively, others overwrite."""

        def deep(a: dict, b: dict) -> dict:
            out = dict(a)
            for k, v in b.items():
                if k in out and isinstance(out[k], dict) and isinstance(v, dict):
                    out[k] = deep(out[k], v)
                else:
                    out[k] = v
            return out

        return type(self).from_dict(deep(self.to_dict(), other))

    def validate(self) -> None:
        """Override in subclasses; raise ConfigurationError on bad values."""


class ConfigManager:
    """YAML → env → default resolution with caching (reference base.py:164-234)."""

    def __init__(self, config_dir: str = "configs") -> None:
        self.config_dir = pathlib.Path(config_dir)
        self._cache: dict[tuple[str, type], Any] = {}
        self._lock = threading.Lock()

    def load(self, name: str, cls: Type[T], env_prefix: Optional[str] = None) -> T:
        key = (name, cls)
        with self._lock:
            if key in self._cache:
                return self._cache[key]
        path = self.config_dir / f"{name}.yaml"
        if path.exists():
            cfg = cls.from_yaml(path)
        else:
            cfg = cls()
            cfg.validate()
        # env overlay
        prefix = env_prefix or f"{ENV_PREFIX}{name.upper()}__"
        overlay: dict[str, Any] = {}
        for k, v in os.environ.items():
            if k.startswith(prefix):
                parts = k[len(prefix):].lower().split("__")
                node = overlay
                for part in parts[:-1]:
                    node = node.setdefault(part, {})
                node[parts[-1]] = v
        if overlay:
            cfg = cfg.merge(overlay)
        with self._lock:
            self._cache[key] = cfg
        return cfg

    def invalidate(self) -> None:
        with self._lock:
            self._cache.clear()
