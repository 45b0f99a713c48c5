"""Composable validators + prompt/config validation.

Role parity: reference ``src/utils/validation_utils.py`` (Validator chain with
String/Numeric/List/Dict validators, validate_prompt with injection checks,
validate_config schema walker, path/JSON/YAML validators).

Own copy for the PyTorch port of ``adaptive_sd_tpu/utils/validation.py``;
``yaml`` is imported only by :func:`validate_yaml`.
"""

from __future__ import annotations

import json
import pathlib
import re
from typing import Any, Callable, Optional, Sequence

from ..core.exceptions import ValidationError


class Validator:
    """Chainable rule set: each rule is (predicate, message)."""

    def __init__(self, name: str = "value") -> None:
        self.name = name
        self._rules: list[tuple[Callable[[Any], bool], str]] = []

    def rule(self, pred: Callable[[Any], bool], message: str) -> "Validator":
        self._rules.append((pred, message))
        return self

    def validate(self, value: Any) -> Any:
        for pred, message in self._rules:
            ok = False
            try:
                ok = bool(pred(value))
            except Exception:  # noqa: BLE001 - a crashing rule is a failure
                ok = False
            if not ok:
                raise ValidationError(f"{self.name}: {message}", details={"value": repr(value)[:200]})
        return value

    def is_valid(self, value: Any) -> bool:
        try:
            self.validate(value)
            return True
        except ValidationError:
            return False


class StringValidator(Validator):
    def __init__(self, name: str = "string") -> None:
        super().__init__(name)
        self.rule(lambda v: isinstance(v, str), "must be a string")

    def non_empty(self) -> "StringValidator":
        self.rule(lambda v: bool(v.strip()), "must be non-empty")
        return self

    def max_length(self, n: int) -> "StringValidator":
        self.rule(lambda v: len(v) <= n, f"must be <= {n} chars")
        return self

    def min_length(self, n: int) -> "StringValidator":
        self.rule(lambda v: len(v) >= n, f"must be >= {n} chars")
        return self

    def matches(self, pattern: str) -> "StringValidator":
        rx = re.compile(pattern)
        self.rule(lambda v: bool(rx.search(v)), f"must match {pattern}")
        return self


class NumericValidator(Validator):
    def __init__(self, name: str = "number") -> None:
        super().__init__(name)
        self.rule(lambda v: isinstance(v, (int, float)) and not isinstance(v, bool), "must be numeric")

    def in_range(self, lo: float, hi: float) -> "NumericValidator":
        self.rule(lambda v: lo <= v <= hi, f"must be in [{lo}, {hi}]")
        return self

    def positive(self) -> "NumericValidator":
        self.rule(lambda v: v > 0, "must be positive")
        return self

    def integer(self) -> "NumericValidator":
        self.rule(lambda v: float(v).is_integer(), "must be an integer")
        return self


class ListValidator(Validator):
    def __init__(self, name: str = "list", item: Optional[Validator] = None) -> None:
        super().__init__(name)
        self.rule(lambda v: isinstance(v, (list, tuple)), "must be a list")
        if item is not None:
            self.rule(
                lambda v: all(item.is_valid(x) for x in v),
                f"every item must satisfy {item.name}",
            )

    def non_empty(self) -> "ListValidator":
        self.rule(lambda v: len(v) > 0, "must be non-empty")
        return self

    def length(self, n: int) -> "ListValidator":
        self.rule(lambda v: len(v) == n, f"must have exactly {n} items")
        return self


class DictValidator(Validator):
    def __init__(self, name: str = "dict", required: Sequence[str] = ()) -> None:
        super().__init__(name)
        self.rule(lambda v: isinstance(v, dict), "must be a dict")
        for key in required:
            self.rule(lambda v, k=key: k in v, f"missing required key {key!r}")


_INJECTION_PATTERNS = [
    re.compile(r"<\s*script", re.I),
    re.compile(r"\x1b\["),                   # ANSI escapes
    re.compile(r"[\x00-\x08\x0b\x0c\x0e-\x1f]"),  # control chars
]


def validate_prompt(prompt: str, max_length: int = 32768) -> str:
    """Length + injection screening (reference validation_utils.py:276)."""
    v = StringValidator("prompt").non_empty().max_length(max_length)
    v.validate(prompt)
    for rx in _INJECTION_PATTERNS:
        if rx.search(prompt):
            raise ValidationError(
                "prompt: rejected by injection screen", details={"pattern": rx.pattern}
            )
    return prompt


def validate_config(config: dict, schema: dict, path: str = "") -> None:
    """Schema walker (reference validation_utils.py:317-424).

    Schema leaves are {"type": ..., "required": bool, "range": (lo,hi),
    "choices": [...]}; nested dicts recurse.
    """
    for key, rule in schema.items():
        where = f"{path}.{key}" if path else key
        if isinstance(rule, dict) and "type" not in rule:
            if key in config:
                if not isinstance(config[key], dict):
                    raise ValidationError(f"{where}: must be a section")
                validate_config(config[key], rule, where)
            continue
        present = key in config
        if rule.get("required", False) and not present:
            raise ValidationError(f"{where}: required key missing")
        if not present:
            continue
        val = config[key]
        expected = rule.get("type")
        if expected is not None and not isinstance(val, expected):
            raise ValidationError(
                f"{where}: expected {expected}, got {type(val).__name__}"
            )
        rng = rule.get("range")
        if rng is not None and not (rng[0] <= val <= rng[1]):
            raise ValidationError(f"{where}: {val} outside [{rng[0]}, {rng[1]}]")
        choices = rule.get("choices")
        if choices is not None and val not in choices:
            raise ValidationError(f"{where}: {val!r} not in {choices}")


def validate_path(path: str, must_exist: bool = False, writable_parent: bool = False) -> pathlib.Path:
    p = pathlib.Path(path)
    if must_exist and not p.exists():
        raise ValidationError(f"path does not exist: {p}")
    if writable_parent and not p.parent.exists():
        raise ValidationError(f"parent directory missing: {p.parent}")
    return p


def validate_json(text: str) -> Any:
    try:
        return json.loads(text)
    except json.JSONDecodeError as exc:
        raise ValidationError(f"invalid JSON: {exc}") from exc


def validate_yaml(text: str) -> Any:
    import yaml

    try:
        return yaml.safe_load(text)
    except yaml.YAMLError as exc:
        raise ValidationError(f"invalid YAML: {exc}") from exc
