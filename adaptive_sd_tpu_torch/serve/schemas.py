"""Request/response schemas of the HTTP API, validated without pydantic (own
copy of ``adaptive_sd_tpu/serve/schemas.py``).

Role parity: reference ``src/serving/server.py:40-84`` (GenerationRequest with
field validation, GenerationResponse, BatchGenerationRequest,
LambdaUpdateRequest with bounds 0.01-100, StatsResponse).

The card's machine has no pydantic, so each request type checks its own
fields, and the responses are dataclasses that ``to_dict`` as ``model_dump``
does. The fields, defaults and bounds are the JAX package's, and
so are pydantic 2's lax coercions for them: ``"5"``, ``5.0`` and ``True``
are the int 5, 5 and 1, ``5.5`` is refused; an int or a numeric string is a
float; a string is never made from another type; extra keys are ignored.
Errors carry pydantic's ``type``, ``loc`` and ``msg`` (its first error is
what the server returns in a 422 body), in its order: fields as declared,
one error a field, a list's items after its length.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field, fields
from typing import Any, Optional

_MISSING = object()
# pydantic-core's int from a string: surrounding blanks, a sign, digits with
# single underscores between them, and an optional fraction of zeros
_INT_STR = re.compile(r"[+-]?[0-9]+(?:_[0-9]+)*(?:\.0+)?")


class ValidationError(ValueError):
    """What pydantic's ValidationError gives the server: ``errors()``, each
    a dict with ``type``, ``loc`` and ``msg``."""

    def __init__(self, model: str, errors: list) -> None:
        self.model = model
        self._errors = errors
        super().__init__(f"{len(errors)} validation error(s) for {model}: "
                         + "; ".join(f"{'.'.join(map(str, e['loc']))}: {e['msg']}"
                                     for e in errors))

    def errors(self) -> list:
        return list(self._errors)


class _Invalid(Exception):
    def __init__(self, type_: str, msg: str, loc: tuple = ()) -> None:
        self.type, self.msg, self.loc = type_, msg, loc


def _num(x: float) -> str:
    """A bound as pydantic prints it: 2.0 -> "2", 0.01 -> "0.01"."""
    return str(int(x)) if float(x).is_integer() else repr(float(x))


def _bounds(v, ge=None, gt=None, le=None) -> None:
    # pydantic-core tests le before ge and gt, so NaN fails on le
    if le is not None and not v <= le:
        raise _Invalid("less_than_equal", f"Input should be less than or equal to {_num(le)}")
    if ge is not None and not v >= ge:
        raise _Invalid("greater_than_equal", f"Input should be greater than or equal to {_num(ge)}")
    if gt is not None and not v > gt:
        raise _Invalid("greater_than", f"Input should be greater than {_num(gt)}")


def _as_str(v, min_length=None, max_length=None) -> str:
    if not isinstance(v, str):
        raise _Invalid("string_type", "Input should be a valid string")
    if min_length is not None and len(v) < min_length:
        raise _Invalid("string_too_short", f"String should have at least {min_length} "
                       f"character{'' if min_length == 1 else 's'}")
    if max_length is not None and len(v) > max_length:
        raise _Invalid("string_too_long", f"String should have at most {max_length} "
                       f"character{'' if max_length == 1 else 's'}")
    return v


def _as_int(v, **bounds) -> int:
    if isinstance(v, bool):
        out = int(v)
    elif isinstance(v, int):
        out = v
    elif isinstance(v, float):
        if not math.isfinite(v):
            raise _Invalid("finite_number", "Input should be a finite number")
        if not v.is_integer():
            raise _Invalid("int_from_float",
                           "Input should be a valid integer, got a number with a fractional part")
        if not -2.0 ** 63 < v < 2.0 ** 63:   # pydantic-core goes through an i64
            raise _Invalid("int_parsing_size",
                           "Unable to parse input string as an integer, exceeded maximum size")
        out = int(v)
    elif isinstance(v, str):
        s = v.strip()
        if not _INT_STR.fullmatch(s):
            raise _Invalid("int_parsing",
                           "Input should be a valid integer, unable to parse string as an integer")
        out = int(s.split(".")[0].replace("_", ""))
    else:
        raise _Invalid("int_type", "Input should be a valid integer")
    _bounds(out, **bounds)
    return out


def _parse_float(raw: str) -> float:
    # pydantic-core trims blanks around a number, but takes underscores only
    # in an untrimmed string, and never first, last or doubled
    s = raw.strip()
    if "_" in s and (s != raw or "__" in s or s.startswith("_") or s.endswith("_")):
        raise ValueError(raw)
    if not s.isascii():
        raise ValueError(raw)
    return float(s.replace("_", ""))


def _as_float(v, **bounds) -> float:
    if isinstance(v, (bool, int)):
        try:
            out = float(v)
        except OverflowError:
            raise _Invalid("float_type", "Input should be a valid number") from None
    elif isinstance(v, float):
        out = v
    elif isinstance(v, str):
        try:
            out = _parse_float(v)
        except ValueError:
            raise _Invalid("float_parsing",
                           "Input should be a valid number, unable to parse string as a number"
                           ) from None
    else:
        raise _Invalid("float_type", "Input should be a valid number")
    _bounds(out, **bounds)
    return out


def _as_str_list(v, min_length: int, max_length: int) -> list:
    if not isinstance(v, (list, tuple)):
        raise _Invalid("list_type", "Input should be a valid list")
    if len(v) > max_length:
        raise _Invalid("too_long", f"List should have at most {max_length} items after "
                       f"validation, not {len(v)}")
    errors = []
    for i, item in enumerate(v):
        if not isinstance(item, str):
            errors.append(_Invalid("string_type", "Input should be a valid string", (i,)))
    if errors:
        raise _Many(errors)
    if len(v) < min_length:
        raise _Invalid("too_short", f"List should have at least {min_length} "
                       f"item{'' if min_length == 1 else 's'} after validation, not {len(v)}")
    return list(v)


class _Many(Exception):
    def __init__(self, errors: list) -> None:
        self.errors = errors


def _snap(v: float) -> float:
    # the JAX package snaps to a 0.05 grid to bound its compile cache; kept so
    # that both servers treat a client's floats alike, and so that
    # batch_process groups requests with near-equal settings
    return round(round(v / 0.05) * 0.05, 2)


def _not_blank(v: str) -> str:
    if not v.strip():
        raise _Invalid("value_error", "Value error, prompt must not be blank")
    return v


def _optional(check):
    return lambda v: None if v is None else check(v)


class _Model:
    """A request type: ``cls(**payload)`` validates as the pydantic model
    does. Each subclass lists ``(name, default, check)`` in ``_SPEC``; a
    default of ``_MISSING`` makes the field required."""

    _SPEC: tuple = ()

    def __init__(self, **data: Any) -> None:
        errors = []
        for name, default, check in self._SPEC:
            if name not in data:
                if default is _MISSING:
                    errors.append({"type": "missing", "loc": (name,), "msg": "Field required"})
                    continue
                setattr(self, name, default)
                continue
            try:
                setattr(self, name, check(data[name]))
            except _Invalid as e:
                errors.append({"type": e.type, "loc": (name, *e.loc), "msg": e.msg})
            except _Many as many:
                errors.extend({"type": e.type, "loc": (name, *e.loc), "msg": e.msg}
                              for e in many.errors)
        if errors:
            raise ValidationError(type(self).__name__, errors)

    def to_dict(self) -> dict:
        """``model_dump()``: the fields in their declared order."""
        return {name: getattr(self, name) for name, _, _ in self._SPEC}

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.to_dict()!r})"


class GenerationRequest(_Model):
    prompt: str
    max_tokens: int
    temperature: float
    top_p: float
    lambda_override: Optional[float]
    request_id: Optional[str]

    _SPEC = (
        ("prompt", _MISSING, lambda v: _not_blank(_as_str(v, 1, 32768))),
        ("max_tokens", 256, lambda v: _as_int(v, ge=1, le=4096)),
        ("temperature", 0.0, lambda v: _snap(_as_float(v, ge=0.0, le=2.0))),
        ("top_p", 1.0, lambda v: _snap(_as_float(v, gt=0.0, le=1.0))),
        ("lambda_override", None, _optional(lambda v: _as_float(v, gt=0.0, le=100.0))),
        ("request_id", None, _optional(_as_str)),
    )


class BatchGenerationRequest(_Model):
    prompts: list
    max_tokens: int
    temperature: float

    _SPEC = (
        ("prompts", _MISSING, lambda v: _as_str_list(v, 1, 256)),
        ("max_tokens", 256, lambda v: _as_int(v, ge=1, le=4096)),
        ("temperature", 0.0, lambda v: _as_float(v, ge=0.0, le=2.0)),
    )


class LambdaUpdateRequest(_Model):
    lambda_value: float

    _SPEC = (("lambda_value", _MISSING, lambda v: _as_float(v, ge=0.01, le=100.0)),)


# -- responses: built by the server from the pipeline's own values ------------------


@dataclass
class GenerationResponse:
    request_id: str
    text: str
    final_stage: int
    final_stage_name: str
    latency_s: float
    cost: float
    acceptance_probs: list = field(default_factory=list)
    cached: bool = False
    error: Optional[str] = None

    def __post_init__(self) -> None:
        self.final_stage = int(self.final_stage)
        self.latency_s, self.cost = float(self.latency_s), float(self.cost)
        self.acceptance_probs = [float(p) for p in self.acceptance_probs]
        self.cached = bool(self.cached)

    def to_dict(self) -> dict:
        return {f.name: getattr(self, f.name) for f in fields(self)}



@dataclass
class BatchGenerationResponse:
    results: list
    batch_latency_s: float

    def to_dict(self) -> dict:
        return {"results": [r.to_dict() for r in self.results],
                "batch_latency_s": float(self.batch_latency_s)}



@dataclass
class StatsResponse:
    total_requests: int
    error_rate: float
    ema_latency_s: float
    ema_cost: float
    stage_distribution: list
    early_stop_rate: float
    lambda_value: float
    acceptance_priors: list
    cache: dict
    uptime_s: float
    # per-tier continuous-batching lane stats (scheduled execution plane
    # only; empty for the fused pipeline)
    schedulers: list = field(default_factory=list)

    def __post_init__(self) -> None:
        self.total_requests = int(self.total_requests)
        for name in ("error_rate", "ema_latency_s", "ema_cost", "early_stop_rate",
                     "lambda_value", "uptime_s"):
            setattr(self, name, float(getattr(self, name)))
        self.stage_distribution = [float(x) for x in self.stage_distribution]
        self.acceptance_priors = [float(x) for x in self.acceptance_priors]
        self.cache, self.schedulers = dict(self.cache), list(self.schedulers)

    def to_dict(self) -> dict:
        return {f.name: getattr(self, f.name) for f in fields(self)}

