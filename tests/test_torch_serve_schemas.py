"""The port's request validation (``serve/schemas.py``, no pydantic) against
the JAX package's pydantic models: for generated payloads of every request
type (wrong types, numeric strings, missing keys, values at and beyond each
bound, extra keys) the same outcome, the same errors in the same order (the
server returns the first one's message in its 422 body) and, when valid,
the same ``model_dump``; and the responses dump as pydantic dumps them."""

import json
import math

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from pydantic import ValidationError as PydanticError

from adaptive_sd_tpu.serve import schemas as J
from adaptive_sd_tpu_torch.serve import schemas as T

FAST = settings(max_examples=100, deadline=None, derandomize=True, database=None)

_BOUNDS = [0, 1, 2, 100, 4096, 4097, 0.01, 0.05, 0.07, 0.5, 1.0, 2.0, 100.0]
_NUM_STR = st.builds(
    lambda pad, sign, digits, frac, exp, under: (
        pad + sign + (digits[:1] + "_" + digits[1:] if under and len(digits) > 1 else digits)
        + frac + exp + pad),
    st.sampled_from(["", " ", "\t"]), st.sampled_from(["", "+", "-"]),
    st.text("0123456789", min_size=1, max_size=5),
    st.sampled_from(["", ".", ".0", ".00", ".5", ".05"]),
    st.sampled_from(["", "e1", "e-2", "E+0"]), st.booleans())
_WILD = st.one_of(
    st.none(), st.booleans(),
    st.integers(-5, 5000), st.sampled_from([2**63, -(2**63), 10**30, 10**400]),
    st.sampled_from(_BOUNDS).flatmap(lambda b: st.sampled_from([b, -b, b + 1e-9, b - 1e-9])),
    st.floats(allow_nan=True, allow_infinity=True),
    st.sampled_from([5.5, 1e19, 9.2e18, -1e300, float("inf"), float("nan")]),
    _NUM_STR,
    st.sampled_from(["", " ", "inf", "-Infinity", "nan", "0x10", "1e3", "1_000", "_1", "1__0",
                     "abc", "٣", "5.", ".5"]),
    st.text(max_size=6),
    st.lists(st.one_of(st.text(max_size=4), st.integers(), st.none()), max_size=3),
    st.dictionaries(st.text(max_size=3), st.integers(), max_size=2),
)
_PROMPT = st.one_of(_WILD, st.sampled_from(["hello", "  ", "\n\t", "　", "​", "x"]),
                    st.integers(32760, 32770).map(lambda n: "p" * n))
_PROMPTS = st.one_of(
    _WILD,
    st.lists(st.one_of(st.text(max_size=5), st.integers(), st.none()), max_size=5),
    st.integers(250, 260).flatmap(lambda n: st.sampled_from([["q"] * n, [1] * n])),
)


def _payload(fields):
    """Each field missing or drawn; an extra key now and then."""
    return st.fixed_dictionaries({}, optional={**fields, "extra_key": _WILD})


def _outcome(cls, payload):
    try:
        model = cls(**payload)
        return "ok", model.model_dump() if cls.__module__ == J.__name__ else model.to_dict()
    except PydanticError as e:
        return "error", [(tuple(x["loc"]), x["msg"]) for x in json.loads(e.json())]
    except T.ValidationError as e:
        return "error", [(tuple(x["loc"]), x["msg"]) for x in e.errors()]


def _same(a, b):
    assert a[0] == b[0], (a, b)
    if a[0] == "error":
        assert a[1] == b[1], (a, b)
        return
    assert a[1].keys() == b[1].keys() and list(a[1]) == list(b[1]), (a, b)
    for k in a[1]:
        x, y = a[1][k], b[1][k]
        assert type(x) is type(y), (k, x, y)
        assert x == y or (isinstance(x, float) and math.isnan(x) and math.isnan(y)), (k, x, y)


_FIELDS = {
    "GenerationRequest": {"prompt": _PROMPT, "max_tokens": _WILD, "temperature": _WILD,
                          "top_p": _WILD, "lambda_override": _WILD, "request_id": _WILD},
    "BatchGenerationRequest": {"prompts": _PROMPTS, "max_tokens": _WILD, "temperature": _WILD},
    "LambdaUpdateRequest": {"lambda_value": _WILD},
}


@pytest.mark.parametrize("name", sorted(_FIELDS))
def test_validation_matches_pydantic(name):
    @FAST
    @given(_payload(_FIELDS[name]))
    def check(payload):
        _same(_outcome(getattr(J, name), payload), _outcome(getattr(T, name), payload))

    check()


@pytest.mark.parametrize("name, payload, msg", [
    ("GenerationRequest", {}, "Field required"),
    ("GenerationRequest", {"prompt": ""}, "String should have at least 1 character"),
    ("GenerationRequest", {"prompt": "x", "max_tokens": 0},
     "Input should be greater than or equal to 1"),
    ("GenerationRequest", {"prompt": " "}, "Value error, prompt must not be blank"),
    ("GenerationRequest", {"prompt": "x", "max_tokens": 5.5},
     "Input should be a valid integer, got a number with a fractional part"),
    ("BatchGenerationRequest", {"prompts": []},
     "List should have at least 1 item after validation, not 0"),
    ("LambdaUpdateRequest", {"lambda_value": 0.001},
     "Input should be greater than or equal to 0.01"),
])
def test_named_messages(name, payload, msg):
    """The messages the server's 422 bodies quote, as pydantic words them."""
    assert _outcome(getattr(J, name), payload)[1][0][1] == msg
    assert _outcome(getattr(T, name), payload)[1][0][1] == msg


def test_coercions_and_snapping():
    r = T.GenerationRequest(prompt="a", max_tokens="5", temperature=True, top_p="0.93",
                            lambda_override=3, extra=1)
    assert r.to_dict() == {"prompt": "a", "max_tokens": 5, "temperature": 1.0, "top_p": 0.95,
                           "lambda_override": 3.0, "request_id": None}
    assert T.GenerationRequest(prompt="a", max_tokens=5.0).max_tokens == 5
    assert T.BatchGenerationRequest(prompts=["a"], temperature=0.07).temperature == 0.07


def test_responses_dump_as_pydantic():
    import numpy as np

    kw = dict(request_id="r", text="t", final_stage=np.int64(1), final_stage_name="b",
              latency_s=1, cost=np.float32(2.5), acceptance_probs=[np.float32(0.5), 1],
              cached=False, error=None)
    assert T.GenerationResponse(**kw).to_dict() == J.GenerationResponse(
        **{**kw, "final_stage": 1, "cost": 2.5, "acceptance_probs": [0.5, 1]}).model_dump()
    stats = dict(total_requests=3, error_rate=0, ema_latency_s=0.1, ema_cost=1, stage_distribution=[1, 0],
                 early_stop_rate=0.5, lambda_value=1, acceptance_priors=[0.7, 0.9],
                 cache={"entries": 1}, uptime_s=2)
    for extra in ({}, {"schedulers": [{"lanes": 2}]}):
        a = T.StatsResponse(**stats, **extra).to_dict()
        b = J.StatsResponse(**stats, **extra).model_dump()
        assert a == b and list(a) == list(b)
        assert [type(v) for v in a.values()] == [type(v) for v in b.values()]
