"""The port's own YAML reader and writer (``config/yaml_lite.py``) against
PyYAML: the repo's configs, generated documents of the supported subset
(block mappings and sequences in their indentation styles, flow sequences,
plain, single- and double-quoted scalars, comments, YAML 1.1 typing), what
``dump`` and ``save_yaml`` write, and the errors outside the subset."""

import math
import re
from pathlib import Path

import pytest
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

from adaptive_sd_tpu_torch import config as tc
from adaptive_sd_tpu_torch.config import yaml_lite as Y
from adaptive_sd_tpu_torch.core.exceptions import ConfigurationError

REPO = Path(__file__).resolve().parent.parent
FAST = settings(max_examples=80, deadline=None, derandomize=True, database=None)


def _same(a, b):
    """Equal values of equal types (True is not 1 here; NaN equals NaN)."""
    assert type(a) is type(b), (a, b)
    if isinstance(a, dict):
        assert list(a) == list(b) or set(a) == set(b), (a, b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b), (a, b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, float) and math.isnan(a):
        assert math.isnan(b)
    else:
        assert a == b, (a, b)


@pytest.mark.parametrize("name", ["serving", "cascade", "training"])
def test_repo_configs_read_as_pyyaml_reads_them(name):
    text = (REPO / "configs" / f"{name}.yaml").read_text()
    _same(Y.load(text), yaml.safe_load(text))


# -- generated documents of the subset ---------------------------------------------

_TIMESTAMP = re.compile(r"^[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}")
_PLAIN = st.text(alphabet="abcxyzEN019_.+-~/:() ", min_size=1, max_size=10).filter(
    lambda t: t == t.strip() and t[0] not in "-:~" and ": " not in t and not t.endswith(":")
    and not _TIMESTAMP.match(t)) | st.sampled_from(["~", "null", "Null", "yes", "No", "ON",
                                                     "off", "True", "FALSE", "y", "n"])
_NUMBER = st.one_of(
    st.integers(-10**6, 10**6).map(str),
    st.integers(0, 4095).map(lambda n: f"0x{n:x}"),
    st.integers(0, 511).map(lambda n: f"0{n:o}"),
    st.integers(0, 255).map(lambda n: f"0b{n:b}"),
    st.integers(1, 99).map(lambda n: f"{n}_000"),
    st.integers(1, 59).map(lambda n: f"1:{n:02d}"),
    st.floats(-1e6, 1e6, allow_nan=False).map(repr).filter(lambda r: "." in r),
    st.sampled_from(["1.5e+3", "2.0E-4", ".5", "1.", "-.inf", ".inf", ".nan", "1_0.5", "1e5",
                     "+7", "-0", "3:25:45.5"]),
)


def _single(t):
    return "'" + t.replace("'", "''") + "'"


def _double(t):
    return '"' + t.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n").replace(
        "\t", "\\t") + '"'


_QUOTED = st.text(alphabet="ab 'x\"\\#:,[]{}-\n\té", max_size=8).flatmap(
    lambda t: st.sampled_from([_double(t)] + ([] if "\n" in t else [_single(t)])))
_SCALAR = st.one_of(_PLAIN, _NUMBER, _QUOTED)
_KEY = st.one_of(_PLAIN.filter(lambda t: " #" not in t and t != "~" and "[" not in t),
                 _NUMBER.filter(lambda t: ":" not in t and "nan" not in t), _QUOTED)
_FLOW_ITEM = st.one_of(_NUMBER.filter(lambda t: ":" not in t), _QUOTED,
                       _PLAIN.filter(lambda t: not set(t) & set(",[]{}:#")))


def _flow(depth=0):
    items = _FLOW_ITEM if depth else st.one_of(_FLOW_ITEM, st.deferred(lambda: _flow(1)))
    return st.lists(items, max_size=4).map(lambda xs: "[" + ", ".join(xs) + "]")


_NODE = st.recursive(
    st.one_of(_SCALAR, _flow(), st.just("{}")),
    lambda inner: st.one_of(
        st.lists(st.tuples(_KEY, inner), min_size=1, max_size=4).map(lambda kv: ("map", kv)),
        st.lists(inner, min_size=1, max_size=4).map(lambda xs: ("seq", xs))),
    max_leaves=12)


def _render(node, indent, draw) -> list:
    """Block lines of a map or sequence node at ``indent``, the styles drawn."""
    pad = " " * indent
    kind, items = node
    out = []
    comment = lambda: draw(st.sampled_from(["", "", "  # note", " #x"]))   # noqa: E731
    for item in items:
        key, value = item if kind == "map" else (None, item)
        lead = f"{pad}{key}:" if kind == "map" else f"{pad}-"
        if isinstance(value, str):
            out.append(f"{lead} {value}{comment() if value[0] not in '[{' else ''}")
            continue
        step = draw(st.sampled_from([2, 4]))
        if kind == "seq" and draw(st.booleans()):
            # the node's first line on the dash's line
            sub = _render(value, indent + 2, draw)
            sub[0] = f"{pad}- {sub[0][indent + 2:]}"
            out += sub
            continue
        out.append(lead + comment())
        same = kind == "map" and value[0] == "seq" and draw(st.booleans())
        out += _render(value, indent if same else indent + step, draw)
        if draw(st.booleans()):
            out.append(draw(st.sampled_from(["", "# between", "   # indented comment"])))
    return out


@FAST
@given(st.data())
def test_generated_documents_read_as_pyyaml_reads_them(data):
    node = data.draw(_NODE)
    text = node if isinstance(node, str) else "\n".join(_render(node, 0, data.draw)) + "\n"
    _same(Y.load(text), yaml.safe_load(text))


# -- the writer ------------------------------------------------------------------------

_TEXT = st.text(st.characters(blacklist_categories=("Cs",)), max_size=12)
_VALUE = st.recursive(
    st.one_of(st.none(), st.booleans(), st.integers(-10**12, 10**12),
              st.floats(allow_nan=False), _TEXT),
    lambda inner: st.one_of(
        st.lists(inner, max_size=4),
        st.lists(inner, max_size=3).map(tuple),
        st.dictionaries(st.one_of(_TEXT, st.integers(-99, 99), st.booleans()), inner,
                        max_size=4)),
    max_leaves=16)


def _as_loaded(v):
    """What a dumped value reads back as: tuples become lists."""
    if isinstance(v, dict):
        return {k: _as_loaded(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_as_loaded(x) for x in v]
    return v


@FAST
@given(_VALUE)
def test_dump_reads_back_equal_through_both_readers(value):
    text = Y.dump(value)
    want = _as_loaded(value)
    _same(Y.load(text), want)
    _same(yaml.safe_load(text), want)


def test_save_yaml_reads_back_equal_through_both(tmp_path):
    """Every config tree (tuples, nested dataclasses, lists of stages) writes
    YAML that PyYAML and the port read back to the same dict."""
    cascade = tc.CascadeConfig.from_yaml(REPO / "configs" / "cascade.yaml")
    for cfg in (tc.ServingConfig(), tc.TrainingConfig(), tc.SystemConfig(), cascade,
                tc.ServingConfig(cascade=cascade)):
        path = tmp_path / f"{type(cfg).__name__}.yaml"
        cfg.save_yaml(path)
        want = _as_loaded(cfg.to_dict())
        _same(yaml.safe_load(path.read_text()), want)
        _same(Y.load(path.read_text()), want)
        assert type(cfg).from_yaml(path).to_dict() == cfg.to_dict()


# -- outside the subset ------------------------------------------------------------------


@pytest.mark.parametrize("text, line", [
    ("a: 1\nb: &x 2\n", 2),
    ("a: *x\n", 1),
    ("a: !!str 1\n", 1),
    ("a: |\n  text\n", 1),
    ("a: >\n  text\n", 1),
    ("a: 1\nb: one\n  two\n", 3),
    ("a: [1,\n  2]\n", 1),
    ("a: {b: 1}\n", 1),
    ("a: 2001-12-14\n", 1),
    ("---\na: 1\n", 1),
    ("a: b: c\n", 1),
    ("a:\n\t- 1\n", 2),
    ("<<: {}\n", 1),
    ("? a\n: b\n", 1),
    ("a: 'open\n", 1),
    ("a: 1\n- 2\n", 2),
])
def test_outside_the_subset_raises_with_the_line(text, line):
    with pytest.raises(ConfigurationError, match=rf"YAML line {line}:"):
        Y.load(text)


def test_from_yaml_names_the_file_and_line(tmp_path):
    path = tmp_path / "bad.yaml"
    path.write_text("server:\n  port: &p 1\n")
    with pytest.raises(ConfigurationError, match=r"bad YAML in .*bad\.yaml: YAML line 2"):
        tc.ServingConfig.from_yaml(path)
