"""Frozen offline evaluation datasets with objective scoring.

Role parity: the reference's dataset setup + real-task scoring
(``experiments/final/setup_datasets.py:20-212`` downloads MMLU/HumanEval;
``experiments/evaluate_pipeline.py:115-188`` loads and scores them). This
environment has no network, so the suites are VENDORED under ``data/``
(VERDICT round-1 #3):

* ``factual-qa``   — hand-authored multiple-choice questions over objective,
  verifiable facts (MMLU-style breadth: geography, science, math, CS,
  history). Scoring: answer-option/keyword match.
* ``gsm-style``    — genuine multi-step arithmetic word problems generated
  from templates with exact integer answers (the generator is committed,
  the sampled set frozen). Scoring: final-number extraction == answer.
* ``humaneval-style`` — small Python programming tasks: signature + spec +
  hidden unit tests + a canonical solution (validates the harness).
  Scoring: candidate code executed against the tests in a restricted
  namespace (pass rate).

Each dataset is real in the sense that matters for quality measurement: the
scoring function computes objective correctness of a model's answer, not
similarity to a synthetic string. (The items are locally authored/generated
rather than copies of the MMLU/GSM8K/HumanEval distributions — those cannot
be fetched here; nothing is vendored from third-party datasets.)
"""

from __future__ import annotations

import json
import pathlib
import re
import subprocess
import sys
import textwrap
from typing import Optional, Sequence

from .sweep import EvalSample

DATA_DIR = pathlib.Path(__file__).resolve().parents[2] / "data"
FROZEN = {
    "factual-qa": "factual_qa.json",
    "gsm-style": "gsm_style.json",
    "humaneval-style": "humaneval_style.json",
}


def available() -> list[str]:
    return sorted(FROZEN)


def load_frozen(name: str, data_dir: Optional[str] = None) -> list[dict]:
    """Raw frozen items (dicts with prompt/answer/task plus per-task extras)."""
    base = pathlib.Path(data_dir) if data_dir else DATA_DIR
    try:
        fname = FROZEN[name]
    except KeyError as exc:
        raise KeyError(f"unknown frozen dataset {name!r}; have {available()}") from exc
    with open(base / fname) as f:
        return json.load(f)


def load_samples(name: str, n: Optional[int] = None,
                 data_dir: Optional[str] = None) -> list[EvalSample]:
    """Frozen items as EvalSamples (prompt/reference/task) for the sweep
    harness; ``reference`` carries the objective answer."""
    items = load_frozen(name, data_dir)
    if n is not None:
        items = items[:n]
    return [
        EvalSample(prompt=it["prompt"], reference=str(it["answer"]),
                   task=it["task"])
        for it in items
    ]


# ---------------------------------------------------------------------------
# objective scoring

_NUM_RE = re.compile(r"-?\d+(?:\.\d+)?")
# explicit answer declarations beat incidental numbers/letters in prose
_DECL_NUM_RE = re.compile(
    r"(?:answer|result|total|remainder|final(?:\s+number)?)\s*(?:is|=|:)?\s*"
    r"\$?(-?\d[\d,]*(?:\.\d+)?)",
    re.I,
)
_DECL_LETTER_RE = re.compile(
    r"(?:answer|option|choice)\s*(?:is|=|:)?\s*\(?([A-D])\)?\b", re.I
)
_LETTER_RE = re.compile(r"(?<![A-Za-z])\(?([A-D])\)?(?![A-Za-z])")
_NEGATED_LETTER_RE = re.compile(r"\bnot\s+\(?([A-D])\)?\b", re.I)


def _last_number(text: str) -> Optional[float]:
    nums = _NUM_RE.findall(text.replace(",", ""))
    return float(nums[-1]) if nums else None


def _declared_number(text: str) -> Optional[float]:
    decls = _DECL_NUM_RE.findall(text)
    return float(decls[-1].replace(",", "")) if decls else None


def score_math(candidate: str, answer: str) -> float:
    """1.0 iff the candidate's answer equals the exact target. An explicit
    declaration ("the answer is 42") wins over incidental numbers; otherwise
    the FINAL number is the claim (models conclude with their answer, and
    work-showing puts intermediates first)."""
    got = _declared_number(candidate)
    if got is None:
        got = _last_number(candidate)
    want = _last_number(answer)
    if got is None or want is None:
        return 0.0
    return float(abs(got - want) < 1e-6)


def score_choice(candidate: str, item: dict) -> float:
    """Multiple choice. Precedence (hardened against adversarial prose —
    "not A; the answer is B", restated wrong options, letters inside words):

    1. an explicit declaration ("answer/option/choice is X") — last one wins;
    2. otherwise the LAST standalone letter token, skipping negated ones
       ("not A");
    3. otherwise a UNIQUE option-text match (two option texts quoted -> 0).
    """
    cand = candidate.strip()
    correct_letter = item["answer"].strip().upper()
    decls = _DECL_LETTER_RE.findall(cand)
    if decls:
        return float(decls[-1].upper() == correct_letter)
    negated = {m.upper() for m in _NEGATED_LETTER_RE.findall(cand)}
    letters = [m.upper() for m in _LETTER_RE.findall(cand)
               if m.upper() not in negated]
    if letters:
        return float(letters[-1] == correct_letter)
    low = cand.lower()
    matches = [j for j, opt in enumerate(item["options"]) if opt.lower() in low]
    if len(matches) == 1:
        return float(matches[0] == ord(correct_letter) - ord("A"))
    return 0.0


_RUNNER = textwrap.dedent("""
    import json, sys
    payload = json.loads(sys.stdin.read())
    safe = {k: __builtins__[k] if isinstance(__builtins__, dict)
            else getattr(__builtins__, k)
            for k in ("abs", "all", "any", "bool", "chr", "dict", "enumerate",
                      "filter", "float", "int", "len", "list", "map", "max",
                      "min", "ord", "range", "reversed", "round", "set",
                      "sorted", "str", "sum", "tuple", "zip", "isinstance",
                      "ValueError", "TypeError", "Exception", "AssertionError")}
    ns = {"__builtins__": safe}
    try:
        exec(compile(payload["code"], "<candidate>", "exec"), ns)
    except Exception:
        print(json.dumps({"rate": 0.0})); sys.exit(0)
    if payload["entry"] not in ns:
        print(json.dumps({"rate": 0.0})); sys.exit(0)
    passed = 0
    for t in payload["tests"]:
        try:
            exec(compile(t, "<test>", "exec"), ns)
            passed += 1
        except Exception:
            pass
    print(json.dumps({"rate": passed / max(len(payload["tests"]), 1)}))
""")


def _run_code_tests(code: str, tests: Sequence[str], entry: str,
                    timeout_s: float = 10.0) -> float:
    """Execute candidate code + asserts in a SUBPROCESS with a restricted
    builtins namespace and a hard wall-clock timeout; returns the fraction
    of tests passing. The subprocess contains side effects a model's code
    can have that an in-process exec cannot survive: infinite loops
    (timeout kills them), sys.exit, recursion blowups, allocator abuse."""
    try:
        proc = subprocess.run(
            # -S skips site/sitecustomize (a site hook may import heavy
            # packages at every interpreter start — seconds per scored item)
            [sys.executable, "-S", "-c", _RUNNER],
            input=json.dumps({"code": code, "tests": list(tests),
                              "entry": entry}),
            capture_output=True, text=True, timeout=timeout_s,
        )
        return float(json.loads(proc.stdout.strip() or '{"rate": 0}')["rate"])
    except (subprocess.TimeoutExpired, json.JSONDecodeError,
            ValueError, KeyError):
        return 0.0


def score_code(candidate: str, item: dict) -> float:
    """Extract the candidate's code (fenced block if present) and run the
    item's unit tests."""
    m = re.search(r"```(?:python)?\n(.*?)```", candidate, re.S)
    code = m.group(1) if m else candidate
    return _run_code_tests(code, item["tests"], item["entry"])


def score_item(item: dict, candidate: str) -> float:
    """Objective score in [0, 1] for a model answer to a frozen item."""
    task = item["task"]
    if task == "math":
        return score_math(candidate, str(item["answer"]))
    if task == "factual":
        return score_choice(candidate, item)
    if task == "code":
        return score_code(candidate, item)
    raise ValueError(f"no objective scorer for task {task!r}")


def evaluate_answers(name: str, candidates: Sequence[str],
                     data_dir: Optional[str] = None) -> dict:
    """Score a candidate answer per frozen item; returns aggregate accuracy
    plus per-task breakdown (the number quality-preservation claims divide)."""
    items = load_frozen(name, data_dir)
    if len(candidates) != len(items):
        raise ValueError(
            f"{len(candidates)} candidates for {len(items)} items in {name}"
        )
    scores = [score_item(it, c) for it, c in zip(items, candidates)]
    return {
        "dataset": name,
        "n": len(items),
        "accuracy": sum(scores) / max(len(scores), 1),
        "scores": scores,
    }
