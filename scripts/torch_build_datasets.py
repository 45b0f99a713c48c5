#!/usr/bin/env python
"""Rebuild the frozen evaluation suites and check them against ``data/`` (the
twin of ``scripts/build_datasets.py``). The item tables come from that
script, whose module imports only numpy; the self-validation runs the port's
scorers (``evalx/datasets.py``): every canonical code solution must pass its
own tests, and every math answer must round-trip through ``score_math``.

By default the rebuilt JSON must equal the committed ``data/*.json`` byte for
byte; a difference exits non-zero. ``--out-dir DIR`` writes the files there
instead (never into ``data/``).

    python scripts/torch_build_datasets.py                 # check data/
    python scripts/torch_build_datasets.py --out-dir /tmp/suites
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

DATA = REPO / "data"
FILES = ("factual_qa.json", "gsm_style.json", "humaneval_style.json")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out-dir", default="", help="write the suites here instead of checking")
    return ap.parse_args(argv)


def _tables():
    spec = importlib.util.spec_from_file_location("build_datasets",
                                                  REPO / "scripts" / "build_datasets.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(args: argparse.Namespace, say=print) -> dict:
    from adaptive_sd_tpu_torch.core.device import describe_device
    from adaptive_sd_tpu_torch.evalx.datasets import _run_code_tests, score_math

    out_dir = pathlib.Path(args.out_dir).resolve() if args.out_dir else None
    if out_dir is not None and out_dir == DATA.resolve():
        raise SystemExit("--out-dir must not be data/: the committed suites are only checked")
    tables = _tables()
    factual, gsm, code = tables.build_factual(), tables.build_gsm(), tables.build_code()
    for it in code:
        rate = _run_code_tests(it["answer"], it["tests"], it["entry"])
        if rate != 1.0:
            raise SystemExit(f"canonical solution fails its tests: {it['id']}")
    for it in gsm:
        if score_math(f"The answer is {it['answer']}.", it["answer"]) != 1.0:
            raise SystemExit(f"math answer does not round-trip: {it['id']}")

    report = {"mode": "write" if out_dir else "check", "files": {}}
    for name, items in zip(FILES, (factual, gsm, code)):
        blob = json.dumps(items, indent=1).encode()
        row = {"items": len(items), "sha256": hashlib.sha256(blob).hexdigest()}
        if out_dir is None:
            row["equal_to_committed"] = (DATA / name).read_bytes() == blob
            say(f"checked data/{name}: {len(items)} items, "
                f"{'equal' if row['equal_to_committed'] else 'DIFFERENT'}")
        else:
            out_dir.mkdir(parents=True, exist_ok=True)
            (out_dir / name).write_bytes(blob)
            say(f"wrote {out_dir / name}: {len(items)} items")
        report["files"][name] = row
    report["device"] = describe_device("cpu")
    return report


def main(argv=None) -> int:
    report = run(parse_args(argv))
    if report["mode"] == "check" and not all(r["equal_to_committed"]
                                             for r in report["files"].values()):
        print("the rebuilt suites differ from data/", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
