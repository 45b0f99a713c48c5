"""scripts/torch_load_bench.py on the CPU over three TINY128 tiers: open-loop
arrivals against the scheduled cascade, prefetch off and on; every request
finishes with no error, no pass uses a bucket the warm-up missed, and the
report has LOADBENCH_r05.json's keys (read, never written) plus the port's
own: ``device``, ``n_train`` and each pass's wall and dispatch shares."""

import importlib.util
import json
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
torch.set_num_threads(2)


def test_load_bench_twin(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "torch_load_bench", REPO / "scripts" / "torch_load_bench.py")
    twin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(twin)
    args = twin.parse_args(["--device", "cpu", "--n", "6", "--rate", "20", "--n-train", "8",
                            "--lanes", "4", "--out", str(tmp_path / "lb.json")])
    report = twin.run(args, progress=lambda m: None)
    ref = json.loads((REPO / "LOADBENCH_r05.json").read_text())
    assert set(report) == set(ref) | {"device", "n_train"}
    assert len(report["passes"]) == 2
    for p, rp in zip(report["passes"], ref["passes"]):
        assert set(p) == set(rp) | {"wall_s", "dispatch_share_per_tier",
                                    "admission_share_per_tier"}
        assert p["errors"] == 0 and p["cold_graph_buckets"] == []
        assert p["preemptions"] == 0
        assert sum(p["stage_distribution"]) == pytest.approx(1.0, abs=1e-2)
        for shares, disp in zip(p["dispatch_share_per_tier"], p["dispatch_per_tier"]):
            assert set(shares) == set(disp)
        assert p["admission_share_per_tier"] == [
            round(s["admit"] + s["verify"], 4) for s in p["dispatch_share_per_tier"]]
    assert report["passes"][0]["dispatch_per_tier"][0]["admit"]["n"] >= 1
