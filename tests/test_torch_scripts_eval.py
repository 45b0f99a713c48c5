"""scripts/torch_trained_cascade_eval.py at --quick on the CPU, cut to four
items a suite and a few training steps: it trains, saves and loads three
tiers, selects lambda and reports with TRAINED_CASCADE.json's keys (read,
never written) plus ``device``; its INT4 tiers 0-1 take per-channel INT4
(K = 96 and 160)."""

import importlib.util
import json
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
torch.set_num_threads(2)


def test_trained_cascade_eval_twin_writes_the_jax_report_keys(tmp_path, monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "torch_trained_cascade_eval", REPO / "scripts" / "torch_trained_cascade_eval.py")
    twin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(twin)
    full = twin.load_frozen
    monkeypatch.setattr(twin, "load_frozen", lambda name: full(name)[:4])
    from adaptive_sd_tpu_torch.ops import matmul_q

    seen = []
    ref_fn = matmul_q.quantized_matmul_ref

    def spy(x, q, scale, *, bits=8, out_dtype=None):
        seen.append((bits, scale.ndim))
        return ref_fn(x, q, scale, bits=bits, out_dtype=out_dtype)

    monkeypatch.setattr(matmul_q, "quantized_matmul_ref", spy)
    args = twin.parse_args(["--quick", "--device", "cpu", "--steps-scale", "0.05",
                            "--distract", "4", "--ckpt-dir", str(tmp_path / "ck"),
                            "--out", str(tmp_path / "tc.json")])
    report = twin.run(args, progress=lambda m: None)
    ref = json.loads((REPO / "TRAINED_CASCADE.json").read_text())
    assert set(report) == set(ref) | {"device"}
    assert report["n_sel"] == 4 and report["n_rep"] == 4 and report["quick"]
    assert [t["hidden"] for t in report["tiers"]] == [96, 160, 256]
    assert len(report["int4_answer_preservation_per_tier"]) == 3
    assert all(0.0 <= a <= 1.0 for a in report["int4_token_agreement_per_tier"])
    assert abs(sum(report["stage_distribution"]) - 1.0) < 1e-2
    assert (4, 1) in seen  # per-channel INT4 was taken
    assert all(Path(tmp_path / "ck" / f"stage{k}").is_dir() for k in range(3))
