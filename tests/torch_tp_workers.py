"""Rank bodies of the tensor-parallel parity tests (tests/test_torch_tp.py).

Spawned processes import this module by name, so it imports neither JAX
nor the JAX package: the parent computes the JAX references and hands the
weights and inputs over as numpy. Each world size runs every check in ONE
spawn; each rank returns a dict of numpy results that the tests hold
against the JAX package (and compare across ranks).
"""

from __future__ import annotations

from unittest import mock

import numpy as np
import torch
import torch.distributed as dist

from adaptive_sd_tpu_torch.engine import ContinuousBatchingScheduler, TierEngine
from adaptive_sd_tpu_torch.engine.decode import _param_bytes
from adaptive_sd_tpu_torch.models import ModelSpec, params_from_jax
from adaptive_sd_tpu_torch.models.qwen_tp import (
    make_tp_forward,
    prepare_tp_params,
    shard_cache_tp,
)
from adaptive_sd_tpu_torch.ops import QuantizedTensor, linear_q
from adaptive_sd_tpu_torch.ops.sharded import (
    shard_weight_column,
    shard_weight_row,
    tp_linear_column,
    tp_linear_row,
    tp_mlp_block,
)
from adaptive_sd_tpu_torch.core.exceptions import ShardingError
from adaptive_sd_tpu_torch.parallel import (
    build_mesh,
    build_multihost_mesh,
    overlap,
    plan_tier_placements,
)
from adaptive_sd_tpu_torch.parallel.host_memory import HostMemoryCollectives
from adaptive_sd_tpu_torch.predict import inline as tinline
from adaptive_sd_tpu_torch.predict import predictor_from_jax

PAGE = 16


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _qt(triple) -> QuantizedTensor:
    q, s, bits = triple
    return QuantizedTensor(_t(q), _t(s), bits)


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().numpy().copy()


# ---------------------------------------------------------------------------
# sharded ops


def _ops(mesh, d: dict) -> dict:
    """Column, row, the MLP block and the column-then-row pair on this
    rank's shards, every output whole (column outputs gathered)."""
    tp = mesh.tp
    x = _t(d["x"])
    out = {}
    for name, w in d["weights"].items():
        t = _qt(w)
        col = tp_linear_column(x, shard_weight_column(t, mesh), mesh)
        out[f"col/{name}"] = _np(tp.all_gather_last(col))
        k_loc = x.shape[1] // tp.size
        x_loc = x[:, tp.rank * k_loc:(tp.rank + 1) * k_loc]
        out[f"row/{name}"] = _np(tp_linear_row(x_loc, shard_weight_row(t, mesh), mesh))
    g, u, dn = (_qt(d["mlp"][k]) for k in ("gate", "up", "down"))
    out["mlp"] = _np(tp_mlp_block(_t(d["mlp_x"]), shard_weight_column(g, mesh),
                                  shard_weight_column(u, mesh), shard_weight_row(dn, mesh), mesh))
    t_col, t_row = _qt(d["weights"]["int8"]), _qt(d["pair_row"])
    y = tp_linear_column(x, shard_weight_column(t_col, mesh), mesh)
    out["pair"] = _np(tp_linear_row(y, shard_weight_row(t_row, mesh), mesh))
    return out


def _w8a8_row(mesh, d: dict) -> np.ndarray:
    """Row-parallel W8A8: each rank quantizes its own K slice of x."""
    tp = mesh.tp
    x, t = _t(d["x"]), _qt(d["w"])
    k_loc = x.shape[1] // tp.size
    x_loc = x[:, tp.rank * k_loc:(tp.rank + 1) * k_loc]
    return _np(tp_linear_row(x_loc, shard_weight_row(t, mesh), mesh, act_quant=True))


def _overlap(mesh, d: dict) -> dict:
    """The ring against the all_reduce ending on the same row shards, for
    each weight of ``d["ring"]`` (raw f32 or quantized, already laid out
    shard-local along K)."""
    tp = mesh.tp
    x = _t(d["ring_x"])
    k_loc = x.shape[1] // tp.size
    x_loc = x[:, tp.rank * k_loc:(tp.rank + 1) * k_loc]
    out = {}
    for name, w in d["ring"].items():
        if isinstance(w, tuple):
            t = _qt(w)
            t = QuantizedTensor(t.q.narrow(0, tp.rank * t.q.shape[0] // tp.size,
                                           t.q.shape[0] // tp.size).contiguous(),
                                t.scale if t.scale.ndim == 1 else t.scale.narrow(
                                    0, tp.rank * t.scale.shape[0] // tp.size,
                                    t.scale.shape[0] // tp.size).contiguous(), t.bits)
        else:
            t = _t(w).narrow(0, tp.rank * k_loc, k_loc).contiguous()

        def lin(xx, ww):
            if isinstance(ww, QuantizedTensor):
                return linear_q(xx, ww)
            return torch.matmul(xx, ww)

        chunks = overlap.split_columns(t, tp.size)
        out[f"ring/{name}"] = _np(overlap.ring_row_parallel(x_loc, chunks, tp, lin))
        out[f"psum/{name}"] = _np(overlap.row_parallel_reduce(x_loc, t, tp, lin))
        out[f"psum_chunks/{name}"] = _np(overlap.row_parallel_reduce(x_loc, chunks, tp, lin))
    return out


def _host_memory(mesh) -> dict:
    """The host-memory collectives on CPU tensors beside gloo's: sums (f32
    and bf16) and gathers of several sizes in a row, so that each rank's
    two slots are taken by turns and reused; which payloads fit a slot;
    and a run of sums with nothing else between them."""
    tp = mesh.tp
    hm = HostMemoryCollectives(tp.group, tp.ranks, tp.rank, slot_bytes=1 << 16)
    rng = np.random.default_rng(100 + tp.rank)
    out = {k: [] for k in ("sum", "order_sum", "gloo_sum", "gather", "gloo_gather")}
    for rows, dtype in [(1, torch.float32), (3, torch.bfloat16), (7, torch.float32),
                        (2, torch.float32), (5, torch.bfloat16)]:
        x = torch.from_numpy(rng.normal(size=(rows, 24)).astype(np.float32)).to(dtype)
        out["sum"].append(_np(hm.all_reduce(x.clone())))
        g = x.clone()
        dist.all_reduce(g, group=tp.group)
        out["gloo_sum"].append(_np(g))
        parts = [torch.empty_like(x) for _ in tp.ranks]
        dist.all_gather(parts, x, group=tp.group)
        acc = parts[0].clone()
        for p in parts[1:]:
            acc += p
        out["order_sum"].append(_np(acc))
        out["gloo_gather"].append(_np(torch.cat(parts, dim=-1)))
        out["gather"].append(_np(hm.all_gather_last(x)))
    out["fits"] = [hm.fits(torch.empty(1 << 14)), hm.fits(torch.empty((1 << 14) + 1))]
    # 200 sums in a row with no other collective between them, so a rank may
    # run ahead into its next slot: every rank makes every rank's input from
    # a seed and checks each sum itself
    out["stress_mismatches"] = 0
    for i in range(200):
        xs = [torch.from_numpy(np.random.default_rng((i, r)).normal(size=(1 + i % 5, 8))
                               .astype(np.float32)) for r in range(tp.size)]
        want = xs[0].clone()
        for x in xs[1:]:
            want += x
        out["stress_mismatches"] += not torch.equal(hm.all_reduce(xs[tp.rank].clone()), want)
    return out


# ---------------------------------------------------------------------------
# forward


def _forward(spec: ModelSpec, mesh, params_np, d: dict, *, overlap_collectives=False,
             count_rings=False) -> dict:
    """prefill (with hidden), one decode step, a window after them and its
    logits, on this rank's shard; ``count_rings`` also counts the ring
    calls of each pass and the weight slices cut while the passes run."""
    params = prepare_tp_params(params_np, spec, mesh, overlap_collectives=overlap_collectives)
    cache = shard_cache_tp(spec, mesh, 32, PAGE, device="cpu")
    fwd = make_tp_forward(spec, mesh, overlap_collectives=overlap_collectives)
    toks, lens, tables = _t(d["toks"]), _t(d["seq_lens"]), _t(d["tables"])
    rings = {}
    with mock.patch.object(overlap, "ring_row_parallel",
                           wraps=overlap.ring_row_parallel) as ring, \
            mock.patch.object(overlap, "_slice_out", wraps=overlap._slice_out) as cut:
        logits, _, h = fwd.prefill(params, spec, toks, lens, cache, tables, return_hidden=True)
        rings["prefill"] = ring.call_count
        nxt = logits.argmax(-1).to(torch.int32)
        logits2, _ = fwd.decode_step(params, spec, nxt, lens, cache, tables)
        rings["decode"] = ring.call_count - rings["prefill"]
        hw, _ = fwd.prefill_window(params, spec, _t(d["win_toks"]), lens + 1,
                                   _t(d["win_lens"]), cache, tables)
        rings["window"] = ring.call_count - rings["prefill"] - rings["decode"]
        rings["weight_slices"] = cut.call_count
    out = {"logits": _np(logits), "h": _np(h), "logits2": _np(logits2), "hw": _np(hw),
           "logits_w": _np(fwd.logits_at(params, spec, hw))}
    if count_rings:
        out["rings"] = rings
    return out


# ---------------------------------------------------------------------------
# engine and scheduler


def _engine_outputs(spec, mesh, params_np, d: dict, *, prefix_cache=False) -> dict:
    """An engine over ``mesh`` built from the whole model's host (numpy)
    tree: its tokens, logprobs, verify, and the bytes of the params it holds."""
    eng = TierEngine(spec, params_np, page_size=PAGE, n_pages=64, device="cpu", mesh=mesh,
                     enable_prefix_cache=prefix_cache)
    outs = eng.generate(d["prompts"], max_new=d["max_new"])
    res = {"tp_mode": eng.tp_mode,
           "kv_heads": int(eng.cache.k_pages[0].shape[0]),
           "param_bytes": _param_bytes(eng.params),
           "tokens": [o.token_ids.tolist() for o in outs],
           "logprobs": [o.logprobs.copy() for o in outs]}
    prompt = d["prompts"][0]
    drafts = [outs[0].token_ids[:4].tolist()]
    (vout, n_acc), = eng.verify_continue([prompt], drafts, max_new=d["max_new"])
    res["verify"] = (vout.token_ids.tolist(), int(n_acc))
    return res


def _scheduler(spec, mesh, params_np, d: dict) -> dict:
    params = params_from_jax(params_np, "cpu")
    eng = TierEngine(spec, params, page_size=PAGE, n_pages=64, device="cpu", mesh=mesh)
    prompt = d["prompts"][0]
    greedy = eng.generate([prompt], max_new=8)[0].token_ids.tolist()
    bad = list(greedy)
    bad[2] = (bad[2] + 1) % (spec.vocab_size - 1) + 1
    sched = ContinuousBatchingScheduler(eng, max_batch=2, max_context=64, scan_steps=3)
    r_plain = sched.submit(prompt, max_new=8)
    r_draft = sched.submit(prompt, max_new=8, draft=bad)
    sched.run_until_idle()
    return {"greedy": greedy, "plain": list(r_plain.out_tokens),
            "draft": list(r_draft.out_tokens), "n_accepted": int(r_draft.n_accepted)}


def _policy(spec, mesh, params_np, d: dict) -> dict:
    """generate_with_policy under tp, with an inline head made from the
    parent's arrays: the tokens and the escalation flags."""
    pol = d["policy"]
    params, mean, std = pol["arrays"]
    head = predictor_from_jax(params, mean, std, n_stages=4)
    policy = tinline.policy_from_predictor(head, pol["cum"], pol["priors"], pol["lam"])
    eng = TierEngine(spec, params_from_jax(params_np, "cpu"), page_size=PAGE, n_pages=64,
                     device="cpu", mesh=mesh)
    outs, esc, _ = eng.generate_with_policy(d["prompts"], policy, 0, max_new=d["max_new"])
    return {"tokens": [o.token_ids.tolist() for o in outs], "escalate": esc.tolist()}


def _graphs_refused(spec, mesh, params_np) -> str:
    """A tensor-parallel engine on CUDA asked for CUDA graphs over gloo
    raises before it touches the card (here the device is only claimed)."""
    params = params_from_jax(params_np, "cpu")
    with mock.patch("adaptive_sd_tpu_torch.engine.decode.resolve_device",
                    return_value=torch.device("cuda")):
        try:
            TierEngine(spec, params, page_size=PAGE, n_pages=64, device="cuda", mesh=mesh)
        except ValueError as exc:
            return str(exc)
    return ""


def world2(rank: int, device, d: dict) -> dict:
    mesh = build_mesh(dp=1, tp=2)
    out = {"rank": rank, "coords": mesh.coords, "ops": _ops(mesh, d["ops"]),
           "w8a8": _w8a8_row(mesh, d["w8a8"]), "overlap": _overlap(mesh, d["ops"]),
           "host_memory": _host_memory(mesh)}
    spec = d["spec"]
    out["forward"] = {name: _forward(spec, mesh, p, d["fwd"]) for name, p in d["params"].items()}
    out["forward_overlap"] = _forward(spec, mesh, d["params"]["int8_fused"], d["fwd"],
                                      overlap_collectives=True, count_rings=True)
    eng_p = d["params"]["int8_fused"]
    out["engine"] = _engine_outputs(spec, mesh, eng_p, d["engine"])
    out["engine_prefix"] = _engine_outputs(spec, mesh, eng_p, d["engine"], prefix_cache=True)
    out["scheduler"] = _scheduler(spec, mesh, eng_p, d["engine"])
    out["policy"] = _policy(spec, mesh, eng_p, d["engine"])
    out["graphs_refused"] = _graphs_refused(spec, mesh, eng_p)
    return out


def world4(rank: int, device, d: dict) -> dict:
    tp4 = build_mesh(dp=1, tp=4)
    dp2 = build_mesh(dp=2, tp=2)
    # two equal tiers over four ranks: each gets two (tp 2); every rank
    # builds both tiers' meshes and belongs to one
    tiers = {p.name: p.mesh() for p in plan_tier_placements(["a", "b"], [1 << 30] * 2, 4)}
    multihost = build_multihost_mesh(dp=1, tp=2)
    try:
        build_mesh(dp=1, tp=3)
        mismatch = ""
    except ShardingError as exc:
        mismatch = str(exc)
    out = {"rank": rank, "coords_dp2": dp2.coords, "ops": _ops(tp4, d["ops"]),
           "tiers": {k: (m.coords, m.tp.ranks) if m is not None else None
                     for k, m in tiers.items()},
           "multihost": (multihost.shape, multihost.coords), "mismatch": mismatch,
           "overlap": _overlap(tp4, d["ops"]), "host_memory": _host_memory(tp4)}
    spec, eng_p = d["spec"], d["params"]["int8_fused"]
    out["dp2"] = _engine_outputs(spec, dp2, eng_p, d["engine"])
    out["fallback"] = _engine_outputs(spec, tp4, eng_p, d["engine"])
    out["kv4"] = _engine_outputs(d["spec_kv4"], tp4, d["params_kv4"], d["engine"])
    return out
