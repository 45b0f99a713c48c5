"""The port's ContinuousBatchingScheduler against the JAX package's, each on
its own TierEngine over the same weights (``params_from_jax``): the same
submissions give the same tokens, accepted counts, preemption and swap
counts at temperature 0, logprobs to ``LP_ATOL``; sampled lanes are held in
distribution (support collected, top-p -> greedy). Parity cases of
tests/test_engine.py (scheduler, preemption, swap, device carry)."""

import time

import numpy as np
import pytest
import torch

from adaptive_sd_tpu.engine.scheduler import ContinuousBatchingScheduler as JScheduler
from adaptive_sd_tpu_torch.core.exceptions import ResourceError
from adaptive_sd_tpu_torch.engine import ContinuousBatchingScheduler, TierEngine
from adaptive_sd_tpu_torch.engine.scheduler import _fold
from adaptive_sd_tpu_torch.models import TINY
from tests.test_torch_common import engine_pair, tiny_weights

torch.set_num_threads(2)

PAGE = 16
# greedy logprobs: f32 log-softmax of logits that differ only by sum order,
# which now and then moves an INT8 KV value across a rounding boundary
LP_ATOL = 1e-3


@pytest.fixture(scope="module")
def weights():
    return tiny_weights(0)


@pytest.fixture(scope="module")
def roomy(weights):
    """Engines whose pool never runs out (one JAX engine for the module: its
    compiled graphs are reused by every test)."""
    return engine_pair(weights, n_pages=128)


@pytest.fixture(scope="module")
def tight(weights):
    """Engines with a 4-page pool: two lanes admit (2 pages each) and the
    pool runs out when decoding crosses a page boundary (prompt + 30 tokens
    need 3 pages a lane)."""
    return engine_pair(weights, n_pages=4)


def _both(pair, submissions, **kw):
    """Run the same submissions through both schedulers; returns
    ((JAX requests, JAX scheduler), (port requests, port scheduler))."""
    out = []
    for eng, cls in zip(pair, (JScheduler, ContinuousBatchingScheduler)):
        sched = cls(eng, **kw)
        reqs = [sched.submit(p, **skw) for p, skw in submissions]
        sched.run_until_idle()
        assert eng.allocator.stats().active_requests == 0
        out.append((reqs, sched))
    return out


def _f64_logprobs(params, spec, prompt, out_tokens) -> np.ndarray:
    """The greedy logprob of every output token recomputed in f64 from the
    same INT8 weights (dequantised exactly) and the same K/V rule: the prompt
    attends to its exact K/V, as the prefill does; each later position
    attends to K/V passed through ``quantize_kv_int8``'s rounding, in f64.
    A lane that was preempted and re-prefilled attended exactly once more at
    its re-admission step, which this reference does not follow."""
    D, half = spec.head_dim, spec.head_dim // 2
    group = spec.n_heads // spec.n_kv_heads
    freqs = spec.rope_theta ** (-torch.arange(half, dtype=torch.float64) / half)

    def mat(t):
        return t.q.double() * t.scale.double()[None, :]

    def norm(x, g):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + spec.rms_eps) * g.double()

    def rope(x, pos):  # x [S, H, D], pos [S]
        ang = pos.double()[:, None, None] * freqs
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * torch.cos(ang) - x2 * torch.sin(ang),
                          x2 * torch.cos(ang) + x1 * torch.sin(ang)], -1)

    def kv_round(x):
        scale = torch.clamp(x.abs().amax(-1) / 127.0, min=1e-8)
        return torch.clamp(torch.round(x / scale[..., None]), -127, 127) * scale[..., None]

    def forward(tokens, pos, caches, exact):
        h = params["embed"].double()[torch.as_tensor(tokens)]
        for li, la in enumerate(params["layers"]):
            x = norm(h, la["input_norm"])
            qkv = x @ mat(la["qkv_proj"]) + la["qkv_bias"].double()
            nq, nkv = spec.n_heads * D, spec.n_kv_heads * D
            q = rope(qkv[:, :nq].reshape(-1, spec.n_heads, D), pos)
            k = rope(qkv[:, nq:nq + nkv].reshape(-1, spec.n_kv_heads, D), pos)
            v = qkv[:, nq + nkv:].reshape(-1, spec.n_kv_heads, D)
            ck, cv = caches[li]
            caches[li] = (torch.cat([ck, kv_round(k)]), torch.cat([cv, kv_round(v)]))
            keys, vals = (k, v) if exact else caches[li]
            keys = keys.repeat_interleave(group, dim=1)
            vals = vals.repeat_interleave(group, dim=1)
            att = torch.einsum("qhd,khd->hqk", q, keys) / np.sqrt(D)
            n_k = keys.shape[0]
            causal = pos[:, None] >= torch.arange(n_k)[None, :] + (pos[0] if exact else 0)
            att = torch.where(causal[None], att, torch.tensor(-np.inf, dtype=torch.float64))
            o = torch.einsum("hqk,khd->qhd", torch.softmax(att, -1), vals).reshape(len(tokens), -1)
            h = h + o @ mat(la["o_proj"])
            gu = norm(h, la["post_norm"]) @ mat(la["gateup_proj"])
            h = h + (torch.nn.functional.silu(gu[:, :spec.ffn]) * gu[:, spec.ffn:]) @ mat(
                la["down_proj"])
        h = norm(h[-1:], params["final_norm"])
        head = params["embed"].double().T if spec.tie_embeddings else mat(params["lm_head"])
        return torch.log_softmax(h @ head, -1)[0]

    caches = [(torch.zeros(0, spec.n_kv_heads, D, dtype=torch.float64),) * 2
              for _ in params["layers"]]
    lp = forward(list(prompt), torch.arange(len(prompt)), caches, exact=True)
    out = [float(lp[out_tokens[0]])]
    for i, tok in enumerate(out_tokens[:-1]):
        lp = forward([tok], torch.tensor([len(prompt) + i]), caches, exact=False)
        out.append(float(lp[out_tokens[i + 1]]))
    return np.asarray(out)


def _which_side_moved(j_lps, t_lps, ref_lps, note="") -> str:
    """The steps whose logprobs differ by more than LP_ATOL, each package's
    distance from the f64 recomputation there, and the side farther from it."""
    j_lps, t_lps = np.asarray(j_lps), np.asarray(t_lps)
    bad = np.flatnonzero(np.abs(t_lps - j_lps) > LP_ATOL)
    d_jax, d_port = np.abs(j_lps - ref_lps)[bad], np.abs(t_lps - ref_lps)[bad]
    side = ("the port moved" if d_port.max() > d_jax.max()
            else "the JAX package moved" if d_jax.max() > d_port.max() else "both moved")
    rows = ", ".join(f"step {i}: jax {j_lps[i]:.6f} port {t_lps[i]:.6f} f64 {ref_lps[i]:.6f}"
                     for i in bad)
    return (f"logprobs differ beyond LP_ATOL={LP_ATOL} at steps {bad.tolist()}; "
            f"distance from f64 jax {d_jax.max():.3g}, port {d_port.max():.3g}: {side}"
            f"{note} ({rows})")


def _same_requests(jreqs, treqs, diagnose=None):
    """``diagnose`` = (port params, spec): a logprob mismatch is reported
    against the f64 recomputation of each request (``_which_side_moved``)."""
    for j, t in zip(jreqs, treqs):
        assert t.done and j.done and t.error is None and j.error is None, (j.error, t.error)
        assert t.out_tokens == j.out_tokens
        if diagnose is not None and not np.allclose(t.out_logprobs, j.out_logprobs, rtol=0,
                                                    atol=LP_ATOL):
            ref = _f64_logprobs(*diagnose, t.prompt, t.out_tokens)
            pytest.fail(_which_side_moved(j.out_logprobs, t.out_logprobs, ref,
                                          f"; preemptions {t.preemptions}"))
        np.testing.assert_allclose(t.out_logprobs, j.out_logprobs, atol=LP_ATOL)
        assert t.n_accepted == j.n_accepted and t.preemptions == j.preemptions
        assert t.position == j.position and t.next_token == j.next_token


PROMPTS = [[3, 14, 15], [9, 2, 6, 5], [7, 8, 9, 1, 2], [4, 4], [11, 12, 13, 14, 15, 16, 17]]


@pytest.mark.parametrize("kw", [
    dict(), dict(scan_steps=4), dict(scan_steps=4, device_carry=False),
    dict(scan_steps=4, pipeline_scans=False),
], ids=["step", "scan_pipelined", "scan_legacy", "scan_carry"])
def test_more_requests_than_lanes_match_jax(roomy, kw):
    """Five requests with unequal budgets through two lanes: lanes are reused
    as requests retire; every dispatch flavour gives the fused output."""
    subs = [(p, dict(max_new=5 + 3 * i)) for i, p in enumerate(PROMPTS)]
    (jr, js), (tr, ts) = _both(roomy, subs, max_batch=2, max_context=64, **kw)
    _same_requests(jr, tr)
    tst, jst = ts.stats(), js.stats()
    fused = roomy[1].generate(PROMPTS[:2], max_new=8)
    assert tr[0].out_tokens == fused[0].token_ids.tolist()[:5]
    assert tr[1].out_tokens == fused[1].token_ids.tolist()
    for k in ("lanes", "occupied", "queued", "resume_queued", "steps", "completed",
              "preemptions", "preemption_mode", "swap_preemptions", "swap_bytes_held"):
        assert tst[k] == jst[k], k
    tst["allocator"].pop("peak_used"), jst["allocator"].pop("peak_used")  # engines are shared
    assert tst["allocator"] == jst["allocator"]
    assert tst["bucket_hits"] == jst["bucket_hits"] and tst["graph_buckets"] == jst["graph_buckets"]
    assert {k: v["n"] for k, v in tst["dispatch"].items()} == \
           {k: v["n"] for k, v in jst["dispatch"].items()}
    assert {k: v for k, v in tst["carry"].items()} == {k: v for k, v in jst["carry"].items()}


def test_staggered_admission_joins_a_running_batch(roomy):
    out = []
    for eng, cls in zip(roomy, (JScheduler, ContinuousBatchingScheduler)):
        sched = cls(eng, max_batch=2, max_context=64)
        a = sched.submit([1, 2], max_new=4)
        sched.step()                                   # a admitted and stepped alone
        b = sched.submit([7, 8, 9], max_new=4)         # joins mid-flight
        sched.run_until_idle()
        out.append([a, b])
    _same_requests(*out)
    want = [o.token_ids.tolist() for o in roomy[1].generate([[1, 2], [7, 8, 9]], max_new=4)]
    assert [r.out_tokens for r in out[1]] == want


def test_context_overflow_rejected(roomy):
    sched = ContinuousBatchingScheduler(roomy[1], max_batch=2, max_context=32)
    with pytest.raises(ResourceError):
        sched.submit(list(range(1, 30)), max_new=16)
    with pytest.raises(ValueError, match="preemption_mode"):
        ContinuousBatchingScheduler(roomy[1], max_batch=2, preemption_mode="page")


LONG = [[3, 14, 15, 9, 2, 6], [7, 8, 9, 1]]


@pytest.mark.parametrize("scan_steps", [1, 4])
@pytest.mark.parametrize("mode,budget", [("recompute", None), ("swap", None), ("swap", 0)],
                         ids=["recompute", "swap", "swap_budget0"])
def test_preempted_requests_complete_identically(roomy, tight, scan_steps, mode, budget):
    """KV-page pressure preempts the newest lane; it comes back by recompute
    or by a bit-exact swap restore (recompute again when the host budget is
    0) and finishes with the unpressured output. Counts equal the JAX
    scheduler's."""
    want = [o.token_ids.tolist() for o in roomy[1].generate(LONG, max_new=30)]
    kw = dict(max_batch=2, max_context=128, scan_steps=scan_steps, preemption_mode=mode)
    if budget is not None:
        kw["max_swap_bytes"] = budget
    subs = [(p, dict(max_new=30)) for p in LONG]
    (jr, js), (tr, ts) = _both(tight, subs, **kw)
    assert [r.out_tokens for r in tr] == want
    _same_requests(jr, tr, diagnose=(tight[1].params, TINY))
    assert ts.preemptions == js.preemptions >= 1
    assert ts.swap_preemptions == js.swap_preemptions
    assert (ts.swap_preemptions >= 1) == (mode == "swap" and budget is None)
    assert sum(r.preemptions for r in tr) == ts.preemptions
    assert ts.stats()["swap_bytes_held"] == 0 and ts.stats()["preemption_mode"] == mode
    n = {k: v["n"] for k, v in ts.stats()["dispatch"].items()}
    assert n == {k: v["n"] for k, v in js.stats()["dispatch"].items()}
    # a victim over the host budget is gathered, then dropped and recomputed
    assert n["swap_in"] == ts.swap_preemptions and n["swap_out"] >= n["swap_in"]
    assert (n["swap_out"] > n["swap_in"]) == (budget == 0)


def test_f64_recomputation_tracks_both_packages(roomy):
    """The diagnostic's reference: on an unpressured run each package's
    greedy logprobs lie within LP_ATOL of the f64 recomputation, and a
    logprob moved on one side is named as that side's."""
    (jr, _), (tr, _) = _both(roomy, [(p, dict(max_new=30)) for p in LONG], max_batch=2,
                             max_context=128)
    for j, t in zip(jr, tr):
        ref = _f64_logprobs(roomy[1].params, TINY, t.prompt, t.out_tokens)
        np.testing.assert_allclose(t.out_logprobs, ref, atol=LP_ATOL)
        np.testing.assert_allclose(j.out_logprobs, ref, atol=LP_ATOL)
        moved = np.asarray(t.out_logprobs)
        moved[5] += 3 * LP_ATOL
        assert "the port moved" in _which_side_moved(j.out_logprobs, moved, ref)
        assert "the JAX package moved" in _which_side_moved(moved, t.out_logprobs, ref)


def test_swap_budget_is_charged_with_the_blob_bytes(tight):
    """A victim's blob is sliced to its live pages and its ``nbytes`` are what
    the budget is charged: one byte less than that and it recomputes."""
    _, te = tight
    probe = ContinuousBatchingScheduler(te, max_batch=2, max_context=128,
                                        preemption_mode="swap")
    held = []
    real = te.swap_out_pages

    def spy(pages):
        blob = real(pages)
        held.append((len(pages), sum(int(b.nbytes) for b in blob)))
        return blob

    te.swap_out_pages = spy
    try:
        for p in LONG:
            probe.submit(p, max_new=30)
        probe.run_until_idle()
        n_pages, nbytes = held[0]
        per_page = TINY.n_layers * TINY.n_kv_heads * PAGE * (TINY.head_dim + 4) * 2
        assert nbytes == n_pages * per_page
        sched = ContinuousBatchingScheduler(te, max_batch=2, max_context=128,
                                            preemption_mode="swap", max_swap_bytes=nbytes - 1)
        for p in LONG:
            sched.submit(p, max_new=30)
        sched.run_until_idle()
        assert sched.preemptions >= 1 and sched.swap_preemptions == 0
    finally:
        te.swap_out_pages = real


def test_admission_waits_then_impossible_request_fails(tight):
    """Arrivals beyond the pool's capacity queue instead of erroring; a
    request that cannot fit even into an empty pool fails cleanly."""
    subs = [([i + 1, i + 2, i + 3], dict(max_new=20)) for i in range(5)]
    (jr, _), (tr, _) = _both(tight, subs, max_batch=4, max_context=128)
    _same_requests(jr, tr)
    assert all(len(r.out_tokens) == 20 for r in tr)
    sched = ContinuousBatchingScheduler(tight[1], max_batch=2, max_context=128)
    r = sched.submit(list(range(1, 81)), max_new=8)        # needs 6 pages, the pool has 4
    sched.run_until_idle()
    assert r.done and r.error is not None
    assert tight[1].allocator.stats().active_requests == 0


def test_priorities_admit_first_and_yield_first(roomy, tight):
    out = []
    for eng, cls in zip(roomy, (JScheduler, ContinuousBatchingScheduler)):
        sched = cls(eng, max_batch=1, max_context=64)
        lo = sched.submit([1, 2, 3], max_new=3, priority=0)
        hi = sched.submit([4, 5, 6], max_new=3, priority=5)
        sched.run_until_idle()
        assert hi.finished_at <= lo.finished_at
        out.append([lo, hi])
    _same_requests(*out)
    out = []
    for eng, cls in zip(tight, (JScheduler, ContinuousBatchingScheduler)):
        sched = cls(eng, max_batch=2, max_context=128)
        a = sched.submit(LONG[0], max_new=30, priority=0)
        b = sched.submit(LONG[1], max_new=30, priority=3)
        sched.run_until_idle()
        out.append([a, b])
    _same_requests(*out)
    assert out[1][0].preemptions >= 1 and out[1][1].preemptions == 0


@pytest.mark.parametrize("scan_steps", [1, 4])
def test_mixed_temperature_lanes(roomy, scan_steps):
    """Greedy and sampled requests share a batch: the greedy lane is exact,
    the sampled lanes collect their top-K support, a lane with a tiny top-p
    reduces to greedy."""
    _, te = roomy
    want = te.generate([[3, 14, 15], [3, 14, 15, 9]], max_new=8)
    sched = ContinuousBatchingScheduler(te, max_batch=4, max_context=64, spec_topk=8,
                                        scan_steps=scan_steps)
    g = sched.submit([3, 14, 15], max_new=8, temperature=0.0)
    s1 = sched.submit([9, 2, 6], max_new=8, temperature=1.0)
    s2 = sched.submit([5, 5], max_new=8, temperature=0.7, top_p=0.9)
    tp = sched.submit([3, 14, 15, 9], max_new=8, temperature=1.0, top_p=1e-6)
    sched.run_until_idle()
    assert g.out_tokens == want[0].token_ids.tolist() and g.out_topk_ids == []
    assert tp.out_tokens == want[1].token_ids.tolist()
    for s in (s1, s2):
        assert len(s.out_tokens) == 8 and len(s.out_topk_ids) == len(s.out_topk_probs) == 8
        assert np.asarray(s.out_topk_ids[0]).shape == (8,)
        assert all(0 <= t < TINY.vocab_size for t in s.out_tokens)
        assert all(lp <= 0 for lp in s.out_logprobs)
        # where an emitted token lies in the collected support, the support
        # carries that token's probability under the lane's own distribution
        for t, lp, ids, pr in zip(s.out_tokens, s.out_logprobs, s.out_topk_ids,
                                  s.out_topk_probs):
            assert float(np.sum(pr)) <= 1.0 + 1e-5 and np.all(np.diff(pr) <= 1e-7)
            if t in list(ids):
                np.testing.assert_allclose(pr[list(ids).index(t)], np.exp(lp), rtol=1e-4)


def test_sampled_lanes_follow_their_seeds(roomy):
    """Same admission counter, same stream; another counter, another stream;
    top_p 1.0 at temperature 1 is not greedy."""
    _, te = roomy
    greedy = te.generate([[5, 5, 5]], max_new=12)[0].token_ids.tolist()
    outs = []
    for seq in (100, 100, 107, 114, 121):
        sched = ContinuousBatchingScheduler(te, max_batch=1, max_context=64)
        sched._admission_seq = seq
        r = sched.submit([5, 5, 5], max_new=12, temperature=1.0)
        sched.run_until_idle()
        outs.append(r.out_tokens)
    assert outs[0] == outs[1]
    assert len({tuple(o) for o in outs}) >= 3 and any(o != greedy for o in outs)
    # derived seeds never collide with the step counters
    assert all(_fold(i, 1) >= 1 << 62 for i in range(1, 50))
    assert len({_fold(a, b) for a in range(1, 30) for b in range(1, 6)}) == 29 * 5


def test_eos_retires_the_lane_like_jax(weights):
    _, probe = engine_pair(weights, n_pages=32)
    toks = probe.generate([[3, 14, 15], [9, 2, 6, 5]], max_new=10)
    eos = int(toks[0].token_ids[3])
    pair = engine_pair(weights, n_pages=32, eos_id=eos)
    for kw in (dict(), dict(scan_steps=4)):
        subs = [([3, 14, 15], dict(max_new=10)), ([9, 2, 6, 5], dict(max_new=10))]
        (jr, _), (tr, _) = _both(pair, subs, max_batch=2, max_context=64, **kw)
        _same_requests(jr, tr)
        first = toks[0].token_ids.tolist()
        assert tr[0].out_tokens == first[: first.index(eos) + 1]


def test_warmup_runs_every_bucket_once_and_leaves_state(weights):
    """``warmup`` walks the shape lattice (admission, verify, scan, swap) with
    dummy dispatches that write nothing; its report and the warmed bucket set
    line up with what traffic then hits."""
    _, tp = weights
    te = TierEngine(TINY, tp, device="cpu", page_size=PAGE, n_pages=32,
                    enable_prefix_cache=True)
    sched = ContinuousBatchingScheduler(te, max_batch=2, max_context=64, scan_steps=4,
                                        preemption_mode="swap", spec_topk=4)
    before = [x.clone() for x in te.cache.k_rows]
    report = sched.warmup(max_prompt=32, max_draft=8, sampled=True, draft_supports=(None, 4))
    assert set(report) == {"graphs", "wall_s"} and report["graphs"] == len(sched._warm_buckets)
    # greedy: 2 rows x 2 windows admit, 2 x 2 x 1 draft verify, 1 scan; sampled: the same
    # with a second verify for the support width; 2 swap page buckets, out and in
    assert report["graphs"] == (4 + 4 + 1) + (4 + 8 + 1) + 2 * 2
    assert all(torch.equal(a, b[: a.shape[0]]) or torch.equal(a[:-1], b[:-1])
               for a, b in zip(before, te.cache.k_rows))
    assert sched.stats()["dispatch"]["admit"]["n"] == 0          # stats reset after warmup
    r = sched.submit(list(range(1, 21)), max_new=6)
    d = sched.submit(list(range(1, 21)), max_new=6, draft=[1, 2, 3])
    sched.run_until_idle()
    assert r.error is None and d.error is None and len(d.out_tokens) == 6
    assert set(sched._buckets) <= sched._warm_buckets
    assert te.allocator.stats().active_requests == te.prefix_cache.stats()["entries"]


def test_loop_thread_survives_step_failure_and_stops(weights):
    """An unexpected step() exception fails the active lanes (their requests
    see the error) but the scheduler thread keeps serving new work."""
    _, tp = weights
    te = TierEngine(TINY, tp, device="cpu", page_size=PAGE, n_pages=32)
    sched = ContinuousBatchingScheduler(te, max_batch=2, max_context=64)
    sched.start()
    try:
        boom = {"armed": True}
        orig = te.decode_sample_batch

        def flaky(*args, **kwargs):
            if boom.pop("armed", False):
                raise RuntimeError("injected device failure")
            return orig(*args, **kwargs)

        te.decode_sample_batch = flaky
        r1 = sched.submit([1, 2, 3], max_new=6)
        assert r1.wait(30.0)
        assert r1.error is not None and "injected" in r1.error
        done = []
        r2 = sched.submit([4, 5, 6], max_new=6, on_done=done.append)
        assert r2.wait(30.0)
        assert not r2.error and len(r2.out_tokens) == 6 and done == [r2]
        assert sched.idle_capacity() == 2 and not sched.backlogged()
    finally:
        sched.stop()
    assert sched._thread is None
    t0 = time.monotonic()
    sched.stop()                                     # idempotent
    assert time.monotonic() - t0 < 1.0


@pytest.mark.parametrize("device,expect", [("cuda", []), ("cuda:0", [torch.device("cuda:0")]),
                                           ("cpu", [])])
def test_loop_sets_the_threads_device_only_when_it_has_an_index(weights, monkeypatch, device,
                                                                expect):
    """The scheduler thread makes the engine's card current; ``torch.device("cuda")``
    carries no index (``torch.cuda.set_device`` refuses it) and means the
    current device already."""
    _, tp = weights
    te = TierEngine(TINY, tp, device="cpu", page_size=PAGE, n_pages=8)
    sched = ContinuousBatchingScheduler(te, max_batch=2, max_context=64)
    te.device = torch.device(device)
    seen = []
    monkeypatch.setattr(torch.cuda, "set_device", seen.append)
    sched._stop.set()
    sched._loop()
    assert seen == expect
