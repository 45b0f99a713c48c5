"""The engine calls the continuous-batching scheduler sits on, in the port
against the JAX TierEngine (``use_pallas=False``) on the same weights and the
same host inputs: one-dispatch admission and decode calls, the multi-step
scan, verify admission, the device carry against the legacy scan, the KV page
swap and the prefix cache's host spill. Greedy rows are exact; logprobs agree
to ``LP_ATOL``."""

import jax
import numpy as np
import pytest
import torch

from adaptive_sd_tpu.engine.allocator import PageAllocator as JPageAllocator
from adaptive_sd_tpu.engine.prefix_cache import PrefixCache as JPrefixCache
from adaptive_sd_tpu_torch.engine import PageAllocator, PrefixCache
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
def pair(weights):
    return engine_pair(weights, n_pages=32)


@pytest.fixture(scope="module")
def pc_pair(weights):
    return engine_pair(weights, n_pages=32, enable_prefix_cache=True)


def _rows(seed, lens, S):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lens), S), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(1, TINY.vocab_size, n)
    return toks


def _tables(rows, per_row, n_pages, width=6):
    """Row r owns pages [r*per_row, (r+1)*per_row); the rest of its table and
    every row past ``rows`` point at the out-of-range page."""
    t = np.full((rows.stop, width), n_pages, np.int32)
    for r in rows:
        t[r, :per_row] = np.arange(r * per_row, (r + 1) * per_row)
    return t


def test_admit_decode_and_scan_match_jax(pair):
    """prefill_sample_batch, decode_sample_batch and decode_sample_scan on a
    4-lane batch with one idle lane (out-of-range table) and unequal
    budgets."""
    je, te = pair
    lens = np.array([5, 16, 9, 1], np.int32)
    tokens = _rows(0, lens, 16)
    tables = _tables(range(3), 3, 32)
    tables = np.concatenate([tables, np.full((1, 6), 32, np.int32)])
    temps = np.zeros(4, np.float32)
    jt, jl, jq_ = je.prefill_sample_batch(tokens, lens, tables, temps, jax.random.key(1))
    tt, tl, tq_ = te.prefill_sample_batch(tokens, lens, tables, temps, 1)
    assert tq_ == () and jq_ == ()
    np.testing.assert_array_equal(tt[:3], jt[:3])
    np.testing.assert_allclose(tl[:3], jl[:3], atol=LP_ATOL)
    assert tt.dtype == np.int32 and tl.dtype == np.float32

    jt2, jl2, _ = je.decode_sample_batch(jt, lens, tables, temps, jax.random.key(2))
    tt2, tl2, _ = te.decode_sample_batch(tt, lens, tables, temps, 2)
    np.testing.assert_array_equal(tt2[:3], jt2[:3])
    np.testing.assert_allclose(tl2[:3], jl2[:3], atol=LP_ATOL)

    remaining = np.array([4, 2, 6, 0], np.int32)
    jo = je.decode_sample_scan(jt2, lens + 1, tables, temps, jax.random.key(3), remaining,
                               n_steps=4)
    to = te.decode_sample_scan(tt2, lens + 1, tables, temps, 3, remaining, n_steps=4)
    np.testing.assert_array_equal(to[2], jo[2])
    assert to[2].tolist() == [4, 2, 4, 0]          # exactly n_steps, budgets respected
    np.testing.assert_array_equal(to[0], jo[0])
    np.testing.assert_allclose(to[1], jo[1], atol=LP_ATOL)
    assert to[0][1, 2:].tolist() == [0, 0] and to[0][3].tolist() == [0] * 4
    assert to[3] == () and jo[3] == ()


def test_scan_stops_at_eos_like_jax(weights):
    """A lane that samples eos mid-scan stops emitting; the others go on."""
    je0, te0 = engine_pair(weights, n_pages=16)
    lens = np.array([6, 3], np.int32)
    tokens = _rows(4, lens, 16)
    tables = _tables(range(2), 3, 16)
    temps = np.zeros(2, np.float32)
    first, _, _ = te0.prefill_sample_batch(tokens, lens, tables, temps, 0)
    probe = te0.decode_sample_scan(first, lens, tables, temps, 0, np.array([6, 6], np.int32),
                                   n_steps=6)[0]
    eos = int(probe[0, 2])
    stop0 = probe[0].tolist().index(eos) + 1
    stop1 = probe[1].tolist().index(eos) + 1 if eos in probe[1].tolist() else 6
    je, te = engine_pair(weights, n_pages=16, eos_id=eos)
    for eng, key in ((je, jax.random.key(0)), (te, 0)):
        eng.prefill_sample_batch(tokens, lens, tables, temps, key)
    jo = je.decode_sample_scan(first, lens, tables, temps, jax.random.key(0),
                               np.array([6, 6], np.int32), n_steps=6)
    to = te.decode_sample_scan(first, lens, tables, temps, 0, np.array([6, 6], np.int32),
                               n_steps=6)
    assert to[2].tolist() == [stop0, stop1]
    np.testing.assert_array_equal(to[2], jo[2])
    np.testing.assert_array_equal(to[0], jo[0])


@pytest.mark.parametrize("cached", [False, True])
def test_verify_admit_matches_jax(pair, pc_pair, cached):
    """Greedy verify admission: a draft this tier agrees with, one corrupted
    at token 3, and one shorter than the window; with the prefix cache the
    window holds only [prompt suffix + draft] and attends cached pages."""
    je, te = pc_pair if cached else pair
    prompts = [list(map(int, r)) for r in _rows(5, [20, 20, 20], 20)]
    drafts = [o.token_ids.tolist() for o in te.generate(prompts, max_new=8)]
    drafts[1][3] = drafts[1][3] % (TINY.vocab_size - 1) + 1
    drafts[2] = drafts[2][:5]
    off = PAGE if cached else 0
    if cached:   # fill pages 0..2 with the prompts' first chunk, as an admission would
        for eng, key in ((je, jax.random.key(0)), (te, 0)):
            eng.prefill_sample_batch(np.asarray(prompts, np.int32)[:, :PAGE],
                                     np.full(3, PAGE, np.int32),
                                     np.array([[0], [1], [2]], np.int32), np.zeros(3, np.float32),
                                     key)
    S = 32
    tokens = np.zeros((4, S), np.int32)
    for i, (p, d) in enumerate(zip(prompts, drafts)):
        seq = p[off:] + d
        tokens[i, :len(seq)] = seq
    p_lens = np.array([20, 20, 20, 1], np.int32)
    t_lens = np.array([28, 28, 25, 1], np.int32)
    tables = np.full((4, 4), 32, np.int32)
    for r in range(3):
        tables[r] = [r, 10 + 3 * r, 11 + 3 * r, 12 + 3 * r]
    temps = np.zeros(4, np.float32)
    kw = dict(max_draft=8, offsets=np.array([off] * 3 + [0], np.int32) if cached else None)
    jn, jt, jl, jd, jq_ = je.verify_admit_sample_batch(tokens, p_lens, t_lens, tables, temps,
                                                       jax.random.key(7), **kw)
    tn, tt, tl, td, tq_ = te.verify_admit_sample_batch(tokens, p_lens, t_lens, tables, temps, 7,
                                                       **kw)
    np.testing.assert_array_equal(tn[:3], jn[:3])
    assert tn[1] == 3 and tn[2] == 5 and tn[0] in (7, 8)
    np.testing.assert_array_equal(tt[:3], jt[:3])
    np.testing.assert_allclose(tl[:3], jl[:3], atol=LP_ATOL)
    for r in range(3):
        n = int(t_lens[r] - p_lens[r])
        np.testing.assert_allclose(td[r, :n], jd[r, :n], atol=LP_ATOL)
    assert tq_ == () and jq_ == ()


def test_verify_admit_stochastic_rows_and_support(pair):
    """A sampled row with ``draft_q`` takes the exact rule, a greedy row in the
    same dispatch the argmax rule; the returned support is the row's own
    adjusted distribution (top-p 1e-6: one token, probability 1)."""
    _, te = pair
    prompts = [list(map(int, r)) for r in _rows(6, [12, 12], 12)]
    outs = te.generate(prompts, max_new=8, temperature=0.8, seed=3, return_topk=4)
    greedy = te.generate(prompts, max_new=8)
    drafts = [outs[0].token_ids.tolist(), greedy[1].token_ids.tolist()]
    tokens = np.asarray([p + d for p, d in zip(prompts, drafts)], np.int32)
    tokens = np.pad(tokens, ((0, 0), (0, 32 - tokens.shape[1])))
    dq = (np.stack([outs[0].logprobs, np.zeros(8, np.float32)]),
          np.stack([outs[0].topk_ids, np.zeros((8, 4), np.int32)]),
          np.stack([outs[0].topk_probs, np.full((8, 4), 0.25, np.float32)]))
    tables = _tables(range(2), 3, 32)
    n_acc, tok, lp, dlp, (qi, qp) = te.verify_admit_sample_batch(
        tokens, np.array([12, 12], np.int32), np.array([20, 20], np.int32), tables,
        np.array([0.8, 0.0], np.float32), 11, max_draft=8, draft_q=dq, return_topk=3,
        top_ps=np.array([1.0, 1e-6], np.float32))
    assert 0 <= n_acc[0] <= 8 and n_acc[1] == 8      # the greedy row accepts its own output
    assert tok[1] >= 0 and np.all(lp <= 0) and dlp.shape == (2, 8)
    assert qi.shape == (2, 9, 3) and qi.dtype == np.int32
    np.testing.assert_allclose(qp[0].sum(-1) <= 1.0 + 1e-5, True)


def test_window_admission_matches_jax(pc_pair):
    je, te = pc_pair
    base = _rows(8, [40, 40], 40)
    tables = np.array([[20, 21, 22, 32], [23, 24, 25, 32]], np.int32)
    temps = np.zeros(2, np.float32)
    for eng, key in ((je, jax.random.key(0)), (te, 0)):
        eng.prefill_sample_batch(base[:, :32], np.full(2, 32, np.int32), tables, temps, key)
    win = np.zeros((2, 16), np.int32)
    win[:, :8] = base[:, 32:]
    offsets, win_lens = np.array([32, 32], np.int32), np.array([8, 5], np.int32)
    jt, jl, _ = je.prefill_window_sample_batch(win, offsets, win_lens, tables, temps,
                                               jax.random.key(1))
    tt, tl, _ = te.prefill_window_sample_batch(win, offsets, win_lens, tables, temps, 1)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tl, jl, atol=LP_ATOL)


def test_carry_matches_legacy_scan(pair):
    """The device carry (init, two chained scans, a lane patch, a lane mask)
    gives what the legacy scan gives from host arrays; sampled lanes draw from
    the carried generator, so one 8-step scan equals two chained 4-step ones."""
    _, te = pair
    lens = np.array([7, 11, 4, 1], np.int32)
    tokens = _rows(9, lens, 16)
    tables = np.concatenate([_tables(range(3), 3, 32), np.full((1, 6), 32, np.int32)])
    temps = np.array([0.0, 0.9, 0.0, 0.0], np.float32)
    tps = np.array([1.0, 0.9, 1.0, 1.0], np.float32)
    first, _, _ = te.prefill_sample_batch(tokens, lens, tables, temps, 0, top_ps=tps)
    rem = np.array([8, 8, 3, 0], np.int32)
    legacy = te.decode_sample_scan(first, lens, tables, temps, 5, rem, n_steps=8, top_ps=tps,
                                   return_topk=2)

    te.prefill_sample_batch(tokens, lens, tables, temps, 0, top_ps=tps)   # same KV again
    carry = te.scan_carry_init(first, lens, rem, temps, tps, seed=5)
    tdev = te.tables_to_device(tables)
    a, carry = te.decode_sample_scan_carry(carry, tdev, n_steps=4, return_topk=2)
    handles, carry = te.decode_sample_scan_carry_async(carry, tdev, n_steps=4, return_topk=2)
    assert all(isinstance(h, torch.Tensor) for h in handles)
    b = te.fetch_scan_handles(handles)
    np.testing.assert_array_equal(np.concatenate([a[0], b[0]], 1), legacy[0])
    np.testing.assert_allclose(np.concatenate([a[1], b[1]], 1), legacy[1], atol=1e-6)
    np.testing.assert_array_equal(a[2] + b[2], legacy[2])
    np.testing.assert_array_equal(np.concatenate([a[3][0], b[3][0]], 1), legacy[3][0])
    assert carry["rem"].tolist() == [0, 0, 0, 0] and carry["pos"].tolist() == [15, 19, 7, 1]

    # patch lane 2 (a new admission) and mask lane 0: the others are untouched
    before = {k: v.clone() for k, v in carry.items() if isinstance(v, torch.Tensor)}
    rem_t = carry["rem"]
    carry = te.scan_carry_update(carry, [2], [int(first[2])], [4], [2], [0.0], [1.0])
    carry = te.scan_carry_mask(carry, [0])
    assert carry["rem"] is rem_t                           # patches are in place
    for k, v in before.items():
        assert torch.equal(carry[k][[1, 3]], v[[1, 3]])
    assert carry["rem"].tolist() == [0, 0, 2, 0] and carry["pos"].tolist() == [15, 19, 4, 1]
    out, carry = te.decode_sample_scan_carry(carry, tdev, n_steps=4)
    assert out[2].tolist() == [0, 0, 2, 0]
    np.testing.assert_array_equal(out[0][2, :2], legacy[0][2, :2])


def test_scan_has_no_host_sync_between_steps(pair, monkeypatch):
    """Nothing in the scan copies to the host or reads a scalar: the count of
    ``.cpu()``, ``.item()``, ``.tolist()``, ``.numpy()`` and tensor truth
    tests stays 0 from the first step to the last; the fetch is the one sync."""
    _, te = pair
    lens = np.array([5, 9], np.int32)
    tables = te.tables_to_device(_tables(range(2), 3, 32))
    te.eos_id = 3                                           # the eos mask is on the device too
    carry = te.scan_carry_init([4, 5], lens, [6, 2], [0.0, 0.8], [1.0, 0.9], seed=1)
    calls = []
    for name in ("cpu", "item", "tolist", "numpy", "__bool__", "__int__", "__float__",
                 "__index__"):
        real = getattr(torch.Tensor, name)

        def spy(self, *a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, spy)
    try:
        handles, carry = te.decode_sample_scan_carry_async(carry, tables, n_steps=6,
                                                           return_topk=2)
        assert calls == []
        te.fetch_scan_handles(handles)
        assert calls and set(calls) <= {"cpu", "numpy"}
    finally:
        te.eos_id = None


def test_swap_roundtrip_is_bit_exact_and_compact(pair):
    """swap_out -> clobber -> swap_in restores the pages exactly; the blob has
    the JAX blob's shapes and types and is sliced to the real page count;
    padding (an out-of-range page, rows beyond the page list) is dropped."""
    je, te = pair
    pages = [4, 9, 2]
    tables = np.full((1, 4), 32, np.int32)
    tables[0, :3] = pages
    toks = (np.arange(1, 41, dtype=np.int32)[None, :] % TINY.vocab_size)
    lens = np.array([40], np.int32)
    temps = np.zeros(1, np.float32)
    te.prefill_sample_batch(toks, lens, tables, temps, 0)
    je.prefill_sample_batch(toks, lens, tables, temps, jax.random.key(0))
    blob, jblob = te.swap_out_pages(pages), je.swap_out_pages(pages)
    assert [b.shape for b in blob] == [b.shape for b in jblob]
    assert [b.dtype for b in blob] == [b.dtype for b in jblob]
    assert all(b.shape[2] == 3 for b in blob)
    assert all(b.shape[2] == 1 for b in te.swap_out_pages([7]))
    # the same prefill wrote (nearly) the same bytes in both packages
    assert np.mean(blob[0] == jblob[0]) > 0.99
    snap = [b.copy() for b in blob]
    other = te.swap_out_pages([5])
    te.prefill_sample_batch(toks[:, ::-1].copy(), lens, tables, temps, 0)
    assert any(not np.array_equal(a, b) for a, b in zip(snap, te.swap_out_pages(pages)))
    te.swap_in_pages(pages + [32], blob)                   # a padding page: dropped
    te.swap_in_pages([], blob)                             # no pages: nothing written
    for a, b in zip(snap, te.swap_out_pages(pages)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(other, te.swap_out_pages([5])):        # neighbours untouched
        np.testing.assert_array_equal(a, b)
    # into other pages than it came from, in another order
    te.swap_in_pages([11, 12, 13], blob)
    for a, b in zip(snap, te.swap_out_pages([11, 12, 13])):
        np.testing.assert_array_equal(a, b)


def _spill_walk(cache_cls, alloc_cls):
    """One sequence of acquires over a 4-page pool with fake swap hooks."""
    alloc = alloc_cls(4)
    store = {}

    def swap_out(pages):
        return (np.full((1, 1, len(pages), 4), store.get(pages[0], -1), np.int8),)

    def swap_in(pages, blob):
        store[pages[0]] = int(blob[0][0, 0, 0, 0])

    pc = cache_cls(alloc, 4, max_pages=4, spill_bytes=16, swap_out=swap_out, swap_in=swap_in)
    log = []
    for i, prompt in enumerate(([1] * 9, [2] * 9, [3] * 9, [1] * 9, [2] * 9, [1] * 5)):
        pages, n_reused, held, fill = pc.acquire(prompt)
        for _, p in fill:
            store[p] = i
        log.append((list(pages), n_reused, len(fill)))
        pc.release(held)
    return log, pc.stats(), store


def test_prefix_cache_spill_walk_matches_jax():
    """The host spill is host logic: the same acquire/evict/restore walk over
    the JAX PrefixCache and the port's gives the same pages and counters."""
    tlog, tstats, tstore = _spill_walk(PrefixCache, PageAllocator)
    jlog, jstats, jstore = _spill_walk(JPrefixCache, JPageAllocator)
    assert tlog == jlog and tstats == jstats and tstore == jstore
    assert tstats["spills"] == 6 and tstats["spill_hits"] == 4
    assert tlog[3] == ([3, 2], 8, 0)     # both chunks restored from the host: nothing to fill


def test_engine_prefix_spill_restores_instead_of_recomputing(weights):
    """A 6-page pool: the third prompt evicts the first one's chunks to the
    host; asking for the first again restores them (spill hit) and gives the
    same tokens as an engine that never evicted."""
    _, tp = weights
    from adaptive_sd_tpu_torch.engine import TierEngine

    ref = TierEngine(TINY, tp, device="cpu", page_size=PAGE, n_pages=64,
                     enable_prefix_cache=True)
    eng = TierEngine(TINY, tp, device="cpu", page_size=PAGE, n_pages=6,
                     enable_prefix_cache=True, prefix_spill_bytes=1 << 20)
    prompts = [list(map(int, r)) for r in _rows(10, [36, 36, 36], 36)]
    want = [ref.generate([p], max_new=4)[0].token_ids.tolist() for p in prompts]
    got = [eng.generate([p], max_new=4)[0].token_ids.tolist() for p in prompts]
    again = eng.generate([prompts[0]], max_new=4)[0].token_ids.tolist()
    st = eng.prefix_cache.stats()
    assert got == want and again == want[0]
    assert st["spills"] >= 1 and st["spill_hits"] >= 1 and st["spilled_bytes"] >= 0
    assert eng.allocator.stats().active_requests == st["entries"]
