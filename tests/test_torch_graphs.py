"""The engine's device-side decode loops on the CPU (engine/graphs.py, the
loops of engine/decode.py): between decode steps the generate and
verify-continue loops read at most one flag a chunk of LOOP_CHUNK steps; a
lane that has stopped writes no K/V past its last position; the scan carry
is patched in place; concurrent calls, which share a bucket's state, take
turns; and the launch bookkeeping a CUDA graph's capture and
replay rest on (the graphs themselves run on the card:
tests/test_torch_cuda.py)."""

import gc
import threading
import types

import numpy as np
import pytest
import torch

from adaptive_sd_tpu_torch.engine import TierEngine
from adaptive_sd_tpu_torch.engine import decode as D
from adaptive_sd_tpu_torch.engine import graphs
from adaptive_sd_tpu_torch.engine.graphs import LOOP_CHUNK, DeviceLoops
from adaptive_sd_tpu_torch.models import TINY, init_params_quantized
from adaptive_sd_tpu_torch.ops import _kernels

torch.set_num_threads(2)

PAGE = 16
_READS = ("cpu", "item", "tolist", "numpy", "__bool__", "__int__", "__float__", "__index__")


@pytest.fixture(scope="module")
def params():
    return init_params_quantized(TINY, 3, device="cpu", dtype=torch.float32)


def _engine(params, **kw):
    return TierEngine(TINY, params, device="cpu", page_size=PAGE, n_pages=48, **kw)


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, TINY.vocab_size, n)] for n in lens]


def _trace(monkeypatch):
    """Events in order: "step" for each decode step, a read's name for each
    host read of a tensor."""
    events = []
    for name in _READS:
        real = getattr(torch.Tensor, name)

        def spy(self, *a, _real=real, _name=name, **k):
            events.append(_name)
            return _real(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, spy)
    real_step = D.decode_step

    def step(*a, **k):
        events.append("step")
        return real_step(*a, **k)

    monkeypatch.setattr(D, "decode_step", step)
    return events


def _assert_one_read_per_chunk(events):
    steps = [i for i, e in enumerate(events) if e == "step"]
    assert steps and len(steps) % LOOP_CHUNK == 0
    for j, (a, b) in enumerate(zip(steps, steps[1:])):
        reads = events[a + 1 : b]
        if (j + 1) % LOOP_CHUNK:
            assert reads == [], (j, reads)        # nothing inside a chunk
        else:
            assert reads == ["item"], (j, reads)  # the chunk's one flag


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("temperature,topk", [(0.0, 0), (0.8, 3)])
def test_generate_reads_one_flag_per_chunk(params, monkeypatch, cached, temperature, topk):
    te = _engine(params, eos_id=5, enable_prefix_cache=cached)
    prompts = _prompts(1, (9, 20, 33))
    events = _trace(monkeypatch)
    outs = te.generate(prompts, max_new=21, temperature=temperature, seed=2, return_topk=topk)
    assert all(0 < o.num_tokens <= 21 for o in outs)
    _assert_one_read_per_chunk(events)


@pytest.mark.parametrize("temperature,topk", [(0.0, 0), (0.8, 3)])
def test_verify_continue_reads_one_flag_per_chunk(params, monkeypatch, temperature, topk):
    te = _engine(params, eos_id=5, enable_prefix_cache=True)
    prompts = _prompts(2, (9, 20, 33))
    drafts = [o.token_ids[:k].tolist() for o, k in zip(te.generate(prompts, max_new=6), (1, 4, 6))]
    events = _trace(monkeypatch)
    got = te.verify_continue(prompts, drafts, max_new=18, temperature=temperature, seed=4,
                             return_topk=topk)
    assert all(o.num_tokens <= 18 for o, _ in got)
    _assert_one_read_per_chunk(events)


@pytest.mark.parametrize("call", ["generate", "verify_continue"])
def test_no_kv_past_a_finished_lane(params, call):
    """Lanes that stop at eos at different steps: every K/V row up to a
    lane's last position is written and none past it, though the loop runs
    on (the other lanes, then the rest of a chunk) after the lane stops."""
    te = _engine(params)
    prompts = _prompts(5, (7, 18, 30))
    base = [o.token_ids.tolist() for o in te.generate(prompts, max_new=24)]
    te.eos_id = base[0][3]                    # lane 0 stops at its fourth token
    granted = {}
    real_alloc = te._alloc

    def alloc(rid, n):
        pages = real_alloc(rid, n)
        granted[rid] = list(pages)
        return pages

    te._alloc = alloc
    sentinel = 77
    for rows in (*te.cache.k_rows, *te.cache.v_rows):
        rows.fill_(sentinel)
    if call == "generate":
        outs = te.generate(prompts, max_new=24)
    else:
        outs = [o for o, _ in te.verify_continue(prompts, [b[:2] for b in base], max_new=24)]
    n_out = [o.num_tokens for o in outs]
    assert len(set(n_out)) > 1 and min(n_out) < 24, n_out
    lanes = [pages for rid, pages in sorted(granted.items(), key=lambda kv: kv[0])][: len(prompts)]
    for p, o, pages in zip(prompts, outs, lanes):
        last = len(p) + o.num_tokens - 1
        for pos in range(len(pages) * PAGE):
            page, slot = pages[pos // PAGE], pos % PAGE
            for pool in (te.cache.k_pages, te.cache.v_pages):
                written = [bool((x[:, page, slot] != sentinel).any()) for x in pool]
                assert written == [pos <= last] * len(pool), (pos, last, written)


def _concurrent(calls):
    """Run ``calls`` in threads that start together; their results."""
    results = [None] * len(calls)
    start = threading.Barrier(len(calls))

    def run(i):
        start.wait()
        results[i] = calls[i]()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(calls))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results


def test_concurrent_calls_equal_one_at_a_time(params):
    """Generates, verify-continues and scans of one shape share a loop
    bucket's state: run from four threads at once on one engine, each gives
    what it gives alone (tokens, logprobs, accepted counts)."""
    te = _engine(params, eos_id=5)
    prompts = [_prompts(10 + i, (9, 20)) for i in range(4)]
    drafts = [[o.token_ids[:3].tolist() for o in te.generate(p, max_new=4)] for p in prompts]
    lens = np.array([5, 9, 14, 3], np.int32)
    tables = np.full((4, 3), 48, np.int32)
    for r in range(4):
        tables[r, :2] = [2 * r, 2 * r + 1]
    toks = np.zeros((4, 16), np.int32)
    for r, p in enumerate(_prompts(6, lens)):
        toks[r, : len(p)] = p
    temps = np.array([0.0, 0.7, 0.0, 0.7], np.float32)
    first, _, _ = te.prefill_sample_batch(toks, lens, tables, temps, 0)

    def gen(i):
        outs = te.generate(prompts[i], max_new=16, temperature=0.8, seed=i)
        return [(o.token_ids.tolist(), o.logprobs.tolist()) for o in outs]

    def ver(i):
        got = te.verify_continue(prompts[i], drafts[i], max_new=16, temperature=0.8, seed=i)
        return [(o.token_ids.tolist(), o.logprobs.tolist(), n) for o, n in got]

    def scan(i):
        out = te.decode_sample_scan(first, lens, tables, temps, i, [4] * 4, n_steps=4)
        return [a.tolist() for a in out[:3]]

    for fn in (gen, ver):
        calls = [lambda i=i: fn(i) for i in range(4)]
        alone = [c() for c in calls]
        assert _concurrent(calls) == alone
    alone = [scan(i) for i in range(4)]
    assert _concurrent([lambda i=i: scan(i) for i in range(4)]) == alone


def test_carry_patch_is_in_place_and_leaves_other_lanes(params):
    """A patch and a mask write the carry's own tensors; the unpatched lanes
    keep their bits and scan as they would have without the patch."""
    te = _engine(params)
    lens = np.array([5, 9, 14, 3], np.int32)
    tables = np.full((4, 3), 48, np.int32)
    for r in range(4):
        tables[r, :2] = [2 * r, 2 * r + 1]
    toks = np.zeros((4, 16), np.int32)
    for r, p in enumerate(_prompts(6, lens)):
        toks[r, : len(p)] = p
    temps = np.array([0.0, 0.7, 0.0, 0.0], np.float32)
    first, _, _ = te.prefill_sample_batch(toks, lens, tables, temps, 0)
    tdev = te.tables_to_device(tables)
    rem = np.array([6, 6, 6, 6], np.int32)
    outs = []
    for patch in (False, True):
        carry = te.scan_carry_init(first, lens, rem, temps, np.ones(4, np.float32), seed=9)
        tensors = {k: v for k, v in carry.items() if isinstance(v, torch.Tensor)}
        before = {k: v.clone() for k, v in tensors.items()}
        if patch:
            carry = te.scan_carry_update(carry, [2], [7], [14], [3], [0.0], [1.0])
            carry = te.scan_carry_mask(carry, [0])
            assert all(carry[k] is v for k, v in tensors.items())
            for k, v in before.items():
                assert torch.equal(carry[k][[1, 3]], v[[1, 3]]), k
            assert carry["rem"].tolist() == [0, 6, 3, 6] and carry["tok"][2] == 7
        outs.append(te.decode_sample_scan_carry(carry, tdev, n_steps=4)[0])
    plain, patched = outs
    for a, b in zip(plain[:3], patched[:3]):
        np.testing.assert_array_equal(a[[1, 3]], b[[1, 3]])
    assert patched[2].tolist() == [0, 4, 3, 4]


def test_diverted_launches_are_recorded_then_counted():
    """Launches inside ``diverted_launches`` reach its record, not the
    counter; ``count_launches`` adds a record back, windows and shapes too
    (a graph's warm-up is dropped, its capture added at each replay)."""
    c = _kernels.LaunchCounter()
    c.shapes = set()
    c.launched(1, 64, 128, 0, "f32")
    with _kernels.diverted_launches() as rec:
        c.launched(4, 64, 128, 0, "f32")
        c.launched(4, 64, 128, 0, "f32")
        c.launched(40, 64, 128, 0, "f32")
        c.launched()
    assert (c.launches, c.windows) == (1, 0)
    assert sum(rec.values()) == 4
    for _ in range(3):
        _kernels.count_launches(rec)
    assert (c.launches, c.windows) == (1 + 12, 3)
    assert c.shapes == {(1, 64, 128, 0, "f32"), (4, 64, 128, 0, "f32"), (40, 64, 128, 0, "f32")}


def test_tile_counters_are_not_made_inside_a_capture(monkeypatch):
    """A stream whose tile counters would first be made inside a graph
    capture raises: the graph's warm-up must make them."""
    monkeypatch.setattr(_kernels, "_tile_counters", {})
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="warm the graph up"):
        _kernels.tile_counters(torch.zeros(1), 123, 8)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    buf = _kernels.tile_counters(torch.zeros(1), 123, 8)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    assert _kernels.tile_counters(torch.zeros(1), 123, 8) is buf


@pytest.mark.parametrize("need", [1000, 1 << 20])
def test_split_workspace_is_made_outside_a_capture_and_kept(monkeypatch, need):
    """The INT4 decode tiles' split-K workspace is the stream's own: made
    outside a capture (a first need inside one raises), reused while it is
    large enough, and where a larger need replaces it, the old buffer is
    kept alive for the graphs that captured its address."""
    monkeypatch.setattr(_kernels, "_split_workspaces", {})
    monkeypatch.setattr(_kernels, "_retired_workspaces", [])
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="warm the graph up"):
        _kernels.split_workspace(torch.zeros(1), 123, need)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    buf = _kernels.split_workspace(torch.zeros(1), 123, need)
    assert buf.dtype == torch.float32 and buf.numel() >= need
    assert _kernels.split_workspace(torch.zeros(1), 123, need) is buf
    assert _kernels.split_workspace(torch.zeros(1), 456, need) is not buf  # another stream
    bigger = _kernels.split_workspace(torch.zeros(1), 123, buf.numel() + 1)
    assert bigger is not buf and bigger.numel() > buf.numel()
    assert any(b is buf for b in _kernels._retired_workspaces)


def test_loop_buckets_are_kept_and_evicted_least_recently_used(monkeypatch):
    monkeypatch.setattr(graphs, "MAX_BUCKETS", 2)
    loops = DeviceLoops(torch.device("cpu"))
    assert not loops.capture
    made = []

    def bucket(key):
        def make():
            made.append(key)
            return {"x": torch.zeros(1)}
        return loops.bucket(key, make, lambda st, gen: st["x"].add_(1), lambda st: None)

    a = bucket("a")
    a.run(None)
    assert bucket("a") is a and a.state["x"].item() == 1
    bucket("b")
    bucket("a")
    bucket("c")                                 # evicts b, the least recently used
    assert made == ["a", "b", "c"] and loops.evictions == 1
    assert bucket("a") is a
    bucket("b")
    assert made == ["a", "b", "c", "b"] and loops.stats()["buckets"] == 2


def test_gc_stays_off_until_the_last_overlapping_capture_ends():
    """Captures in two threads may overlap: cyclic collection stays off
    until the last ends, then returns to what it was before the first."""
    assert gc.isenabled()
    a, b = graphs._gc_paused(), graphs._gc_paused()
    try:
        a.__enter__()
        assert not gc.isenabled()
        b.__enter__()
        a.__exit__(None, None, None)
        assert not gc.isenabled()
        b.__exit__(None, None, None)
        assert gc.isenabled()
        gc.disable()
        with graphs._gc_paused():
            pass
        assert not gc.isenabled()
    finally:
        gc.enable()


def test_table_width_is_a_power_of_two_on_a_card_only():
    card = types.SimpleNamespace(device=torch.device("cuda"))
    cpu = types.SimpleNamespace(device=torch.device("cpu"))
    assert [TierEngine._width(card, n) for n in (1, 2, 3, 5, 9)] == [1, 2, 4, 8, 16]
    assert [TierEngine._width(cpu, n) for n in (1, 3, 5)] == [1, 3, 5]
