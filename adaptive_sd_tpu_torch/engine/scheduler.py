"""Continuous batching scheduler: token-level admission into a running batch
(counterpart of ``adaptive_sd_tpu/engine/scheduler.py``; the host logic is the
same, the engine calls take integer seeds where the JAX ones take keys).
Design:

* A fixed-width lane array (``max_batch``) keeps the decode shapes static:
  one decode step serves any lane occupancy, with free lanes masked out.
  Admission runs a bucketed prefill, then the request joins a lane;
  completion (eos / budget) frees the lane and its KV pages the same step. No
  request waits for the batch to drain.
* Pages come from the shared PageAllocator and grow one page ahead of the
  write position (``ensure``).
* Each step is ONE engine call: the decode forward and the per-lane
  temperature sampling are enqueued together
  (TierEngine.decode_sample_batch / decode_sample_scan), and only [B]-sized
  token/logprob arrays come back to the host.
* Sampling streams: a decode step or scan is seeded with the step counter,
  an admission with ``_fold(admission counter, 1)`` and a drafted subgroup
  with a further fold, so the streams stay disjoint (the JAX scheduler's
  ``key(steps)`` / ``fold_in`` arithmetic).
* The per-lane done/token/position scan runs in the C++ lane table
  (native/allocator.cc ``asd_lanes_*``, engine/native_bridge.py, built with
  g++ at first use) when the native library is available, and in the
  identical Python loop otherwise, as in the JAX scheduler.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np

from ..core.exceptions import ResourceError
from .decode import PAD_ID, TierEngine, _bucket_batch, _bucket_pow2

_M64 = (1 << 64) - 1


def _fold(seed: int, data: int) -> int:
    """Derive a seed from ``seed`` and ``data`` (the role of
    ``jax.random.fold_in``): a splitmix64 round, with bit 62 set so that a
    derived seed never equals a plain counter value."""
    x = (seed * 0x9E3779B97F4A7C15 + (data + 1) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    x ^= x >> 31
    return (x & ((1 << 62) - 1)) | (1 << 62)


@dataclass
class SchedRequest:
    request_id: str
    prompt: list[int]
    max_new: int = 128
    temperature: float = 0.0
    top_p: float = 1.0
    # Admission order: higher priority admits first (FIFO within a level);
    # preemption under page pressure victimises the LOWEST priority first
    # (reference surface: RequestContext.priority, core/types.py).
    priority: int = 0
    # Speculative escalation into this tier's lanes: when set, admission runs
    # a verify pass over [prompt + draft] (engine.verify_admit_sample_batch)
    # instead of a plain prefill — the accepted prefix lands in out_tokens in
    # one dispatch and the lane resumes decoding after it.
    draft: Optional[list[int]] = None
    # Draft support (logprobs [d], topk_ids [d, K], topk_probs [d, K]) from
    # the draft tier: with temperature > 0 the verify admission then uses the
    # EXACT stochastic rejection rule instead of greedy argmax matching.
    draft_q: Optional[tuple] = None
    on_done: Optional[Callable[["SchedRequest"], None]] = None
    arrival: float = field(default_factory=time.monotonic)
    # filled by the scheduler:
    out_tokens: list[int] = field(default_factory=list)
    out_logprobs: list[float] = field(default_factory=list)
    # per-token top-K support of this tier's own sampling distribution
    # (populated when the scheduler's spec_topk > 0 and temperature > 0) —
    # the draft_q handed to the NEXT tier on escalation
    out_topk_ids: list = field(default_factory=list)
    out_topk_probs: list = field(default_factory=list)
    n_accepted: int = 0        # verified draft prefix length (draft admission)
    position: int = 0          # next position to write (== current length)
    next_token: int = PAD_ID   # token to feed at the next step
    # prefix-cache bookkeeping: reused prompt-prefix length, cache-owned page
    # count at the head of this lane's table, held/fill entry keys
    n_reused: int = 0
    page_offset: int = 0
    held_keys: list = field(default_factory=list)
    fill_keys: list = field(default_factory=list)
    # times this request was preempted under KV-page pressure (its pages were
    # reclaimed and it re-queued for recompute admission)
    preemptions: int = 0
    # swap-mode preemption: host-side copy of this request's KV pages (an
    # engine.swap_out_pages blob) awaiting restore at re-admission, the live
    # page count it covers, and its host-memory footprint
    swap_blob: Optional[tuple] = None
    swap_pages: int = 0
    swap_bytes: int = 0
    done: bool = False
    error: Optional[str] = None
    finished_at: float = 0.0
    _event: threading.Event = field(default_factory=threading.Event)

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)


class ContinuousBatchingScheduler:
    def __init__(
        self,
        engine: TierEngine,
        *,
        max_batch: int = 8,
        max_context: int = 2048,
        admission_wait_s: float = 0.002,
        spec_topk: int = 0,
        scan_steps: int = 1,
        preemption_mode: str = "recompute",
        max_swap_bytes: int = 256 << 20,
        device_carry: bool = True,
        pipeline_scans: bool = True,
    ) -> None:
        """``spec_topk`` > 0: sampled lanes (temperature > 0) also carry the
        top-K support of each emitted token's distribution, so a later tier
        can verify this tier's lane output with the exact stochastic rule.

        ``scan_steps`` > 1: run that many decode steps per dispatch
        (engine.decode_sample_scan): the host syncs lane bookkeeping once per
        scan instead of once per token, at the cost of admission latency
        bounded by one scan.

        ``preemption_mode``: what a page-pressure victim pays to come back
        (role parity: vLLM's two preemption flavours, SURVEY.md §2.8).
        ``"recompute"`` frees the pages and re-prefills [prompt + generated]
        at re-admission — zero host memory, one prefill of recompute.
        ``"swap"`` copies the victim's live KV pages to host memory
        (engine.swap_out_pages) and restores them bit-exactly into a fresh
        page grant at re-admission — no recompute, at most
        ``max_swap_bytes`` of host memory held across all swapped-out
        requests (beyond the budget, victims fall back to recompute)."""
        if preemption_mode not in ("recompute", "swap"):
            raise ValueError(
                f"preemption_mode must be 'recompute' or 'swap', "
                f"got {preemption_mode!r}"
            )
        self.engine = engine
        self.max_batch = max_batch
        self.max_context = max_context
        self.spec_topk = spec_topk
        self.scan_steps = max(int(scan_steps), 1)
        self.page = engine.page_size
        self.max_pages = (max_context + self.page - 1) // self.page
        self._lanes: list[Optional[SchedRequest]] = [None] * max_batch
        # (-priority, seq) ordering: higher priority first, FIFO within a
        # level (seq is a monotone tiebreak — heap order is otherwise
        # undefined for equal keys)
        self._queue: "queue.PriorityQueue[tuple[int, int, SchedRequest]]" = (
            queue.PriorityQueue()
        )
        self._enq_seq = 0
        # preempted requests waiting for recompute re-admission; served BEFORE
        # the arrival queue (they are the oldest work — FIFO fairness)
        self._resume: collections.deque[SchedRequest] = collections.deque()
        # Idle/retired lanes point at an out-of-range page so their decode
        # writes are dropped by the scatter instead of corrupting page 0 (or
        # whatever page a stale table row referenced).
        self._oob_page = engine.allocator.n_pages
        self._tables = np.full((max_batch, self.max_pages), self._oob_page, np.int32)
        self._admission_wait = admission_wait_s
        # the ranks of a tensor-parallel engine issue their collectives in
        # step: each must admit the same batch, so the clock does not cut an
        # admission short there (each rank queues the same requests itself)
        self._same_batch_on_every_rank = bool(getattr(engine, "tp_mode", False))
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.steps = 0
        self.completed = 0
        self.preemptions = 0
        self.preemption_mode = preemption_mode
        self.max_swap_bytes = max_swap_bytes
        self.swap_preemptions = 0
        self._swap_bytes_held = 0
        # monotone admission counter: admission RNG keys must advance even
        # when self.steps does not (a step that dispatches nothing), or
        # successive admission rounds would reuse identical sampling keys
        self._admission_seq = 0
        # Per-dispatch-kind timing: {kind: [count, total_s, max_s]}. The
        # engine calls end in a host fetch, so each sample includes
        # queueing + (first-use) kernel build + execution — the max
        # column is how a first use shows up in production stats.
        # ``_buckets``: dispatches per (kind, shape-bucket) key.
        self._disp: dict[str, list] = {
            k: [0, 0.0, 0.0]
            for k in ("admit", "verify", "scan", "swap_out", "swap_in")
        }
        self._buckets: collections.Counter = collections.Counter()
        self._warm_buckets: set = set()  # lattice keys run once by warmup()
        from .native_bridge import make_lanes

        # C++ lane table mirror (None -> Python scan). Lane choice stays in
        # Python (lowest-free order matches the C++ admit scan; asserted).
        self._nlanes = make_lanes(max_batch, self.page)

        # Device-resident scan carry (tokens/positions/budgets/generator kept
        # on the device between scan dispatches, so a steady-state round
        # uploads nothing).
        # ``_carry_host`` mirrors what the device carry holds; each round the
        # desired host state is diffed against it and only changed lanes are
        # scatter-patched (admissions, retires, preemptions) — zero hooks in
        # the mutation sites, self-healing by construction. Patches write
        # the carry in place; the engine copies it into its scan graph's
        # state when it enqueues a round, so stream order keeps an enqueued
        # round on the values before a patch.
        self.device_carry = bool(device_carry)
        self._carry = None
        self._carry_host: Optional[dict] = None
        self._tables_dev = None
        self._tables_uploaded: Optional[np.ndarray] = None
        self._carry_rounds = 0
        self._carry_rebuilds = 0
        self._carry_patches = 0
        # Pipelined scans (requires device_carry): round N+1 is enqueued
        # from the device carry BEFORE round N's results are fetched, so the
        # host launches ahead while the card works (a round's handles are
        # copies of the scan's outputs, which round N+1 overwrites). Host bookkeeping runs
        # one round stale; the scan masks zero-budget lanes, so a lane that
        # finished in the unprocessed round idles harmlessly for one extra
        # dispatch.
        self.pipeline_scans = bool(pipeline_scans) and self.device_carry
        self._pending = None          # (handles, [(lane, req)], topk, t0)
        self._patched_since: set = set()   # lanes patched after pending round
        self._rebuilt_since = False        # carry rebuilt after pending round

    def _timed(self, kind: str, bucket: tuple, fn, *args, **kw):
        """Run one engine dispatch under the per-kind timer. ``bucket`` is
        the padded-shape key of the dispatch (batch/window buckets)."""
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        dt = time.perf_counter() - t0
        d = self._disp[kind]
        d[0] += 1
        d[1] += dt
        d[2] = max(d[2], dt)
        self._buckets[(kind,) + bucket] += 1
        return out

    # --------------------------------------------------------------- warmup
    @staticmethod
    def _pow2_lattice(floor: int, cap: int) -> list[int]:
        """All values _bucket_pow2 can produce for lengths in [1, cap]."""
        top = _bucket_pow2(cap, floor, cap)
        vals, v = [], floor
        while v < top:
            vals.append(v)
            v <<= 1
        vals.append(top)
        return vals

    def warmup(
        self,
        *,
        max_prompt: Optional[int] = None,
        max_draft: int = 32,
        sampled: bool = False,
        draft_supports: Sequence[Optional[int]] = (None,),
        drafts: bool = True,
    ) -> dict:
        """Run every padded shape of the serving lattice once with dummy
        dispatches. Eager PyTorch compiles nothing per shape, so this only
        builds the CUDA kernels (first use) and touches each bucket once;
        it exists so that the first request pays neither, and so that
        ``_warm_buckets`` can be held against the traffic's buckets.

        Every distinct padded shape the scheduler can dispatch — admission
        (row bucket x window bucket), escalation verify (row x window x
        draft x support), decode scan — is enumerated (_bucket_pow2 keeps
        the lattice O(log) per axis) and dispatched against an
        all-out-of-range page table (the KV scatter drops every write, so
        device state is untouched).

        ``sampled``: also warm the temperature>0 variants (per-token top-K
        support attached). ``draft_supports``: support widths K of draft_q
        tuples escalations may carry (None = greedy acceptance).
        ``max_draft``/``max_prompt``: lattice caps — requests beyond them
        still work. Returns
        {"graphs": n, "wall_s": t}; dispatch stats are reset afterwards so
        serving metrics start clean (the warmed keys stay in
        ``self._warm_buckets`` for coverage checks)."""
        t0 = time.perf_counter()
        cap_w = min(max_prompt or self.max_context, self.max_context)
        cached = self.engine.prefix_cache is not None
        w_floor = min(64, self.page) if cached else self.page
        key = 0
        oob = np.full((1, self.max_pages), self._oob_page, np.int32)

        nb_plain = self._pow2_lattice(1, self.max_batch)
        nb_verify = [1] if self.max_batch == 1 else [1, self.max_batch]
        topks = [0] + ([self.spec_topk] if sampled and self.spec_topk else [])

        def row(nb):
            return np.repeat(oob, nb, axis=0)

        for topk in topks:
            temps_v = 1.0 if topk else 0.0
            for nb in nb_plain:
                temps = np.full((nb,), temps_v, np.float32)
                tps = np.ones((nb,), np.float32)
                for W in self._pow2_lattice(w_floor, cap_w):
                    tokens = np.ones((nb, W), np.int32)
                    if cached:
                        self._timed(
                            "admit", (nb, W, topk),
                            self.engine.prefill_window_sample_batch,
                            tokens, np.zeros((nb,), np.int32),
                            np.full((nb,), W, np.int32), row(nb), temps, key,
                            return_topk=topk, top_ps=tps,
                        )
                    else:
                        self._timed(
                            "admit", (nb, W, topk),
                            self.engine.prefill_sample_batch,
                            tokens, np.full((nb,), W, np.int32), row(nb),
                            temps, key, return_topk=topk, top_ps=tps,
                        )
            if drafts:
                for nb in nb_verify:
                    temps = np.full((nb,), temps_v, np.float32)
                    tps = np.ones((nb,), np.float32)
                    for S in self._pow2_lattice(w_floor, cap_w):
                        for Dw in self._pow2_lattice(
                            8, min(max_draft, self.max_context)
                        ):
                            if Dw > S:
                                continue  # window always covers the draft
                            for kq in draft_supports:
                                if kq is not None and not topk:
                                    continue  # support rides sampled lanes
                                dq = ()
                                if kq:
                                    dq = (
                                        np.zeros((nb, Dw), np.float32),
                                        np.zeros((nb, Dw, kq), np.int32),
                                        np.full((nb, Dw, kq), 1.0 / kq,
                                                np.float32),
                                    )
                                tokens = np.ones((nb, S), np.int32)
                                # the bucket is keyed by (S, Dw), not by
                                # the lengths: any valid split will do
                                d = min(Dw, S - 1)
                                p_lens = np.full((nb,), S - d, np.int32)
                                t_lens = np.full((nb,), S, np.int32)
                                self._timed(
                                    "verify", (nb, S, Dw, kq or 0, topk),
                                    self.engine.verify_admit_sample_batch,
                                    tokens, p_lens, t_lens, row(nb), temps,
                                    key, max_draft=Dw, draft_q=dq,
                                    return_topk=topk,
                                    offsets=(np.zeros((nb,), np.int32)
                                             if cached else None),
                                    top_ps=tps,
                                )
            B = self.max_batch
            temps = np.full((B,), temps_v, np.float32)
            tps = np.ones((B,), np.float32)
            toks0 = np.full((B,), PAD_ID, np.int32)
            pos0 = np.zeros((B,), np.int32)
            if self.scan_steps > 1:
                self._timed(
                    "scan", (self.scan_steps, topk),
                    self.engine.decode_sample_scan,
                    toks0, pos0, np.repeat(oob, B, axis=0), temps, key,
                    np.ones((B,), np.int32), n_steps=self.scan_steps,
                    return_topk=topk, top_ps=tps,
                )
            else:
                self._timed(
                    "scan", (1, topk),
                    self.engine.decode_sample_batch,
                    toks0, pos0, np.repeat(oob, B, axis=0), temps, key,
                    return_topk=topk, top_ps=tps,
                )

        # Prefix-cache host spill also dispatches the swap gather/scatter
        # (one page per eviction/restore -> the P=2 bucket) regardless of
        # preemption_mode; run it too.
        pc = getattr(self.engine, "prefix_cache", None)
        spill_on = pc is not None and getattr(pc, "spill_bytes", 0) > 0
        if self.preemption_mode == "swap" or spill_on:
            # swap gather/scatter per pow2 page-count bucket. Gather reads
            # page 0 (harmless); restore is given no page, so every row of
            # the blob is dropped and state is untouched.
            # Keys use the PADDED bucket (_bucket_pow2, same as the runtime
            # dispatch sites) so warm-coverage checks line up even when the
            # lattice top is clamped to a non-pow2 page cap.
            if self.preemption_mode == "swap":
                lattice = self._pow2_lattice(
                    2, min(self.max_pages, self.engine.allocator.n_pages)
                )
            else:  # spill only: single-page swaps
                lattice = [2]
            for P in lattice:
                blob = self._timed(
                    "swap_out", (_bucket_pow2(P, 2),),
                    self.engine.swap_out_pages, [0] * P,
                )
                self._timed(
                    "swap_in", (_bucket_pow2(int(blob[0].shape[2]), 2),),
                    self.engine.swap_in_pages, [], blob,
                )

        report = {
            "graphs": len(self._buckets),
            "wall_s": round(time.perf_counter() - t0, 3),
        }
        self._warm_buckets = set(self._buckets)
        self.reset_dispatch_stats()
        return report

    # -------------------------------------------------------------- frontend
    def submit(
        self, prompt: Sequence[int], *, max_new: int = 128, temperature: float = 0.0,
        top_p: float = 1.0,
        request_id: Optional[str] = None, draft: Optional[Sequence[int]] = None,
        draft_q: Optional[tuple] = None,
        on_done: Optional[Callable[[SchedRequest], None]] = None,
        priority: int = 0,
    ) -> SchedRequest:
        """``draft``: a lower tier's output tokens — admission verifies them
        in one parallel pass and the lane resumes after the accepted prefix.
        With ``draft_q`` (logprobs [d], topk_ids [d, K], topk_probs [d, K])
        and temperature > 0 the acceptance uses the exact stochastic
        rejection rule; otherwise greedy argmax matching (exact at
        temperature 0, conservative above). ``on_done`` runs on the
        scheduler thread at retirement, before the request's wait() event
        fires — the cascade escalation hook."""
        if len(prompt) + max_new > self.max_context:
            raise ResourceError(
                f"prompt+max_new {len(prompt) + max_new} exceeds max_context {self.max_context}"
            )
        draft = list(draft)[:max_new] if draft else None
        if draft_q is not None and draft:
            draft_q = tuple(np.asarray(a)[: len(draft)] for a in draft_q)
        else:
            draft_q = None
        req = SchedRequest(
            request_id=request_id or f"req{time.monotonic_ns()}",
            prompt=list(prompt),
            max_new=max_new,
            temperature=temperature,
            top_p=top_p,
            draft=draft,
            draft_q=draft_q,
            on_done=on_done,
            priority=priority,
        )
        self._enq_seq += 1
        self._queue.put((-priority, self._enq_seq, req))
        return req

    # -------------------------------------------------------------- internals
    def _free_lane_ids(self) -> list[int]:
        return [i for i, r in enumerate(self._lanes) if r is None]

    @staticmethod
    def _seq(req: SchedRequest) -> list[int]:
        """The token sequence admission must prefill: the prompt plus any
        tokens already generated before a preemption (recompute resume)."""
        return req.prompt + req.out_tokens if req.out_tokens else req.prompt

    def _admit(self) -> int:
        """Move waiting requests into free lanes. Plain requests batch one
        prefill+sample dispatch; draft-carrying escalations batch one
        verify+sample dispatch (accepted prefix lands immediately, the lane
        resumes after it). Preempted requests (``_resume``) re-admit first:
        their generated-so-far tokens are recomputed as part of the prefill
        (vLLM-style recompute preemption)."""
        free = self._free_lane_ids()
        if not free:
            return 0
        batch: list[tuple[int, SchedRequest]] = []
        while len(batch) < len(free) and self._resume:
            batch.append((free[len(batch)], self._resume.popleft()))
        deadline = time.monotonic() + self._admission_wait
        while len(batch) < len(free):
            timeout = deadline - time.monotonic()
            try:
                _, _, req = self._queue.get(
                    timeout=max(timeout, 0) if batch == [] else 0
                )
            except queue.Empty:
                break
            batch.append((free[len(batch)], req))
            if time.monotonic() > deadline and not self._same_batch_on_every_rank:
                break
        if not batch:
            return 0

        prefix = self.engine.prefix_cache

        def _fail_batch(exc: Exception) -> None:
            for lane, req in batch:
                self._drop_swap(req)
                self._release_prefix(req, failed=True)
                # free any pages already granted to this batch (sibling
                # allocations that succeeded would otherwise leak forever)
                self.engine.allocator.free_request(req.request_id)
                self._tables[lane, :] = self._oob_page
                self._lanes[lane] = None
                req.error = str(exc)
                req.done = True
                if req.on_done is not None:
                    try:
                        req.on_done(req)
                    except Exception:  # noqa: BLE001 - hooks must not kill the loop
                        pass
                req._event.set()

        batch_fills: set = set()
        admitted: list[tuple[int, SchedRequest]] = []
        for bi, (lane, req) in enumerate(batch):
            try:
                seq = self._seq(req)
                pref_pages: list[int] = []
                # swapped-out resumes restore a private KV copy: no prefix
                # sharing (their pages must be exclusively owned)
                if prefix is not None and req.swap_blob is None:
                    pref_pages, n_reused, held, fill = prefix.acquire(seq)
                    req.n_reused = n_reused
                    req.page_offset = len(pref_pages)
                    req.held_keys = held
                    req.fill_keys = [k for k, _ in fill]
                    # A batch-mate registered some of these chunks THIS round
                    # and hasn't written them yet (its dispatch runs in this
                    # same admission). Recompute from the first such chunk:
                    # the scatter writes identical K/V for an identical
                    # prefix, so the sharing stays consistent regardless of
                    # dispatch order within the batch.
                    for ci, k in enumerate(held):
                        if k in batch_fills:
                            req.n_reused = min(req.n_reused, ci * self.page)
                            break
                    batch_fills.update(req.fill_keys)
                total = len(seq) + (len(req.draft) if req.draft else 0)
                needed = min((total + self.page) // self.page + 1, self.max_pages)
                own = self._alloc_admission(
                    req, max(needed - req.page_offset, 1)
                )
                self._tables[lane, :] = self._oob_page
                if pref_pages:
                    self._tables[lane, : len(pref_pages)] = pref_pages
                self._tables[lane, req.page_offset : req.page_offset + len(own)] = own
                admitted.append((lane, req))
            except ResourceError as exc:
                # Transient KV-page pressure must never error a request: park
                # this one and the rest of the batch at the FRONT of the
                # resume queue (they are the oldest work) and retry once
                # pages free; the batch-mates that already got their pages
                # proceed. Only a request that can never fit — it alone needs
                # more pages than the pool holds — is failed outright.
                self._requeue_batch(batch[bi:], exc)
                break
        if not admitted:
            return 0
        batch = admitted

        swapped = [(lane, req) for lane, req in batch if req.swap_blob is not None]
        plain = [(lane, req) for lane, req in batch
                 if not req.draft and req.swap_blob is None]
        drafted = [(lane, req) for lane, req in batch if req.draft]
        # dedicated monotone counter (NOT self.steps, which stalls when a
        # step dispatches nothing); fold_in(1) keeps admission keys disjoint
        # from the decode-step keys
        self._admission_seq += 1
        key = _fold(self._admission_seq, 1)

        try:
            for lane, req in swapped:
                # restore the host KV copy into the fresh page grant; the
                # lane then resumes exactly where it was preempted — no
                # recompute, next_token/position/out_tokens kept as saved
                pages = [int(p) for p in self._tables[lane, : req.swap_pages]]
                self._timed(
                    "swap_in",
                    (_bucket_pow2(int(req.swap_blob[0].shape[2]), 2),),
                    self.engine.swap_in_pages, pages, req.swap_blob,
                )
                self._swap_bytes_held -= req.swap_bytes
                req.swap_blob = None
                req.swap_bytes = 0

            if plain:
                # rows bucket to powers of two, as in the JAX scheduler (dummy
                # rows mask to OOB tables)
                n = len(plain)
                nb = _bucket_batch(n)
                tables = np.full((nb, self.max_pages), self._oob_page, np.int32)
                for row, (lane, req) in enumerate(plain):
                    tables[row] = self._tables[lane]
                temps = np.zeros((nb,), np.float32)
                temps[:n] = [r.temperature for _, r in plain]
                tps = np.ones((nb,), np.float32)
                tps[:n] = [r.top_p for _, r in plain]
                topk = self.spec_topk if any(r.temperature > 0 for _, r in plain) else 0
                seqs = [self._seq(r) for _, r in plain]
                if prefix is not None:
                    # prefix-cache admission: prefill only the uncached
                    # suffix windows (offsets 0 rows degrade to full prefill)
                    W = _bucket_pow2(
                        max(len(s) - r.n_reused for s, (_, r) in zip(seqs, plain)),
                        min(64, self.page), self.max_context,
                    )
                    tokens = np.full((nb, W), PAD_ID, np.int32)
                    offsets = np.zeros((nb,), np.int32)
                    win_lens = np.ones((nb,), np.int32)
                    for row, (seq, (lane, req)) in enumerate(zip(seqs, plain)):
                        sx = seq[req.n_reused:]
                        tokens[row, : len(sx)] = sx
                        offsets[row] = req.n_reused
                        win_lens[row] = len(sx)
                    toks, lps, q_out = self._timed(
                        "admit", (nb, W, topk),
                        self.engine.prefill_window_sample_batch,
                        tokens, offsets, win_lens, tables, temps, key,
                        return_topk=topk, top_ps=tps,
                    )
                else:
                    S = _bucket_pow2(
                        max(len(s) for s in seqs), self.page, self.max_context
                    )
                    tokens = np.full((nb, S), PAD_ID, np.int32)
                    seq_lens = np.ones((nb,), np.int32)
                    for row, (seq, (lane, req)) in enumerate(zip(seqs, plain)):
                        tokens[row, : len(seq)] = seq
                        seq_lens[row] = len(seq)
                    toks, lps, q_out = self._timed(
                        "admit", (nb, S, topk),
                        self.engine.prefill_sample_batch,
                        tokens, seq_lens, tables, temps, key, return_topk=topk,
                        top_ps=tps,
                    )
                for row, (seq, (lane, req)) in enumerate(zip(seqs, plain)):
                    req.next_token = int(toks[row])
                    req.out_tokens.append(req.next_token)
                    req.out_logprobs.append(float(lps[row]))
                    if q_out and req.temperature > 0:
                        req.out_topk_ids.append(q_out[0][row])
                        req.out_topk_probs.append(q_out[1][row])
                    req.position = len(seq)

            if drafted:
                # one verify dispatch per (stochastic support width) subgroup:
                # rows with draft_q + temperature > 0 use the exact rejection
                # rule, the rest greedy argmax matching
                groups: dict = {}
                for lane, req in drafted:
                    kq = (
                        int(req.draft_q[1].shape[-1])
                        if req.draft_q is not None and req.temperature > 0
                        else None
                    )
                    groups.setdefault(kq, []).append((lane, req))
                for gi, (kq, grp) in enumerate(groups.items()):
                    self._admit_drafted(grp, _fold(key, 2 + gi), kq)
        except Exception as exc:  # noqa: BLE001 - admission must not kill the loop
            _fail_batch(exc)
            return 0

        for lane, req in batch:  # batch order == native lowest-free-lane order
            self._lanes[lane] = req
            if self._nlanes is not None:
                # emissions before this admission's own sampled token: the
                # verified draft prefix (drafted), or recomputed tokens from a
                # preemption (resumed) — the native budget is what remains
                pre = max(len(req.out_tokens) - 1, 0)
                got = self._nlanes.admit(
                    req.position, max(req.max_new - pre, 0), req.next_token
                )
                if got != lane:
                    raise RuntimeError(f"native lane table diverged: {got} != {lane}")
        return len(batch)

    # ------------------------------------------------- page-pressure policy
    def _alloc_admission(self, req: SchedRequest, n_own: int) -> list[int]:
        """Admission page grant. New arrivals never preempt running lanes
        (FIFO fairness: they wait instead), but idle refcount-0 prefix-cache
        pages ARE reclaimed under pressure."""
        while True:
            try:
                return self.engine.allocator.ensure(req.request_id, n_own)
            except ResourceError:
                prefix = self.engine.prefix_cache
                if prefix is None or not prefix.evict_one():
                    raise

    def _requeue_batch(self, batch, exc: ResourceError) -> None:
        """Back out an admission batch that hit page pressure: release any
        prefix refs / pages taken, then park the requests at the FRONT of the
        resume queue. A request that cannot fit even into an empty pool is
        failed permanently instead."""
        for lane, req in reversed(batch):
            self._release_prefix(req, failed=True)
            self.engine.allocator.free_request(req.request_id)
            self._tables[lane, :] = self._oob_page
            self._lanes[lane] = None
            req.n_reused = 0
            req.page_offset = 0
            total = len(self._seq(req)) + (len(req.draft) if req.draft else 0)
            needed = min((total + self.page) // self.page + 1, self.max_pages)
            if needed > self.engine.allocator.n_pages:
                self._drop_swap(req)
                req.error = str(exc)
                req.done = True
                if req.on_done is not None:
                    try:
                        req.on_done(req)
                    except Exception:  # noqa: BLE001
                        pass
                req._event.set()
            else:
                self._resume.appendleft(req)

    def _drop_swap(self, req: SchedRequest) -> None:
        """Release a parked host KV copy (request failed or abandoned)."""
        if req.swap_blob is not None:
            self._swap_bytes_held -= req.swap_bytes
            req.swap_blob = None
            req.swap_bytes = 0

    def _pick_victim(self, exclude: int = -1) -> Optional[int]:
        """Preemption victim: lowest priority first, newest arrival within a
        level (high-priority and oldest work keep their pages)."""
        cands = [
            ((-req.priority, req.arrival), lane)
            for lane, req in enumerate(self._lanes)
            if req is not None and lane != exclude
        ]
        return max(cands)[1] if cands else None

    def _preempt(self, lane: int) -> None:
        """Reclaim a lane's KV pages and park its request for recompute
        re-admission (role parity: vLLM's RECOMPUTE preemption — the
        capability the reference rents, SURVEY.md §2.8). The generated-so-far
        tokens are kept; admission re-prefills [prompt + generated] and the
        lane resumes exactly where it left off (identical output at
        temperature 0)."""
        # a pipelined in-flight round may hold the victim's newest tokens;
        # materialise it so out_tokens/position are current before the KV
        # snapshot (swap) or the recompute baseline is taken
        self._flush_scans()
        req = self._lanes[lane]
        if req is None:
            return
        if self.preemption_mode == "swap" and req.position > 0:
            # copy the live KV pages to host BEFORE the grant is reclaimed;
            # restore at re-admission is bit-exact, so the lane resumes
            # without recompute. Beyond the host-memory budget the victim
            # falls back to recompute (blob dropped).
            n_save = (req.position + self.page - 1) // self.page
            pages = [int(p) for p in self._tables[lane, :n_save]]
            if all(p != self._oob_page for p in pages):
                blob = self._timed(
                    "swap_out", (_bucket_pow2(len(pages), 2),),
                    self.engine.swap_out_pages, pages,
                )
                nbytes = sum(int(b.nbytes) for b in blob)
                if self._swap_bytes_held + nbytes <= self.max_swap_bytes:
                    req.swap_blob = blob
                    req.swap_pages = n_save
                    req.swap_bytes = nbytes
                    self._swap_bytes_held += nbytes
                    self.swap_preemptions += 1
        self._release_prefix(req)  # fills were written by admission: keep them
        self.engine.allocator.free_request(req.request_id)
        self._tables[lane, :] = self._oob_page
        self._lanes[lane] = None
        if self._nlanes is not None:
            self._nlanes.release(lane)
        # the draft admission already ran; its accepted prefix lives in
        # out_tokens, so the request resumes as a plain recompute
        req.draft = None
        req.draft_q = None
        req.n_reused = 0
        req.page_offset = 0
        req.preemptions += 1
        self.preemptions += 1
        self._resume.appendleft(req)

    def _ensure_pages(self, lane: int, req: SchedRequest, needed: int):
        """Grow a lane's pages to ``needed``, preempting the newest lanes on
        exhaustion. Returns the page list, or None when the lane itself had
        to be preempted (it was the newest — nothing older to reclaim)."""
        while True:
            try:
                return self.engine.allocator.ensure(
                    req.request_id, max(needed - req.page_offset, 1)
                )
            except ResourceError:
                # cheapest reclaim first: idle (refcount-0) prefix-cache pages
                prefix = self.engine.prefix_cache
                if prefix is not None and prefix.evict_one():
                    continue
                victim = self._pick_victim()
                if victim is None or victim == lane:
                    # the requester IS the newest (or only) lane: it yields
                    self._preempt(lane)
                    return None
                self._preempt(victim)

    def _fail_all_lanes(self, exc: Exception) -> None:
        """Last-resort recovery for an unexpected step() failure: retire
        every active lane with the error instead of letting the scheduler
        thread die (which would hang all in-flight and future requests)."""
        # abandon any in-flight round (its results are moot; fetching could
        # be the very thing that failed)
        self._pending = None
        self._patched_since = set()
        self._rebuilt_since = False
        self._carry = None
        self._carry_host = None
        for lane, req in enumerate(self._lanes):
            if req is not None:
                self._retire(lane, req, error=str(exc))

    def _admit_drafted(self, drafted, key, kq) -> None:
        """One fused verify+sample dispatch for a drafted-admission subgroup.
        ``kq``: support width for the exact stochastic rule, or None for
        greedy argmax acceptance. With the prefix cache on, each row's
        verify window is [uncached prompt suffix + draft]."""
        cached = self.engine.prefix_cache is not None
        d_lens = [len(req.draft) for _, req in drafted]
        Dw = _bucket_pow2(max(d_lens), 8, self.max_context)
        offs = [req.n_reused if cached else 0 for _, req in drafted]
        S = _bucket_pow2(
            max(
                len(r.prompt) + dl - o
                for (_, r), dl, o in zip(drafted, d_lens, offs)
            ),
            min(64, self.page) if cached else self.page,
            self.max_context,
        )
        n = len(drafted)
        # coarse row bucket {1, max_batch}, as in the JAX scheduler (whose
        # verify graphs are its biggest lattice: nb x S x Dw x support)
        nb = 1 if n == 1 else self.max_batch
        tokens = np.full((nb, S), PAD_ID, np.int32)
        p_lens = np.ones((nb,), np.int32)
        t_lens = np.ones((nb,), np.int32)
        tables = np.full((nb, self.max_pages), self._oob_page, np.int32)
        for row, (lane, req) in enumerate(drafted):
            seq = req.prompt[offs[row]:] + req.draft
            tokens[row, : len(seq)] = seq
            p_lens[row] = len(req.prompt)
            t_lens[row] = len(req.prompt) + len(req.draft)
            tables[row] = self._tables[lane]
        temps = np.zeros((nb,), np.float32)
        temps[:n] = [r.temperature for _, r in drafted]
        tps = np.ones((nb,), np.float32)
        tps[:n] = [r.top_p for _, r in drafted]
        dq = ()
        if kq is not None:
            dlp = np.zeros((nb, Dw), np.float32)
            qids = np.zeros((nb, Dw, kq), np.int32)
            qpr = np.zeros((nb, Dw, kq), np.float32)
            for row, (_, req) in enumerate(drafted):
                d = len(req.draft)
                lp_a, id_a, pr_a = req.draft_q
                dlp[row, :d] = np.asarray(lp_a, np.float32)[:d]
                qids[row, :d] = np.asarray(id_a, np.int32)[:d]
                qpr[row, :d] = np.asarray(pr_a, np.float32)[:d]
            dq = (dlp, qids, qpr)
        topk = self.spec_topk if any(r.temperature > 0 for _, r in drafted) else 0
        off_arr = np.zeros((nb,), np.int32)
        off_arr[:n] = offs
        n_accs, toks, lps, draft_lps, q_out = self._timed(
            "verify", (nb, S, Dw, kq or 0, topk),
            self.engine.verify_admit_sample_batch,
            tokens, p_lens, t_lens, tables, temps, key,
            max_draft=Dw, draft_q=dq, return_topk=topk,
            offsets=off_arr if cached else None, top_ps=tps,
        )
        eos = self.engine.eos_id
        for row, (lane, req) in enumerate(drafted):
            n_acc = int(n_accs[row])
            req.n_accepted = n_acc
            acc = req.draft[:n_acc]
            acc_lp = [float(x) for x in draft_lps[row, :n_acc]]
            want_q = bool(q_out) and req.temperature > 0

            def keep_q(count: int, row=row, q_out=q_out) -> tuple[list, list]:
                return list(q_out[0][row, :count]), list(q_out[1][row, :count])

            if eos is not None and eos in acc:
                # draft carried an eos the verifier accepted: finish there
                k = acc.index(eos) + 1
                req.out_tokens.extend(acc[:k])
                req.out_logprobs.extend(acc_lp[:k])
                if want_q:
                    qi, qp = keep_q(k)
                    req.out_topk_ids.extend(qi)
                    req.out_topk_probs.extend(qp)
                req.next_token = eos  # the scan retires before stepping
                req.position = len(req.prompt) + k
            elif n_acc >= req.max_new:
                # full budget verified in one pass; no bonus token fits
                req.out_tokens.extend(acc[: req.max_new])
                req.out_logprobs.extend(acc_lp[: req.max_new])
                if want_q:
                    qi, qp = keep_q(req.max_new)
                    req.out_topk_ids.extend(qi)
                    req.out_topk_probs.extend(qp)
                req.next_token = int(toks[row])
                req.position = len(req.prompt) + req.max_new
            else:
                req.out_tokens.extend(acc)
                req.out_logprobs.extend(acc_lp)
                req.next_token = int(toks[row])
                req.out_tokens.append(req.next_token)
                req.out_logprobs.append(float(lps[row]))
                if want_q:
                    # accepted rows + the bonus row (slot n_acc scores the
                    # emitted token's distribution — marginally the target)
                    qi, qp = keep_q(n_acc + 1)
                    req.out_topk_ids.extend(qi)
                    req.out_topk_probs.extend(qp)
                req.position = len(req.prompt) + n_acc

    def _release_prefix(self, req: SchedRequest, failed: bool = False) -> None:
        """Return the request's prefix-cache refs. ``failed`` = the admission
        prefill never ran, so this request's fill entries hold garbage pages
        and must be dropped (successful admissions wrote them: keep)."""
        prefix = self.engine.prefix_cache
        if prefix is None or not req.held_keys:
            return
        if failed and req.fill_keys:
            prefix.invalidate(req.fill_keys)
            fk = set(req.fill_keys)
            prefix.release([k for k in req.held_keys if k not in fk])
        else:
            prefix.release(req.held_keys)
        req.held_keys, req.fill_keys = [], []

    def _retire(self, lane: int, req: SchedRequest, error: Optional[str] = None) -> None:
        req.error = error or req.error
        req.done = True
        req.finished_at = time.monotonic()
        self._release_prefix(req)
        self.engine.allocator.free_request(req.request_id)
        self._tables[lane, :] = self._oob_page  # stale rows must not alias
        self._lanes[lane] = None
        if self._nlanes is not None:
            self._nlanes.release(lane)
        self.completed += 1
        if req.on_done is not None:
            try:
                req.on_done(req)
            except Exception:  # noqa: BLE001 - hooks must not kill the loop
                pass
        req._event.set()

    def _scan(self) -> list[tuple[int, SchedRequest, bool]]:
        """Per-step lane scan: retire finished lanes (budget/eos), return
        [(lane, request, needs_new_page)] for the lanes to step. Native C++
        table when built, identical Python loop otherwise."""
        if self._nlanes is not None:
            finished, active, _toks, _pos, needs = self._nlanes.step_prepare(
                self.engine.eos_id
            )
            for lane in finished:
                req = self._lanes[lane]
                if req is not None:
                    self._retire(lane, req)
            return [
                (lane, self._lanes[lane], bool(np_))
                for lane, np_ in zip(active, needs)
                if self._lanes[lane] is not None
            ]
        still = []
        for lane, req in enumerate(self._lanes):
            if req is None:
                continue
            if len(req.out_tokens) >= req.max_new or (
                self.engine.eos_id is not None and req.next_token == self.engine.eos_id
            ):
                self._retire(lane, req)
            else:
                still.append((lane, req, ((req.position + 1) % self.page) == 0))
        return still

    def step(self, n_steps: int = 1) -> int:
        """One scheduler iteration: admit, then ONE fused dispatch advancing
        every occupied lane by up to ``n_steps`` tokens. Returns the number
        of lanes stepped. Admission always runs first, so a scan only ever
        delays arrivals DURING it (bounded by one scan's wall time)."""
        self._admit()
        if n_steps == 1:
            # the single-step path book-keeps inline — materialise any
            # pipelined round first so host state is current
            self._flush_scans()
        # Check budgets/eos BEFORE stepping (the sampled token may finish one).
        still = self._scan()
        if not still and self._pending is not None:
            # host believes every lane idle, but an unprocessed round may
            # hold the last emissions (or completions) — drain it and look
            # again before declaring idle
            self._flush_scans()
            still = self._scan()
        if not still:
            return 0
        if n_steps > 1:
            return self._step_scan(still, n_steps)

        # page growth first (it can preempt lanes under pressure), THEN build
        # the dispatch arrays from the surviving lanes
        for lane, req, needs_page in still:
            if needs_page and self._lanes[lane] is req:
                # crossing a page boundary next write: grow one page ahead
                # (admission pre-allocated through the first boundary). Own
                # pages sit after the cache-owned prefix pages in the table.
                needed = min((req.position + 1) // self.page + 1, self.max_pages)
                pages = self._ensure_pages(lane, req, needed)
                if pages is None:
                    continue  # this lane was preempted; skip it this step
                self._tables[
                    lane, req.page_offset : req.page_offset + len(pages)
                ] = pages
        still = [(lane, req, n) for lane, req, n in still if self._lanes[lane] is req]
        if not still:
            return 0

        tokens = np.full((self.max_batch,), PAD_ID, np.int32)
        positions = np.zeros((self.max_batch,), np.int32)
        temps = np.zeros((self.max_batch,), np.float32)
        tps = np.ones((self.max_batch,), np.float32)
        for lane, req, _ in still:
            tokens[lane] = req.next_token
            positions[lane] = req.position
            temps[lane] = req.temperature
            tps[lane] = req.top_p

        self.steps += 1
        topk = self.spec_topk if any(r.temperature > 0 for _, r, _ in still) else 0
        toks, lps, q_out = self._timed(
            "scan", (1, topk),
            self.engine.decode_sample_batch,
            tokens, positions, self._tables, temps, self.steps,
            return_topk=topk, top_ps=tps,
        )
        for lane, req, _ in still:
            req.next_token = int(toks[lane])
            req.out_tokens.append(req.next_token)
            req.out_logprobs.append(float(lps[lane]))
            if q_out and req.temperature > 0:
                req.out_topk_ids.append(q_out[0][lane])
                req.out_topk_probs.append(q_out[1][lane])
            req.position += 1
            if self._nlanes is not None:
                self._nlanes.advance(lane, req.next_token)
        return len(still)

    def _sync_carry(self, tokens, positions, temps, tps, remaining) -> None:
        """Reconcile the device carry with the desired host state. The
        desired arrays (what the non-carry path would upload) are diffed
        against the mirror of what the device already holds; only changed
        lanes are scatter-patched, and the whole carry is rebuilt when most
        lanes changed (or none exists). Lanes with zero budget are masked
        on device, so retired lanes need no patch beyond zeroing their
        budget. Patched/rebuilt lanes are recorded so a pipelined in-flight
        round's results for them are discarded (they get recomputed from
        the patched state)."""
        eng = self.engine
        mir = self._carry_host
        self._carry_rounds += 1
        rebuild = self._carry is None or mir is None
        if not rebuild:
            act = remaining > 0
            differs = (
                (mir["tok"] != tokens) | (mir["pos"] != positions)
                | (mir["rem"] != remaining) | (mir["temps"] != temps)
                | (mir["tps"] != tps)
            )
            # inactive lanes only need their device budget zeroed; their
            # stale token/position are masked by the graph
            need = np.nonzero((act & differs) | (~act & (mir["rem"] > 0)))[0]
            if len(need) > self.max_batch // 2:
                rebuild = True
            elif len(need):
                self._carry = eng.scan_carry_update(
                    self._carry, need, tokens[need], positions[need],
                    remaining[need], temps[need], tps[need],
                )
                self._carry_patches += 1
                self._patched_since.update(int(x) for x in need)
                for f, arr in (("tok", tokens), ("pos", positions),
                               ("rem", remaining), ("temps", temps),
                               ("tps", tps)):
                    mir[f][need] = arr[need]
        if rebuild:
            self._carry = eng.scan_carry_init(
                tokens, positions, remaining, temps, tps, seed=self.steps
            )
            self._carry_host = {
                "tok": tokens.copy(), "pos": positions.copy(),
                "rem": remaining.copy(), "temps": temps.copy(),
                "tps": tps.copy(),
            }
            self._carry_rebuilds += 1
            self._rebuilt_since = True
        if self._tables_uploaded is None or not np.array_equal(
            self._tables_uploaded, self._tables
        ):
            self._tables_dev = self.engine.tables_to_device(self._tables)
            self._tables_uploaded = self._tables.copy()

    def _advance_mirror(self, out_t, emitted, lanes) -> None:
        """Advance the mirror exactly as the graph advanced the carry (only
        for lanes whose results were applied — patched lanes were already
        overwritten with their post-patch state)."""
        mir = self._carry_host
        eos = self.engine.eos_id
        for lane in lanes:
            k = int(emitted[lane])
            if k == 0:
                continue
            last = int(out_t[lane, k - 1])
            mir["tok"][lane] = last
            mir["pos"][lane] += k
            mir["rem"][lane] = (
                0 if (eos is not None and last == eos)
                else mir["rem"][lane] - k
            )

    def _dispatch_scan_carried(self, tokens, positions, temps, tps, remaining,
                               n_steps: int, topk: int):
        """Non-pipelined carry dispatch: sync, dispatch, fetch inline."""
        self._sync_carry(tokens, positions, temps, tps, remaining)
        (out_t, out_l, emitted, q_out), self._carry = self._timed(
            "scan", (n_steps, topk),
            self.engine.decode_sample_scan_carry, self._carry,
            self._tables_dev, n_steps=n_steps, return_topk=topk,
        )
        # results are applied (and the mirror advanced) by the caller's
        # _apply_scan_results; consume the epoch — nothing is in flight
        self._patched_since.clear()
        self._rebuilt_since = False
        return out_t, out_l, emitted, q_out

    def _apply_scan_results(self, out_t, out_l, emitted, q_out, lanes,
                            skip_lanes=frozenset(), skip_all=False) -> None:
        """Book-keep one fetched round. ``lanes``: [(lane, req)] snapshot at
        dispatch time — results apply only if the lane still belongs to the
        same request (preempted/retired lanes' emissions are recomputed or
        irrelevant) and the lane was not patched/rebuilt after dispatch."""
        applied = []
        for lane, req in lanes:
            if skip_all or lane in skip_lanes or self._lanes[lane] is not req:
                continue
            k = int(emitted[lane])
            if k == 0:
                continue
            req.out_tokens.extend(int(t) for t in out_t[lane, :k])
            req.out_logprobs.extend(float(x) for x in out_l[lane, :k])
            if q_out and req.temperature > 0:
                req.out_topk_ids.extend(q_out[0][lane, :k])
                req.out_topk_probs.extend(q_out[1][lane, :k])
            req.position += k
            req.next_token = int(out_t[lane, k - 1])
            if self._nlanes is not None:
                for t in out_t[lane, :k]:
                    self._nlanes.advance(lane, int(t))
            applied.append(lane)
        if not skip_all and self._carry_host is not None:
            self._advance_mirror(out_t, emitted, applied)

    def _process_pending(self) -> None:
        """Fetch + book-keep the in-flight pipelined round, consuming the
        patched/rebuilt epoch that accumulated since its dispatch."""
        if self._pending is None:
            return
        handles, lanes, topk = self._pending
        self._pending = None
        skip, self._patched_since = self._patched_since, set()
        skip_all, self._rebuilt_since = self._rebuilt_since, False
        out_t, out_l, emitted, q_out = self.engine.fetch_scan_handles(handles)
        self._apply_scan_results(out_t, out_l, emitted, q_out, lanes,
                                 skip_lanes=skip, skip_all=skip_all)

    def _pipelined_round(self, tokens, positions, temps, tps, remaining,
                         n_steps: int, topk: int, still) -> int:
        """Dispatch round N from the carry, THEN fetch round N-1: the device
        stays a dispatch ahead of the host's bookkeeping, which runs one
        round stale by construction."""
        def round_body():
            self._sync_carry(tokens, positions, temps, tps, remaining)
            handles, self._carry = self.engine.decode_sample_scan_carry_async(
                self._carry, self._tables_dev,
                n_steps=n_steps, return_topk=topk,
            )
            prev_epoch = (self._pending, self._patched_since,
                          self._rebuilt_since)
            self._pending = (handles, [(ln, rq) for ln, rq, _ in still], topk)
            self._patched_since = set()
            self._rebuilt_since = False
            pend, skip, skip_all = prev_epoch
            if pend is not None:
                p_handles, p_lanes, _ = pend
                out_t, out_l, emitted, q_out = (
                    self.engine.fetch_scan_handles(p_handles)
                )
                self._apply_scan_results(out_t, out_l, emitted, q_out,
                                         p_lanes, skip_lanes=skip,
                                         skip_all=skip_all)
            return len(still)

        return self._timed("scan", (n_steps, topk), round_body)

    def _flush_scans(self) -> None:
        """Materialise the in-flight round before any operation that needs
        host state current (single-step path, preemption, drain)."""
        if self._pending is not None:
            self._process_pending()

    def _step_scan(self, still, n_steps: int) -> int:
        """Advance the active lanes by up to ``n_steps`` tokens in ONE
        dispatch (engine.decode_sample_scan). Pages are pre-grown to cover
        the whole scan; per-lane budgets/eos mask emissions on device."""
        # page growth first (it can preempt lanes under pressure), THEN build
        # the dispatch arrays from the surviving lanes. Pipelined scans run
        # host bookkeeping one round stale: pre-grow pages for TWO rounds so
        # the device (one round ahead) never outruns its table.
        horizon = 2 * n_steps if self.pipeline_scans else n_steps
        for lane, req, _needs in still:
            if self._lanes[lane] is not req:
                continue
            budget = max(req.max_new - len(req.out_tokens), 0)
            needed = min(
                (req.position + min(horizon, budget) + 1) // self.page + 1,
                self.max_pages,
            )
            pages = self._ensure_pages(lane, req, needed)
            if pages is None:
                continue  # this lane was preempted; skip it this scan
            self._tables[
                lane, req.page_offset : req.page_offset + len(pages)
            ] = pages
        still = [(lane, req, n) for lane, req, n in still if self._lanes[lane] is req]
        if not still:
            return 0

        tokens = np.full((self.max_batch,), PAD_ID, np.int32)
        positions = np.zeros((self.max_batch,), np.int32)
        temps = np.zeros((self.max_batch,), np.float32)
        tps = np.ones((self.max_batch,), np.float32)
        remaining = np.zeros((self.max_batch,), np.int32)
        for lane, req, _ in still:
            tokens[lane] = req.next_token
            positions[lane] = req.position
            temps[lane] = req.temperature
            tps[lane] = req.top_p
            remaining[lane] = max(req.max_new - len(req.out_tokens), 0)

        self.steps += 1
        topk = self.spec_topk if any(r.temperature > 0 for _, r, _ in still) else 0
        if self.pipeline_scans:
            # Endgame de-pipelining: when every lane is within two rounds of
            # its budget, the in-flight round may finish them all — dispatch-
            # ing another (fully masked) speculative round would add a whole
            # scan of pure drain latency per request. Fetch first and re-
            # derive the lane set instead; mid-stream traffic (any lane with
            # >2 rounds to go) keeps the pipeline. EOS-ended lanes still pay
            # one masked round (the host cannot predict eos).
            if self._pending is not None and all(
                max(rq.max_new - len(rq.out_tokens), 0) <= 2 * n_steps
                for _, rq, _ in still
            ):
                self._flush_scans()
                still = [
                    (ln, rq, nd) for ln, rq, nd in still
                    if self._lanes[ln] is rq
                    and len(rq.out_tokens) < rq.max_new
                    and not (self.engine.eos_id is not None
                             and rq.next_token == self.engine.eos_id)
                ]
                if not still:
                    # the flushed round completed every lane; retire them
                    # via the normal scan path on the next step()
                    return 0
                for lane, req, _ in still:
                    tokens[lane] = req.next_token
                    positions[lane] = req.position
                    remaining[lane] = max(req.max_new - len(req.out_tokens), 0)
                # lanes dropped by the flush must be masked in this dispatch
                active = {ln for ln, _, _ in still}
                for lane in range(self.max_batch):
                    if lane not in active:
                        remaining[lane] = 0
            return self._pipelined_round(
                tokens, positions, temps, tps, remaining, n_steps, topk, still
            )
        if self.device_carry:
            out_t, out_l, emitted, q_out = self._dispatch_scan_carried(
                tokens, positions, temps, tps, remaining, n_steps, topk
            )
        else:
            out_t, out_l, emitted, q_out = self._timed(
                "scan", (n_steps, topk),
                self.engine.decode_sample_scan,
                tokens, positions, self._tables, temps,
                self.steps,
                remaining, n_steps=n_steps, return_topk=topk, top_ps=tps,
            )
        self._apply_scan_results(out_t, out_l, emitted, q_out,
                                 [(ln, rq) for ln, rq, _ in still])
        return len(still)

    # ------------------------------------------------------------------ loop
    def run_until_idle(self, max_steps: int = 100_000) -> None:
        """Drain queue + lanes (offline/batch mode)."""
        for _ in range(max_steps):
            n = self.step(self.scan_steps)
            if (
                n == 0
                and self._queue.empty()
                and not self._resume
                and not any(self._lanes)
            ):
                return

    def start(self) -> None:
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _loop(self) -> None:  # pragma: no cover - thread loop
        dev = self.engine.device
        if dev.type == "cuda" and dev.index is not None:
            import torch

            torch.cuda.set_device(dev)  # the current device is per thread
        while not self._stop.is_set():
            # step() admits first, so waiting requests enter lanes before
            # each scan; scanning costs new arrivals at most one scan's wall
            # time of admission latency
            try:
                n = self.step(self.scan_steps)
            except Exception as exc:  # noqa: BLE001 - the loop must survive
                # an unexpected step failure: fail the active lanes (their
                # requests see the error) instead of dying silently, which
                # would hang every in-flight and future request on this tier
                self._fail_all_lanes(exc)
                n = 0
            if n == 0:
                time.sleep(0.001)

    def reset_dispatch_stats(self) -> None:
        """Zero the per-kind dispatch timers and bucket tallies (measured
        benchmark passes call this after their warm phase). The warmed-
        lattice set is kept — cold-bucket detection stays valid."""
        self._disp = {k: [0, 0.0, 0.0] for k in self._disp}
        self._buckets.clear()

    def idle_capacity(self) -> int:
        """Free lanes beyond already-queued work — capacity a speculative
        prefetch may consume without delaying real admissions. Approximate
        (read without the dispatch lock); callers treat it as a hint."""
        free = sum(r is None for r in self._lanes)
        return max(free - self._queue.qsize() - len(self._resume), 0)

    def backlogged(self) -> bool:
        """True when queued work exceeds free lanes — the tier cannot absorb
        its queue in the next admission window, i.e. the system is saturated
        rather than bursting. Speculative prefetch keys off this: on shared
        hardware a prefetch prefill steals device time from EVERY tier, so
        it must fire only when no tier is running a backlog (approximate,
        lock-free — callers treat it as a hint)."""
        free = sum(r is None for r in self._lanes)
        return self._queue.qsize() + len(self._resume) > free

    def stats(self) -> dict:
        occ = sum(r is not None for r in self._lanes)
        return {
            "lanes": self.max_batch,
            "occupied": occ,
            "queued": self._queue.qsize(),
            "resume_queued": len(self._resume),
            "steps": self.steps,
            "completed": self.completed,
            "preemptions": self.preemptions,
            "preemption_mode": self.preemption_mode,
            "swap_preemptions": self.swap_preemptions,
            "swap_bytes_held": self._swap_bytes_held,
            "allocator": vars(self.engine.allocator.stats()),
            # where the scheduler thread's wall time goes, by dispatch kind;
            # max_s >> mean flags a first use (kernel build)
            "dispatch": {
                k: {
                    "n": d[0],
                    "total_s": round(d[1], 3),
                    "mean_ms": round(1e3 * d[1] / d[0], 2) if d[0] else 0.0,
                    "max_s": round(d[2], 3),
                }
                for k, d in self._disp.items()
            },
            "carry": {
                "enabled": self.device_carry,
                "pipelined": self.pipeline_scans,
                "rounds": self._carry_rounds,
                "rebuilds": self._carry_rebuilds,
                "patches": self._carry_patches,
            },
            "graph_buckets": len(self._buckets),
            "bucket_hits": {
                " ".join(map(str, k)): v for k, v in self._buckets.most_common()
            },
        }
