"""Tier execution engine: generation and speculative verify-and-continue
(counterpart of ``adaptive_sd_tpu/engine/decode.py``).

The JAX engine fuses prefill and a ``lax.while_loop`` decode into one jitted
graph per shape bucket. Here the same steps run eagerly: a prefill (or a
prefix-cached window prefill), then a Python loop over ``decode_step`` with
the JAX loop's early exit and the same padding of ``out_toks``, ``out_lps``
and ``gen_len``. Loop bookkeeping (write slots, budgets) lives on the host;
tokens stay on the device and come back in one copy per call (one per step
only when an ``eos_id`` must be checked). The shape bucketing of the JAX
engine is kept, so both packages see the same padded shapes.

For the continuous-batching scheduler (engine/scheduler.py) the engine also
has one-dispatch calls: a forward, the per-row sampling and one fetch
(``prefill_sample_batch``, ``prefill_window_sample_batch``,
``decode_sample_batch``, ``verify_admit_sample_batch``), a multi-step decode
scan whose masks live on the device so that nothing syncs with the host
between its steps (``decode_sample_scan`` and the device-carry variants), and
the KV page swap. Where the JAX engine takes a ``jax.random`` key these take
an integer seed and make a ``torch.Generator`` on the engine's device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.exceptions import ResourceError
from ..models.config import ModelSpec
from ..models.qwen import decode_step, logits_at, prefill, prefill_window
from ..ops.quant import QuantizedTensor
from ..ops.sampling import (
    SampleResult,
    _categorical,
    adjusted_logits,
    row_adjusted_logits,
    sample,
    sample_rows_with_topk,
    sample_with_topk,
    speculative_accept,
)
from .allocator import PageAllocator
from .kv_cache import PagedKVCache
from .prefix_cache import PrefixCache

PAD_ID = 0


def _bucket_batch(b: int) -> int:
    return 1 << max(0, (b - 1).bit_length())


def _bucket_len(s: int, multiple: int) -> int:
    return max(multiple, ((s + multiple - 1) // multiple) * multiple)


def _bucket_pow2(s: int, floor: int, cap: Optional[int] = None) -> int:
    """Geometric length bucket: next power of two >= ``s``, floored at
    ``floor`` and clamped to ``cap`` (rounded up to a ``floor`` multiple)."""
    b = max(floor, 1 << max(s - 1, 0).bit_length())
    if cap is not None:
        b = min(b, _bucket_len(cap, floor))
    return b


@dataclass
class GenerationOutput:
    """Per-request generation payload (host side)."""

    token_ids: np.ndarray      # [n] int32
    logprobs: np.ndarray       # [n] float32
    prefill_time_s: float
    decode_time_s: float
    # top-K of the adjusted sampling distribution per generated token, for a
    # later tier's stochastic verify; None unless requested
    topk_ids: Optional[np.ndarray] = None    # [n, K] int32
    topk_probs: Optional[np.ndarray] = None  # [n, K] float32

    @property
    def num_tokens(self) -> int:
        return int(self.token_ids.shape[0])


def _param_bytes(node) -> int:
    if isinstance(node, dict):
        return sum(_param_bytes(v) for v in node.values())
    if isinstance(node, (list, tuple)):
        return sum(_param_bytes(v) for v in node)
    if isinstance(node, QuantizedTensor):
        return node.nbytes()
    if isinstance(node, torch.Tensor):
        return node.numel() * node.element_size()
    return 0


class TierEngine:
    """One cascade tier: params + paged KV cache + page allocation, on one
    device (CUDA unless ``device="cpu"`` is passed). Callers serialise
    generate calls per engine; the allocator is locked."""

    def __init__(
        self,
        spec: ModelSpec,
        params,
        *,
        name: Optional[str] = None,
        page_size: int = 128,
        n_pages: int = 512,
        eos_id: Optional[int] = None,
        cost_per_token: float = 1.0,
        enable_prefix_cache: bool = False,
        device=None,
        act_quant: bool = False,
        prefix_spill_bytes: int = 0,
    ) -> None:
        """``act_quant``: INT8 weights take the W8A8 path (dynamic INT8
        activations, ``ops.matmul_q.quantized_matmul_w8a8``) in every forward
        of this engine. ``prefix_spill_bytes`` > 0: evicted prefix-cache
        pages spill to host memory and restore bit-exactly on a chain-intact
        re-acquire instead of recomputing the prefill."""
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(
                f"params live on {params['embed'].device}, the engine on {self.device}"
            )
        self.spec = spec
        self.name = name or spec.name
        self.page_size = page_size
        self.eos_id = eos_id
        self.cost_per_token = cost_per_token
        self.params = params
        self.act_quant = bool(act_quant)
        # extra keywords of every forward call (empty without act_quant)
        self._fwd_kw = {"act_quant": True} if self.act_quant else {}
        self.allocator = PageAllocator(n_pages)
        self.cache = PagedKVCache.create(spec, n_pages, page_size, device=self.device)
        # automatic prefix caching: content-addressed KV-page reuse; prompts
        # then prefill only their uncached suffix window (prefill_window)
        self.prefix_cache = (
            PrefixCache(self.allocator, page_size, spill_bytes=prefix_spill_bytes,
                        swap_out=self.swap_out_pages, swap_in=self.swap_in_pages)
            if enable_prefix_cache else None
        )
        self.total_generated_tokens = 0
        self.total_decode_time_s = 0.0

    # helpers ------------------------------------------------------------------
    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def _acquire_prefixes(self, prompts):
        """Acquire prefix-cache chains for a batch, unwinding earlier
        acquisitions if a later one hits allocator pressure."""
        acqs = []
        try:
            for p in prompts:
                acqs.append(self.prefix_cache.acquire(p))
        except Exception:
            self._release_failed(acqs)
            raise
        return acqs

    def _release_failed(self, acqs) -> None:
        """Drop the fresh (unfilled) entries of failed acquisitions and
        release their cached ones."""
        for _, _, held, fill in acqs:
            fkeys = {k for k, _ in fill}
            self.prefix_cache.invalidate(list(fkeys))
            self.prefix_cache.release([k for k in held if k not in fkeys])

    def _alloc(self, request_id: str, n: int) -> list[int]:
        """allocator.alloc, evicting idle prefix pages under pressure before
        the ResourceError propagates."""
        while True:
            try:
                return self.allocator.alloc(request_id, n)
            except ResourceError:
                if self.prefix_cache is None or not self.prefix_cache.evict_one():
                    raise

    def _first_token(self, logits, gen, temperature, top_p, return_topk):
        if return_topk:
            first, qi, qp = sample_with_topk(logits, gen, return_topk, temperature, top_p)
            return first, (qi, qp)
        return sample(logits, gen, temperature=temperature, top_p=top_p), ()

    def _decode_loop(self, first, q_cur, seq_lens, block_tables, gen, *, budget, max_new,
                     temperature, top_p, return_topk, decide=None):
        """Decode tail shared by generate paths (JAX ``_decode_loop``):
        write sampled tokens until budget/eos. ``seq_lens`` [B] are the
        context lengths when ``first`` was sampled. Returns host arrays
        (out_toks [B, max_new], out_lps, gen_len [B], q_bufs). ``decide``
        (out_lps [B, max_new], gen_len [B], both on the device) -> tensors
        runs on the device before anything is fetched; its results come back
        as a fifth item, fetched with the tokens."""
        B = seq_lens.shape[0]
        active = np.ones(B, bool)
        gen_len = np.zeros(B, np.int32)
        toks, lps, writes, q_rows = [], [], [], []
        tok = first
        for i in range(max_new):
            writing = active & (i < budget)
            toks.append(tok.token)
            lps.append(tok.logprob)
            writes.append(writing)
            if return_topk:
                q_rows.append(q_cur)
            gen_len += writing
            if self.eos_id is not None:
                active &= tok.token.cpu().numpy() != self.eos_id
            active &= i + 1 < budget
            if not (active.any() and i + 1 < max_new):
                break  # the JAX loop decodes once more here; nothing reads it
            logits, _ = decode_step(self.params, self.spec, tok.token, seq_lens + i,
                                    self.cache, block_tables, **self._fwd_kw)
            if return_topk:
                tok, qi, qp = sample_with_topk(logits, gen, return_topk, temperature, top_p)
                q_cur = (qi, qp)
            else:
                tok = sample(logits, gen, temperature=temperature, top_p=top_p)

        n = len(toks)
        wmask = np.stack(writes, axis=1)                                  # [B, n]
        decided = None
        if decide is not None:
            wmask_d = self._t(wmask)
            lps_d = torch.zeros((B, max_new), dtype=torch.float32, device=self.device)
            lps_d[:, :n] = torch.where(wmask_d, torch.stack(lps, 1).float(), 0.0)
            decided = decide(lps_d, wmask_d.sum(dim=1))
        out_toks = np.full((B, max_new), PAD_ID, np.int32)
        out_lps = np.zeros((B, max_new), np.float32)
        out_toks[:, :n] = np.where(wmask, torch.stack(toks, 1).cpu().numpy(), PAD_ID)
        out_lps[:, :n] = np.where(wmask, torch.stack(lps, 1).float().cpu().numpy(), 0.0)
        q_bufs = ()
        if return_topk:
            qi = np.zeros((B, max_new, return_topk), np.int32)
            qp = np.zeros((B, max_new, return_topk), np.float32)
            qi[:, :n] = np.where(wmask[..., None],
                                 torch.stack([q[0] for q in q_rows], 1).cpu().numpy(), 0)
            qp[:, :n] = np.where(wmask[..., None],
                                 torch.stack([q[1] for q in q_rows], 1).cpu().numpy(), 0.0)
            q_bufs = (qi, qp)
        if decided is not None:
            return out_toks, out_lps, gen_len, q_bufs, tuple(d.cpu().numpy() for d in decided)
        return out_toks, out_lps, gen_len, q_bufs

    def _outputs(self, out_toks, out_lps, gen_len, q_bufs, B, dt, return_topk):
        results = []
        for i in range(B):
            n = int(gen_len[i])
            results.append(
                GenerationOutput(
                    token_ids=out_toks[i, :n].copy(),
                    logprobs=out_lps[i, :n].copy(),
                    prefill_time_s=0.0,
                    decode_time_s=dt,
                    topk_ids=q_bufs[0][i, :n].copy() if return_topk else None,
                    topk_probs=q_bufs[1][i, :n].copy() if return_topk else None,
                )
            )
        self.total_generated_tokens += int(gen_len[:B].sum())
        self.total_decode_time_s += dt
        return results

    # generation -----------------------------------------------------------------
    def generate(
        self,
        prompts: Sequence[Sequence[int]],
        *,
        max_new: int = 128,
        temperature: float = 0.0,
        top_p: float = 1.0,
        seed: int = 0,
        return_topk: int = 0,
    ) -> list[GenerationOutput]:
        """Prefill + decode each prompt. ``return_topk`` > 0 (temperature >
        0 only) also returns the top-K of each step's sampling distribution,
        the draft-side support for a later tier's stochastic verify."""
        if return_topk and temperature <= 0.0:
            return_topk = 0  # greedy verify needs no draft distribution
        if self.prefix_cache is not None:
            return self._generate_cached(
                prompts, max_new=max_new, temperature=temperature, top_p=top_p,
                seed=seed, return_topk=return_topk,
            )
        out, dt = self._generate_uncached(prompts, max_new, temperature, top_p, seed,
                                          return_topk)
        return self._outputs(*out, len(prompts), dt, return_topk)

    def _generate_uncached(self, prompts, max_new, temperature, top_p, seed, return_topk,
                           decide=None):
        """Full prefill + decode loop without the prefix cache. Returns
        (the decode loop's host arrays, seconds)."""
        B = len(prompts)
        Bb = _bucket_batch(B)
        lens = [len(p) for p in prompts]
        S = _bucket_len(max(lens), min(64, self.page_size))
        max_new_b = _bucket_len(max_new, 32)
        max_pages = (S + max_new_b + self.page_size - 1) // self.page_size + 1

        tokens = np.full((Bb, S), PAD_ID, np.int32)
        for i, p in enumerate(prompts):
            tokens[i, : len(p)] = np.asarray(p, np.int32)
        seq_lens = np.asarray(lens + [1] * (Bb - B), np.int32)

        rid = f"gen{id(self)}_{time.monotonic_ns()}"
        tables = np.zeros((Bb, max_pages), np.int32)
        try:
            for b in range(Bb):
                tables[b] = self._alloc(f"{rid}_{b}", max_pages)
            t0 = time.perf_counter()
            gen = self._generator(seed)
            seq_lens_t, tables_t = self._t(seq_lens), self._t(tables)
            logits, _ = prefill(self.params, self.spec, self._t(tokens), seq_lens_t,
                                self.cache, tables_t, **self._fwd_kw)
            first, q_cur = self._first_token(logits, gen, temperature, top_p, return_topk)
            out = self._decode_loop(
                first, q_cur, seq_lens_t, tables_t, gen, budget=max_new, max_new=max_new_b,
                temperature=temperature, top_p=top_p, return_topk=return_topk, decide=decide,
            )
            dt = time.perf_counter() - t0
        finally:
            for b in range(Bb):
                self.allocator.free_request(f"{rid}_{b}")
        return out, dt

    def _generate_cached(self, prompts, *, max_new, temperature, top_p, seed, return_topk):
        """Prefix-cache generation: acquire cached page-aligned prompt
        prefixes, prefill only the suffix windows, decode as usual. Fresh
        full-page chunks written by this call become cached entries."""
        B = len(prompts)
        Bb = _bucket_batch(B)
        page = self.page_size
        lens = [len(p) for p in prompts]
        max_new_b = _bucket_len(max_new, 32)
        max_pages = (max(lens) + max_new_b + page - 1) // page + 1
        oob = self.allocator.n_pages

        acqs = self._acquire_prefixes(prompts)
        offs = [a[1] for a in acqs]
        suffix = [list(p)[o:] for p, o in zip(prompts, offs)]
        Wb = _bucket_len(max(len(sx) for sx in suffix), min(64, page))

        tokens = np.full((Bb, Wb), PAD_ID, np.int32)
        offsets = np.zeros((Bb,), np.int32)
        win_lens = np.ones((Bb,), np.int32)
        tables = np.full((Bb, max_pages), oob, np.int32)
        rid = f"genc{id(self)}_{time.monotonic_ns()}"
        try:
            for i, (sx, (pref_pages, n_reused, _held, _fill)) in enumerate(zip(suffix, acqs)):
                tokens[i, : len(sx)] = np.asarray(sx, np.int32)
                offsets[i] = n_reused
                win_lens[i] = len(sx)
                needed = min((lens[i] + max_new_b + page - 1) // page + 1, max_pages)
                own = max(needed - len(pref_pages), 0)
                tables[i, : len(pref_pages)] = pref_pages
                if own:
                    tables[i, len(pref_pages) : len(pref_pages) + own] = (
                        self._alloc(f"{rid}_{i}", own)
                    )
            t0 = time.perf_counter()
            gen = self._generator(seed)
            offsets_t, win_lens_t, tables_t = self._t(offsets), self._t(win_lens), self._t(tables)
            h, _ = prefill_window(self.params, self.spec, self._t(tokens), offsets_t,
                                  win_lens_t, self.cache, tables_t, **self._fwd_kw)
            last = h[torch.arange(Bb, device=h.device), (win_lens_t.long() - 1).clamp(min=0)]
            logits = logits_at(self.params, self.spec, last, **self._fwd_kw)
            first, q_cur = self._first_token(logits, gen, temperature, top_p, return_topk)
            out = self._decode_loop(
                first, q_cur, offsets_t + win_lens_t, tables_t, gen, budget=max_new,
                max_new=max_new_b, temperature=temperature, top_p=top_p,
                return_topk=return_topk,
            )
            dt = time.perf_counter() - t0
        except Exception:
            self._release_failed(acqs)
            raise
        finally:
            for i in range(B):
                self.allocator.free_request(f"{rid}_{i}")
        for _, _, held, _fill in acqs:
            self.prefix_cache.release(held)
        return self._outputs(*out, B, dt, return_topk)

    # single steps and streaming -----------------------------------------------------
    def prefill_batch(self, tokens: torch.Tensor, seq_lens: torch.Tensor,
                      block_tables: torch.Tensor) -> torch.Tensor:
        """One prefill over caller-managed pages; returns last-token logits."""
        logits, _ = prefill(self.params, self.spec, tokens, seq_lens, self.cache, block_tables,
                            **self._fwd_kw)
        return logits

    def decode_batch(self, tokens: torch.Tensor, positions: torch.Tensor,
                     block_tables: torch.Tensor) -> torch.Tensor:
        """One decode step over caller-managed pages; returns logits [B, V]."""
        logits, _ = decode_step(self.params, self.spec, tokens, positions, self.cache,
                                block_tables, **self._fwd_kw)
        return logits

    def stream(
        self,
        prompt: Sequence[int],
        *,
        max_new: int = 128,
        temperature: float = 0.0,
        top_p: float = 1.0,
        seed: int = 0,
    ):
        """Token-by-token generator (reference ModelStage.generate_stream
        contract, src/core/interfaces.py:81): one step and one fetch per
        token, inherent to streaming. Yields (token_id, logprob)."""
        S = _bucket_len(len(prompt), min(64, self.page_size))
        max_pages = (S + max_new + self.page_size - 1) // self.page_size + 1
        rid = f"str{id(self)}_{time.monotonic_ns()}"
        pages = self._alloc(rid, max_pages)
        try:
            tokens = np.full((1, S), PAD_ID, np.int32)
            tokens[0, : len(prompt)] = np.asarray(prompt, np.int32)
            tables = self._t(np.asarray(pages, np.int32)[None, :])
            logits = self.prefill_batch(
                self._t(tokens), self._t(np.asarray([len(prompt)], np.int32)), tables
            )
            gen = self._generator(seed)
            pos = len(prompt)
            for step in range(max_new):
                res = sample(logits, gen, temperature=temperature, top_p=top_p)
                tok = int(res.token[0])
                yield tok, float(res.logprob[0])
                if self.eos_id is not None and tok == self.eos_id:
                    return
                if step == max_new - 1:
                    return
                logits = self.decode_batch(
                    self._t(np.asarray([tok], np.int32)), self._t(np.asarray([pos], np.int32)),
                    tables,
                )
                pos += 1
        finally:
            self.allocator.free_request(rid)


    # one-dispatch calls for the continuous-batching scheduler -----------------------
    @staticmethod
    def _host(*tensors):
        """Copy result tensors to the host (the call's one sync point);
        ``None`` stays ``None``, floats come back as f32."""
        out = []
        for t in tensors:
            if t is None:
                out.append(None)
            else:
                t = t.detach()
                out.append((t.float() if t.is_floating_point() else t).cpu().numpy())
        return out

    def _rows(self, temps, top_ps):
        temps_t = self._t(np.asarray(temps, np.float32))
        if top_ps is None:
            top_ps = np.ones(len(temps), np.float32)
        return temps_t, self._t(np.asarray(top_ps, np.float32))

    def _sample_fetch(self, logits, seed, temps, top_ps, return_topk):
        """Per-row sampling of last-token logits and the fetch: host (tokens
        [B], logprobs [B], q_out), q_out () or (topk_ids [B, K], topk_probs)."""
        temps_t, tps_t = self._rows(temps, top_ps)
        res, qi, qp = sample_rows_with_topk(logits, self._generator(seed), temps_t,
                                            return_topk, tps_t)
        tok, lp, qi, qp = self._host(res.token, res.logprob, qi, qp)
        return tok, lp, ((qi, qp) if return_topk else ())

    def prefill_sample_batch(self, tokens, seq_lens, block_tables, temps, seed: int,
                             *, return_topk: int = 0, top_ps=None):
        """Prefill + per-row sample in one dispatch (scheduler admission):
        host arrays in, host (tokens [B], logprobs [B], q_out) out.
        ``top_ps`` [B]: per-row nucleus parameter (None = 1.0)."""
        logits, _ = prefill(self.params, self.spec, self._t(np.asarray(tokens)),
                            self._t(np.asarray(seq_lens, np.int32)), self.cache,
                            self._t(np.asarray(block_tables, np.int32)), **self._fwd_kw)
        return self._sample_fetch(logits, seed, temps, top_ps, return_topk)

    def decode_sample_batch(self, tokens, positions, block_tables, temps, seed: int,
                            *, return_topk: int = 0, top_ps=None):
        """One decode step + per-row sample (scheduler single-step loop): one
        dispatch, one [B]-sized fetch."""
        logits, _ = decode_step(self.params, self.spec,
                                self._t(np.asarray(tokens, np.int32)),
                                self._t(np.asarray(positions, np.int32)), self.cache,
                                self._t(np.asarray(block_tables, np.int32)), **self._fwd_kw)
        return self._sample_fetch(logits, seed, temps, top_ps, return_topk)

    def prefill_window_sample_batch(self, tokens_w, offsets, win_lens, block_tables, temps,
                                    seed: int, *, return_topk: int = 0, top_ps=None):
        """Prefix-cache admission: prefill only each row's uncached suffix
        window (cached prompt pages are attended through the stitched block
        table) + per-row sample, one dispatch."""
        win_lens_t = self._t(np.asarray(win_lens, np.int32))
        h, _ = prefill_window(self.params, self.spec, self._t(np.asarray(tokens_w)),
                              self._t(np.asarray(offsets, np.int32)), win_lens_t, self.cache,
                              self._t(np.asarray(block_tables, np.int32)), **self._fwd_kw)
        last = h[torch.arange(h.shape[0], device=h.device), (win_lens_t.long() - 1).clamp(min=0)]
        logits = logits_at(self.params, self.spec, last, **self._fwd_kw)
        return self._sample_fetch(logits, seed, temps, top_ps, return_topk)

    def verify_admit_sample_batch(
        self, tokens, prompt_lens, total_lens, block_tables, temps, seed: int, *,
        max_draft: int, draft_q=(), return_topk: int = 0, offsets=None, top_ps=None,
    ):
        """Scheduler escalation admission (JAX ``_make_verify_admit_fn``):
        verify [prompt + draft] rows in one parallel pass and emit each row's
        next token at its lane temperature; no decode loop, the lane's
        regular steps decode the remainder. ``draft_q`` = () for greedy
        argmax acceptance, or (draft_lp [B, Dw], q_ids [B, Dw, K], q_probs
        [B, Dw, K]) for the exact stochastic rule on rows with temperature
        > 0. ``offsets`` (prefix-cache mode): reused prompt-prefix lengths;
        ``tokens`` then holds only the window [prompt-suffix + draft].
        Returns host (n_accepted [B], next_token [B], next_logprob [B],
        draft_logprobs [B, max_draft], q_out) where q_out is () or (topk_ids
        [B, Dw+1, K'], topk_probs) when ``return_topk`` = K' > 0. Rejected
        draft positions leave stale KV beyond the resume position; decode
        overwrites each such slot before attention can read it."""
        cached = offsets is not None
        gen = self._generator(seed)
        tokens_t = self._t(np.asarray(tokens))
        tables = self._t(np.asarray(block_tables, np.int32))
        p_lens = self._t(np.asarray(prompt_lens, np.int32))
        t_lens = self._t(np.asarray(total_lens, np.int32))
        temps_t, tps_t = self._rows(temps, top_ps)
        B, S = tokens_t.shape
        if cached:
            offs = self._t(np.asarray(offsets, np.int32))
            h, _ = prefill_window(self.params, self.spec, tokens_t, offs, t_lens - offs,
                                  self.cache, tables, **self._fwd_kw)
            base = (p_lens - offs).long()
        else:
            _, _, h = prefill(self.params, self.spec, tokens_t, t_lens, self.cache, tables,
                              return_hidden=True, **self._fwd_kw)
            base = p_lens.long()
        # hidden state at position prompt_len-1+i predicts draft token i; the
        # +1 window slot is the bonus token on full acceptance
        ar = torch.arange(max_draft + 1, device=self.device)
        pos = (base[:, None] - 1 + ar[None, :]).clamp(0, S - 1)
        h_sel = torch.gather(h, 1, pos[:, :, None].expand(-1, -1, h.shape[-1]))
        logits_d = logits_at(self.params, self.spec, h_sel, **self._fwd_kw)  # [B, Dw+1, V]
        draft_idx = (base[:, None] + ar[None, :max_draft]).clamp(0, S - 1)
        draft = torch.gather(tokens_t, 1, draft_idx).to(torch.int32)         # [B, Dw]
        draft_len = t_lens - p_lens

        # every row is scored under its own temperature/top_p, greedy-accepted
        # rows too: accepted-token logprobs and the carried support must be on
        # the lane's own scale
        stoch = temps_t > 0.0
        logp_d = torch.log_softmax(row_adjusted_logits(logits_d, temps_t, tps_t), dim=-1)
        pred = torch.argmax(logits_d, dim=-1).to(torch.int32)
        valid = ar[None, :max_draft] < draft_len.long()[:, None]
        match = (pred[:, :max_draft] == draft) & valid
        n_acc = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1).to(torch.int32)
        draft_lp = torch.gather(logp_d[:, :max_draft], 2, draft.long()[:, :, None])[:, :, 0]

        tok_s = lp_s = None
        if draft_q:
            dlp_q, q_ids, q_probs = (self._t(np.asarray(a)) for a in draft_q)
            n_acc_s, tok_s, lp_s = speculative_accept(
                gen, draft, dlp_q.float(), q_ids, q_probs, logp_d, draft_len
            )
            n_acc = torch.where(stoch, n_acc_s, n_acc)

        V = logits_d.shape[-1]
        next_logits = torch.gather(logits_d, 1, n_acc.long()[:, None, None].expand(-1, 1, V))[:, 0]
        res, _, _ = sample_rows_with_topk(next_logits, gen, temps_t, 0, tps_t)
        tok, lp = res.token, res.logprob
        if draft_q:
            # stochastic rows emit the residual/bonus sample of the exact rule
            tok = torch.where(stoch, tok_s, tok)
            lp = torch.where(stoch, lp_s, lp)

        qi = qp = None
        if return_topk:
            w_lp, w_ids = torch.topk(logp_d, return_topk, dim=-1)            # [B, Dw+1, K]
            qi, qp = w_ids.to(torch.int32), torch.exp(w_lp)
        n_acc_h, tok_h, lp_h, dlp_h, qi, qp = self._host(n_acc, tok, lp, draft_lp, qi, qp)
        return n_acc_h, tok_h, lp_h, dlp_h, ((qi, qp) if return_topk else ())

    def _scan(self, tok, pos, rem, tables, temps, top_ps, gen, n_steps: int, return_topk: int):
        """``n_steps`` decode + sample iterations, all state on the device:
        lanes with ``rem`` > 0 emit; a lane that runs out of budget (or
        samples eos) mid-scan keeps re-feeding its last token at a frozen
        position, which rewrites identical K/V, and its emissions are masked.
        No step reads a value back to the host, so the whole scan is one
        stream of launches. Returns device (out_t [B, n], out_l, emitted [B],
        qi, qp) and the final (tok, pos, rem)."""
        B = tok.shape[0]
        dev = self.device
        out_t = torch.full((B, n_steps), PAD_ID, dtype=torch.int32, device=dev)
        out_l = torch.zeros((B, n_steps), dtype=torch.float32, device=dev)
        emitted = torch.zeros((B,), dtype=torch.int32, device=dev)
        qi = qp = None
        if return_topk:
            qi = torch.zeros((B, n_steps, return_topk), dtype=torch.int32, device=dev)
            qp = torch.zeros((B, n_steps, return_topk), dtype=torch.float32, device=dev)
        for i in range(n_steps):
            active = rem > 0
            logits, _ = decode_step(self.params, self.spec, tok, pos, self.cache, tables,
                                    **self._fwd_kw)
            res, ri, rp = sample_rows_with_topk(logits, gen, temps, return_topk, top_ps)
            if return_topk:
                qi[:, i] = torch.where(active[:, None], ri, torch.zeros_like(ri))
                qp[:, i] = torch.where(active[:, None], rp, torch.zeros_like(rp))
            out_t[:, i] = torch.where(active, res.token, torch.full_like(res.token, PAD_ID))
            out_l[:, i] = torch.where(active, res.logprob, torch.zeros_like(res.logprob))
            step = active.to(torch.int32)
            emitted = emitted + step
            rem = rem - step
            if self.eos_id is not None:
                rem = torch.where(active & (res.token == self.eos_id), torch.zeros_like(rem), rem)
            tok = torch.where(active, res.token, tok)
            pos = pos + step
        return (out_t, out_l, emitted, qi, qp), (tok, pos, rem)

    def decode_sample_scan(
        self, tokens, positions, block_tables, temps, seed: int, remaining, *,
        n_steps: int, return_topk: int = 0, top_ps=None,
    ):
        """Exactly ``n_steps`` decode+sample iterations in one dispatch
        (scheduler batch hot loop). ``remaining`` [B]: per-lane emission
        budgets; lanes stop emitting at budget/eos but cost nothing extra.
        Callers pre-grow each active lane's pages to cover position +
        n_steps. Returns host (out_tokens [B, n_steps], out_logprobs
        [B, n_steps], emitted [B], q_out)."""
        temps_t, tps_t = self._rows(temps, top_ps)
        handles, _ = self._scan(
            self._t(np.asarray(tokens, np.int32)), self._t(np.asarray(positions, np.int32)),
            self._t(np.asarray(remaining, np.int32)),
            self._t(np.asarray(block_tables, np.int32)), temps_t, tps_t,
            self._generator(seed), n_steps, return_topk,
        )
        return self.fetch_scan_handles(handles)

    # device-carry scanning: lane state stays on the device between scans ---------
    def scan_carry_init(self, tokens, positions, remaining, temps, top_ps, seed: int) -> dict:
        """Stage lane state on the device for chained scans: a dict of device
        tensors plus the generator whose state the scans advance."""
        return {
            "tok": self._t(np.asarray(tokens, np.int32)),
            "pos": self._t(np.asarray(positions, np.int32)),
            "rem": self._t(np.asarray(remaining, np.int32)),
            "gen": self._generator(seed),
            "temps": self._t(np.asarray(temps, np.float32)),
            "top_ps": self._t(np.asarray(top_ps, np.float32)),
        }

    def scan_carry_update(self, carry: dict, lanes, tokens, positions, remaining,
                          temps=None, top_ps=None) -> dict:
        """Patch fresh per-lane state (admissions) into a device carry
        without touching the other lanes. The patched tensors are new ones: a
        scan already enqueued on the old carry is unaffected."""
        idx = self._t(np.asarray(lanes, np.int64))
        upd = dict(carry)
        fields = [("tok", tokens, np.int32), ("pos", positions, np.int32),
                  ("rem", remaining, np.int32)]
        if temps is not None:
            fields.append(("temps", temps, np.float32))
        if top_ps is not None:
            fields.append(("top_ps", top_ps, np.float32))
        for name, values, dt in fields:
            upd[name] = carry[name].index_copy(0, idx, self._t(np.asarray(values, dt)))
        return upd

    def scan_carry_mask(self, carry: dict, lanes) -> dict:
        """Zero the budgets of ``lanes`` (retired/preempted): the scan masks
        rem == 0 lanes, so they can stay in the dispatch harmlessly."""
        idx = self._t(np.asarray(lanes, np.int64))
        upd = dict(carry)
        upd["rem"] = carry["rem"].index_fill(0, idx, 0)
        return upd

    def decode_sample_scan_carry_async(self, carry: dict, block_tables_dev, *, n_steps: int,
                                       return_topk: int = 0):
        """Enqueue one chained scan WITHOUT fetching: returns (device result
        handles, new_carry). Nothing on this path copies from or to the
        host, so the caller can enqueue the next scan from ``new_carry``
        before it fetches this one's handles."""
        handles, (tok, pos, rem) = self._scan(
            carry["tok"], carry["pos"], carry["rem"], block_tables_dev, carry["temps"],
            carry["top_ps"], carry["gen"], n_steps, return_topk,
        )
        new_carry = dict(carry)
        new_carry["tok"], new_carry["pos"], new_carry["rem"] = tok, pos, rem
        return handles, new_carry

    def decode_sample_scan_carry(self, carry: dict, block_tables_dev, *, n_steps: int,
                                 return_topk: int = 0):
        """One chained scan from a device-resident carry. Returns (host
        (out_tokens, out_logprobs, emitted, q_out), new_carry)."""
        handles, new_carry = self.decode_sample_scan_carry_async(
            carry, block_tables_dev, n_steps=n_steps, return_topk=return_topk
        )
        return self.fetch_scan_handles(handles), new_carry

    @classmethod
    def fetch_scan_handles(cls, handles):
        """Copy a scan's device handles to the host: (out_tokens,
        out_logprobs, emitted, q_out)."""
        out_t, out_l, emitted, qi, qp = cls._host(*handles)
        return out_t, out_l, emitted, ((qi, qp) if qi is not None else ())

    def tables_to_device(self, tables: np.ndarray) -> torch.Tensor:
        """A host block table as an int32 tensor on the engine's device."""
        return self._t(np.asarray(tables, np.int32))

    # KV page swap (scheduler swap-mode preemption, prefix-cache spill) -----------
    def _pools(self):
        c = self.cache
        return c.k_pages, c.k_scales, c.v_pages, c.v_scales

    def swap_out_pages(self, pages: list) -> tuple:
        """Copy the full contents (K/V int8 + scales, every layer) of
        ``pages`` to host memory. Returns a blob for :meth:`swap_in_pages`,
        four numpy arrays ([L, n_kv, P, page, D] int8 and [L, n_kv, P, 1,
        page] f32, for K and V) sliced to the real page count: callers charge
        ``nbytes`` of it to their host budgets. An empty list reads page 0."""
        idx = self._t(np.asarray(list(pages) or [0], np.int64))
        return tuple(
            torch.stack([x.index_select(1, idx) for x in pool]).cpu().numpy()
            for pool in self._pools()
        )

    def swap_in_pages(self, pages: list, blob: tuple) -> None:
        """Restore a :meth:`swap_out_pages` blob into (freshly granted)
        device pages, bit for bit: the resumed lane's attention reads
        identical quantized KV. Blob rows beyond ``pages``, and pages out of
        range (padding), are dropped here, on the host: ``index_copy_`` has
        no drop mode."""
        n_pages = self.cache.n_pages
        keep = [(i, int(p)) for i, p in enumerate(list(pages)[: int(blob[0].shape[2])])
                if 0 <= int(p) < n_pages]
        if not keep:
            return
        rows = [i for i, _ in keep]
        idx = self._t(np.asarray([p for _, p in keep], np.int64))
        for pool, arr in zip(self._pools(), blob):
            src = self._t(np.ascontiguousarray(np.asarray(arr)[:, :, rows]))
            for layer, x in enumerate(pool):
                x.index_copy_(1, idx, src[layer])

    # on-device stopping ---------------------------------------------------------------
    def generate_with_policy(
        self,
        prompts: Sequence[Sequence[int]],
        policy,                     # predict.inline.InlinePolicyParams on this device
        stage_index: int,
        *,
        max_new: int = 128,
        temperature: float = 0.0,
        top_p: float = 1.0,
        seed: int = 0,
        return_topk: int = 0,
    ) -> tuple[list[GenerationOutput], np.ndarray, np.ndarray]:
        """Draft + inline stopping: the quality predictor and the DP rule run
        on the device right after the decode loop, on the logprob buffer that
        never left it; the escalation flags are fetched together with the
        tokens (no host round-trip in the decision path). Like the JAX
        engine, this path prefills whole prompts (no prefix cache). Returns
        (outputs, escalate [B] bool, p_hat [B])."""
        from ..predict.inline import inline_decision

        if return_topk and temperature <= 0.0:
            return_topk = 0
        B = len(prompts)

        def decide(out_lps, gen_len):
            return inline_decision(policy, out_lps, gen_len, stage_index)

        (out_toks, out_lps, gen_len, q_bufs, (escalate, p_hat)), dt = self._generate_uncached(
            prompts, max_new, temperature, top_p, seed, return_topk, decide=decide)
        results = self._outputs(out_toks, out_lps, gen_len, q_bufs, B, dt, return_topk)
        return results, escalate[:B].astype(bool), p_hat[:B]

    # speculative escalation -------------------------------------------------------
    def verify_continue(
        self,
        prompts: Sequence[Sequence[int]],
        drafts: Sequence[Sequence[int]],
        *,
        max_new: int = 128,
        temperature: float = 0.0,
        top_p: float = 1.0,
        seed: int = 0,
        draft_q: Optional[Sequence] = None,
        return_topk: int = 0,
    ) -> list[tuple[GenerationOutput, int]]:
        """Escalation entry: verify each draft in one parallel pass, keep the
        accepted prefix, decode the remainder. Returns per request
        (GenerationOutput over the FULL output window, accepted-prefix length).

        ``draft_q``: optional per-request (logprobs [d], topk_ids [d, K],
        topk_probs [d, K]) from the draft tier; with temperature > 0 and
        draft_q for every request the exact stochastic rejection rule is
        used, otherwise greedy argmax acceptance. ``return_topk``
        (temperature > 0) carries this tier's own top-K support per token."""
        if len(prompts) != len(drafts):
            raise ValueError("prompts and drafts must align")
        B = len(prompts)
        Bb = _bucket_batch(B)
        page = self.page_size
        p_lens = [len(p) for p in prompts]
        d_lens = [min(len(d), max_new) for d in drafts]
        max_draft = _bucket_len(max(d_lens), 8)
        max_new_b = _bucket_len(max_new, 32)

        cached = self.prefix_cache is not None
        acqs = self._acquire_prefixes(prompts) if cached else []
        offs = [a[1] for a in acqs] if cached else [0] * B
        # window = [prompt-suffix + draft]; without prefix cache the window
        # is the whole sequence (offsets 0)
        S = _bucket_len(max(pl + dl - o for pl, dl, o in zip(p_lens, d_lens, offs)),
                        min(64, page))
        max_pages = (max(pl + dl for pl, dl in zip(p_lens, d_lens)) + max_new_b + page - 1
                     ) // page + 1

        tokens = np.full((Bb, S), PAD_ID, np.int32)
        for i, (pr, d) in enumerate(zip(prompts, drafts)):
            seq = list(pr)[offs[i]:] + list(d)[: d_lens[i]]
            tokens[i, : len(seq)] = np.asarray(seq, np.int32)
        prompt_lens = np.asarray(p_lens + [1] * (Bb - B), np.int32)
        total_lens = np.asarray([pl + dl for pl, dl in zip(p_lens, d_lens)] + [1] * (Bb - B),
                                np.int32)
        offsets = np.asarray(offs + [0] * (Bb - B), np.int32)

        dq = ()
        if temperature > 0.0 and draft_q is not None and all(q is not None for q in draft_q):
            K = int(draft_q[0][1].shape[-1])
            dlp = np.zeros((Bb, max_draft), np.float32)
            qids = np.zeros((Bb, max_draft, K), np.int32)
            qpr = np.zeros((Bb, max_draft, K), np.float32)
            for i, (lp, ids, pr) in enumerate(draft_q):
                d = d_lens[i]
                dlp[i, :d] = np.asarray(lp, np.float32)[:d]
                qids[i, :d] = np.asarray(ids, np.int32)[:d]
                qpr[i, :d] = np.asarray(pr, np.float32)[:d]
            dq = (self._t(dlp), self._t(qids), self._t(qpr))
        if temperature <= 0.0:
            return_topk = 0  # greedy consumers re-verify greedily; no q needed

        rid = f"ver{id(self)}_{time.monotonic_ns()}"
        tables = np.full((Bb, max_pages), self.allocator.n_pages, np.int32)
        try:
            for b in range(Bb):
                pref = acqs[b][0] if cached and b < B else []
                own = max_pages - len(pref)
                tables[b, : len(pref)] = pref
                if own:
                    tables[b, len(pref):] = self._alloc(f"{rid}_{b}", own)
            t0 = time.perf_counter()
            out_toks, out_lps, gen_len, n_acc, q_bufs = self._verify(
                tokens, prompt_lens, total_lens, offsets, tables, dq, seed,
                budget=max_new, max_new=max_new_b, max_draft=max_draft,
                temperature=temperature, top_p=top_p, return_topk=return_topk,
                cached=cached,
            )
            dt = time.perf_counter() - t0
        except Exception:
            if cached:
                self._release_failed(acqs)
            raise
        finally:
            for b in range(Bb):
                self.allocator.free_request(f"{rid}_{b}")
        if cached:
            for _, _, held, _fill in acqs:
                self.prefix_cache.release(held)
        outs = self._outputs(out_toks, out_lps, gen_len, q_bufs, B, dt, return_topk)
        return [(o, int(n_acc[i])) for i, o in enumerate(outs)]

    def _verify(self, tokens_np, prompt_lens_np, total_lens_np, offsets_np, tables_np, dq,
                seed, *, budget, max_new, max_draft, temperature, top_p, return_topk, cached):
        """Verify pass + continued decode (JAX ``_make_verify_continue_fn``).
        Returns host (out_toks, out_lps, gen_len, n_acc, q_bufs)."""
        gen = self._generator(seed)
        tokens, tables = self._t(tokens_np), self._t(tables_np)
        prompt_lens, total_lens = self._t(prompt_lens_np), self._t(total_lens_np)
        offsets = self._t(offsets_np)
        B, S = tokens_np.shape
        if cached:
            h, _ = prefill_window(self.params, self.spec, tokens, offsets,
                                  total_lens - offsets, self.cache, tables, **self._fwd_kw)
        else:
            _, _, h = prefill(self.params, self.spec, tokens, total_lens, self.cache, tables,
                              return_hidden=True, **self._fwd_kw)
        # hidden state at position prompt_len-1+i predicts draft token i; the
        # extra slot (i == draft_len) is the bonus token on full acceptance.
        # In cached mode h/tokens are window-relative: shift by offsets.
        base = (prompt_lens - offsets if cached else prompt_lens).long()
        ar = torch.arange(max_draft + 1, device=self.device)
        pos_c = (base[:, None] - 1 + ar[None, :]).clamp(0, S - 1)
        h_sel = torch.gather(h, 1, pos_c[:, :, None].expand(-1, -1, h.shape[-1]))
        logits_d = logits_at(self.params, self.spec, h_sel, **self._fwd_kw)  # [B, Dw+1, V]
        draft_idx = (base[:, None] + ar[None, :max_draft]).clamp(0, S - 1)
        draft = torch.gather(tokens, 1, draft_idx)                       # [B, Dw]
        draft_len = total_lens - prompt_lens

        def pick(logp, idx):  # logp [B, Dw(+1), V] at token idx [B, Dw]
            return torch.gather(logp[:, :max_draft], 2, idx.long()[:, :, None])[:, :, 0]

        if dq:
            # exact stochastic acceptance (ops.sampling.speculative_accept)
            dlp_q, q_ids, q_probs = dq
            logp_t = torch.log_softmax(adjusted_logits(logits_d, temperature, top_p), dim=-1)
            n_acc, bonus_tok, bonus_lp = speculative_accept(
                gen, draft, dlp_q, q_ids, q_probs, logp_t, draft_len
            )
            draft_lp = pick(logp_t, draft)
            logp_w = logp_t
        else:
            # greedy acceptance: longest prefix where this model's argmax
            # equals the draft; logprobs, the bonus token and any carried
            # support use the tier's own adjusted distribution at T > 0
            stochastic = temperature is not None and temperature > 0.0
            logp_d = torch.log_softmax(
                adjusted_logits(logits_d, temperature, top_p) if stochastic else logits_d,
                dim=-1,
            )
            pred = torch.argmax(logits_d, dim=-1).to(torch.int32)        # [B, Dw+1]
            valid = ar[None, :max_draft] < draft_len.long()[:, None]
            match = (pred[:, :max_draft] == draft) & valid
            n_acc = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
            V = logp_d.shape[-1]
            sel_logp = torch.gather(logp_d, 1, n_acc.long()[:, None, None].expand(-1, 1, V))[:, 0]
            if stochastic:
                bonus_tok = _categorical(sel_logp, gen)
            else:
                bonus_tok = torch.gather(pred, 1, n_acc.long()[:, None])[:, 0]
            bonus_lp = torch.gather(sel_logp, 1, bonus_tok.long()[:, None])[:, 0]
            draft_lp = pick(logp_d, draft)
            logp_w = logp_d

        n_acc_h = n_acc.cpu().numpy().astype(np.int32)
        draft_h = draft.cpu().numpy()
        draft_lp_h = draft_lp.float().cpu().numpy()
        # output buffer: accepted draft prefix, then the bonus token, then decoding
        slots = np.arange(max_new)[None, :]
        accepted = slots < n_acc_h[:, None]
        padn = max(max_new - max_draft, 0)
        out_toks = np.where(accepted, np.pad(draft_h, ((0, 0), (0, padn)))[:, :max_new],
                            PAD_ID).astype(np.int32)
        out_lps = np.where(accepted, np.pad(draft_lp_h, ((0, 0), (0, padn)))[:, :max_new],
                           0.0).astype(np.float32)
        q_bufs = ()
        if return_topk:
            # window slots j <= n_acc carry the verifier's own top-K there
            w_lp, w_ids = torch.topk(logp_w, return_topk, dim=-1)        # [B, Dw+1, K]
            padw = max(max_new - (max_draft + 1), 0)
            wi = np.pad(w_ids.cpu().numpy(), ((0, 0), (0, padw), (0, 0)))[:, :max_new]
            wp = np.pad(torch.exp(w_lp).cpu().numpy(), ((0, 0), (0, padw), (0, 0)))[:, :max_new]
            in_window = (slots <= n_acc_h[:, None])[..., None]
            q_bufs = (np.where(in_window, wi, 0).astype(np.int32),
                      np.where(in_window, wp, 0.0).astype(np.float32))

        active = np.ones(B, bool)
        gen_len = n_acc_h.copy()
        wr = n_acc_h.copy()          # next write slot; the bonus goes here
        rows = np.arange(B)
        tok = SampleResult(bonus_tok, bonus_lp)
        steps, q_steps = [], []
        while active.any() and (wr < budget).any():
            can_write = active & (wr < budget)
            steps.append((tok.token, tok.logprob, can_write, np.clip(wr, 0, max_new - 1)))
            gen_len += can_write
            if self.eos_id is not None:
                active &= tok.token.cpu().numpy() != self.eos_id
            active &= wr + 1 < budget
            if not (active.any() and (wr + 1 < budget).any()):
                break  # the JAX loop decodes once more here; nothing reads it
            logits, _ = decode_step(self.params, self.spec, tok.token,
                                    prompt_lens + self._t(wr.astype(np.int32)),
                                    self.cache, tables, **self._fwd_kw)
            if return_topk:
                tok, nqi, nqp = sample_with_topk(logits, gen, return_topk, temperature, top_p)
                # the next iteration writes tok at slot wr+1: stage its q row
                q_steps.append((nqi, nqp, active & (wr + 1 < budget),
                                np.clip(wr + 1, 0, max_new - 1)))
            else:
                tok = sample(logits, gen, temperature=temperature, top_p=top_p)
            wr = wr + 1

        if steps:
            toks = torch.stack([s[0] for s in steps]).cpu().numpy()          # [n, B]
            lps = torch.stack([s[1] for s in steps]).float().cpu().numpy()
            for t, (_, _, can_write, wrc) in enumerate(steps):
                r = rows[can_write]
                out_toks[r, wrc[can_write]] = toks[t, can_write]
                out_lps[r, wrc[can_write]] = lps[t, can_write]
        for nqi, nqp, will, nwrc in q_steps:
            r = rows[will]
            q_bufs[0][r, nwrc[will]] = nqi.cpu().numpy()[will]
            q_bufs[1][r, nwrc[will]] = nqp.cpu().numpy()[will]
        return out_toks, out_lps, gen_len, n_acc_h, q_bufs

    # ops/info ---------------------------------------------------------------------
    def warmup(self, batch: int = 1, prompt_len: int = 16, max_new: int = 8) -> float:
        t0 = time.perf_counter()
        self.generate([[1] * prompt_len for _ in range(batch)], max_new=max_new, temperature=0.0)
        return time.perf_counter() - t0

    def memory_usage_bytes(self) -> int:
        return _param_bytes(self.params) + self.cache.memory_bytes()

    def get_model_info(self) -> dict:
        return {
            "name": self.name,
            "spec": self.spec.name,
            "n_layers": self.spec.n_layers,
            "hidden": self.spec.hidden,
            "approx_params": self.spec.approx_params,
            "page_size": self.page_size,
            "n_pages": self.allocator.n_pages,
            "cost_per_token": self.cost_per_token,
            "memory_bytes": self.memory_usage_bytes(),
            "device": str(self.device),
            **({"prefix_cache": self.prefix_cache.stats()} if self.prefix_cache is not None
               else {}),
        }
