"""Tier execution engine: generation and speculative verify-and-continue
(counterpart of ``adaptive_sd_tpu/engine/decode.py``).

The JAX engine fuses prefill and a ``lax.while_loop`` decode into one jitted
graph per shape bucket. Here a prefill (or a prefix-cached window prefill)
runs eagerly, then the decode loop runs on the device: its lane masks, write
slots, budgets and output buffers are static tensors of a loop bucket
(engine/graphs.py), advanced ``LOOP_CHUNK`` steps at a time, with one host
read (is any lane still writing?) between chunks and one fetch at the end.
On a CUDA device each bucket is a captured CUDA graph that every chunk
replays (``cuda_graphs=False`` runs the same steps without capture); on the
CPU the same steps run eagerly. A lane that is done feeds its last token at
its last position again, which rewrites the same K/V, so no K/V lands past a
lane's last position. The shape bucketing of the JAX engine is kept, so both
packages see the same padded shapes; on a CUDA device the block table's
width is also rounded up to a power of two (padding on the out-of-range
page), which bounds the number of graphs.

For the continuous-batching scheduler (engine/scheduler.py) the engine also
has one-dispatch calls: a forward, the per-row sampling and one fetch
(``prefill_sample_batch``, ``prefill_window_sample_batch``,
``decode_sample_batch``, ``verify_admit_sample_batch``), a multi-step decode
scan whose masks live on the device so that nothing syncs with the host
between its steps (``decode_sample_scan`` and the device-carry variants, a
loop bucket too), and the KV page swap. Where the JAX engine takes a
``jax.random`` key these take an integer seed and make a ``torch.Generator``
on the engine's device.
"""

from __future__ import annotations

import functools
import logging
import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from ..core.exceptions import ResourceError
from ..models.config import ModelSpec
from ..models.qwen import decode_step, logits_at, prefill, prefill_window
from ..ops.quant import QuantizedTensor
from ..ops.sampling import (
    _categorical,
    adjusted_logits,
    row_adjusted_logits,
    sample,
    sample_rows_with_topk,
    sample_with_topk,
    speculative_accept,
)
from .allocator import PageAllocator
from .graphs import LOOP_CHUNK, DeviceLoops
from .kv_cache import PagedKVCache
from .prefix_cache import PrefixCache

PAD_ID = 0
logger = logging.getLogger(__name__)


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
        cuda_graphs: bool = True,
        mesh=None,
    ) -> None:
        """``act_quant``: INT8 weights take the W8A8 path (dynamic INT8
        activations, ``ops.matmul_q.quantized_matmul_w8a8``) in every forward
        of this engine. ``prefix_spill_bytes`` > 0: evicted prefix-cache
        pages spill to host memory and restore bit-exactly on a chain-intact
        re-acquire instead of recomputing the prefill. ``cuda_graphs``: on a
        CUDA device, the decode loops (generate, verify-continue, the
        scheduler's scan) replay captured CUDA graphs; False runs the same
        device-side loops without capture (a comparison). No effect on the
        CPU.

        ``mesh``: this rank's :class:`~adaptive_sd_tpu_torch.parallel.mesh.Mesh`
        (every rank of the world builds the same engine and makes the same
        calls). ``params`` may then be a host tree (CPU tensors, or the numpy
        tree of models/convert.py) of the whole model. Where the spec divides
        across the mesh's ``tp`` axis (models/qwen_tp.py ``tp_compatible``),
        the engine moves only this rank's shard of the weights to its device,
        a layer at a time, allocates only its heads of the KV cache, and runs
        models/qwen.py's forward with ``tp=`` the group (``tp_mode``;
        ``self.spec`` is then the rank's ``local_spec``). Otherwise every rank
        runs the whole tier, replicated (the JAX engine hands such a tier to
        GSPMD, which PyTorch has not). A ``dp`` axis replicates. Sampling
        reads the gathered logits, the same bits on every rank, so every rank
        returns the same tokens. Collectives of a gloo group cannot be
        captured in a CUDA graph: a tensor-parallel engine on CUDA over gloo
        needs ``cuda_graphs=False``."""
        self.device = resolve_device(device)
        self.tp_mode = False
        tp_kw = {}
        if mesh is not None:
            from ..models.convert import params_from_jax
            from ..models.qwen_tp import local_spec, prepare_tp_params, tp_compatible, tree_to
            from ..parallel.mesh import AXIS_TP

            if isinstance(params["embed"], np.ndarray):
                params = params_from_jax(params, "cpu")
            tp = mesh.shape.get(AXIS_TP, 1)
            self.tp_mode = tp_compatible(spec, params, tp)
            backend = mesh.tp.backend
            if self.tp_mode and cuda_graphs and self.device.type == "cuda" and backend != "nccl":
                raise ValueError(
                    f"cuda_graphs=True needs collectives a CUDA graph can capture, and the "
                    f"tp group's backend is {backend!r}: pass cuda_graphs=False (or use an "
                    f"NCCL group)")
            name = name or spec.name
            if self.tp_mode:
                params = prepare_tp_params(params, spec, mesh, self.device)
                spec = local_spec(spec, tp)
                tp_kw = {"tp": mesh.tp}
            else:
                if tp > 1:
                    logger.warning("%s: tp=%d does not divide this tier; every rank runs it "
                                   "whole (replicated)", name, tp)
                params = tree_to(params, self.device)
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
        # extra keywords of every forward call (empty without act_quant or tp)
        self._fwd_kw = {"act_quant": True, **tp_kw} if self.act_quant else tp_kw
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
        self.loops = DeviceLoops(self.device, cuda_graphs=cuda_graphs)

    # helpers ------------------------------------------------------------------
    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def _width(self, max_pages: int) -> int:
        """Block-table width of a generate or verify call: on a CUDA device
        the next power of two (the columns past ``max_pages`` on the
        out-of-range page), so that a few graphs serve every length."""
        return _bucket_pow2(max_pages, 1) if self.device.type == "cuda" else max_pages

    def _park(self, state: dict) -> None:
        """Point a loop state's block table at the out-of-range page: K/V
        writes are dropped (a graph's warm-up)."""
        state["tables"].fill_(self.allocator.n_pages)

    def _zeros(self, shape, dtype) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=self.device)

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
        write sampled tokens until budget/eos (:meth:`_continue`).
        ``seq_lens`` [B] are the context lengths when ``first`` was sampled.
        Returns host arrays (out_toks [B, max_new], out_lps, gen_len [B],
        q_bufs). ``decide`` (out_lps [B, max_new], gen_len [B], both on the
        device) -> tensors runs on the device before anything is fetched; its
        results come back as a fifth item, fetched with the tokens."""
        B, K = seq_lens.shape[0], return_topk
        out_q = ()
        if K:
            # the first token's support goes to slot 0; the loop stages the rest
            out_q = (self._zeros((B, max_new, K), torch.int32),
                     self._zeros((B, max_new, K), torch.float32))
            if budget > 0:
                out_q[0][:, 0], out_q[1][:, 0] = q_cur
        with self.loops.hold():
            st = self._continue(
                gen, tok=first.token, lp=first.logprob, wr=self._zeros(B, torch.int32),
                base=seq_lens, budget=budget, tables=block_tables,
                out_toks=torch.full((B, max_new), PAD_ID, dtype=torch.int32, device=self.device),
                out_lps=self._zeros((B, max_new), torch.float32), out_q=out_q,
                temperature=temperature, top_p=top_p)
            decided = decide(st["out_lps"], st["gen_len"]) if decide is not None else None
            out_toks, out_lps, gen_len, qi, qp = self._host(
                st["out_toks"], st["out_lps"], st["gen_len"], st.get("out_qi"), st.get("out_qp"))
            if decided is not None:
                decided = tuple(self._host(*decided))
        q_bufs = (qi, qp) if K else ()
        if decided is not None:
            return out_toks, out_lps, gen_len, q_bufs, decided
        return out_toks, out_lps, gen_len, q_bufs

    def _continue(self, gen, *, tok, lp, wr, base, budget, tables, out_toks, out_lps, out_q,
                  temperature, top_p) -> dict:
        """The decode loop of generate and of verify-continue (the JAX
        ``while_loop``s), on the device: lane ``b`` writes ``tok`` at its
        slot ``wr`` of ``out_toks`` [B, N] (and the sampled top-K of the
        next token at ``wr + 1`` of ``out_q``), feeds it at position
        ``base + wr`` and samples the next, until eos or ``budget``. The
        state lives in a loop bucket and advances ``LOOP_CHUNK`` steps a run,
        with one host read of the lanes' flag before each run. Returns the
        bucket's state (outputs, ``gen_len`` = ``wr`` + the tokens written),
        which the caller reads while it holds ``self.loops``."""
        (B, P), N = tables.shape, out_toks.shape[1]
        K = out_q[0].shape[-1] if out_q else 0
        if N % LOOP_CHUNK:
            raise ValueError(f"max_new {N} is not a multiple of {LOOP_CHUNK}")
        bucket = self.loops.bucket(
            ("decode", B, P, N, K, float(temperature), float(top_p)),
            functools.partial(self._continue_state, B, P, N, K),
            functools.partial(self._continue_steps, temperature=float(temperature),
                              top_p=float(top_p), return_topk=K),
            self._park,
        )
        st = bucket.state
        for name, value in (("tok", tok), ("lp", lp), ("wr", wr), ("gen_len", wr),
                            ("base", base), ("tables", tables), ("feed_tok", tok),
                            ("feed_pos", base + wr), ("out_toks", out_toks),
                            ("out_lps", out_lps), *zip(("out_qi", "out_qp"), out_q)):
            st[name].copy_(value)
        st["active"].fill_(True)
        st["budget"].fill_(budget)
        for _ in range(N // LOOP_CHUNK):
            # the one host read of a chunk (the JAX loop's cond)
            if not (st["active"] & (st["wr"] < st["budget"])).any().item():
                break
            bucket.run(gen)
        return st

    def _continue_state(self, B: int, P: int, N: int, K: int) -> dict:
        i32, f32 = torch.int32, torch.float32
        st = {
            "tok": self._zeros(B, i32), "lp": self._zeros(B, f32),
            "active": self._zeros(B, torch.bool), "wr": self._zeros(B, i32),
            "gen_len": self._zeros(B, i32), "base": self._zeros(B, i32),
            "budget": self._zeros(1, i32), "tables": self._zeros((B, P), i32),
            "feed_tok": self._zeros(B, i32), "feed_pos": self._zeros(B, i32),
            "out_toks": self._zeros((B, N), i32), "out_lps": self._zeros((B, N), f32),
        }
        if K:
            st.update(out_qi=self._zeros((B, N, K), i32), out_qp=self._zeros((B, N, K), f32))
        return st

    def _continue_steps(self, st: dict, gen, *, temperature, top_p, return_topk) -> None:
        """``LOOP_CHUNK`` iterations of the JAX loops' body, in place on the
        state. A lane that stopped feeds its last written token at its last
        position again (identical K/V), so nothing lands past it."""
        active, tok, wr, budget = st["active"], st["tok"], st["wr"], st["budget"]
        N = st["out_toks"].shape[1]
        for _ in range(LOOP_CHUNK):
            can_write = active & (wr < budget)
            wrc = wr.clamp(0, N - 1).long()[:, None]
            for name, new in (("out_toks", tok), ("out_lps", st["lp"])):
                buf = st[name]
                buf.scatter_(1, wrc, torch.where(can_write, new, buf.gather(1, wrc)[:, 0])[:, None])
            st["gen_len"].add_(can_write.to(torch.int32))
            if self.eos_id is not None:
                active.logical_and_(tok != self.eos_id)
            active.logical_and_(wr + 1 < budget)
            st["feed_tok"].copy_(torch.where(can_write, tok, st["feed_tok"]))
            st["feed_pos"].copy_(torch.where(can_write, st["base"] + wr, st["feed_pos"]))
            logits, _ = decode_step(self.params, self.spec, st["feed_tok"], st["feed_pos"],
                                    self.cache, st["tables"], **self._fwd_kw)
            if return_topk:
                res, nqi, nqp = sample_with_topk(logits, gen, return_topk, temperature, top_p)
                # the next iteration writes res at slot wr+1: stage its q row
                will = (active & (wr + 1 < budget))[:, None]
                nwrc = (wr + 1).clamp(0, N - 1).long()[:, None, None].expand(-1, 1, return_topk)
                for name, new in (("out_qi", nqi), ("out_qp", nqp)):
                    buf = st[name]
                    buf.scatter_(1, nwrc, torch.where(will, new, buf.gather(1, nwrc)[:, 0])[:, None])
            else:
                res = sample(logits, gen, temperature=temperature, top_p=top_p)
            tok.copy_(res.token)
            st["lp"].copy_(res.logprob)
            wr.add_(1)

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
        tables = np.full((Bb, self._width(max_pages)), self.allocator.n_pages, np.int32)
        try:
            for b in range(Bb):
                tables[b, :max_pages] = self._alloc(f"{rid}_{b}", max_pages)
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
        tables = np.full((Bb, self._width(max_pages)), oob, np.int32)
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
        ``None`` stays ``None``, floats come back as f32. Always copies: on
        the CPU ``.numpy()`` would share the memory of a loop bucket's
        outputs, which the bucket's next call overwrites."""
        out = []
        for t in tensors:
            if t is None:
                out.append(None)
            else:
                t = t.detach()
                a = (t.float() if t.is_floating_point() else t).cpu().numpy()
                out.append(a.copy() if t.device.type == "cpu" else a)
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

    def _scan_bucket(self, B: int, P: int, n_steps: int, return_topk: int):
        """The scan bucket of ``B`` lanes over a ``P``-page block table."""
        return self.loops.bucket(
            ("scan", B, P, n_steps, return_topk),
            functools.partial(self._scan_state, B, P, n_steps, return_topk),
            functools.partial(self._scan_steps, n_steps=n_steps, return_topk=return_topk),
            self._park,
        )

    def _scan_state(self, B: int, P: int, n: int, K: int) -> dict:
        i32, f32 = torch.int32, torch.float32
        st = {"tok": self._zeros(B, i32), "pos": self._zeros(B, i32), "rem": self._zeros(B, i32),
              "temps": self._zeros(B, f32), "top_ps": self._zeros(B, f32),
              "tables": self._zeros((B, P), i32), "out_t": self._zeros((B, n), i32),
              "out_l": self._zeros((B, n), f32), "emitted": self._zeros(B, i32)}
        if K:
            st.update(qi=self._zeros((B, n, K), i32), qp=self._zeros((B, n, K), f32))
        return st

    def _scan_steps(self, st: dict, gen, *, n_steps: int, return_topk: int) -> None:
        """``n_steps`` decode + sample iterations, all state on the device
        and advanced in place: lanes with ``rem`` > 0 emit; a lane that runs
        out of budget (or samples eos) mid-scan keeps re-feeding its last
        token at a frozen position, which rewrites identical K/V, and its
        emissions are masked. No step reads a value back to the host, so the
        whole scan is one stream of launches (one graph on a CUDA device)."""
        tok, pos, rem = st["tok"], st["pos"], st["rem"]
        out_t, out_l, emitted = st["out_t"], st["out_l"], st["emitted"]
        emitted.zero_()  # every step writes its column of the other outputs
        for i in range(n_steps):
            active = rem > 0
            logits, _ = decode_step(self.params, self.spec, tok, pos, self.cache, st["tables"],
                                    **self._fwd_kw)
            res, ri, rp = sample_rows_with_topk(logits, gen, st["temps"], return_topk,
                                                st["top_ps"])
            if return_topk:
                st["qi"][:, i] = torch.where(active[:, None], ri, 0)
                st["qp"][:, i] = torch.where(active[:, None], rp, 0.0)
            out_t[:, i] = torch.where(active, res.token, PAD_ID)
            out_l[:, i] = torch.where(active, res.logprob, 0.0)
            step = active.to(torch.int32)
            emitted.add_(step)
            rem.sub_(step)
            if self.eos_id is not None:
                rem.masked_fill_(active & (res.token == self.eos_id), 0)
            tok.copy_(torch.where(active, res.token, tok))
            pos.add_(step)

    @staticmethod
    def _scan_outputs(st: dict) -> tuple:
        return st["out_t"], st["out_l"], st["emitted"], st.get("qi"), st.get("qp")

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
        tables = self._t(np.asarray(block_tables, np.int32))
        temps_t, tps_t = self._rows(temps, top_ps)
        lanes = (("tok", tokens), ("pos", positions), ("rem", remaining))
        with self.loops.hold():
            bucket = self._scan_bucket(*tables.shape, n_steps, return_topk)
            st = bucket.state
            for name, values in lanes:
                st[name].copy_(self._t(np.asarray(values, np.int32)))
            st["temps"].copy_(temps_t)
            st["top_ps"].copy_(tps_t)
            st["tables"].copy_(tables)
            bucket.run(self._generator(seed))
            return self.fetch_scan_handles(self._scan_outputs(st))

    # device-carry scanning: lane state stays on the device between scans ---------
    def scan_carry_init(self, tokens, positions, remaining, temps, top_ps, seed: int) -> dict:
        """Stage lane state on the device for chained scans: a dict of device
        tensors (copies: the scans and patches write them in place) plus the
        generator whose state the scans advance."""

        def own(values, dtype):
            return torch.tensor(np.asarray(values, dtype), device=self.device)

        return {
            "tok": own(tokens, np.int32),
            "pos": own(positions, np.int32),
            "rem": own(remaining, np.int32),
            "gen": self._generator(seed),
            "temps": own(temps, np.float32),
            "top_ps": own(top_ps, np.float32),
        }

    def scan_carry_update(self, carry: dict, lanes, tokens, positions, remaining,
                          temps=None, top_ps=None) -> dict:
        """Patch fresh per-lane state (admissions) into the device carry in
        place, without touching the other lanes. A scan already enqueued
        reads the carry before the patch (stream order); returns ``carry``."""
        idx = self._t(np.asarray(lanes, np.int64))
        fields = [("tok", tokens, np.int32), ("pos", positions, np.int32),
                  ("rem", remaining, np.int32)]
        if temps is not None:
            fields.append(("temps", temps, np.float32))
        if top_ps is not None:
            fields.append(("top_ps", top_ps, np.float32))
        for name, values, dt in fields:
            carry[name].index_copy_(0, idx, self._t(np.asarray(values, dt)))
        return carry

    def scan_carry_mask(self, carry: dict, lanes) -> dict:
        """Zero the budgets of ``lanes`` (retired/preempted) in place: the
        scan masks rem == 0 lanes, so they can stay in the dispatch
        harmlessly. Returns ``carry``."""
        carry["rem"].index_fill_(0, self._t(np.asarray(lanes, np.int64)), 0)
        return carry

    def decode_sample_scan_carry_async(self, carry: dict, block_tables_dev, *, n_steps: int,
                                       return_topk: int = 0):
        """Enqueue one chained scan WITHOUT fetching: returns (device result
        handles, carry advanced in place). Nothing on this path copies from
        or to the host, so the caller can enqueue the next scan from the
        carry before it fetches this one's handles: the handles are copies
        of the bucket's outputs, which the next scan overwrites. The carry is
        copied into the bucket's state before the run and back after it."""
        with self.loops.hold():
            bucket = self._scan_bucket(*block_tables_dev.shape, n_steps, return_topk)
            st = bucket.state
            for name in ("tok", "pos", "rem", "temps", "top_ps"):
                st[name].copy_(carry[name])
            st["tables"].copy_(block_tables_dev)
            bucket.run(carry["gen"])
            for name in ("tok", "pos", "rem"):
                carry[name].copy_(st[name])
            handles = tuple(None if t is None else t.clone() for t in self._scan_outputs(st))
        return handles, carry

    def decode_sample_scan_carry(self, carry: dict, block_tables_dev, *, n_steps: int,
                                 return_topk: int = 0):
        """One chained scan from a device-resident carry. Returns (host
        (out_tokens, out_logprobs, emitted, q_out), carry)."""
        handles, carry = self.decode_sample_scan_carry_async(
            carry, block_tables_dev, n_steps=n_steps, return_topk=return_topk
        )
        return self.fetch_scan_handles(handles), carry

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
        tables = np.full((Bb, self._width(max_pages)), self.allocator.n_pages, np.int32)
        try:
            for b in range(Bb):
                pref = acqs[b][0] if cached and b < B else []
                own = max_pages - len(pref)
                tables[b, : len(pref)] = pref
                if own:
                    tables[b, len(pref):max_pages] = self._alloc(f"{rid}_{b}", own)
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
        """Verify pass + continued decode (JAX ``_make_verify_continue_fn``):
        the verify forward eagerly (its window varies per call), then the
        continue loop on the device (:meth:`_continue`). Returns host
        (out_toks, out_lps, gen_len, n_acc, q_bufs)."""
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

        # output buffer: accepted draft prefix, then the bonus token, then decoding
        N, Dw = max_new, max_draft
        n_acc = n_acc.to(torch.int32)
        slots = torch.arange(N, device=self.device)[None, :]
        accepted = slots < n_acc[:, None]
        padn = max(N - Dw, 0)
        out_toks = torch.where(accepted, F.pad(draft.to(torch.int32), (0, padn))[:, :N], PAD_ID)
        out_lps = torch.where(accepted, F.pad(draft_lp.float(), (0, padn))[:, :N], 0.0)
        K = return_topk
        if K:
            # window slots j <= n_acc carry the verifier's own top-K there
            w_lp, w_ids = torch.topk(logp_w, K, dim=-1)                   # [B, Dw+1, K]
            padw = max(N - (Dw + 1), 0)
            in_window = (slots <= n_acc[:, None])[..., None]
            out_qi = torch.where(in_window, F.pad(w_ids.to(torch.int32),
                                                  (0, 0, 0, padw))[:, :N], 0)
            out_qp = torch.where(in_window, F.pad(torch.exp(w_lp).float(),
                                                  (0, 0, 0, padw))[:, :N], 0.0)

        with self.loops.hold():
            st = self._continue(
                gen, tok=bonus_tok, lp=bonus_lp, wr=n_acc, base=prompt_lens, budget=budget,
                tables=tables, out_toks=out_toks, out_lps=out_lps,
                out_q=(out_qi, out_qp) if K else (), temperature=temperature, top_p=top_p)
            out_toks, out_lps, gen_len, n_acc, qi, qp = self._host(
                st["out_toks"], st["out_lps"], st["gen_len"], n_acc, st.get("out_qi"),
                st.get("out_qp"))
        return out_toks, out_lps, gen_len, n_acc, ((qi, qp) if K else ())

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
