"""In-environment training of tiny Qwen-architecture LMs for the cascade
(counterpart of ``adaptive_sd_tpu/models/tiny_train.py``).

The environment has no real model weights, so measured answer quality has
to come from models trained here: tiny Qwen2-architecture LMs (the param
layout :func:`~adaptive_sd_tpu_torch.models.qwen.init_params` emits) trained
on a char-level QA corpus built from the frozen ``data/`` suites. Capability
tiers come from capacity and training compute. The trained float weights
then flow through the production checkpoint path (models/loader.py
save_checkpoint -> load_params -> quantize -> TierEngine).

The tokenizer and corpus are the JAX module's numpy code. :func:`lm_forward`
is plain torch under autograd (its products go to ``torch.matmul``, as JAX
left them to XLA, outside any Pallas kernel), and :func:`train_lm` is step
for step the JAX optax chain: ``clip_by_global_norm(1.0)`` written by hand
(no epsilon), then ``adamw`` (eps 1e-8, b1 0.9, b2 0.999, every leaf
decays, norms and biases too, the decay scaled by the scheduled rate) with
``warmup_cosine_decay_schedule(0, lr, warmup, steps, 0.05 * lr)`` read at
the count before each update, so the first update takes lr = 0 while Adam's
moments advance. Batches are the same numpy row draws. TF32 is off while
training. It runs on the card unless the caller passes a CPU device.

Consumers: scripts/torch_real_smoke.py --rehearse and chip_smoke.py's
rehearsal phase.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from .config import ModelSpec
from .qwen import Params, apply_rope, init_params, rms_norm, rope_tables

__all__ = [
    "ANSWER_CUE",
    "CharTokenizer",
    "DEFAULT_RECIPES",
    "TierRecipe",
    "answer_text",
    "encode_qa",
    "lm_forward",
    "lr_schedule",
    "train_lm",
    "qa_corpus",
]


# ---------------------------------------------------------------------------
# char-level tokenizer (deterministic, vocab-bounded, reversible)


class CharTokenizer:
    """Reversible char-level tokenizer over printable ASCII.

    ids: 0 = pad, 1 = BOS, 2 = EOS, 3 = unknown, 4.. = charset. Fits any
    ModelSpec with vocab_size >= 4 + len(charset) (default charset is 96
    printable chars -> vocab 100).
    """

    PAD, BOS, EOS, UNK = 0, 1, 2, 3

    def __init__(self) -> None:
        charset = [chr(c) for c in range(32, 127)] + ["\n"]
        self._c2i = {c: i + 4 for i, c in enumerate(charset)}
        self._i2c = {i + 4: c for i, c in enumerate(charset)}
        self.vocab_size = 4 + len(charset)

    def encode(self, text: str) -> list[int]:
        return [self._c2i.get(c, self.UNK) for c in text]

    def decode(self, ids: Sequence[int]) -> str:
        out = []
        for i in ids:
            i = int(i)
            if i == self.EOS:
                break
            if i in (self.PAD, self.BOS, self.UNK):
                continue
            out.append(self._i2c.get(i, ""))
        return "".join(out)


# ---------------------------------------------------------------------------
# QA corpus from the frozen suites


def answer_text(item: dict) -> str:
    """Canonical answer declaration the objective scorers accept
    (evalx/datasets.py: declared answers beat incidental tokens)."""
    task = item["task"]
    if task == "factual":
        return f"The answer is {item['answer'].strip().upper()}."
    if task == "math":
        return f"The answer is {item['answer']}."
    if task == "code":
        return f"```python\n{item['answer']}\n```"
    raise ValueError(f"no canonical answer for task {task!r}")


ANSWER_CUE = "\nAnswer: "


def qa_corpus(items: Sequence[dict]) -> list[tuple[str, str]]:
    """(context, target) pairs: context = prompt + answer cue, target = the
    canonical answer declaration."""
    return [(it["prompt"] + ANSWER_CUE, answer_text(it)) for it in items]


def encode_qa(
    tokenizer: CharTokenizer,
    pairs: Sequence[tuple[str, str]],
    seq_len: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Pack pairs into fixed [N, seq_len] rows with an answer-region loss
    mask. Row = BOS + context + target + EOS (left-truncating the CONTEXT
    when too long — the answer is never cut). Loss covers target + EOS only:
    capacity goes to answering, not to memorizing prompt text."""
    toks = np.zeros((len(pairs), seq_len), np.int32)
    mask = np.zeros((len(pairs), seq_len), np.float32)
    for r, (ctx, tgt) in enumerate(pairs):
        c = tokenizer.encode(ctx)
        t = tokenizer.encode(tgt) + [tokenizer.EOS]
        room = seq_len - 1 - len(t)
        if room < 0:
            t = t[: seq_len - 1]
            room = 0
        c = c[-room:] if room else []
        row = [tokenizer.BOS] + c + t
        toks[r, : len(row)] = row
        mask[r, 1 + len(c) : len(row)] = 1.0
    return toks, mask


# ---------------------------------------------------------------------------
# training forward (same param layout the production engine consumes)


def lm_forward(params: Params, spec: ModelSpec, tokens: torch.Tensor,
               mask_pad: bool = True) -> torch.Tensor:
    """[B, S] -> logits [B, S, V]. Differentiable training twin of the
    engine's prefill (models/qwen.prefill): padding columns receive no
    attention (fill -1e30; ``mask_pad=False`` treats the PAD id as a token,
    for corpora that are not the char tokenizer's), K/V heads are repeated
    for GQA, the head is the embedding's transpose when tied."""
    B, S = tokens.shape
    sm_scale = 1.0 / math.sqrt(spec.head_dim)
    tokens = tokens.long()
    h = params["embed"][tokens]
    pos = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    cos, sin = rope_tables(pos, spec.head_dim, spec.rope_theta)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    causal = torch.tril(torch.ones((S, S), dtype=torch.bool, device=tokens.device))
    # padding columns must not receive attention
    pad_ok = tokens != (CharTokenizer.PAD if mask_pad else -1)
    mask = causal[None] & pad_ok[:, None, :]
    rep = spec.n_heads // spec.n_kv_heads
    for layer in params["layers"]:
        x = rms_norm(h, layer["input_norm"], spec.rms_eps)

        def proj(name, n_heads):
            y = x @ layer[f"{name}_proj"]
            if f"{name}_bias" in layer:
                y = y + layer[f"{name}_bias"]
            return y.reshape(B, S, n_heads, spec.head_dim)

        q = apply_rope(proj("q", spec.n_heads), cos, sin)
        k = apply_rope(proj("k", spec.n_kv_heads), cos, sin)
        v = proj("v", spec.n_kv_heads)
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
        att = torch.einsum("bqhd,bkhd->bhqk", q, k) * sm_scale
        att = torch.where(mask[:, None], att, torch.full_like(att, -1e30))
        att = torch.softmax(att, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(B, S, -1)
        h = h + o @ layer["o_proj"]
        x = rms_norm(h, layer["post_norm"], spec.rms_eps)
        g = F.silu(x @ layer["gate_proj"]) * (x @ layer["up_proj"])
        h = h + g @ layer["down_proj"]
    h = rms_norm(h, params["final_norm"], spec.rms_eps)
    head = params["embed"].t() if spec.tie_embeddings else params["lm_head"]
    return h @ head


def lr_schedule(count: int, *, lr: float, warmup: int, steps: int) -> float:
    """``optax.warmup_cosine_decay_schedule(0, lr, warmup, steps, 0.05 * lr)``
    at ``count``: a linear warmup from 0, then cosine decay to 5 % of lr."""
    if count < warmup:
        return lr * min(max(count, 0), warmup) / warmup
    decay = steps - warmup
    t = min(count - warmup, decay)
    alpha = 0.05
    return lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / decay)) + alpha)


def _leaves(params: Params) -> list[torch.Tensor]:
    """The leaves in JAX's pytree order (dict keys sorted), so the global
    norm sums them in the same order."""
    out = [params["embed"], params["final_norm"]]
    for layer in params["layers"]:
        out.extend(layer[k] for k in sorted(layer))
    if "lm_head" in params:
        out.append(params["lm_head"])
    return out


def train_lm(
    spec: ModelSpec,
    tokens: np.ndarray,
    loss_mask: np.ndarray,
    *,
    steps: int = 1000,
    batch: int = 32,
    lr: float = 3e-3,
    weight_decay: float = 1e-4,
    seed: int = 0,
    warmup_frac: float = 0.05,
    progress: Optional[Callable[[str], None]] = None,
    device=None,
    init: Optional[Params] = None,
    mask_pad: bool = True,
) -> tuple[Params, dict]:
    """AdamW + warmup-cosine training of the masked next-token loss on
    ``device`` (default CUDA); returns (float32 params, report). Rows are
    sampled with replacement each step: the corpus is small and memorising
    it IS the capability being trained. The report has the JAX function's
    keys plus ``step_losses``, the loss of every step (unrounded).
    ``init``: the initial weights (copied; default ``init_params(spec,
    seed)`` on ``device``), e.g. another device's, or another package's
    handed across. ``mask_pad``: as :func:`lm_forward` takes it."""
    device = resolve_device(device)
    params = init if init is not None else init_params(spec, seed, torch.float32, device=device)
    params = _map(params, lambda t: t.to(device=device, dtype=torch.float32)
                  .detach().clone().requires_grad_())
    leaves = _leaves(params)
    warmup = max(int(steps * warmup_frac), 1)
    opt = torch.optim.AdamW(leaves, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)

    def loss_fn(toks, msk):
        logits = lm_forward(params, spec, toks[:, :-1], mask_pad)
        tgt = toks[:, 1:].long()
        m = msk[:, 1:]
        lp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(lp, -1, tgt[..., None])[..., 0]
        return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)

    toks_d = torch.from_numpy(np.ascontiguousarray(tokens)).to(device)
    mask_d = torch.from_numpy(np.ascontiguousarray(loss_mask)).to(device)
    n = len(tokens)
    rng = np.random.default_rng(seed)
    step_losses = torch.zeros(steps, dtype=torch.float32, device=device)
    losses = []
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    try:
        for i in range(steps):
            sl = torch.from_numpy(rng.integers(0, n, size=batch)).to(device)
            loss = loss_fn(toks_d[sl], mask_d[sl])
            opt.zero_grad()
            loss.backward()
            with torch.no_grad():
                grads = [t.grad for t in leaves]
                norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
                keep = norm < 1.0
                for g in grads:
                    g.copy_(torch.where(keep, g, g / norm))
            for group in opt.param_groups:  # optax reads the count before the update
                group["lr"] = lr_schedule(i, lr=lr, warmup=warmup, steps=steps)
            opt.step()
            step_losses[i] = loss.detach()
            if i % 50 == 0 or i == steps - 1:
                lf = float(loss.detach())
                losses.append(lf)
                if progress:
                    progress(f"step {i}/{steps} loss {lf:.3f} ({time.time() - t0:.0f}s)")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    report = {
        "steps": steps,
        "batch": batch,
        "final_loss_nats": float(losses[-1]),
        "loss_curve": [round(x, 4) for x in losses],
        "step_losses": step_losses.tolist(),
        "params": int(spec.approx_params),
        "train_wall_s": round(time.time() - t0, 1),
    }
    return _map(params, lambda t: t.detach()), report


def _map(params: Params, fn) -> Params:
    out = {k: fn(v) for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: fn(v) for k, v in layer.items()} for layer in params["layers"]]
    return out


@dataclass(frozen=True)
class TierRecipe:
    """Capacity/compute recipe for one cascade tier's tiny LM."""

    name: str
    hidden: int
    n_layers: int
    n_heads: int
    ffn: int
    steps: int
    head_dim: int = 64
    # per-recipe LR: the wider/deeper tier destabilises at the small tiers'
    # 3e-3 (measured: 448x6 ended at loss 0.271 vs 256x4's 0.018 — the
    # CAPABILITY gradient inverted); width-scaled LR restores monotone
    # convergence
    lr: float = 3e-3

    def spec(self, vocab_size: int, max_seq_len: int = 512) -> ModelSpec:
        return ModelSpec(
            name=self.name, vocab_size=vocab_size, hidden=self.hidden,
            n_layers=self.n_layers, n_heads=self.n_heads,
            n_kv_heads=max(self.n_heads // 2, 1), head_dim=self.head_dim,
            ffn=self.ffn, max_seq_len=max_seq_len, rope_theta=10_000.0,
        )


# Default 3-tier ladder: capacity AND compute scale together, the way the
# real 7B->32B->72B ladder does. head_dim 64 keeps Q/K/V shapes modest;
# hidden = n_heads * head_dim so o_proj stays square.
DEFAULT_RECIPES = (
    TierRecipe("trained-t0", hidden=128, n_layers=2, n_heads=2, ffn=384,
               steps=700),
    TierRecipe("trained-t1", hidden=256, n_layers=4, n_heads=4, ffn=768,
               steps=1400, lr=2e-3),
    TierRecipe("trained-t2", hidden=448, n_layers=6, n_heads=8, ffn=1344,
               steps=3600, lr=1e-3),
)
