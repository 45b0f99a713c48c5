"""Token sampling: greedy / temperature / top-p, top-K support and the
speculative rejection rule (counterpart of ``adaptive_sd_tpu/ops/sampling.py``).

A ``torch.Generator`` on the logits' device takes the place of a
``jax.random`` key; the two give different numbers from the same seed, so
stochastic paths agree with the JAX package in distribution, greedy ones
exactly.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class SampleResult(NamedTuple):
    token: torch.Tensor     # [B] int32
    logprob: torch.Tensor   # [B] f32 logprob of the sampled token


def _take(logp: torch.Tensor, token: torch.Tensor) -> torch.Tensor:
    return torch.gather(logp, -1, token.long()[..., None])[..., 0]


def _categorical(logits: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """One draw per row from softmax(logits) by the Gumbel-max trick (what
    ``jax.random.categorical`` does); ``-inf`` logits are never drawn."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20, max=1.0 - 1e-7)))
    return torch.argmax(logits.float() + gumbel, dim=-1).to(torch.int32)


def greedy_sample(logits: torch.Tensor) -> SampleResult:
    """logits: [B, V] -> argmax token + its logprob."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    token = torch.argmax(logits, dim=-1).to(torch.int32)
    return SampleResult(token, _take(logp, token))


def adjusted_logits(logits: torch.Tensor, temperature: float, top_p: float) -> torch.Tensor:
    """Temperature/top-p–adjusted logits defining the sampling distribution.
    Top-p keeps tokens while the cumulative probability before them is
    < top_p (always keeping the top token)."""
    scaled = logits.float() / max(temperature, 1e-6)
    if top_p < 1.0:
        sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = cum - probs < top_p
        inf = torch.full_like(sorted_logits, float("inf"))
        cutoff = torch.where(keep, sorted_logits, inf).amin(dim=-1, keepdim=True)
        scaled = torch.where(scaled >= cutoff, scaled, torch.full_like(scaled, float("-inf")))
    return scaled


def sample(
    logits: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    temperature: float = 0.0,
    top_p: float = 1.0,
) -> SampleResult:
    """Temperature + nucleus sampling; temperature 0 reduces to greedy."""
    if temperature <= 0.0:
        return greedy_sample(logits)
    scaled = adjusted_logits(logits, temperature, top_p)
    token = _categorical(scaled, generator)
    return SampleResult(token, _take(torch.log_softmax(scaled, dim=-1), token))


def sample_with_topk(
    logits: torch.Tensor,
    generator: Optional[torch.Generator],
    k: int,
    temperature: float,
    top_p: float = 1.0,
) -> tuple[SampleResult, torch.Tensor, torch.Tensor]:
    """Sample AND return the top-k of the adjusted distribution:
    (result, topk_ids [B, k] int32, topk_probs [B, k] f32) — the draft-side
    support the speculative verifier needs for the exact residual."""
    scaled = adjusted_logits(logits, temperature, top_p)
    logp = torch.log_softmax(scaled, dim=-1)
    token = _categorical(scaled, generator)
    top_lp, top_ids = torch.topk(logp, k, dim=-1)
    return SampleResult(token, _take(logp, token)), top_ids.to(torch.int32), torch.exp(top_lp)


def speculative_accept(
    generator: Optional[torch.Generator],
    draft_tokens: torch.Tensor,   # [B, D] int32 draft proposals
    draft_lp: torch.Tensor,       # [B, D] f32 log q_i(draft token i)
    q_ids: torch.Tensor,          # [B, D, K] int32 draft top-K support ids
    q_probs: torch.Tensor,        # [B, D, K] f32 draft top-K probabilities
    target_logp: torch.Tensor,    # [B, D+1, V] f32 ADJUSTED target log-probs
    draft_len: torch.Tensor,      # [B] int32 valid draft lengths
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stochastic speculative acceptance (Leviathan/Chen rejection rule):
    accept token i iff u_i < min(1, p_i / q_i); at the first rejection emit a
    sample from norm(max(p - q, 0)); on full acceptance a sample from p at
    the bonus position. Returns (n_acc [B], next_token [B], next_logp [B])."""
    B, D = draft_tokens.shape
    V = target_logp.shape[-1]
    dev = target_logp.device
    p_tok = torch.gather(target_logp[:, :D], 2, draft_tokens.long()[..., None])[..., 0]
    u = torch.rand((B, D), generator=generator, device=dev, dtype=torch.float32)
    log_u = torch.log(u.clamp(min=1e-12))
    accept = log_u < torch.clamp(p_tok - draft_lp, max=0.0)
    valid = torch.arange(D, device=dev)[None, :] < draft_len.long()[:, None]
    ok = (accept & valid).to(torch.int32)
    n_acc = torch.cumprod(ok, dim=1).sum(dim=1).to(torch.int32)      # [B]

    pos = torch.clamp(n_acc, max=D).long()
    logp_here = torch.gather(
        target_logp, 1, pos[:, None, None].expand(B, 1, V)
    )[:, 0]                                                          # [B, V]
    p_here = torch.exp(logp_here)
    q_pos = torch.clamp(n_acc, max=D - 1).long()
    K = q_ids.shape[-1]
    ids_here = torch.gather(q_ids.long(), 1, q_pos[:, None, None].expand(B, 1, K))[:, 0]
    qp_here = torch.gather(q_probs.float(), 1, q_pos[:, None, None].expand(B, 1, K))[:, 0]
    q_here = torch.zeros((B, V), dtype=torch.float32, device=dev).scatter_add_(
        1, ids_here, qp_here
    )
    full = n_acc >= draft_len
    resid = torch.clamp(p_here - q_here, min=0.0)
    mass = resid.sum(dim=-1, keepdim=True)
    use_target = full[:, None] | (mass < 1e-9)
    dist = torch.where(use_target, p_here, resid)
    next_tok = _categorical(torch.log(torch.clamp(dist, min=1e-30)), generator)
    return n_acc, next_tok, _take(logp_here, next_tok)


def row_adjusted_logits(
    logits: torch.Tensor, temperatures: torch.Tensor, top_ps: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Per-ROW temperature + nucleus adjustment (the vectorised form of
    :func:`adjusted_logits` for the continuous-batching lanes, whose requests
    carry their own temperature and top_p). ``logits`` is [B, V] or
    [B, S, V]; ``temperatures`` and ``top_ps`` are [B] tensors on the same
    device. Greedy rows (temperature <= 0) pass through at T=1 unfiltered:
    their argmax is taken separately. Nothing here reads a value back to the
    host."""
    logits = logits.float()
    t_shape = (-1,) + (1,) * (logits.ndim - 1)
    greedy = temperatures <= 0.0
    safe_t = torch.where(greedy, torch.ones_like(temperatures), temperatures).float()
    scaled = logits / safe_t.reshape(t_shape)
    if top_ps is None:
        return scaled
    sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    p_row = top_ps.float().reshape(t_shape)
    keep = cum - probs < p_row  # always keeps each row's top token
    inf = torch.full_like(sorted_logits, float("inf"))
    cutoff = torch.where(keep, sorted_logits, inf).amin(dim=-1, keepdim=True)
    apply = (p_row < 1.0) & ~greedy.reshape(t_shape)
    return torch.where(apply & (scaled < cutoff), torch.full_like(scaled, float("-inf")), scaled)


def sample_rows(
    logits: torch.Tensor,
    generator: Optional[torch.Generator],
    temperatures: torch.Tensor,
    top_ps: Optional[torch.Tensor] = None,
) -> SampleResult:
    """Per-row temperature (+ nucleus) sampling in one pass: rows with
    temperature <= 0 take the argmax and report the log-softmax of the raw
    logits (the convention of :func:`greedy_sample`)."""
    return sample_rows_with_topk(logits, generator, temperatures, 0, top_ps)[0]


def sample_rows_with_topk(
    logits: torch.Tensor,
    generator: Optional[torch.Generator],
    temperatures: torch.Tensor,
    k: int,
    top_ps: Optional[torch.Tensor] = None,
) -> tuple[SampleResult, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """:func:`sample_rows` that also returns the top-k of each row's adjusted
    distribution, (result, topk_ids [B, k] int32, topk_probs [B, k] f32): the
    per-lane draft support a later tier needs for the exact stochastic
    verify. ``k`` 0 returns (result, None, None). Greedy rows' support rows
    are of the unscaled softmax and are unused downstream."""
    greedy = temperatures <= 0.0
    scaled = row_adjusted_logits(logits, temperatures, top_ps)
    cat = _categorical(scaled, generator)
    arg = torch.argmax(logits, dim=-1).to(torch.int32)
    token = torch.where(greedy, arg, cat)
    logp = torch.log_softmax(scaled, dim=-1)
    res = SampleResult(token, _take(logp, token))
    if not k:
        return res, None, None
    top_lp, top_ids = torch.topk(logp, k, dim=-1)
    return res, top_ids.to(torch.int32), torch.exp(top_lp)


def logprob_stats(logprobs: torch.Tensor, length) -> dict[str, torch.Tensor]:
    """Summary statistics over per-token logprobs [n] with the padding past
    ``length`` masked: mean, std, min and the share below log(0.1), feature
    inputs of the quality predictor."""
    n = logprobs.shape[-1]
    mask = torch.arange(n, device=logprobs.device) < length
    cnt = mask.sum().clamp(min=1)
    zero = torch.zeros_like(logprobs)
    mean = torch.where(mask, logprobs, zero).sum() / cnt
    var = torch.where(mask, (logprobs - mean) ** 2, zero).sum() / cnt
    mn = torch.where(mask, logprobs, torch.full_like(logprobs, float("inf"))).min()
    return {
        "mean": mean,
        "std": torch.sqrt(var),
        "min": mn,
        "frac_low_conf": (mask & (logprobs < -2.3)).sum() / cnt,  # p < 0.1
    }
