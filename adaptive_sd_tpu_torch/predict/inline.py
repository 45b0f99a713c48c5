"""On-device (inline) quality prediction: device-computable features + MLP
(counterpart of ``adaptive_sd_tpu/predict/inline.py``).

The host predictor (predict/mlp.py) sees 64 features including text
statistics; the *inline* predictor uses exactly the 16 logprob-derived
features (the draft model's own confidence, the strongest signal), which are
computable on the device from the generation buffers. Its feature vector
equals columns [16:32] of the host vector, so one dataset trains both.

This is the piece that makes stopping decisions *on device*: the draft
engine's decode loop ends with ``inline_features_torch -> mlp_forward ->
optimal_stopping_rule_torch`` and the escalation flag is fetched together
with the tokens; no host round-trip in the decision path.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..policy.dp import optimal_stopping_rule_torch
from .mlp import MLPQualityPredictor, mlp_forward

INLINE_SLICE = slice(16, 32)
INLINE_DIM = 16


def inline_features_torch(logprobs: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """[B, T] per-token logprobs (zero-padded) + [B] lengths -> [B, 16].

    Replicates predict.features._logprob_block semantics exactly (masking via
    lengths; quantiles over the valid prefix).
    """
    B, T = logprobs.shape
    logprobs = logprobs.float()
    lengths = lengths.long()
    inf = float("inf")
    pos = torch.arange(T, device=logprobs.device)[None, :]
    mask = pos < lengths[:, None]
    cnt = lengths.clamp(min=1).float()
    zero = torch.zeros((), dtype=logprobs.dtype, device=logprobs.device)

    lp = torch.where(mask, logprobs, zero)
    mean = lp.sum(dim=1) / cnt
    var = torch.where(mask, (logprobs - mean[:, None]) ** 2, zero).sum(dim=1) / cnt
    std = torch.sqrt(var)
    big = logprobs.masked_fill(~mask, inf)
    small = logprobs.masked_fill(~mask, -inf)
    mn = big.amin(dim=1)
    mx = small.amax(dim=1)

    # Quantiles over the valid prefix: sort padded-with-inf so valid entries
    # lead; linear interpolation matches numpy.percentile.
    s = torch.sort(big, dim=1).values

    def q_at(q):
        pos_f = q * (lengths - 1).float()
        lo = torch.floor(pos_f).long().clamp(0, T - 1)
        hi = (lo + 1).clamp(0, T - 1)
        frac = pos_f - lo.float()
        v_lo = torch.gather(s, 1, lo[:, None])[:, 0]
        v_hi = torch.gather(s, 1, hi[:, None])[:, 0]
        v_hi = torch.where(hi < lengths, v_hi, v_lo)  # clamp at prefix end
        return v_lo + frac * (v_hi - v_lo)

    q25, q50, q75 = q_at(0.25), q_at(0.50), q_at(0.75)

    frac_low = (mask & (logprobs < -2.3)).sum(dim=1) / cnt
    frac_half = (mask & (logprobs < -0.69)).sum(dim=1) / cnt
    first = logprobs[:, 0]
    last_idx = (lengths - 1).clamp(0, T - 1)
    last = torch.gather(logprobs, 1, last_idx[:, None])[:, 0]
    half_len = (lengths // 2).clamp(min=1)
    first_half = torch.where(pos < half_len[:, None], logprobs, zero)
    second_half = torch.where((pos >= half_len[:, None]) & mask, logprobs, zero)
    mean_first = first_half.sum(dim=1) / half_len.float()
    n_second = (lengths - half_len).clamp(min=1).float()
    mean_second = second_half.sum(dim=1) / n_second
    trend = torch.where(lengths >= 2, mean_second - mean_first, zero)
    perplexity = torch.exp(-mean)
    p_tok = torch.exp(logprobs.clamp(-20, 0))
    probs_mean = torch.where(mask, p_tok, zero).sum(dim=1) / cnt
    probs_min = p_tok.masked_fill(~mask, inf).amin(dim=1)
    log_n = torch.log1p(lengths.float())

    feats = torch.stack(
        [mean, std, mn, mx, q25, q50, q75, frac_low, frac_half, first, last,
         trend, perplexity, probs_mean, probs_min, log_n],
        dim=1,
    )
    return torch.nan_to_num(feats, nan=0.0, posinf=1e4, neginf=-1e4)


class InlinePolicyParams(NamedTuple):
    """Everything the engine needs for the on-device decision."""

    mlp: dict             # MLP weights (predict.mlp layout)
    mean: torch.Tensor    # [16] feature standardisation
    std: torch.Tensor     # [16]
    costs: torch.Tensor   # [n_stages] cumulative, normalised
    priors: torch.Tensor  # [n_stages] acceptance priors for unvisited stages
    lam: torch.Tensor     # scalar

    def to(self, device) -> "InlinePolicyParams":
        mlp = {k: ([t.to(device) for t in v] if isinstance(v, list) else v.to(device))
               for k, v in self.mlp.items()}
        return InlinePolicyParams(mlp, self.mean.to(device), self.std.to(device),
                                  self.costs.to(device), self.priors.to(device),
                                  self.lam.to(device))


def inline_decision(
    policy: InlinePolicyParams,
    logprobs: torch.Tensor,   # [B, T]
    lengths: torch.Tensor,    # [B]
    stage_index: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """On-device stopping decision. Returns (escalate [B] bool, p_hat [B])."""
    feats = inline_features_torch(logprobs, lengths)
    x = ((feats - policy.mean) / policy.std).clamp(-10.0, 10.0)
    p_hat = mlp_forward(policy.mlp, x)  # [B]
    n = policy.priors.shape[0]
    idx = torch.arange(n, device=p_hat.device)[None, :]
    p_vec = torch.where(idx == stage_index, p_hat[:, None], policy.priors[None, :])
    p_vec = torch.where(idx < stage_index, torch.zeros_like(p_vec), p_vec)  # visited+rejected
    k = optimal_stopping_rule_torch(p_vec, policy.costs, policy.lam)
    return k > stage_index, p_hat


def train_inline_predictor(
    X64: np.ndarray, y: np.ndarray, **fit_kwargs
) -> MLPQualityPredictor:
    """Train the inline head on the 16 device-computable columns of the
    full 64-dim training matrix (one dataset serves both predictors).
    ``fit_kwargs`` go to :meth:`MLPQualityPredictor.fit` (``device`` too:
    the card unless the caller passes another)."""
    # embed_dim=0: the on-device graph has no text to hash — dense-only head
    m = MLPQualityPredictor(feature_dim=INLINE_DIM, hidden=(64, 32), embed_dim=0)
    m.fit(np.asarray(X64)[:, INLINE_SLICE], y, **fit_kwargs)
    return m


def policy_from_predictor(
    predictor: MLPQualityPredictor,
    costs,
    priors,
    lam: float,
    device=None,
) -> InlinePolicyParams:
    """Inline policy from a dense 16-feature predictor; tensors live on the
    CPU unless ``device`` is given (the stage moves them to its engine)."""
    if predictor.feature_dim != INLINE_DIM:
        raise ValueError(f"inline predictor must have {INLINE_DIM} features")
    if getattr(predictor, "embed_dim", 0):
        raise ValueError("inline predictor must be dense-only (embed_dim=0)")
    costs = torch.as_tensor(np.asarray(costs, np.float32))
    policy = InlinePolicyParams(
        mlp={"w": list(predictor.params["w"]), "b": list(predictor.params["b"])},
        mean=torch.as_tensor(np.asarray(predictor.mean, np.float32)),
        std=torch.as_tensor(np.asarray(predictor.std, np.float32)),
        costs=costs / costs[-1],
        priors=torch.as_tensor(np.asarray(priors, np.float32)),
        lam=torch.tensor(float(lam), dtype=torch.float32),
    )
    return policy if device is None else policy.to(device)
