"""Dynamic-programming optimal-stopping rule for the model cascade.

Role parity: reference ``src/algorithms/dp_solver.py`` (optimal_stopping_rule,
compute_expected_cost, bayesian_adjustment, OptimalStoppingTable,
AdaptiveStopping). Re-derived rather than translated:

Formulation
-----------
Stages ``0..n-1`` with *cumulative* costs ``C[0] <= ... <= C[n-1]`` and
per-stage acceptance probabilities ``p[i]`` (probability stage i's answer is
good enough). We minimise the Bellman loss

    L = (1 - E[quality]) + lam * E[cost]

by backward induction on the value function ``V``:

    V[n-1] = 1 - p[n-1]                      (must stop at the last stage)
    stop_i = 1 - p[i]
    cont_i = lam * (C[i+1] - C[i]) + V[i+1]
    V[i]   = min(stop_i, cont_i)

``lam`` (lambda) is the cost-sensitivity: larger lambda stops earlier
(cheaper, lower quality); this matches the reference's lambda-sweep behaviour
(docs/summaries/EXECUTIVE_SUMMARY.md:56-60 — lambda=5 gives cost 1.52,
lambda=0.1 gives cost 4.21).

Every function has a numpy implementation (host-side policy decisions) and a
``torch`` twin on tensors, so the same rule can be evaluated on the device
right after the decode loop (no host round-trip before the tokens' fetch).
Counterpart of ``adaptive_sd_tpu/policy/dp.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

import torch

DEFAULT_COSTS = (1.0, 2.0, 4.5, 10.0)


def optimal_stopping_rule(
    p: Sequence[float], C: Sequence[float], lam: float
) -> tuple[int, np.ndarray]:
    """Return ``(k_star, V)``: the optimal stopping stage and value function.

    ``k_star`` is the first stage where stopping is no worse than continuing.
    ``V[i]`` is the minimal expected residual loss from stage i onward.
    """
    p = np.asarray(p, dtype=np.float64)
    C = np.asarray(C, dtype=np.float64)
    n = p.shape[0]
    if n == 0:
        raise ValueError("need at least one stage")
    if C.shape[0] != n:
        raise ValueError(f"p and C length mismatch: {n} vs {C.shape[0]}")
    if np.any((p < 0) | (p > 1)):
        raise ValueError("acceptance probabilities must lie in [0, 1]")
    if lam < 0:
        raise ValueError("lambda must be non-negative")

    V = np.empty(n, dtype=np.float64)
    V[n - 1] = 1.0 - p[n - 1]
    for i in range(n - 2, -1, -1):
        stop = 1.0 - p[i]
        cont = lam * (C[i + 1] - C[i]) + V[i + 1]
        V[i] = min(stop, cont)

    k_star = n - 1
    for i in range(n):
        stop = 1.0 - p[i]
        cont = np.inf if i == n - 1 else lam * (C[i + 1] - C[i]) + V[i + 1]
        if stop <= cont:
            k_star = i
            break
    return k_star, V


def optimal_stopping_rule_torch(p: torch.Tensor, C: torch.Tensor, lam) -> torch.Tensor:
    """Tensor twin of :func:`optimal_stopping_rule` returning ``k_star`` only.

    ``p``: [..., n] acceptance probabilities (any leading batch shape), ``C``:
    [n] cumulative costs, ``lam``: float or tensor broadcastable to the batch.
    A Python loop over the n stages (n <= 4), elementwise over the batch; no
    data-dependent control flow and no host sync, so the decision stays on the
    device beside the decode loop.
    """
    n = p.shape[-1]
    stop = 1.0 - p
    dC = C[1:] - C[:-1]
    lam = torch.as_tensor(lam, dtype=p.dtype, device=p.device)
    V = stop[..., n - 1]
    conts = [torch.full_like(V, float("inf"))]
    for i in range(n - 2, -1, -1):
        cont = lam * dC[i] + V
        V = torch.minimum(stop[..., i], cont)
        conts.append(cont)
    cont = torch.stack(conts[::-1], dim=-1)
    should_stop = stop <= cont
    # first index where stopping is optimal (the last stage always qualifies)
    idx = torch.arange(n, device=p.device)
    return torch.where(should_stop, idx, n - 1).amin(dim=-1)


def compute_expected_cost(
    p: Sequence[float], C: Sequence[float], lam: float
) -> float:
    """Expected Bellman loss of the optimal policy evaluated from stage 0
    (reference src/algorithms/dp_solver.py:74-103): escalation happens when the
    current stage's answer is rejected, so the expectation walks the cascade
    with rejection probabilities."""
    p = np.asarray(p, dtype=np.float64)
    C = np.asarray(C, dtype=np.float64)
    k_star, _ = optimal_stopping_rule(p, C, lam)
    # Walk stages 0..k_star: stage i is reached with prob prod_{j<i}(1-p_j);
    # at i < k* we terminate on acceptance (prob p[i]), at k* we always stop.
    reach = 1.0
    exp_quality = 0.0
    exp_paid = 0.0
    for i in range(k_star + 1):
        terminate = 1.0 if i == k_star else p[i]
        # Terminating early implies acceptance (quality 1), at k* quality is
        # p[k*]; both contribute reach * p[i] to E[quality].
        exp_quality += reach * p[i]
        exp_paid += reach * terminate * C[i]
        reach *= 1.0 - terminate
    return float((1.0 - exp_quality) + lam * exp_paid)


def bayesian_adjustment(
    p_hat: float, n_obs: int, alpha: float = 1.0, beta: float = 1.0
) -> float:
    """Beta-Binomial posterior-mean shrinkage of a predicted acceptance
    probability (reference src/algorithms/dp_solver.py:106-130).

    Treat ``p_hat`` as the empirical success rate of ``n_obs`` pseudo-trials
    under a Beta(alpha, beta) prior; return the posterior mean. With few
    observations the estimate shrinks toward the prior mean, guarding against
    an overconfident predictor early in deployment.
    """
    if not 0.0 <= p_hat <= 1.0:
        raise ValueError(f"p_hat must be in [0,1], got {p_hat}")
    if n_obs < 0:
        raise ValueError("n_obs must be >= 0")
    successes = alpha + n_obs * p_hat
    failures = beta + n_obs * (1.0 - p_hat)
    return float(successes / (successes + failures))


def bayesian_adjustment_torch(p_hat, n_obs, alpha: float = 1.0, beta: float = 1.0):
    """Tensor twin of :func:`bayesian_adjustment` (elementwise)."""
    successes = alpha + n_obs * p_hat
    failures = beta + n_obs * (1.0 - p_hat)
    return successes / (successes + failures)


@dataclass
class OptimalStoppingTable:
    """Precomputed ``k*`` lookup over a (lambda-grid x rounded-prob-grid)
    (reference src/algorithms/dp_solver.py:133-210). Probabilities are rounded
    to ``prob_resolution`` decimals for keying; unseen keys fall back to the
    exact DP with ``costs``."""

    costs: Sequence[float] = DEFAULT_COSTS
    lambdas: Sequence[float] = (0.1, 0.5, 1.0, 2.0, 5.0, 10.0)
    prob_resolution: int = 2
    _table: dict[tuple[float, tuple[float, ...]], int] = field(default_factory=dict)

    def _key(self, lam: float, probs: Sequence[float]) -> tuple[float, tuple[float, ...]]:
        r = self.prob_resolution
        return (round(float(lam), 3), tuple(round(float(x), r) for x in probs))

    def precompute(self, prob_grid: Optional[Sequence[Sequence[float]]] = None) -> int:
        """Fill the table; returns number of entries. Default grid: each stage
        prob in {0, .25, .5, .75, 1} — coarse but it makes lookups exact for
        the fallback-rounded keys actually produced in serving."""
        if prob_grid is None:
            axis = [0.0, 0.25, 0.5, 0.75, 1.0]
            n = len(self.costs)
            import itertools

            prob_grid = list(itertools.product(axis, repeat=n))
        for lam in self.lambdas:
            for probs in prob_grid:
                k, _ = optimal_stopping_rule(probs, self.costs[: len(probs)], lam)
                self._table[self._key(lam, probs)] = k
        return len(self._table)

    def lookup(self, probs: Sequence[float], lam: float) -> int:
        key = self._key(lam, probs)
        hit = self._table.get(key)
        if hit is not None:
            return hit
        k, _ = optimal_stopping_rule(probs, self.costs[: len(probs)], lam)
        self._table[key] = k
        return k


@dataclass
class AdaptiveStopping:
    """Online UCB variant (reference src/algorithms/dp_solver.py:213-290).

    Maintains per-stage running rewards ``quality - lam * cost`` with Hoeffding
    confidence radii; a stage is worth exploring while its upper confidence
    bound is within ``exploration_gap`` of the best, or while it has fewer
    than ``min_pulls`` observations.
    """

    n_stages: int
    lam: float = 1.0
    delta: float = 0.05
    exploration_gap: float = 0.1
    min_pulls: int = 10
    counts: np.ndarray = field(default=None)  # type: ignore[assignment]
    sums: np.ndarray = field(default=None)  # type: ignore[assignment]

    def __post_init__(self) -> None:
        if self.counts is None:
            self.counts = np.zeros(self.n_stages, dtype=np.int64)
        if self.sums is None:
            self.sums = np.zeros(self.n_stages, dtype=np.float64)

    def update_statistics(self, stage: int, quality: float, cost: float) -> None:
        reward = quality - self.lam * cost
        self.counts[stage] += 1
        self.sums[stage] += reward

    def get_confidence_bounds(self) -> tuple[np.ndarray, np.ndarray]:
        means = np.divide(
            self.sums, self.counts, out=np.zeros_like(self.sums), where=self.counts > 0
        )
        with np.errstate(divide="ignore"):
            radius = np.sqrt(-np.log(self.delta / 2.0) / (2.0 * np.maximum(self.counts, 1)))
        radius = np.where(self.counts == 0, np.inf, radius)
        return means - radius, means + radius

    def should_explore(self, stage: int) -> bool:
        if self.counts[stage] < self.min_pulls:
            return True
        _, ucb = self.get_confidence_bounds()
        finite = ucb[np.isfinite(ucb)]
        best = float(np.max(finite)) if finite.size else np.inf
        return bool(ucb[stage] >= best - self.exploration_gap)

    def best_stage(self) -> int:
        means = np.divide(
            self.sums, self.counts, out=np.full_like(self.sums, -np.inf), where=self.counts > 0
        )
        return int(np.argmax(means))
