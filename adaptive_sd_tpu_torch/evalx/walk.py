"""Vectorized cascade-walk model for offline evaluation and the bench.

The headline bench replays the production pipeline's routing semantics
(cascade/pipeline.py process_request + cascade/scheduled.py prefetch) over a
workload as a timing-model "walk": direct entry from prompt-conditional
estimates, prompt-conditional unvisited-tier priors in the DP, tier
skipping, speculative verify escalation gated on
min_draft_quality_for_verify, arrival + chain prefix prefetch with warm-page
exposure capped by elapsed time. Through round 4 the walk was a per-item
Python loop; a lambda sweep calls it ``n_lambdas x n_items`` times, which
dominated the bench's robustness matrix (~5 min per cell — VERDICT r4
next #1b, fitting the default run into its time budget).

:class:`CascadeWalk` keeps the exact semantics (``run_one`` is the scalar
reference, literally the round-4 bench code; tests assert the vectorized
``run`` matches it item-for-item) and evaluates ALL items per lambda in a
handful of numpy passes — the walk's escalation loop advances every item at
most ``n_tiers - 1`` times, so the whole sweep is O(n_lambdas * n_tiers *
n_items) vector work.

Role parity: reference ``src/serving/pipeline.py:165-286`` (the stage loop
this walk models) and ``experiments/evaluate_pipeline.py`` (the lambda-sweep
evaluation this accelerates).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..policy.dp import optimal_stopping_rule

__all__ = [
    "CascadeWalk",
    "dp_kstar_batch",
    "simulate",
    "sweep",
    "sweep_or_fallback",
    "pres_sigma",
]


def dp_kstar_batch(P: np.ndarray, C: np.ndarray, lam: float) -> np.ndarray:
    """Vectorized twin of :func:`policy.dp.optimal_stopping_rule` returning
    ``k_star`` for every row of ``P`` ([n, K] acceptance probabilities).

    Same backward induction: ``V[K-1] = 1 - p[K-1]``; ``cont_i = lam *
    (C[i+1] - C[i]) + V[i+1]``; k* = first stage where stopping is no worse
    than continuing (ties stop, matching the scalar rule's ``<=``).
    """
    P = np.asarray(P, np.float64)
    n, K = P.shape
    stop = 1.0 - P
    cont = np.full((n, K), np.inf)
    V = stop[:, K - 1].copy()
    for i in range(K - 2, -1, -1):
        cont[:, i] = lam * (C[i + 1] - C[i]) + V
        V = np.minimum(stop[:, i], cont[:, i])
    ok = stop <= cont          # [:, K-1] is always True (cont = inf)
    return np.argmax(ok, axis=1)


class CascadeWalk:
    """Timing-model walk of the adaptive cascade over a frozen workload.

    Parameters
    ----------
    step, prefill, verify : [K] per-tier full-depth times (seconds): decode
        step, prefill pass, speculative verify pass.
    p_hat : [n, K] predictor acceptance estimates for each (item, tier)
        draft (consulted once a tier is visited).
    p0 : [n, K] prompt-conditional prior estimates (direct entry, skipping,
        unvisited tiers in the DP, prefetch decisions).
    p_true : [n, K] ground-truth acceptance probabilities — drives the
        *expected* speculative acceptance inside the transition cost.
    max_new : decode budget per tier visit (tokens).
    skip_threshold, min_draft_quality, prefetch_threshold, chain_threshold :
        PipelineConfig knobs the walk honours (cascade/pipeline.py).
    prefetch_credit : model arrival/chain prefix prefetch warm pages
        (cascade/scheduled.py); off for strictly serial planes.
    costs : optional cumulative DP costs; default cumsum(prefill +
        max_new * step), normalized so the last entry is 1.
    """

    def __init__(
        self,
        *,
        step: Sequence[float],
        prefill: Sequence[float],
        verify: Sequence[float],
        p_hat: np.ndarray,
        p0: np.ndarray,
        p_true: np.ndarray,
        max_new: int,
        skip_threshold: float,
        min_draft_quality: float,
        prefetch_threshold: float,
        chain_threshold: float,
        prefetch_credit: bool = True,
        costs: Optional[Sequence[float]] = None,
    ) -> None:
        self.step = np.asarray(step, np.float64)
        self.prefill = np.asarray(prefill, np.float64)
        self.verify = np.asarray(verify, np.float64)
        self.p_hat = np.asarray(p_hat, np.float64)
        self.p0 = np.asarray(p0, np.float64)
        self.p_true = np.asarray(p_true, np.float64)
        self.max_new = int(max_new)
        self.skip_t = float(skip_threshold)
        self.min_draft_q = float(min_draft_quality)
        self.pf_t = float(prefetch_threshold)
        self.chain_t = float(chain_threshold)
        self.prefetch_credit = bool(prefetch_credit)
        self.stage_plain = self.prefill + self.max_new * self.step
        if costs is not None:
            c = np.asarray(costs, np.float64)
            self.costs = c / c[-1]
        else:
            c = np.cumsum(self.stage_plain)
            self.costs = c / c[-1]
        self.n, self.K = self.p_hat.shape
        if self.p0.shape != (self.n, self.K) or self.p_true.shape != (self.n, self.K):
            raise ValueError("p_hat/p0/p_true shape mismatch")
        self._cache: dict[float, tuple[np.ndarray, np.ndarray]] = {}

    # -- vectorized ----------------------------------------------------------
    def run(self, lam: float) -> tuple[np.ndarray, np.ndarray]:
        """(stops [n] int, latency [n] float) for every item at ``lam``."""
        lam = float(lam)
        hit = self._cache.get(lam)
        if hit is not None:
            return hit
        n, K = self.n, self.K
        ar = np.arange(n)
        p0, p_hat, p_true = self.p0, self.p_hat, self.p_true
        step, prefl, verf = self.step, self.prefill, self.verify
        mx = self.max_new

        # direct entry (pipeline._entry_tier): advance e while e < k0 and
        # p0[e] < skip_t; cap at K-1
        k0 = dp_kstar_batch(p0, self.costs, lam)
        e = np.zeros(n, np.int64)
        for s in range(K - 1):
            adv = (e == s) & (s < k0) & (p0[:, s] < self.skip_t)
            e[adv] = s + 1
        e = np.minimum(e, K - 1)

        warm_t = np.full((n, K), np.inf)
        if self.prefetch_credit:
            m = (e + 1 < K) & (p0[ar, e] < self.pf_t)
            warm_t[ar[m], e[m] + 1] = 0.0     # arrival prefetch at submit

        t = self.stage_plain[e].copy()
        j = e.copy()
        P_cur = p0.copy()
        P_cur[ar, j] = p_hat[ar, j]
        active = np.ones(n, bool)

        for _ in range(K - 1):
            k = dp_kstar_batch(P_cur, self.costs, lam)
            active &= ~((k <= j) | (j == K - 1))
            if not active.any():
                break
            nxt = j + 1
            for s in range(1, K - 1):
                adv = active & (nxt == s) & (s < k) & (p0[:, s] < self.skip_t)
                nxt[adv] = s + 1
            nxt = np.minimum(nxt, K - 1)
            if self.prefetch_credit:
                cp = active & (nxt + 1 < K) & (p0[ar, np.minimum(nxt, K - 1)]
                                               < self.chain_t)
                warm_t[ar[cp], nxt[cp] + 1] = t[cp]
            # transition(i, j, nxt): expected speculative-escalation cost
            acc = p_true[ar, j]
            spec_ok = p_hat[ar, j] >= self.min_draft_q
            wt = warm_t[ar, nxt]
            is_warm = np.isfinite(wt)
            exposed = np.maximum(prefl[nxt] - (t - wt), 0.0)
            spec_warm = exposed + np.maximum(verf[nxt] - prefl[nxt], step[nxt]) \
                + (1.0 - acc) * mx * step[nxt]
            plain_warm = exposed + mx * step[nxt]
            spec_cold = verf[nxt] + (1.0 - acc) * mx * step[nxt]
            plain_cold = prefl[nxt] + mx * step[nxt]
            spec = np.where(is_warm, spec_warm, spec_cold)
            plain = np.where(is_warm, plain_warm, plain_cold)
            cost = np.where(spec_ok, spec, plain)
            t[active] += cost[active]
            j[active] = nxt[active]
            P_cur[ar[active], j[active]] = p_hat[ar[active], j[active]]

        self._cache[lam] = (j, t)
        return j, t

    def __call__(self, i: int, lam: float) -> tuple[int, float]:
        """Per-item view backed by the vectorized run (bench walk signature)."""
        stops, ts = self.run(lam)
        return int(stops[i]), float(ts[i])

    # -- scalar reference (the round-4 bench walk, verbatim semantics) -------
    def run_one(self, i: int, lam: float) -> tuple[int, float]:
        n_tiers = self.K
        step, prefl, verf = self.step, self.prefill, self.verify
        max_new = self.max_new
        p0 = self.p0[i]

        def transition(j, k, t_now, warm):
            acc = self.p_true[i, j]
            spec_ok = self.p_hat[i, j] >= self.min_draft_q
            if k in warm:
                exposed = max(prefl[k] - (t_now - warm[k]), 0.0)
                spec = exposed + max(verf[k] - prefl[k], step[k]) \
                    + (1.0 - acc) * max_new * step[k]
                plain = exposed + max_new * step[k]
            else:
                spec = verf[k] + (1.0 - acc) * max_new * step[k]
                plain = prefl[k] + max_new * step[k]
            return spec if spec_ok else plain

        k0, _ = optimal_stopping_rule(p0, self.costs, lam)
        e = 0
        while e < k0 and p0[e] < self.skip_t:
            e += 1
        e = min(e, n_tiers - 1)
        warm: dict[int, float] = {}
        if self.prefetch_credit and e + 1 < n_tiers and p0[e] < self.pf_t:
            warm[e + 1] = 0.0
        t = float(self.stage_plain[e])
        j = e
        visited = {j: float(self.p_hat[i, j])}
        while True:
            p_vec = np.asarray([visited.get(s, p0[s]) for s in range(n_tiers)])
            k, _ = optimal_stopping_rule(p_vec, self.costs, lam)
            if k <= j or j == n_tiers - 1:
                return j, t
            nxt = j + 1
            while nxt < k and p0[nxt] < self.skip_t:
                nxt += 1
            nxt = min(nxt, n_tiers - 1)
            if (self.prefetch_credit and nxt + 1 < n_tiers
                    and p0[nxt] < self.chain_t):
                warm[nxt + 1] = t
            t += transition(j, nxt, t, warm)
            j = nxt
            visited[j] = float(self.p_hat[i, j])


# ---------------------------------------------------------------------------
# sweep / reporting helpers over a CascadeWalk


def simulate(walk: CascadeWalk, goodness: np.ndarray, q_largest: float,
             largest_time: float, lam: float, idx,
             agreement=None) -> tuple[np.ndarray, float, float]:
    """(stage_distribution, quality_preservation, speedup) on ``idx``."""
    idx = np.asarray(idx, np.int64)
    stops, ts = walk.run(float(lam))
    stops, ts = stops[idx], ts[idx]
    counts = np.bincount(stops, minlength=walk.K).astype(np.float64)
    q = goodness[idx, stops].astype(np.float64)
    if agreement is not None:
        q = q * np.asarray(agreement, np.float64)[stops]
    n = len(idx)
    return counts / n, float(q.mean() / q_largest), float(largest_time / ts.mean())


def sweep(walk, goodness, q_largest, largest_time, idx, gate=0.95,
          agreement=None):
    """Best (lam, preservation, speedup, dist) on ``idx`` subject to the
    quality gate; coarse geomspace pass then refine near the winner.
    Returns None when no lambda is feasible at the gate."""
    def run(lams, best):
        for lam in lams:
            dist, pres, spd = simulate(walk, goodness, q_largest, largest_time,
                                       float(lam), idx, agreement)
            if pres >= gate and (best is None or spd > best[2]):
                best = (float(lam), pres, spd, dist)
        return best

    best = run(np.geomspace(0.01, 10.0, 25), None)
    if best is not None:
        best = run(np.linspace(best[0] / 1.35, best[0] * 1.35, 21), best)
    return best


def sweep_or_fallback(walk, goodness, q_largest, largest_time, idx, gate=0.95,
                      agreement=None):
    best = sweep(walk, goodness, q_largest, largest_time, idx, gate, agreement)
    if best is None:  # fall back to the most quality-preserving point
        cands = []
        for lam in np.geomspace(0.01, 10.0, 25):
            dist, pres, spd = simulate(walk, goodness, q_largest, largest_time,
                                       float(lam), idx, agreement)
            cands.append((pres, float(lam), spd, dist))
        pres, lam, spd, dist = max(cands, key=lambda t: t[0])
        best = (lam, pres, spd, dist)
    return best


def pres_sigma(walk, goodness, q_largest, idx, lam) -> float:
    """Delta-method standard error of the preservation ratio
    mean(g_stop)/mean(g_top) on ``idx`` — the honest noise floor of the
    quality gate at this sample size (drives the selection margin)."""
    idx = np.asarray(idx, np.int64)
    stops, _ = walk.run(float(lam))
    g_stop = goodness[idx, stops[idx]].astype(np.float64)
    g_top = goodness[idx, -1].astype(np.float64)
    n = len(idx)
    ms, mt = g_stop.mean(), max(g_top.mean(), 1e-9)
    c = np.cov(g_stop, g_top)
    var = (c[0, 0] / mt**2 - 2 * ms * c[0, 1] / mt**3
           + ms**2 * c[1, 1] / mt**4) / n
    return float(np.sqrt(max(var, 0.0)))
