"""Perfect-knowledge routing bounds over a realized goodness matrix.

Role parity: reference ``src/baselines.py:31-78`` OracleBaseline (perfect
difficulty knowledge as the upper bound on any predictor-driven policy), but
computed over a REALIZED per-(item, tier) goodness matrix and measured
per-tier times, so the bound is exact for the benchmark's own world rather
than a smooth-quality-model approximation.

Two bounds matter and they answer different questions:

* :func:`oracle_assignments` — quality-maximal routing: every item goes to
  the cheapest tier whose answer is good; items NO tier solves stop at
  tier 0 (futility: their quality is zero everywhere, only cost differs —
  routing them to the most expensive tier, as a naive "default to the top"
  oracle does, understates the attainable speedup).
* :func:`gate_constrained_assignments` — the benchmark objective's true
  ceiling: maximal speed subject to mean quality >= the gate. Starting from
  the quality-maximal assignment it greedily demotes to tier 0 the items
  whose good tier costs the most, spending the quality slack between the
  quality-maximal mean and the gate. With binary goodness each demotion
  costs exactly one quality unit, so sorting by time saved is exact
  (knapsack with identical weights).
"""

from __future__ import annotations

import numpy as np


def oracle_assignments(goodness: np.ndarray) -> np.ndarray:
    """Per-item stopping tier for the quality-maximal direct-routing oracle.

    ``goodness``: [n_items, n_tiers] bool — which tiers' answers are good.
    Returns [n_items] int: cheapest good tier; tier 0 when none is good.
    """
    g = np.asarray(goodness, bool)
    any_good = g.any(axis=1)
    # argmax over bool returns the FIRST True (the cheapest good tier)
    return np.where(any_good, g.argmax(axis=1), 0)


def gate_constrained_assignments(
    goodness: np.ndarray,
    stage_times: np.ndarray,
    quality_gate_mean: float,
) -> np.ndarray:
    """Max-speed direct routing subject to ``mean(quality) >= quality_gate_mean``.

    ``stage_times``: [n_tiers] per-item wall time of serving an item at each
    tier (monotone increasing). ``quality_gate_mean`` is an absolute mean
    goodness (e.g. ``0.95 * goodness[:, -1].mean()``).
    """
    g = np.asarray(goodness, bool)
    t = np.asarray(stage_times, np.float64)
    ks = oracle_assignments(g).copy()
    n = len(ks)
    q = g[np.arange(n), ks].astype(np.float64)
    budget = float(q.sum() - quality_gate_mean * n)
    if budget <= 0.0:
        return ks  # gate already binds (or is unattainable): keep quality-max
    savings = t[ks] - t[0]
    for i in np.argsort(-savings):
        if budget < 1.0:
            break
        if ks[i] == 0 or savings[i] <= 0.0 or not q[i]:
            continue
        ks[i] = 0
        budget -= 1.0
    return ks


def expected_gate_constrained_assignments(
    p: np.ndarray,
    stage_times: np.ndarray,
    quality_gate_mean: float,
    *,
    n_mu: int = 400,
) -> np.ndarray:
    """Max-speed direct routing on EXPECTED per-tier quality subject to
    ``mean_i p[i, k_i] >= quality_gate_mean``.

    ``p``: [n_items, n_tiers] per-tier solve probabilities — the most any
    policy that knows the world's PROBABILITIES (but not its realizations)
    can exploit. The gap between this ceiling and the realized-goodness
    ceiling (:func:`gate_constrained_assignments`) is ALEATORIC: information
    only an oracle that has seen the coin flips can use. The gap between a
    learned policy and THIS ceiling is predictor/policy loss — the part a
    better decision layer can close (VERDICT r3 next #1a decomposition).

    Solved by sweeping the dual variable mu of the Lagrangian
    ``min_k t[k] - mu * p[i, k]`` (per-item, so the sweep is exact on the
    convex hull of the feasible frontier) and keeping the fastest feasible
    assignment; a final greedy promote pass (best dq/dt) repairs the at-most-
    one-item hull gap if no mu is feasible.
    """
    p = np.asarray(p, np.float64)
    t = np.asarray(stage_times, np.float64)
    n, m = p.shape
    best_ks, best_t = None, np.inf
    for mu in np.geomspace(1e-4, 1e4, n_mu):
        ks = np.argmin(t[None, :] - mu * p, axis=1)
        if p[np.arange(n), ks].mean() >= quality_gate_mean:
            tm = float(t[ks].mean())
            if tm < best_t:
                best_ks, best_t = ks, tm
    if best_ks is not None:
        return best_ks
    # no dual point feasible: promote greedily from the all-cheapest start
    ks = np.zeros(n, np.int64)
    while p[np.arange(n), ks].mean() < quality_gate_mean:
        dq = np.where(ks[:, None] < np.arange(m)[None, :],
                      p - p[np.arange(n), ks][:, None], -np.inf)
        dt = np.maximum(t[None, :] - t[ks][:, None], 1e-12)
        ratio = dq / dt
        i, k = np.unravel_index(np.argmax(ratio), ratio.shape)
        if not np.isfinite(ratio[i, k]) or ratio[i, k] <= 0:
            ks[:] = m - 1  # gate unattainable below always-largest
            break
        ks[i] = k
    return ks
