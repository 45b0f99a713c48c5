"""Rigorous statistical evaluation: paired tests, corrections, bootstrap.

Role parity: reference ``src/statistical_evaluation.py`` (RigorousEvaluator:
paired/independent t-tests with CI + Cohen's d + post-hoc power, Bonferroni
correction, k-fold CV comparison, bootstrap CIs, normality checks,
publication LaTeX table generator).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np


@dataclass
class StatisticalResult:
    """reference statistical_evaluation.py StatisticalResult."""

    test: str
    statistic: float
    p_value: float
    effect_size: float            # Cohen's d
    ci_low: float
    ci_high: float
    power: float
    significant: bool
    n: int


class RigorousEvaluator:
    def __init__(self, alpha: float = 0.05) -> None:
        self.alpha = alpha

    # ----------------------------------------------------------------- tests
    def paired_t_test(self, a: Sequence[float], b: Sequence[float]) -> StatisticalResult:
        """a vs b paired; CI on the mean difference (reference :45-115)."""
        from scipy import stats as sp_stats  # seconds to import; only here

        a, b = np.asarray(a, float), np.asarray(b, float)
        if a.shape != b.shape or a.size < 2:
            raise ValueError("paired test needs equal-length samples, n >= 2")
        diff = a - b
        t, p = sp_stats.ttest_rel(a, b)
        sd = diff.std(ddof=1)
        d = float(diff.mean() / sd) if sd > 0 else 0.0
        se = sd / np.sqrt(diff.size)
        tcrit = sp_stats.t.ppf(1 - self.alpha / 2, diff.size - 1)
        power = self._power(abs(d), diff.size)
        return StatisticalResult(
            test="paired_t",
            statistic=float(t),
            p_value=float(p),
            effect_size=d,
            ci_low=float(diff.mean() - tcrit * se),
            ci_high=float(diff.mean() + tcrit * se),
            power=power,
            significant=bool(p < self.alpha),
            n=int(diff.size),
        )

    def independent_t_test(self, a: Sequence[float], b: Sequence[float]) -> StatisticalResult:
        from scipy import stats as sp_stats  # seconds to import; only here

        a, b = np.asarray(a, float), np.asarray(b, float)
        t, p = sp_stats.ttest_ind(a, b, equal_var=False)
        pooled = np.sqrt((a.var(ddof=1) + b.var(ddof=1)) / 2)
        d = float((a.mean() - b.mean()) / pooled) if pooled > 0 else 0.0
        se = np.sqrt(a.var(ddof=1) / a.size + b.var(ddof=1) / b.size)
        df = min(a.size, b.size) - 1
        tcrit = sp_stats.t.ppf(1 - self.alpha / 2, df)
        mean_diff = a.mean() - b.mean()
        return StatisticalResult(
            test="independent_t",
            statistic=float(t),
            p_value=float(p),
            effect_size=d,
            ci_low=float(mean_diff - tcrit * se),
            ci_high=float(mean_diff + tcrit * se),
            power=self._power(abs(d), min(a.size, b.size)),
            significant=bool(p < self.alpha),
            n=int(a.size + b.size),
        )

    def _power(self, d: float, n: int) -> float:
        """Post-hoc power for a two-sided t-test at alpha."""
        from scipy import stats as sp_stats  # seconds to import; only here

        if n < 2:
            return 0.0
        nc = d * np.sqrt(n)
        tcrit = sp_stats.t.ppf(1 - self.alpha / 2, n - 1)
        return float(
            1 - sp_stats.nct.cdf(tcrit, n - 1, nc) + sp_stats.nct.cdf(-tcrit, n - 1, nc)
        )

    # ------------------------------------------------------------ corrections
    def bonferroni_correction(self, p_values: Sequence[float]) -> list[dict]:
        """reference :117-137."""
        m = len(p_values)
        out = []
        for p in p_values:
            p_adj = min(p * m, 1.0)
            out.append(
                {"p_raw": float(p), "p_adjusted": p_adj, "significant": p_adj < self.alpha}
            )
        return out

    def holm_correction(self, p_values: Sequence[float]) -> list[dict]:
        """Step-down Holm (uniformly more powerful than Bonferroni)."""
        m = len(p_values)
        order = np.argsort(p_values)
        adjusted = np.empty(m)
        running = 0.0
        for rank, idx in enumerate(order):
            running = max(running, (m - rank) * p_values[idx])
            adjusted[idx] = min(running, 1.0)
        return [
            {"p_raw": float(p), "p_adjusted": float(adjusted[i]),
             "significant": adjusted[i] < self.alpha}
            for i, p in enumerate(p_values)
        ]

    # -------------------------------------------------------------- bootstrap
    def bootstrap_confidence_interval(
        self,
        data: Sequence[float],
        statistic: Callable[[np.ndarray], float] = np.mean,
        n_boot: int = 2000,
        seed: int = 0,
    ) -> tuple[float, float, float]:
        """Percentile bootstrap CI; returns (stat, lo, hi) (reference :117+)."""
        data = np.asarray(data, float)
        rng = np.random.default_rng(seed)
        boots = np.asarray(
            [statistic(rng.choice(data, size=data.size, replace=True)) for _ in range(n_boot)]
        )
        lo, hi = np.percentile(boots, [100 * self.alpha / 2, 100 * (1 - self.alpha / 2)])
        return float(statistic(data)), float(lo), float(hi)

    # ------------------------------------------------------------ assumptions
    def check_assumptions(self, data: Sequence[float]) -> dict:
        """Normality (Shapiro) + skew/kurtosis diagnostics."""
        from scipy import stats as sp_stats  # seconds to import; only here

        data = np.asarray(data, float)
        if data.size < 3:
            return {"normal": None, "note": "too few samples"}
        stat, p = sp_stats.shapiro(data[:5000])
        return {
            "normal": bool(p > self.alpha),
            "shapiro_p": float(p),
            "skew": float(sp_stats.skew(data)),
            "kurtosis": float(sp_stats.kurtosis(data)),
        }

    # ----------------------------------------------------- cross-validation
    def cross_validated_comparison(
        self,
        scores_a: Sequence[float],
        scores_b: Sequence[float],
        k: int = 5,
        seed: int = 0,
    ) -> dict:
        """k-fold means + paired test over folds (reference :200+)."""
        a, b = np.asarray(scores_a, float), np.asarray(scores_b, float)
        rng = np.random.default_rng(seed)
        idx = rng.permutation(a.size)
        folds = np.array_split(idx, k)
        fa = [float(a[f].mean()) for f in folds]
        fb = [float(b[f].mean()) for f in folds]
        res = self.paired_t_test(fa, fb)
        return {"fold_means_a": fa, "fold_means_b": fb, "test": res}


def generate_publication_table(
    rows: Sequence[dict],
    caption: str = "Method comparison",
    label: str = "tab:results",
) -> str:
    """LaTeX table from comparison rows (reference :329). Each row:
    {"method", "mean", "ci_low", "ci_high", "p_value", "effect_size"}."""
    lines = [
        r"\begin{table}[t]",
        r"\centering",
        rf"\caption{{{caption}}}",
        rf"\label{{{label}}}",
        r"\begin{tabular}{lcccc}",
        r"\toprule",
        r"Method & Mean & 95\% CI & $p$ & Cohen's $d$ \\",
        r"\midrule",
    ]
    for r in rows:
        p = r.get("p_value")
        p_str = "---" if p is None else (f"{p:.3g}" if p >= 0.001 else "$<$0.001")
        d_str = "---" if r.get("effect_size") is None else f"{r['effect_size']:.2f}"
        lines.append(
            f"{r['method']} & {r['mean']:.3f} & "
            f"[{r['ci_low']:.3f}, {r['ci_high']:.3f}] & {p_str} & {d_str} \\\\"
        )
    lines += [r"\bottomrule", r"\end{tabular}", r"\end{table}"]
    return "\n".join(lines)
