"""Ensemble quality predictor (counterpart of
``adaptive_sd_tpu/predict/ensemble.py``).

Role parity: reference ``EnsembleQualityPredictor``
(``src/models/enhanced_predictor.py:262-578``): random-forest, gradient-
boosting, MLP and Ridge members, each behind its own standard scaler,
averaged with weights from their clipped validation R^2, the spread across
members as the uncertainty, impurity-based feature importance.

The JAX package fits sklearn members; the card's machine has no sklearn, so
the members are written here with sklearn's settings:

- the scaler: population std, a scale of 1 where the std is 0;
- Ridge (alpha 1) in closed form with an unpenalised intercept;
- the forest (100 trees, depth 12, bootstrap rows, every feature at every
  split) and boosting (100 trees of depth 5, learning rate 0.1, a mean
  init, ``friedman_mse`` splits) on host numpy. A tree grows level by
  level: the feature columns are sorted once, each level stably re-sorts
  them by node, and segmented cumulative sums give every split's gain at
  once. Splits fall at the midpoint between sorted distinct float32 values;
  rows are compared as float32, as sklearn's trees compare them;
- the MLP (128, 64), ReLU, Adam 1e-3, L2 1e-4, batches of ``min(200, n)``,
  early stopping on a 10 % split after 10 epochs without a gain of 1e-4,
  trained in float64 with torch on ``device`` (default: the card) and
  predicted on the host.

:func:`ensemble_from_jax` carries a fitted JAX ensemble across by reading
its members' arrays (it imports no sklearn). ``save`` and ``load`` use this
package's own ``.npz`` layout of flat tree arrays; the JAX ``.pkl`` holds
sklearn objects, which cannot be read without sklearn.
"""

from __future__ import annotations

import json
import pathlib
import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.exceptions import PredictionError
from ..core.types import PredictionResult
from .features import FEATURE_DIM, extract_features

MEMBERS = ("random_forest", "gbm", "mlp", "ridge")
FOREST_TREES, FOREST_DEPTH = 100, 12
GBM_TREES, GBM_DEPTH, GBM_LR = 100, 5, 0.1
MLP_HIDDEN = (128, 64)
RIDGE_ALPHA = 1.0
_EPS = np.finfo(np.float64).eps
_FEATURE_THRESHOLD = 1e-7  # sklearn's: values closer than this do not split


# ---------------------------------------------------------------------------
# members


@dataclass
class _Scaler:
    mean: np.ndarray
    scale: np.ndarray

    @classmethod
    def fit(cls, X: np.ndarray) -> "_Scaler":
        mean = X.mean(axis=0)
        std = np.sqrt(((X - mean) ** 2).mean(axis=0))
        return cls(mean, np.where(std < 10 * _EPS, 1.0, std))

    def transform(self, X: np.ndarray) -> np.ndarray:
        return (X - self.mean) / self.scale


@dataclass
class _Linear:
    """Ridge: ``X @ coef + intercept``."""

    coef: np.ndarray
    intercept: float

    @classmethod
    def fit(cls, X: np.ndarray, y: np.ndarray, alpha: float = RIDGE_ALPHA) -> "_Linear":
        xm, ym = X.mean(axis=0), y.mean()
        Xc = X - xm
        coef = np.linalg.solve(Xc.T @ Xc + alpha * np.eye(X.shape[1]), Xc.T @ (y - ym))
        return cls(coef, float(ym - xm @ coef))

    def predict(self, X: np.ndarray) -> np.ndarray:
        return X @ self.coef + self.intercept


@dataclass
class _MLP:
    """A ReLU MLP with an identity output, predicted in float64 on the host."""

    coefs: list
    intercepts: list

    def predict(self, X: np.ndarray) -> np.ndarray:
        a = np.asarray(X, np.float64)
        for i, (w, b) in enumerate(zip(self.coefs, self.intercepts)):
            a = a @ w
            a += b
            if i < len(self.coefs) - 1:
                np.maximum(a, 0, out=a)
        return a.ravel()


@dataclass
class TreeEnsemble:
    """Trees in flat arrays: node ``i``'s children ``left[i]`` / ``right[i]``
    (global indices, -1 at a leaf), split ``feature[i]`` and ``threshold[i]``,
    leaf ``value[i]``, and the ``impurity`` and ``weighted_n`` the feature
    importance is read from; ``roots[t]`` is tree ``t``'s first node.
    ``lr is None``: a forest, the mean of its trees; otherwise boosting,
    ``init + lr * tree_0 + lr * tree_1 + ...`` added in tree order."""

    left: np.ndarray
    right: np.ndarray
    feature: np.ndarray
    threshold: np.ndarray
    value: np.ndarray
    impurity: np.ndarray
    weighted_n: np.ndarray
    roots: np.ndarray
    init: float = 0.0
    lr: Optional[float] = None

    def leaf_values(self, X: np.ndarray) -> np.ndarray:
        """[trees, rows]: each tree's leaf value for each row. Rows are
        compared as float32 (sklearn casts X so before its float64
        thresholds)."""
        Xf = np.asarray(X, np.float32).astype(np.float64)
        n = len(Xf)
        node = np.repeat(self.roots[:, None], n, axis=1)
        cols = np.arange(n)[None, :]
        while True:
            inner = self.left[node] >= 0
            if not inner.any():
                return self.value[node]
            xv = Xf[cols, np.where(inner, self.feature[node], 0)]
            nxt = np.where(xv <= self.threshold[node], self.left[node], self.right[node])
            node = np.where(inner, nxt, node)

    def predict(self, X: np.ndarray) -> np.ndarray:
        vals = self.leaf_values(X)
        if self.lr is None:
            out = np.zeros(vals.shape[1])
            for v in vals:
                out += v
            return out / len(vals)
        out = np.full(vals.shape[1], self.init)
        for v in vals:
            out += self.lr * v
        return out

    def feature_importances(self, n_features: int) -> np.ndarray:
        """The forest's ``feature_importances_``: each tree's impurity
        decrease by feature over its root's weight, normalised; the mean over
        trees that split, normalised."""
        ends = np.append(self.roots[1:], len(self.left))
        per_tree = []
        for lo, hi in zip(self.roots, ends):
            if hi - lo <= 1:
                continue
            imp = np.zeros(n_features)
            for i in range(lo, hi):
                lc, rc = self.left[i], self.right[i]
                if lc < 0:
                    continue
                imp[self.feature[i]] += (
                    self.weighted_n[i] * self.impurity[i]
                    - self.weighted_n[lc] * self.impurity[lc]
                    - self.weighted_n[rc] * self.impurity[rc])
            imp /= self.weighted_n[lo]
            total = np.sum(imp)
            per_tree.append(imp / total if total > 0 else imp)
        if not per_tree:
            return np.zeros(n_features)
        mean = np.mean(per_tree, axis=0, dtype=np.float64)
        return mean / np.sum(mean)

    def arrays(self) -> dict:
        return {"left": self.left, "right": self.right, "feature": self.feature,
                "threshold": self.threshold, "value": self.value,
                "impurity": self.impurity, "weighted_n": self.weighted_n,
                "roots": self.roots,
                "init_lr": np.asarray([self.init, np.nan if self.lr is None else self.lr])}

    @classmethod
    def from_arrays(cls, a: dict) -> "TreeEnsemble":
        init, lr = (float(v) for v in a.pop("init_lr"))
        return cls(**a, init=init, lr=None if np.isnan(lr) else lr)

    @classmethod
    def concat(cls, trees: Sequence[dict], init: float = 0.0,
               lr: Optional[float] = None) -> "TreeEnsemble":
        """Trees given as sklearn-style local arrays (children -1 at a leaf)."""
        roots, off = [], 0
        parts: dict = {k: [] for k in ("left", "right", "feature", "threshold", "value",
                                       "impurity", "weighted_n")}
        for t in trees:
            n = len(t["left"])
            roots.append(off)
            for side in ("left", "right"):
                c = np.asarray(t[side], np.int64)
                parts[side].append(np.where(c >= 0, c + off, -1))
            parts["feature"].append(np.asarray(t["feature"], np.int64))
            for k in ("threshold", "value", "impurity", "weighted_n"):
                parts[k].append(np.asarray(t[k], np.float64))
            off += n
        return cls(**{k: np.concatenate(v) for k, v in parts.items()},
                   roots=np.asarray(roots, np.int64), init=float(init), lr=lr)


# ---------------------------------------------------------------------------
# tree fitting, level by level


def _grow_tree(XT32: np.ndarray, order: np.ndarray, y: np.ndarray, w: np.ndarray,
               max_depth: int, friedman: bool) -> dict:
    """One regression tree on the rows of ``order`` ([features, rows]: each
    feature's row indices, sorted by value) with weights ``w`` (0 for rows
    not drawn). ``XT32``: [features, all rows] float32. ``friedman``: the
    ``friedman_mse`` split gain, else squared error's. Nodes are numbered
    breadth first; returns local arrays as :meth:`TreeEnsemble.concat` takes."""
    F, N = XT32.shape
    node_of = np.full(N, -1, np.int64)
    node_of[order[0]] = 0
    wy, wyy = w * y, w * y * y
    out: dict = {k: [] for k in ("left", "right", "feature", "threshold", "value",
                                 "impurity", "weighted_n")}
    lo, hi, depth = 0, 1, 0
    while lo < hi:
        n_open = hi - lo
        rows = order[0]
        slot = node_of[rows] - lo
        slot = np.where(slot >= 0, slot, n_open)
        W = np.bincount(slot, w[rows], minlength=n_open + 1)[:n_open]
        S = np.bincount(slot, wy[rows], minlength=n_open + 1)[:n_open]
        SS = np.bincount(slot, wyy[rows], minlength=n_open + 1)[:n_open]
        cnt = np.bincount(slot, minlength=n_open + 1)[:n_open]
        value = S / W
        impurity = SS / W - value * value
        out["value"].append(value)
        out["impurity"].append(impurity)
        out["weighted_n"].append(W)
        left = np.full(n_open, -1, np.int64)
        right = np.full(n_open, -1, np.int64)
        feature = np.full(n_open, -2, np.int64)
        threshold = np.full(n_open, -2.0)
        may_split = (depth < max_depth) & (cnt >= 2) & (impurity > _EPS)
        if may_split.any():
            key_of = np.full(N, n_open, np.int64)
            key_of[rows] = np.where(may_split[np.minimum(slot, n_open - 1)] & (slot < n_open),
                                    slot, n_open)
            keys = key_of[order].astype(np.int16 if n_open < 2 ** 15 - 1 else np.int64)
            seq = np.take_along_axis(order, np.argsort(keys, axis=1, kind="stable"), axis=1)
            m = int(cnt[may_split].sum())
            seq = seq[:, :m]
            seg = key_of[seq[0]]                       # a row's node slot (every feature)
            starts = np.flatnonzero(np.r_[True, seg[1:] != seg[:-1]])
            seg_pos = np.repeat(np.arange(len(starts)), np.diff(np.r_[starts, m]))
            row_start = starts[seg_pos]
            xs = np.take_along_axis(XT32, seq, axis=1).astype(np.float64)
            cw = np.cumsum(w[seq], axis=1)
            cs = np.cumsum(wy[seq], axis=1)
            before = row_start - 1
            has_before = before >= 0
            lw = cw - np.where(has_before, cw[:, np.maximum(before, 0)], 0.0)
            ls = cs - np.where(has_before, cs[:, np.maximum(before, 0)], 0.0)
            rw = W[seg] - lw
            rs = S[seg] - ls
            valid = np.zeros((F, m), bool)
            valid[:, :-1] = (seg[1:] == seg[:-1]) & (xs[:, 1:] > xs[:, :-1] + _FEATURE_THRESHOLD)
            with np.errstate(divide="ignore", invalid="ignore"):
                if friedman:
                    diff = rw * ls - lw * rs
                    gain = diff * diff / (lw * rw)
                else:
                    gain = ls * ls / lw + rs * rs / rw
            gain = np.where(valid, gain, -np.inf)
            bf = np.argmax(gain, axis=0)               # best feature at each row
            bg = gain[bf, np.arange(m)]
            seg_best = np.maximum.reduceat(bg, starts)
            hit = np.flatnonzero((bg == seg_best[seg_pos]) & np.isfinite(bg))
            segs, first = np.unique(seg[hit], return_index=True)
            at = hit[first]
            f_best = bf[at]
            a, b = xs[f_best, at], xs[f_best, at + 1]
            thr = a / 2.0 + b / 2.0
            thr = np.where((thr == b) | np.isinf(thr), a, thr)
            kids = hi + 2 * np.arange(len(segs))
            left[segs], right[segs] = kids, kids + 1
            feature[segs], threshold[segs] = f_best, thr
            # move each row of a split node to its child
            split_rows = rows[(slot < n_open)]
            s_slot = node_of[split_rows] - lo
            moving = left[s_slot] >= 0
            split_rows, s_slot = split_rows[moving], s_slot[moving]
            go_left = (XT32[feature[s_slot], split_rows].astype(np.float64)
                       <= threshold[s_slot])
            node_of[split_rows] = np.where(go_left, left[s_slot], right[s_slot])
        out["left"].append(left)
        out["right"].append(right)
        out["feature"].append(feature)
        out["threshold"].append(threshold)
        n_split = int((left >= 0).sum())
        lo, hi, depth = hi, hi + 2 * n_split, depth + 1
    return {k: np.concatenate(v) for k, v in out.items()}


def fit_forest(X: np.ndarray, y: np.ndarray, seed: int, n_trees: int = FOREST_TREES,
               max_depth: int = FOREST_DEPTH) -> TreeEnsemble:
    """Bootstrap rows (drawn with ``np.random.default_rng(seed)``, counted as
    weights), every feature at every split, squared-error gain."""
    XT32 = np.ascontiguousarray(np.asarray(X, np.float32).T)
    y = np.asarray(y, np.float64)
    n = len(y)
    order_all = np.argsort(XT32, axis=1, kind="stable")
    rng = np.random.default_rng(seed)
    trees = []
    for _ in range(n_trees):
        w = np.bincount(rng.integers(0, n, n), minlength=n).astype(np.float64)
        keep = w[order_all] > 0
        order = order_all[keep].reshape(XT32.shape[0], -1)
        trees.append(_grow_tree(XT32, order, y, w, max_depth, friedman=False))
    return TreeEnsemble.concat(trees)


def fit_boosting(X: np.ndarray, y: np.ndarray, n_trees: int = GBM_TREES,
                 max_depth: int = GBM_DEPTH, lr: float = GBM_LR) -> TreeEnsemble:
    """Squared-error gradient boosting from the mean: each tree fits the
    residuals with the ``friedman_mse`` gain."""
    XT32 = np.ascontiguousarray(np.asarray(X, np.float32).T)
    y = np.asarray(y, np.float64)
    order = np.argsort(XT32, axis=1, kind="stable")
    w = np.ones(len(y))
    init = float(y.mean())
    raw = np.full(len(y), init)
    trees = []
    for _ in range(n_trees):
        t = _grow_tree(XT32, order, y - raw, w, max_depth, friedman=True)
        trees.append(t)
        raw += lr * TreeEnsemble.concat([t]).leaf_values(X)[0]
    return TreeEnsemble.concat(trees, init=init, lr=lr)


def fit_mlp(X: np.ndarray, y: np.ndarray, seed: int, device: torch.device,
            hidden: Sequence[int] = MLP_HIDDEN, alpha: float = 1e-4, lr: float = 1e-3,
            max_iter: int = 500, n_iter_no_change: int = 10, tol: float = 1e-4,
            val_frac: float = 0.1) -> _MLP:
    """sklearn's ``MLPRegressor(early_stopping=True)`` recipe in float64 on
    ``device``: Glorot-uniform init, squared loss / 2 plus ``alpha / 2`` of
    the squared weights over the batch, Adam, the weights of the best
    validation R^2."""
    rng = np.random.default_rng(seed)
    n = len(X)
    n_val = max(int(np.ceil(val_frac * n)), 1)
    perm = rng.permutation(n)
    va, tr = perm[:n_val], perm[n_val:]
    sizes = [X.shape[1], *hidden, 1]
    ws, bs = [], []
    for fi, fo in zip(sizes[:-1], sizes[1:]):
        bound = np.sqrt(6.0 / (fi + fo))
        ws.append(torch.tensor(rng.uniform(-bound, bound, (fi, fo)), device=device,
                               requires_grad=True))
        bs.append(torch.tensor(rng.uniform(-bound, bound, fo), device=device,
                               requires_grad=True))
    Xt = torch.tensor(X[tr], dtype=torch.float64, device=device)
    yt = torch.tensor(y[tr], dtype=torch.float64, device=device)
    Xv = torch.tensor(X[va], dtype=torch.float64, device=device)
    yv = torch.tensor(y[va], dtype=torch.float64, device=device)
    ss_tot = float(torch.sum((yv - yv.mean()) ** 2))

    def forward(x):
        for i, (w, b) in enumerate(zip(ws, bs)):
            x = x @ w + b
            if i < len(ws) - 1:
                x = torch.relu(x)
        return x[:, 0]

    opt = torch.optim.Adam([*ws, *bs], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    batch = min(200, len(tr))
    best_score, best, stall = -np.inf, None, 0
    for _ in range(max_iter):
        order_e = rng.permutation(len(tr))
        for s in range(0, len(tr), batch):
            idx = torch.as_tensor(order_e[s:s + batch], device=device)
            xb, yb = Xt[idx], yt[idx]
            loss = (0.5 * torch.mean((yb - forward(xb)) ** 2)
                    + 0.5 * alpha * sum(torch.sum(w * w) for w in ws) / len(idx))
            opt.zero_grad()
            loss.backward()
            opt.step()
        with torch.no_grad():
            ss_res = float(torch.sum((yv - forward(Xv)) ** 2))
        # sklearn's r2_score on a constant target: 1 if exact, else 0
        score = 1.0 - ss_res / ss_tot if ss_tot > 0 else float(ss_res == 0)
        stall = stall + 1 if score < best_score + tol else 0
        if score > best_score:
            best_score = score
            best = [t.detach().clone() for t in (*ws, *bs)]
        if stall > n_iter_no_change:
            break
    k = len(ws)
    return _MLP([t.cpu().numpy() for t in best[:k]], [t.cpu().numpy() for t in best[k:]])


# ---------------------------------------------------------------------------
# the predictor


def _r2(y: np.ndarray, pred: np.ndarray) -> float:
    ss_res = float(np.sum((y - pred) ** 2))
    ss_tot = float(np.sum((y - y.mean()) ** 2)) or 1e-12
    return 1.0 - ss_res / ss_tot


class EnsembleQualityPredictor:
    """Same API as the JAX class: ``fit`` returns the members' validation
    R^2, ``predict_features`` the weighted mean and the spread."""

    def __init__(self, feature_dim: int = FEATURE_DIM, n_stages: int = 4, seed: int = 0):
        self.feature_dim = feature_dim
        self.n_stages = n_stages
        self.seed = seed
        self.members: dict = {}
        self.scalers: dict[str, _Scaler] = {}
        self.weights: dict[str, float] = {}
        self.fitted = False

    def fit(self, X: np.ndarray, y: np.ndarray, val_frac: float = 0.2,
            device=None) -> dict[str, float]:
        """Train every member on the JAX class's split; weights = validation
        R^2 clipped at 0.01, normalised. ``device``: where the MLP member
        trains (default: the card; raises without one)."""
        device = resolve_device(device)
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        perm = np.random.default_rng(self.seed).permutation(len(X))
        n_val = max(int(len(X) * val_frac), 1)
        val_idx, tr_idx = perm[:n_val], perm[n_val:]
        fitters = {
            "random_forest": lambda Xs, ys: fit_forest(Xs, ys, self.seed),
            "gbm": lambda Xs, ys: fit_boosting(Xs, ys),
            "mlp": lambda Xs, ys: fit_mlp(Xs, ys, self.seed, device),
            "ridge": lambda Xs, ys: _Linear.fit(Xs, ys),
        }
        scores: dict[str, float] = {}
        self.members, self.scalers, self.weights = {}, {}, {}
        for name in MEMBERS:
            scaler = _Scaler.fit(X[tr_idx])
            model = fitters[name](scaler.transform(X[tr_idx]), y[tr_idx])
            r2 = _r2(y[val_idx], model.predict(scaler.transform(X[val_idx])))
            self.members[name], self.scalers[name] = model, scaler
            scores[name] = r2
            self.weights[name] = max(r2, 0.01)
        total = sum(self.weights.values())
        self.weights = {k: v / total for k, v in self.weights.items()}
        self.fitted = True
        return scores

    def _predict_members(self, X: np.ndarray) -> dict[str, np.ndarray]:
        if not self.fitted:
            raise PredictionError("ensemble not fitted")
        X = np.atleast_2d(np.asarray(X, np.float64))
        return {name: np.clip(m.predict(self.scalers[name].transform(X)), 0.0, 1.0)
                for name, m in self.members.items()}

    def predict_features(self, X: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Returns (weighted mean, cross-member std) per row."""
        preds = self._predict_members(X)
        stacked = np.stack(list(preds.values()))
        weights = np.asarray([self.weights[k] for k in preds])
        mean = np.einsum("m,mn->n", weights, stacked)
        return mean, stacked.std(axis=0)

    def predict(self, prompt: str, draft_output: str, draft_logprobs: Optional[np.ndarray],
                stage_index: int) -> PredictionResult:
        t0 = time.perf_counter()
        feats = extract_features(prompt, draft_output, draft_logprobs, stage_index,
                                 n_stages=self.n_stages)
        mean, std = self.predict_features(feats)
        return PredictionResult(
            quality_score=float(mean[0]),
            confidence=1.0 - float(std[0]),
            uncertainty=float(std[0]),
            features=feats,
            prediction_time_s=time.perf_counter() - t0,
            predictor_name="ensemble",
        )

    def predict_batch(self, items: Sequence) -> list[PredictionResult]:
        return [self.predict(*it) for it in items]

    def feature_importance(self) -> Optional[np.ndarray]:
        rf = self.members.get("random_forest")
        return None if rf is None else rf.feature_importances(self.feature_dim)

    # -- persistence ---------------------------------------------------------
    def save(self, path: str) -> None:
        """One ``.npz``: flat arrays, no pickle."""
        if not self.fitted:
            raise PredictionError("ensemble not fitted")
        p = pathlib.Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        flat = {}
        for name in MEMBERS:
            sc = self.scalers[name]
            flat[f"{name}.scaler_mean"], flat[f"{name}.scaler_scale"] = sc.mean, sc.scale
        for name in ("random_forest", "gbm"):
            for k, v in self.members[name].arrays().items():
                flat[f"{name}.{k}"] = v
        mlp = self.members["mlp"]
        for i, (w, b) in enumerate(zip(mlp.coefs, mlp.intercepts)):
            flat[f"mlp.w{i}"], flat[f"mlp.b{i}"] = w, b
        flat["ridge.coef"] = self.members["ridge"].coef
        flat["ridge.intercept"] = np.asarray(self.members["ridge"].intercept)
        meta = {"feature_dim": self.feature_dim, "n_stages": self.n_stages,
                "seed": self.seed, "mlp_layers": len(mlp.coefs),
                "weights": [self.weights[k] for k in MEMBERS]}
        with open(p, "wb") as f:
            np.savez(f, meta=json.dumps(meta), **flat)

    @classmethod
    def load(cls, path: str) -> "EnsembleQualityPredictor":
        data = np.load(path, allow_pickle=False)
        meta = json.loads(str(data["meta"]))
        self = cls(meta["feature_dim"], meta["n_stages"], meta["seed"])

        def part(name):
            pre = name + "."
            return {k[len(pre):]: data[k] for k in data.files
                    if k.startswith(pre) and not k.startswith(pre + "scaler_")}

        for name in MEMBERS:
            self.scalers[name] = _Scaler(data[f"{name}.scaler_mean"],
                                         data[f"{name}.scaler_scale"])
        self.members["random_forest"] = TreeEnsemble.from_arrays(part("random_forest"))
        self.members["gbm"] = TreeEnsemble.from_arrays(part("gbm"))
        n = meta["mlp_layers"]
        self.members["mlp"] = _MLP([data[f"mlp.w{i}"] for i in range(n)],
                                   [data[f"mlp.b{i}"] for i in range(n)])
        self.members["ridge"] = _Linear(data["ridge.coef"], float(data["ridge.intercept"]))
        self.weights = dict(zip(MEMBERS, (float(w) for w in meta["weights"])))
        self.fitted = True
        return self


def _sk_tree(tree) -> dict:
    t = tree.tree_
    return {"left": t.children_left, "right": t.children_right, "feature": t.feature,
            "threshold": t.threshold, "value": t.value[:, 0, 0], "impurity": t.impurity,
            "weighted_n": t.weighted_n_node_samples}


def ensemble_from_jax(pred) -> EnsembleQualityPredictor:
    """A fitted JAX ``EnsembleQualityPredictor`` (sklearn members) as this
    package's predictor, read attribute by attribute: the trees' node arrays,
    boosting's ``init_`` and ``learning_rate``, the MLP's ``coefs_`` and
    ``intercepts_``, Ridge's ``coef_`` and ``intercept_``, the scalers'
    ``mean_`` and ``scale_``, and the weights."""
    if not pred.fitted:
        raise PredictionError("ensemble not fitted")
    self = EnsembleQualityPredictor(pred.feature_dim, pred.n_stages, pred.seed)
    m = pred.members
    self.members["random_forest"] = TreeEnsemble.concat(
        [_sk_tree(t) for t in m["random_forest"].estimators_])
    gbm = m["gbm"]
    self.members["gbm"] = TreeEnsemble.concat(
        [_sk_tree(t) for t in gbm.estimators_[:, 0]],
        init=float(np.asarray(gbm.init_.constant_).ravel()[0]),
        lr=float(gbm.learning_rate))
    self.members["mlp"] = _MLP([np.asarray(w, np.float64) for w in m["mlp"].coefs_],
                               [np.asarray(b, np.float64) for b in m["mlp"].intercepts_])
    self.members["ridge"] = _Linear(np.asarray(m["ridge"].coef_, np.float64),
                                    float(m["ridge"].intercept_))
    for name in MEMBERS:
        sc = pred.scalers[name]
        self.scalers[name] = _Scaler(np.asarray(sc.mean_, np.float64),
                                     np.asarray(sc.scale_, np.float64))
    self.weights = {k: float(pred.weights[k]) for k in MEMBERS}
    self.fitted = True
    return self
