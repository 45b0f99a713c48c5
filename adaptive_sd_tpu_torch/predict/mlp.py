"""Quality-predictor MLP on tensors (counterpart of
``adaptive_sd_tpu/predict/mlp.py``).

Role parity: reference ``ResearchQualityPredictor`` (torch MLP
128->[256,128,64]->1 sigmoid with batchnorm, scripts/train_predictor.py:57-91)
and the missing ``src/models/predictor.py`` contract (predict(prompt, draft,
logprobs, stage) -> prob, loaded from a checkpoint,
src/serving/server.py:168-176). The forward pass is a plain tensor function,
so the stopping decision can be evaluated on the device right after the
decode loop; the serving hot path predicts on the host in numpy. Training
(``fit``) runs on the card by default: AdamW + cosine decay + global-norm
clipping + early stopping + k-fold CV + Platt calibration, the JAX class's
optax recipe step for step. ``save`` and ``load`` use the JAX class's
``.npz`` layout, so either package reads the other's files.
"""

from __future__ import annotations

import json
import math
import pathlib
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.types import PredictionResult
from .embed import EMBED_LEN, EMBED_VOCAB, hash_batch, pool_np
from .features import (
    DRAFT_LEN_IDX,
    FEATURE_DIM,
    MAX_STAGES,
    STAGE_ONEHOT_START,
    extract_features,
)

Params = dict


def _np32(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy().astype(np.float32, copy=False)
    return np.asarray(t, np.float32)


def _t32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _init_mlp(generator: torch.Generator, sizes: Sequence[int], embed_dim: int = 0) -> Params:
    """He-normal weights from a seeded ``torch.Generator`` (CPU). The numbers
    differ from the JAX class's for the same seed; JAX-made weights come in
    through ``load`` / :func:`predictor_from_jax`."""
    params = {"w": [], "b": []}
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((fan_in, fan_out), generator=generator) * (2.0 / fan_in) ** 0.5
        params["w"].append(w)
        params["b"].append(torch.zeros((fan_out,)))
    if embed_dim > 0:
        # row 0 is the pad row; masked pooling keeps its contribution zero
        params["emb"] = torch.randn((EMBED_VOCAB, embed_dim), generator=generator) * 0.1
    return params


def mlp_forward(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x: [..., F] -> acceptance probability [...] in (0,1). When the params
    carry a learned text embedding table ("emb"), x must already include the
    pooled embedding; use mlp_forward_embed for the raw-indices path."""
    h = x
    n = len(params["w"])
    for i, (w, b) in enumerate(zip(params["w"], params["b"])):
        h = h @ w + b
        if i < n - 1:
            h = torch.relu(h)
    return torch.sigmoid(h[..., 0])


def mlp_forward_embed(
    params: Params, x: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Joint forward: gather + masked mean-pool the learned text embedding
    and concatenate to the handcrafted features (reference parity: DistilBERT
    dims appended to handcrafted features, enhanced_predictor.py:54-245)."""
    e = params["emb"][idx.long()]                # [..., L, d]
    m = mask[..., None]
    pooled = (e * m).sum(dim=-2) / m.sum(dim=-2).clamp(min=1.0)
    return mlp_forward(params, torch.cat([x, pooled], dim=-1))


@dataclass
class TrainReport:
    train_losses: list[float] = field(default_factory=list)
    val_losses: list[float] = field(default_factory=list)
    val_auc: float = 0.0
    val_r2: float = 0.0
    best_epoch: int = 0
    epochs_run: int = 0
    train_time_s: float = 0.0
    fold_metrics: list[dict] = field(default_factory=list)
    calibration_report: list[dict] = field(default_factory=list)


class MLPQualityPredictor:
    """Feature-standardising MLP predictor with save/load."""

    def __init__(
        self,
        feature_dim: int = FEATURE_DIM,
        hidden: Sequence[int] = (128, 64),
        n_stages: int = 4,
        seed: int = 0,
        embed_dim: int = 16,
    ) -> None:
        """``embed_dim``: width of the learned text embedding (0 disables).
        Without texts at predict time the embedding contributes a zero
        vector, so feature-only callers behave exactly as before."""
        self.feature_dim = feature_dim
        self.hidden = tuple(hidden)
        self.n_stages = n_stages
        self.embed_dim = embed_dim
        self.params = _init_mlp(
            torch.Generator().manual_seed(seed), [feature_dim + embed_dim, *hidden, 1], embed_dim
        )
        self.mean = np.zeros(feature_dim, np.float32)
        self.std = np.ones(feature_dim, np.float32)
        # Pooled Platt fallback + per-(stage, draftless) group calibration
        self.calibration: tuple[float, float] = (1.0, 0.0)  # (scale, shift) on logit
        self.group_calibration: dict[tuple[int, int], tuple[float, float]] = {}

    # -- inference -----------------------------------------------------------
    def _forward_np(self, x: np.ndarray) -> np.ndarray:
        """Host-side twin of mlp_forward for the serving hot path (reference
        parity: '<1 ms CPU predictor'). Keeps per-completion predictions off
        the accelerator, where each call would queue behind the engines'
        kernel launches."""
        cache = getattr(self, "_np_cache", None)
        if cache is None or cache[0] is not self.params:
            ws = [_np32(w) for w in self.params["w"]]
            bs = [_np32(b) for b in self.params["b"]]
            self._np_cache = (self.params, ws, bs)
        _, ws, bs = self._np_cache
        h = x.astype(np.float32)
        for i, (w, b) in enumerate(zip(ws, bs)):
            h = h @ w + b
            if i < len(ws) - 1:
                np.maximum(h, 0.0, out=h)
        return 1.0 / (1.0 + np.exp(-h[..., 0]))

    def _pooled(self, texts) -> np.ndarray:
        """[N, embed_dim] learned-embedding vectors (zeros when disabled or
        no texts given — matches the masked-out training contribution)."""
        n = len(texts) if texts is not None else 1
        if self.embed_dim == 0 or texts is None:
            return np.zeros((n, self.embed_dim), np.float32)
        table = _np32(self.params["emb"])
        idx, mask = hash_batch(texts)
        return pool_np(table, idx, mask).astype(np.float32)

    @staticmethod
    def _groups_of(feats: np.ndarray) -> np.ndarray:
        """Recover the calibration group (stage, draftless) per raw feature
        row from the fixed layout (features.py anchors)."""
        f = np.atleast_2d(feats)
        stage = f[:, STAGE_ONEHOT_START : STAGE_ONEHOT_START + MAX_STAGES].argmax(1)
        draftless = (f[:, DRAFT_LEN_IDX] == 0.0).astype(np.int64)
        return np.stack([stage, draftless], axis=1)

    def _apply_calibration(self, p: np.ndarray, feats: np.ndarray) -> np.ndarray:
        """Platt-scale per (stage, draftless) group, pooled fallback for
        groups without their own fit."""
        pooled = self.calibration
        if not self.group_calibration and pooled == (1.0, 0.0):
            return p
        groups = self._groups_of(feats)
        a_row = np.full(len(p), pooled[0])
        b_row = np.full(len(p), pooled[1])
        for (st, dl), (a, b) in self.group_calibration.items():
            m = (groups[:, 0] == st) & (groups[:, 1] == dl)
            a_row[m], b_row[m] = a, b
        logit = np.log(np.clip(p, 1e-7, 1 - 1e-7) / np.clip(1 - p, 1e-7, 1))
        return 1.0 / (1.0 + np.exp(-(a_row * logit + b_row)))

    def predict_features(self, feats: np.ndarray, texts=None) -> np.ndarray:
        """``texts``: optional aligned (prompt, draft) pairs activating the
        learned embedding block."""
        feats = np.atleast_2d(feats)
        # clip: features constant in training (std floored) can be wildly
        # out-of-distribution at serve time; +-10 sigma keeps the MLP sane
        x = np.clip((feats - self.mean) / self.std, -10.0, 10.0)
        if self.embed_dim:
            if texts is None:
                pooled = np.zeros((len(x), self.embed_dim), np.float32)
            else:
                if len(texts) != len(x):
                    raise ValueError(f"{len(texts)} texts for {len(x)} feature rows")
                pooled = self._pooled(texts)
            x = np.concatenate([x, pooled], axis=-1)
        return self._apply_calibration(self._forward_np(x), feats)

    def predict(
        self,
        prompt: str,
        draft_output: str,
        draft_logprobs: Optional[np.ndarray],
        stage_index: int,
    ) -> PredictionResult:
        t0 = time.perf_counter()
        feats = extract_features(
            prompt, draft_output, draft_logprobs, stage_index, n_stages=self.n_stages
        )
        p = float(
            self.predict_features(feats, texts=[(prompt, draft_output)])[0]
        )
        return PredictionResult(
            quality_score=p,
            confidence=abs(p - 0.5) * 2.0,
            features=feats,
            prediction_time_s=time.perf_counter() - t0,
            predictor_name="mlp",
        )

    def predict_batch(self, items) -> list[PredictionResult]:
        return [self.predict(*it) for it in items]

    def normalized_params(self, device=None):
        """(params, mean, std) as tensors on ``device`` (default: where the
        params live), for the on-device inline policy."""
        def mv(t):
            return t if device is None else t.to(device)

        params = {k: ([mv(t) for t in v] if isinstance(v, list) else mv(v))
                  for k, v in self.params.items()}
        return params, mv(torch.from_numpy(np.asarray(self.mean, np.float32))), \
            mv(torch.from_numpy(np.asarray(self.std, np.float32)))

    # -- training ------------------------------------------------------------
    def fit(
        self,
        X: np.ndarray,
        y: np.ndarray,
        *,
        epochs: int = 100,
        batch_size: int = 256,
        lr: float = 1e-3,
        weight_decay: float = 1e-4,
        val_frac: float = 0.15,
        patience: int = 10,
        seed: int = 0,
        k_fold: int = 0,
        texts=None,
        calibrate: bool = False,
        device=None,
    ) -> TrainReport:
        """BCE training with AdamW + cosine schedule + grad clip + early
        stopping; optional k-fold CV reporting (reference
        scripts/train_predictor.py:261-466).

        ``texts``: optional aligned (prompt, draft) pairs — activates joint
        training of the learned text-embedding block. Without texts the
        embedding rows stay masked (zero contribution) and the model is the
        plain dense MLP.

        ``calibrate``: Platt-scale the output probabilities on the validation
        split (a, b on the logit — the DP consumes the predictor as a
        probability, so calibration error translates directly into routing
        error).

        ``device``: where the steps run (default: the card; raises without
        one). The fitted params stay there; ``predict_features`` copies them
        to the host once."""
        device = resolve_device(device)
        t_start = time.perf_counter()
        X = np.asarray(X, np.float32)
        y = np.asarray(y, np.float32)
        self.mean = X.mean(axis=0)
        # floor the std: near-constant training features must not amplify
        # serve-time variation by 1/std ~ 1e6 (saturates the net)
        self.std = np.maximum(X.std(axis=0), 1e-3)
        Xn = (X - self.mean) / self.std
        if self.embed_dim and texts is not None:
            if len(texts) != len(Xn):
                raise ValueError(f"{len(texts)} texts for {len(Xn)} samples")
            IDX, MASK = hash_batch(texts)
        else:
            IDX = np.zeros((len(Xn), EMBED_LEN), np.int32)
            MASK = np.zeros((len(Xn), EMBED_LEN), np.float32)

        report = TrainReport()
        if k_fold and k_fold > 1:
            idx = np.random.default_rng(seed).permutation(len(Xn))
            folds = np.array_split(idx, k_fold)
            for fi in range(k_fold):
                val_idx = folds[fi]
                tr_idx = np.concatenate([folds[j] for j in range(k_fold) if j != fi])
                m, rep = self._train_one(
                    Xn[tr_idx], IDX[tr_idx], MASK[tr_idx], y[tr_idx],
                    Xn[val_idx], IDX[val_idx], MASK[val_idx], y[val_idx],
                    epochs, batch_size, lr, weight_decay, patience, seed + fi, device,
                )
                report.fold_metrics.append(
                    {"fold": fi, "val_auc": rep.val_auc, "val_r2": rep.val_r2}
                )
            # final model trained on everything (standard practice)

        rng = np.random.default_rng(seed)
        perm = rng.permutation(len(Xn))
        n_val = max(int(len(Xn) * val_frac), 1)
        val_idx, tr_idx = perm[:n_val], perm[n_val:]
        self.params, rep = self._train_one(
            Xn[tr_idx], IDX[tr_idx], MASK[tr_idx], y[tr_idx],
            Xn[val_idx], IDX[val_idx], MASK[val_idx], y[val_idx],
            epochs, batch_size, lr, weight_decay, patience, seed, device,
        )
        self._np_cache = None
        if calibrate and len(val_idx) >= 20:
            self.calibration = (1.0, 0.0)
            self.group_calibration = {}
            p_val = self.predict_features(
                X[val_idx],
                texts=[texts[i] for i in val_idx] if texts is not None else None,
            )
            y_val = y[val_idx]

            def _cal(p: np.ndarray, ab: tuple[float, float]) -> np.ndarray:
                a, b = ab
                logit = np.log(np.clip(p, 1e-7, 1 - 1e-7)
                               / np.clip(1 - p, 1e-7, 1))
                return 1.0 / (1.0 + np.exp(-(a * logit + b)))

            # Pooled Platt, kept only when it reduces ECE on the validation
            # slice it was fit on — a fit that cannot even help in-sample
            # (small n, ECE-vs-NLL mismatch) would only distort the DP.
            pooled = _fit_platt(p_val, y_val)
            if _ece(y_val, _cal(p_val, pooled)) <= _ece(y_val, p_val):
                self.calibration = pooled
            # Per-(stage, draftless) calibration: each group picks the best
            # of {identity, pooled, its own Platt fit} by validation ECE, so
            # calibration can only improve per-tier reliability — the
            # quantity the DP routes on. Reliability/ECE per group goes into
            # the report.
            groups = self._groups_of(X[val_idx])
            for key in sorted({tuple(g) for g in groups}):
                m = (groups[:, 0] == key[0]) & (groups[:, 1] == key[1])
                n_pos = int((y_val[m] > 0.5).sum())
                n_neg = int(m.sum()) - n_pos
                row = {"stage": int(key[0]), "draftless": int(key[1]),
                       "n": int(m.sum()),
                       "ece_before": _ece(y_val[m], p_val[m])}
                candidates = [("identity", (1.0, 0.0)),
                              ("pooled", self.calibration)]
                if m.sum() >= 20 and n_pos >= 3 and n_neg >= 3:
                    candidates.append(("group", _fit_platt(p_val[m], y_val[m])))
                chosen, (a, b) = min(
                    candidates,
                    key=lambda c: _ece(y_val[m], _cal(p_val[m], c[1])),
                )
                if (a, b) != self.calibration:
                    self.group_calibration[(int(key[0]), int(key[1]))] = (a, b)
                row.update({"a": round(float(a), 4), "b": round(float(b), 4),
                            "chosen": chosen,
                            "ece_after": _ece(y_val[m], _cal(p_val[m], (a, b)))})
                rep.calibration_report.append(row)
        rep.fold_metrics = report.fold_metrics
        rep.train_time_s = time.perf_counter() - t_start
        return rep

    def _train_one(
        self, Xtr, Itr, Mtr, ytr, Xval, Ival, Mval, yval,
        epochs, batch_size, lr, weight_decay, patience, seed, device,
    ):
        """One training run on ``device``, step for step the JAX class's
        optax chain: ``clip_by_global_norm(1.0)`` (``g / |g|`` where
        ``|g| >= 1``, no epsilon) then ``adamw`` (every leaf decays, the
        embedding table and biases too), the cosine-decayed rate of update t
        applied at update t (the first takes the full ``lr``). Batches come
        from the same numpy permutation and drop the last partial batch."""
        init = _init_mlp(
            torch.Generator().manual_seed(seed),
            [self.feature_dim + self.embed_dim, *self.hidden, 1],
            self.embed_dim,
        )
        params = _map_params(init, lambda t: t.to(device).requires_grad_())
        leaves = _leaves(params)
        steps_per_epoch = max(len(Xtr) // batch_size, 1)
        decay_steps = epochs * steps_per_epoch
        opt = torch.optim.AdamW(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay)
        use_embed = self.embed_dim > 0

        def fwd(p, xb, ib, mb):
            if use_embed:
                return mlp_forward_embed(p, xb, ib, mb)
            return mlp_forward(p, xb)

        def loss_fn(p, xb, ib, mb, yb):
            pred = fwd(p, xb, ib, mb).clamp(1e-7, 1 - 1e-7)
            return -torch.mean(yb * torch.log(pred) + (1 - yb) * torch.log(1 - pred))

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        train = (put(Xtr), put(Itr).long(), put(Mtr), put(ytr))
        val = (put(Xval), put(Ival).long(), put(Mval), put(yval))
        rep = TrainReport()
        best_val = np.inf
        best_params = _map_params(params, lambda t: t.detach().clone())
        bad = 0
        update = 0
        rng = np.random.default_rng(seed)
        for epoch in range(epochs):
            order = put(rng.permutation(len(Xtr)))
            losses = []
            for i in range(steps_per_epoch):
                sl = order[i * batch_size : (i + 1) * batch_size]
                loss = loss_fn(params, *(t[sl] for t in train))
                opt.zero_grad()
                loss.backward()
                with torch.no_grad():
                    grads = [t.grad for t in leaves]
                    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
                    keep = norm < 1.0
                    for g in grads:
                        g.copy_(torch.where(keep, g, g / norm))
                for group in opt.param_groups:
                    group["lr"] = lr * 0.5 * (
                        1.0 + math.cos(math.pi * min(update, decay_steps) / decay_steps))
                opt.step()
                update += 1
                losses.append(loss.detach())
            with torch.no_grad():
                vl = float(loss_fn(params, *val))
            # the host sums the f32 step losses in f64, as the JAX loop does
            rep.train_losses.append(sum(torch.stack(losses).tolist()) / steps_per_epoch)
            rep.val_losses.append(vl)
            if vl < best_val - 1e-5:
                best_val, bad = vl, 0
                best_params = _map_params(params, lambda t: t.detach().clone())
                rep.best_epoch = epoch
            else:
                bad += 1
                if bad >= patience:
                    break
        rep.epochs_run = len(rep.train_losses)

        with torch.no_grad():
            pv = fwd(best_params, *val[:3]).cpu().numpy()
        rep.val_auc = _auc(yval, pv)
        ss_res = float(np.sum((yval - pv) ** 2))
        ss_tot = float(np.sum((yval - yval.mean()) ** 2)) or 1e-12
        rep.val_r2 = 1.0 - ss_res / ss_tot
        return best_params, rep

    # -- persistence ---------------------------------------------------------
    def save(self, path: str) -> None:
        p = pathlib.Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        flat = {}
        for i, (w, b) in enumerate(zip(self.params["w"], self.params["b"])):
            flat[f"w{i}"] = _np32(w)
            flat[f"b{i}"] = _np32(b)
        if "emb" in self.params:
            flat["emb"] = _np32(self.params["emb"])
        if self.group_calibration:
            keys = sorted(self.group_calibration)
            flat["cal_groups"] = np.asarray(keys, np.int64)
            flat["cal_ab"] = np.asarray(
                [self.group_calibration[k] for k in keys], np.float64
            )
        np.savez(
            p,
            mean=self.mean,
            std=self.std,
            calibration=np.asarray(self.calibration),
            meta=json.dumps(
                {
                    "feature_dim": self.feature_dim,
                    "hidden": list(self.hidden),
                    "n_stages": self.n_stages,
                    "n_layers": len(self.params["w"]),
                    "embed_dim": self.embed_dim,
                }
            ),
            **flat,
        )

    @classmethod
    def load(cls, path: str) -> "MLPQualityPredictor":
        data = np.load(path, allow_pickle=False)
        meta = json.loads(str(data["meta"]))
        self = cls(meta["feature_dim"], meta["hidden"], meta["n_stages"],
                   embed_dim=meta.get("embed_dim", 0))
        self.params = {
            "w": [_t32(data[f"w{i}"]) for i in range(meta["n_layers"])],
            "b": [_t32(data[f"b{i}"]) for i in range(meta["n_layers"])],
        }
        if "emb" in data:
            self.params["emb"] = _t32(data["emb"])
        self.mean = data["mean"]
        self.std = data["std"]
        self.calibration = tuple(float(v) for v in data["calibration"])
        if "cal_groups" in data:
            self.group_calibration = {
                (int(g[0]), int(g[1])): (float(ab[0]), float(ab[1]))
                for g, ab in zip(data["cal_groups"], data["cal_ab"])
            }
        return self



def _map_params(params: Params, fn) -> Params:
    return {k: ([fn(t) for t in v] if isinstance(v, list) else fn(v)) for k, v in params.items()}


def _leaves(params: Params) -> list:
    return [t for v in params.values() for t in (v if isinstance(v, list) else [v])]


def _ece(y: np.ndarray, p: np.ndarray, n_bins: int = 10) -> float:
    """Expected calibration error: confidence-binned |accuracy - confidence|
    weighted by bin mass (standard 10-bin ECE)."""
    y = np.asarray(y, np.float64)
    p = np.asarray(p, np.float64)
    if len(p) == 0:
        return 0.0
    bins = np.clip((p * n_bins).astype(int), 0, n_bins - 1)
    ece = 0.0
    for b in range(n_bins):
        m = bins == b
        if m.any():
            ece += m.mean() * abs(float(y[m].mean()) - float(p[m].mean()))
    return round(float(ece), 4)


def _fit_platt(p: np.ndarray, y: np.ndarray, iters: int = 50) -> tuple[float, float]:
    """Fit sigmoid(a * logit(p) + b) to binary labels by Newton's method
    (2-parameter logistic regression — Platt scaling). Targets use the
    standard (n+ + 1)/(n+ + 2), 1/(n- + 2) smoothing to avoid overconfident
    endpoints."""
    p = np.clip(np.asarray(p, np.float64), 1e-7, 1 - 1e-7)
    y = np.asarray(y, np.float64) > 0.5
    z = np.log(p / (1 - p))
    n_pos, n_neg = y.sum(), (~y).sum()
    t = np.where(y, (n_pos + 1.0) / (n_pos + 2.0), 1.0 / (n_neg + 2.0))
    def nll(a_, b_):
        s = np.clip(a_ * z + b_, -35, 35)
        q = 1.0 / (1.0 + np.exp(-s))
        q = np.clip(q, 1e-12, 1 - 1e-12)
        return -np.sum(t * np.log(q) + (1 - t) * np.log(1 - q))

    a, b = 1.0, 0.0
    loss = nll(a, b)
    for _ in range(iters):
        s = np.clip(a * z + b, -35, 35)
        q = 1.0 / (1.0 + np.exp(-s))
        g = np.array([np.sum((q - t) * z), np.sum(q - t)])
        w = q * (1 - q)
        h = np.array([[np.sum(w * z * z) + 1e-9, np.sum(w * z)],
                      [np.sum(w * z), np.sum(w) + 1e-9]])
        step = np.linalg.solve(h, g)
        # damped Newton: backtrack until the NLL decreases (a plain step
        # diverges when the start is far from the optimum)
        scale = 1.0
        for _ in range(30):
            na, nb = a - scale * step[0], b - scale * step[1]
            new_loss = nll(na, nb)
            if new_loss <= loss:
                break
            scale *= 0.5
        else:
            break
        a, b, loss = na, nb, new_loss
        if scale * np.abs(step).max() < 1e-8:
            break
    if not (np.isfinite(a) and np.isfinite(b)) or a <= 0:
        return (1.0, 0.0)  # degenerate fit: keep identity
    return (float(a), float(b))


def _auc(y: np.ndarray, p: np.ndarray) -> float:
    """Rank-based AUC without sklearn (ties handled by average rank)."""
    y = np.asarray(y) > 0.5
    n_pos, n_neg = int(y.sum()), int((~y).sum())
    if n_pos == 0 or n_neg == 0:
        return 0.5
    order = np.argsort(p, kind="mergesort")
    ranks = np.empty(len(p), np.float64)
    sorted_p = p[order]
    i = 0
    r = np.arange(1, len(p) + 1, dtype=np.float64)
    while i < len(p):
        j = i
        while j + 1 < len(p) and sorted_p[j + 1] == sorted_p[i]:
            j += 1
        ranks[order[i : j + 1]] = r[i : j + 1].mean()
        i = j + 1
    return float((ranks[y].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def predictor_from_jax(
    params,
    mean,
    std,
    calibration=(1.0, 0.0),
    group_calibration=None,
    *,
    hidden: Optional[Sequence[int]] = None,
    n_stages: int = 4,
) -> MLPQualityPredictor:
    """Build a predictor from numpy copies of a JAX predictor's state:
    ``params`` = {"w": [...], "b": [...], optional "emb"}, ``mean``/``std``
    [feature_dim], ``calibration`` (a, b), ``group_calibration``
    {(stage, draftless): (a, b)}."""
    ws = [_t32(w) for w in params["w"]]
    embed_dim = int(np.asarray(params["emb"]).shape[1]) if "emb" in params else 0
    feature_dim = ws[0].shape[0] - embed_dim
    hidden = tuple(hidden) if hidden is not None else tuple(int(w.shape[1]) for w in ws[:-1])
    self = MLPQualityPredictor(feature_dim, hidden, n_stages, embed_dim=embed_dim)
    self.params = {"w": ws, "b": [_t32(b) for b in params["b"]]}
    if embed_dim:
        self.params["emb"] = _t32(params["emb"])
    self.mean = np.asarray(mean, np.float32)
    self.std = np.asarray(std, np.float32)
    self.calibration = (float(calibration[0]), float(calibration[1]))
    self.group_calibration = {
        (int(k[0]), int(k[1])): (float(v[0]), float(v[1]))
        for k, v in (group_calibration or {}).items()
    }
    return self
