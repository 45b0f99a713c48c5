"""Quality-predictor MLP on tensors (counterpart of
``adaptive_sd_tpu/predict/mlp.py``).

Role parity: reference ``ResearchQualityPredictor`` (torch MLP
128->[256,128,64]->1 sigmoid with batchnorm, scripts/train_predictor.py:57-91)
and the missing ``src/models/predictor.py`` contract (predict(prompt, draft,
logprobs, stage) -> prob, loaded from a checkpoint,
src/serving/server.py:168-176). The forward pass is a plain tensor function,
so the stopping decision can be evaluated on the device right after the
decode loop; the serving hot path predicts on the host in numpy. ``save`` and
``load`` use the JAX class's ``.npz`` layout, so either package reads the
other's files. Training (``fit``) belongs to the training slice of the port
and raises here.
"""

from __future__ import annotations

import json
import pathlib
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.types import PredictionResult
from .embed import EMBED_VOCAB, hash_batch, pool_np
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
    differ from the JAX class's for the same seed; trained or JAX-made
    weights come in through ``load`` / :func:`predictor_from_jax`."""
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
    def fit(self, X, y, **kwargs) -> TrainReport:
        """Training (AdamW + cosine schedule + early stopping + Platt
        calibration in the JAX class) is not ported yet: it comes with the
        training slice of the port. Train with
        ``adaptive_sd_tpu.predict.MLPQualityPredictor.fit``, ``save``, and
        ``load`` the file here."""
        raise NotImplementedError(
            "MLPQualityPredictor.fit waits for the training slice of the port; "
            "load a predictor saved by the JAX class instead"
        )

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
