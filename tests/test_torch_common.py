"""Shared set-up of the port's pipeline parity tests (no tests here): the
same tiny random tiers in the JAX package and in the port, weights handed
over byte for byte, behind text stages; a host predictor and an inline head
made from the same seeded numpy arrays."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from adaptive_sd_tpu.cascade import AdaptiveCascadePipeline as JPipeline
from adaptive_sd_tpu.cascade import EngineTextStage as JStage
from adaptive_sd_tpu.cascade import PipelineConfig as JConfig
from adaptive_sd_tpu.cascade import StageManager as JManager
from adaptive_sd_tpu.engine import TierEngine as JEngine
from adaptive_sd_tpu.models import TINY as JTINY
from adaptive_sd_tpu.models import qwen as jq
from adaptive_sd_tpu.ops.quant import QuantizedTensor as JQT
from adaptive_sd_tpu.predict import MLPQualityPredictor as JPredictor
from adaptive_sd_tpu.predict import inline as jinline
from adaptive_sd_tpu_torch.cascade import (
    AdaptiveCascadePipeline,
    EngineTextStage,
    PipelineConfig,
    StageManager,
)
from adaptive_sd_tpu_torch.engine import TierEngine
from adaptive_sd_tpu_torch.models import TINY, params_from_jax
from adaptive_sd_tpu_torch.predict import inline as tinline
from adaptive_sd_tpu_torch.predict import predictor_from_jax

torch.set_num_threads(2)

COSTS = (1.0, 2.0, 4.0)          # per-tier cost; cumulative 1, 3, 7
PRIORS = [0.6, 0.8, 0.95]
MAX_NEW = 8
PROMPTS = ["What is 2 + 2?", "Rigorously prove the optimal bound, step by step.",
           "def fib(n):", "Name the capital of France and explain why it matters."]


def tok(text):
    return [(ord(c) % 250) + 1 for c in text[:40]] or [1]


def detok(ids):
    return " ".join(str(int(i)) for i in ids)


def plain(x):
    """Dataclasses of either package as dicts (recursively), so that equal
    fields compare equal across the two packages' classes."""
    if dataclasses.is_dataclass(x):
        return plain(dataclasses.asdict(x))
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    return x


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_numpy(v) for v in tree]
    if isinstance(tree, JQT):
        return (np.asarray(tree.q), np.asarray(tree.scale), tree.bits)
    return np.asarray(tree)


def _predictor_arrays(seed, feature_dim, hidden, embed_dim):
    rng = np.random.default_rng(seed)
    sizes = [feature_dim + embed_dim, *hidden, 1]
    params = {"w": [rng.normal(size=(a, b)).astype(np.float32) * np.sqrt(2.0 / a)
                    for a, b in zip(sizes[:-1], sizes[1:])],
              "b": [rng.normal(size=(b,)).astype(np.float32) * 0.1 for b in sizes[1:]]}
    if embed_dim:
        params["emb"] = rng.normal(size=(4096, embed_dim)).astype(np.float32) * 0.1
    mean = rng.normal(size=feature_dim).astype(np.float32) * 0.1
    std = rng.uniform(0.5, 2.0, size=feature_dim).astype(np.float32)
    return params, mean, std


def _jax_predictor(params, mean, std, feature_dim, hidden, embed_dim):
    jp = JPredictor(feature_dim=feature_dim, hidden=hidden, n_stages=4, embed_dim=embed_dim)
    jp.params = {k: ([jnp.asarray(a) for a in v] if isinstance(v, list) else jnp.asarray(v))
                 for k, v in params.items()}
    jp.mean, jp.std = mean, std
    jp.calibration = (1.2, 0.1)
    jp.group_calibration = {(1, 0): (0.9, -0.2)}
    return jp


def predictor_pair(seed=0, feature_dim=64, hidden=(32, 16), embed_dim=8):
    """The same host predictor in both packages, from one set of seeded numpy
    arrays (calibration and one group calibration included)."""
    arrays = _predictor_arrays(seed, feature_dim, hidden, embed_dim)
    jpred = _jax_predictor(*arrays, feature_dim, hidden, embed_dim)
    tpred = predictor_from_jax(arrays[0], arrays[1], arrays[2], jpred.calibration,
                               jpred.group_calibration, n_stages=4)
    return jpred, tpred


def build_world(n_tiers=3):
    """``n_tiers`` tiny tiers (INT8, then grouped INT4) in both packages from
    the same bytes, a host predictor and an inline head from the same numpy
    arrays."""
    from adaptive_sd_tpu.predict.embed import EMBED_VOCAB

    assert EMBED_VOCAB == 4096
    jengines, tengines = [], []
    for i, bits in enumerate((8, 4, 4)[:n_tiers]):
        raw = jq.fuse_projections(jq.init_params(JTINY, jax.random.key(10 + i),
                                                 dtype=jnp.float32))
        jp = jq.quantize_model(raw, bits=bits, group_size=32)
        tp = params_from_jax(_to_numpy(jp), device="cpu")
        kw = dict(page_size=16, n_pages=128, enable_prefix_cache=i > 0)
        jengines.append(JEngine(JTINY, jp, use_pallas=False, **kw))
        tengines.append(TierEngine(TINY, tp, device="cpu", **kw))
    assert tengines[1].params["layers"][0]["qkv_proj"].bits == 4
    assert tengines[1].params["layers"][0]["qkv_proj"].scale.ndim == 2

    jpred, tpred = predictor_pair()
    inl = _predictor_arrays(1, 16, (64, 32), 0)
    jinl = _jax_predictor(*inl, 16, (64, 32), 0)
    jinl.calibration, jinl.group_calibration = (1.0, 0.0), {}
    tinl = predictor_from_jax(inl[0], inl[1], inl[2], n_stages=4)
    return jengines, tengines, jpred, tpred, jinl, tinl


def pipelines(world, inline_lam=None, **cfg):
    jengines, tengines, jpred, tpred, jinl, tinl = world
    n = len(jengines)
    cum = np.cumsum(COSTS[:n]).tolist()
    jpol = tpol = None
    if inline_lam is not None:
        jpol = jinline.policy_from_predictor(jinl, cum, PRIORS[:n], inline_lam)
        tpol = tinline.policy_from_predictor(tinl, cum, PRIORS[:n], inline_lam)
    jst = [JStage(e, tok, detok, name=f"t{i}", cost_per_token=COSTS[i], stage_index=i,
                  inline_policy=jpol if i == 0 else None) for i, e in enumerate(jengines)]
    tst = [EngineTextStage(e, tok, detok, name=f"t{i}", cost_per_token=COSTS[i],
                           stage_index=i, inline_policy=tpol if i == 0 else None)
           for i, e in enumerate(tengines)]
    cfg = dict(max_new_tokens=MAX_NEW, prior_quality=tuple(PRIORS[:n]), **cfg)
    return (JPipeline(JManager(jst), jpred, JConfig(**cfg)),
            AdaptiveCascadePipeline(StageManager(tst), tpred, PipelineConfig(**cfg)))


def same_result(j, t):
    assert t.error is None and j.error is None, (j.error, t.error)
    assert t.final_stage == j.final_stage and t.final_stage_name == j.final_stage_name
    assert [s.stage_index for s in t.stage_results] == [s.stage_index for s in j.stage_results]
    assert [s.accepted for s in t.stage_results] == [s.accepted for s in j.stage_results]
    assert t.total_cost == j.total_cost and t.text == j.text
    for a, b in zip(j.stage_results, t.stage_results):
        np.testing.assert_array_equal(b.output.token_ids, a.output.token_ids)
        # f32 log-softmax of logits that differ only by sum order
        np.testing.assert_allclose(b.output.logprobs, a.output.logprobs, atol=1e-3)
        assert b.output.finish_reason == a.output.finish_reason
    # the predictor sees logprobs equal to ~1e-3, so probabilities agree to ~1e-3
    np.testing.assert_allclose(t.decision.acceptance_probs, j.decision.acceptance_probs,
                               atol=5e-3)
    np.testing.assert_allclose(t.decision.adjusted_probs, j.decision.adjusted_probs, atol=5e-3)
    assert t.decision.selected_stage == j.decision.selected_stage
    assert t.decision.rationale == j.decision.rationale


def tiny_weights(seed=0, spec=JTINY):
    """Random fused INT8 weights at TINY size: (JAX params, the same bytes as
    the port's params on the CPU)."""
    jp = jq.init_params_quantized(spec, jax.random.key(seed), dtype=jnp.float32)
    return jp, params_from_jax(_to_numpy(jp), device="cpu")


def engine_pair(weights, *, n_pages=64, page=16, **kw):
    """A JAX TierEngine (plain reference path) and the port's, on the CPU,
    over the same weights and the same cache geometry."""
    jp, tp = weights
    je = JEngine(JTINY, jp, use_pallas=False, page_size=page, n_pages=n_pages, **kw)
    te = TierEngine(TINY, tp, device="cpu", page_size=page, n_pages=n_pages, **kw)
    return je, te
