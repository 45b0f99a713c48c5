"""The PyTorch port's TierEngine against the JAX TierEngine
(``use_pallas=False``) on the same weights: greedy ``generate`` and
``verify_continue`` give identical tokens and acceptance counts, with and
without the automatic prefix cache. Plus the stochastic paths' contracts and
the text stages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_sd_tpu.engine import TierEngine as JEngine
from adaptive_sd_tpu.models import TINY as JTINY
from adaptive_sd_tpu.models import TINY128 as JTINY128
from adaptive_sd_tpu.models import qwen as jq
from adaptive_sd_tpu.ops.quant import QuantizedTensor as JQT
from adaptive_sd_tpu_torch.cascade import EngineTextStage, StageManager
from adaptive_sd_tpu_torch.engine import TierEngine
from adaptive_sd_tpu_torch.models import TINY, TINY128, params_from_jax

torch.set_num_threads(2)

PAGE = 16
# greedy logprobs: f32 log-softmax of logits that differ only by sum order,
# which now and then moves an INT8 KV value across a rounding boundary
LP_ATOL = 1e-3


def jax_to_numpy(tree):
    """The JAX params pytree as numpy, QuantizedTensor -> (q, scale, bits)."""
    if isinstance(tree, dict):
        return {k: jax_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [jax_to_numpy(v) for v in tree]
    if isinstance(tree, JQT):
        return (np.asarray(tree.q), np.asarray(tree.scale), tree.bits)
    return np.asarray(tree)


@pytest.fixture(scope="module")
def tiny():
    jp = jq.init_params_quantized(JTINY, jax.random.key(0), dtype=jnp.float32)
    return jp, params_from_jax(jax_to_numpy(jp), device="cpu")


def _prompts(seed, lens, vocab):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, vocab, n)] for n in lens]


def _same(jouts, touts):
    for j, t in zip(jouts, touts):
        np.testing.assert_array_equal(t.token_ids, j.token_ids)
        np.testing.assert_allclose(t.logprobs, j.logprobs, atol=LP_ATOL)


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_greedy_generate_and_verify_match_jax(tiny, prefix_cache):
    jp, tp = tiny
    kw = dict(page_size=PAGE, n_pages=64, enable_prefix_cache=prefix_cache)
    je = JEngine(JTINY, jp, use_pallas=False, **kw)
    te = TierEngine(TINY, tp, device="cpu", **kw)
    prompts = _prompts(0, (5, 17, 40), JTINY.vocab_size)  # 3 requests -> one padding lane

    jg, tg = je.generate(prompts, max_new=12), te.generate(prompts, max_new=12)
    _same(jg, tg)
    assert all(t.num_tokens == 12 for t in tg)

    # drafts: a prefix this tier agrees with, then tokens it may reject
    drafts = [list(o.token_ids[:6]) + [3, 4, 5] for o in jg]
    for _ in range(2):  # the second round hits the prefix cache when it is on
        jv = je.verify_continue(prompts, drafts, max_new=12)
        tv = te.verify_continue(prompts, drafts, max_new=12)
        assert [n for _, n in tv] == [n for _, n in jv]
        _same([o for o, _ in jv], [o for o, _ in tv])
    if prefix_cache:
        assert te.prefix_cache.stats()["hits"] == je.prefix_cache.stats()["hits"] > 0


def test_budget_below_bucket_and_self_verify(tiny):
    """max_new 5 pads to the 32 bucket in both packages; a tier verifying
    its own greedy output accepts all of it."""
    jp, tp = tiny
    je = JEngine(JTINY, jp, page_size=PAGE, n_pages=64, use_pallas=False)
    te = TierEngine(TINY, tp, page_size=PAGE, n_pages=64, device="cpu")
    prompts = _prompts(1, (9, 33), JTINY.vocab_size)
    jg, tg = je.generate(prompts, max_new=5), te.generate(prompts, max_new=5)
    _same(jg, tg)
    tv = te.verify_continue(prompts, [o.token_ids.tolist() for o in tg], max_new=5)
    assert [n for _, n in tv] == [5, 5]
    assert [o.token_ids.tolist() for o, _ in tv] == [o.token_ids.tolist() for o in tg]


def test_tiny128_prefix_cache_matches_jax():
    """head_dim 128 (the real models' head width), prompts longer than a page."""
    jp = jq.init_params_quantized(JTINY128, jax.random.key(5), dtype=jnp.float32)
    tp = params_from_jax(jax_to_numpy(jp), device="cpu")
    kw = dict(page_size=PAGE, n_pages=64, enable_prefix_cache=True)
    je = JEngine(JTINY128, jp, use_pallas=False, **kw)
    te = TierEngine(TINY128, tp, device="cpu", **kw)
    prompts = _prompts(2, (20, 35), JTINY128.vocab_size)
    drafts = [o.token_ids.tolist() for o in je.generate(prompts, max_new=8)]
    _same(je.generate(prompts, max_new=8), te.generate(prompts, max_new=8))
    jv = je.verify_continue(prompts, drafts, max_new=8)
    tv = te.verify_continue(prompts, drafts, max_new=8)
    assert [n for _, n in tv] == [n for _, n in jv] == [8, 8]
    _same([o for o, _ in jv], [o for o, _ in tv])


def test_stochastic_paths(tiny):
    _, tp = tiny
    te = TierEngine(TINY, tp, page_size=PAGE, n_pages=64, device="cpu")
    prompts = _prompts(3, (7, 21), TINY.vocab_size)
    outs = te.generate(prompts, max_new=10, temperature=0.8, top_p=0.9, seed=4, return_topk=6)
    for o in outs:
        assert o.num_tokens == 10 and o.topk_ids.shape == (10, 6)
        assert np.all(o.logprobs <= 0) and np.all(o.topk_probs[:, 0] >= o.topk_probs[:, -1])
        assert np.all((o.token_ids >= 0) & (o.token_ids < TINY.vocab_size))
    again = te.generate(prompts, max_new=10, temperature=0.8, top_p=0.9, seed=4, return_topk=6)
    assert [o.token_ids.tolist() for o in again] == [o.token_ids.tolist() for o in outs]
    draft_q = [(o.logprobs, o.topk_ids, o.topk_probs) for o in outs]
    ver = te.verify_continue(prompts, [o.token_ids for o in outs], max_new=10,
                             temperature=0.8, top_p=0.9, draft_q=draft_q, return_topk=6)
    for (o, n_acc) in ver:
        assert 0 <= n_acc <= 10 and o.num_tokens == 10 and o.topk_ids.shape == (10, 6)


def test_text_stages(tiny):
    _, tp = tiny
    te = TierEngine(TINY, tp, page_size=PAGE, n_pages=64, device="cpu",
                    enable_prefix_cache=True)
    tok = lambda s: [1 + (ord(c) % 250) for c in s]  # noqa: E731
    detok = lambda ids: " ".join(str(i) for i in ids)  # noqa: E731
    stage = EngineTextStage(te, tok, detok, name="t0", cost_per_token=1.0)
    prompts = ["hello world, a prompt longer than one page", "short"]
    outs = stage.generate_text(prompts, max_new=6)
    assert [o.num_generated_tokens for o in outs] == [6, 6]
    ver = stage.verify_continue_text(prompts, [o.token_ids for o in outs], max_new=6)
    assert [o.finish_reason for o in ver] == ["spec_accepted=6"] * 2
    assert [o.token_ids.tolist() for o in ver] == [o.token_ids.tolist() for o in outs]
    mgr = StageManager([stage, EngineTextStage(te, tok, detok, name="t1", cost_per_token=2.0)])
    assert mgr.costs() == [1.0, 3.0] and mgr.get_stage("t1").name == "t1"
    assert mgr.info()[0]["prefix_cache"]["hits"] > 0
