"""The port's tiny-LM training (``models/tiny_train.py``) against the JAX
package's on the CPU: the corpus rows, ``lm_forward``'s logits and gradients
and ``train_lm``'s per-step losses from the JAX initial weights (handed over
by a monkeypatch of the port's ``init_params``), and a rehearsal tier
trained, saved and loaded in both packages giving the same greedy answers."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_sd_tpu.evalx.datasets import load_frozen as jload_frozen
from adaptive_sd_tpu.models import qwen as jq
from adaptive_sd_tpu.models import tiny_train as jtt
from adaptive_sd_tpu_torch.models import params_from_jax
from adaptive_sd_tpu_torch.models import tiny_train as ttt
from adaptive_sd_tpu_torch.models.config import ModelSpec as TSpec
from tests.test_torch_qwen import jax_to_numpy

torch.set_num_threads(2)

# f32 forward and backward of the same math, sums in another order
LOGIT_ATOL, GRAD_ATOL = 1e-4, 1e-5
# the training losses of the same steps (f32, another sum order)
LOSS_ATOL = 1e-4
# weights after a few AdamW steps: the normalised update m / (sqrt(v) + eps)
# of a near-zero gradient turns sum-order differences into a few per cent of
# one step (lr 3e-3)
PARAM_ATOL = 1e-4

# the rehearsal's first tier (scripts/real_smoke.py): head_dim 48
RECIPE = dict(name="rehearsal-t0", hidden=96, n_layers=2, n_heads=2, ffn=288, steps=140,
              head_dim=48)


def _specs(seq=512):
    j = jtt.TierRecipe(**RECIPE).spec(jtt.CharTokenizer().vocab_size, max_seq_len=seq)
    return j, TSpec(**dataclasses.asdict(j))


@pytest.fixture(scope="module")
def corpus():
    items = jload_frozen("factual-qa")[:24]
    tok = jtt.CharTokenizer()
    return items, jtt.encode_qa(tok, jtt.qa_corpus(items), 96)


def jax_init(spec, seed):
    """JAX's ``train_lm`` initial weights, ``init_params(key(seed))``, as the
    port's params (the port's trainer takes them as ``init``)."""
    p = jq.init_params(spec, jax.random.key(seed), dtype=jnp.float32)
    return params_from_jax(jax_to_numpy(p), device="cpu")


def test_corpus_rows_equal(corpus):
    items, (toks, mask) = corpus
    tok = ttt.CharTokenizer()
    t, m = ttt.encode_qa(tok, ttt.qa_corpus(items), 96)
    np.testing.assert_array_equal(t, toks)
    np.testing.assert_array_equal(m, mask)
    assert ttt.ANSWER_CUE == jtt.ANSWER_CUE and tok.vocab_size == jtt.CharTokenizer().vocab_size
    assert tok.decode(t[0]) == jtt.CharTokenizer().decode(toks[0])


def test_lm_forward_logits_and_grads(corpus):
    _, (toks, mask) = corpus
    js, ts = _specs()
    jp = jq.init_params(js, jax.random.key(3), dtype=jnp.float32)
    tp = params_from_jax(jax_to_numpy(jp), device="cpu")
    x = toks[:3, :-1]  # rows with padding columns

    def jloss(p):
        return jnp.sum(jtt.lm_forward(p, js, jnp.asarray(x)) ** 2) * 1e-3

    jl = jtt.lm_forward(jp, js, jnp.asarray(x))
    jg = jax.grad(jloss)(jp)
    for t in jax.tree_util.tree_leaves(tp):
        t.requires_grad_()
    tl = ttt.lm_forward(tp, ts, torch.from_numpy(x))
    (torch.sum(tl ** 2) * 1e-3).backward()
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), atol=LOGIT_ATOL, rtol=1e-4)
    for name in ("embed", "lm_head"):
        np.testing.assert_allclose(tp[name].grad.numpy(), np.asarray(jg[name]), atol=GRAD_ATOL,
                                   rtol=1e-3)
    for jl_, tl_ in zip(jg["layers"], tp["layers"]):
        for k, v in jl_.items():
            np.testing.assert_allclose(tl_[k].grad.numpy(), np.asarray(v), atol=GRAD_ATOL,
                                       rtol=1e-3, err_msg=k)


def test_lr_schedule_matches_optax():
    import optax

    sched = optax.warmup_cosine_decay_schedule(0.0, 3e-3, 7, 140, 3e-3 * 0.05)
    for c in (0, 1, 6, 7, 8, 70, 139, 140, 200):
        assert ttt.lr_schedule(c, lr=3e-3, warmup=7, steps=140) == pytest.approx(
            float(sched(c)), rel=1e-6, abs=1e-12)


def _jax_train_step_losses(monkeypatch, *args, **kw):
    """JAX ``train_lm`` with every step's loss recorded (it reads only every
    50th): its jitted step is wrapped for the call."""
    seen = []
    real_jit = jax.jit

    def jit(fn):
        compiled = real_jit(fn)

        def step(*a):
            out = compiled(*a)
            seen.append(float(out[-1]))
            return out

        return step

    monkeypatch.setattr(jax, "jit", jit)
    try:
        params, rep = jtt.train_lm(*args, **kw)
    finally:
        monkeypatch.setattr(jax, "jit", real_jit)
    return params, rep, seen


def test_train_lm_losses_match_jax(corpus, monkeypatch):
    """Eight steps from the same initial weights: the first at lr = 0 (only
    Adam's moments move), the warmup and the decay after it."""
    _, (toks, mask) = corpus
    js, ts = _specs()
    kw = dict(steps=8, batch=4, lr=3e-3, seed=1, warmup_frac=0.25)
    jp, jrep, jlosses = _jax_train_step_losses(monkeypatch, js, toks, mask, **kw)
    tp, trep = ttt.train_lm(ts, toks, mask, device="cpu", init=jax_init(js, 1), **kw)
    assert len(jlosses) == 8
    np.testing.assert_allclose(trep["step_losses"], jlosses, atol=LOSS_ATOL, rtol=0)
    assert trep["loss_curve"] == pytest.approx(jrep["loss_curve"], abs=LOSS_ATOL)
    assert trep["steps"] == jrep["steps"] and trep["params"] == jrep["params"]
    np.testing.assert_allclose(tp["embed"].numpy(), np.asarray(jp["embed"]), atol=PARAM_ATOL)
    np.testing.assert_allclose(tp["layers"][1]["down_proj"].numpy(),
                               np.asarray(jp["layers"][1]["down_proj"]), atol=PARAM_ATOL)


def test_trained_tier_saved_and_loaded_answers_equal(corpus, tmp_path):
    """The rehearsal's first tier trained 40 steps in both packages from the
    same weights, written by each package's ``save_checkpoint``, read back by
    its ``load_params`` (INT8) into a TierEngine: the same greedy answers on
    suite items."""
    from adaptive_sd_tpu.engine import TierEngine as JEngine
    from adaptive_sd_tpu.models import loader as jloader
    from adaptive_sd_tpu_torch.engine import TierEngine as TEngine
    from adaptive_sd_tpu_torch.models import loader as tloader

    items, (toks, mask) = corpus
    js, ts = _specs(seq=256)
    kw = dict(steps=40, batch=8, lr=3e-3, seed=0)
    jp, _ = jtt.train_lm(js, toks, mask, **kw)
    tp, _ = ttt.train_lm(ts, toks, mask, device="cpu", init=jax_init(js, 0), **kw)
    jdir = jloader.save_checkpoint(jp, js, str(tmp_path / "jax"))
    tdir = tloader.save_checkpoint(tp, ts, str(tmp_path / "torch"))
    jeng = JEngine(jloader.spec_from_checkpoint(jdir), jloader.load_params(jdir, js, bits=8),
                   n_pages=64, page_size=16, use_pallas=False, eos_id=jtt.CharTokenizer.EOS)
    teng = TEngine(tloader.spec_from_checkpoint(tdir),
                   tloader.load_params(tdir, ts, bits=8, device="cpu"), n_pages=64,
                   page_size=16, device="cpu", eos_id=ttt.CharTokenizer.EOS)
    tok = ttt.CharTokenizer()
    prompts = [[tok.BOS] + tok.encode(it["prompt"] + ttt.ANSWER_CUE)[-80:] for it in items[:4]]
    jout = jeng.generate(prompts, max_new=12, temperature=0.0)
    tout = teng.generate(prompts, max_new=12, temperature=0.0)
    janswers = [tok.decode(o.token_ids) for o in jout]
    tanswers = [tok.decode(o.token_ids) for o in tout]
    assert tanswers == janswers and any(janswers)
