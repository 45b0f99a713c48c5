"""Sampling in the PyTorch port against the JAX package: greedy is exact;
stochastic sampling and the speculative rejection rule are checked in
distribution (the two packages draw different random numbers), in the style
of tests/test_ops.py::TestSpeculativeAccept."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_sd_tpu.ops import sampling as js
from adaptive_sd_tpu_torch.ops import sampling as ts

torch.set_num_threads(2)

# total-variation bound for 60k draws over 16 tokens (sampling noise ~0.01)
TV_MAX = 0.02


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _tv(tokens, p, V):
    hist = np.bincount(np.asarray(tokens), minlength=V) / len(tokens)
    return 0.5 * np.abs(hist - p).sum()


class TestGreedy:
    def test_greedy_exact(self):
        logits = np.random.default_rng(0).normal(size=(6, 50)).astype(np.float32)
        logits[2, 7] = logits[2, 9] = logits[2].max() + 1.0  # tie: first index wins in both
        j = js.greedy_sample(jnp.asarray(logits))
        t = ts.greedy_sample(torch.from_numpy(logits))
        np.testing.assert_array_equal(t.token.numpy(), np.asarray(j.token))
        np.testing.assert_allclose(t.logprob.numpy(), np.asarray(j.logprob), rtol=1e-6, atol=1e-6)

    def test_temperature_zero_is_greedy(self):
        logits = torch.tensor([[0.0, 5.0, 1.0]])
        assert ts.sample(logits, _gen(0), temperature=0.0).token.tolist() == [1]

    @pytest.mark.parametrize("temperature,top_p", [(0.7, 1.0), (1.0, 0.8), (1.3, 0.5)])
    def test_adjusted_logits_match(self, temperature, top_p):
        logits = np.random.default_rng(1).normal(size=(4, 64)).astype(np.float32)
        j = np.asarray(js.adjusted_logits(jnp.asarray(logits), temperature, top_p))
        t = ts.adjusted_logits(torch.from_numpy(logits), temperature, top_p).numpy()
        np.testing.assert_array_equal(np.isinf(t), np.isinf(j))
        np.testing.assert_allclose(t[~np.isinf(t)], j[~np.isinf(j)], rtol=1e-6)


class TestStochastic:
    @pytest.mark.parametrize("top_p", [1.0, 0.7])
    def test_sample_matches_target_distribution(self, top_p):
        V, B = 16, 60000
        logits = np.random.default_rng(2).normal(0, 1.5, V).astype(np.float32)
        target = np.asarray(jax.nn.softmax(js.adjusted_logits(jnp.asarray(logits), 1.0, top_p)))
        res = ts.sample(torch.from_numpy(np.broadcast_to(logits, (B, V)).copy()), _gen(3),
                        temperature=1.0, top_p=top_p)
        assert _tv(res.token.numpy(), target, V) < TV_MAX
        if top_p < 1.0:  # nothing outside the nucleus is ever drawn
            assert target[res.token.numpy()].min() > 0

    def test_sample_with_topk_support(self):
        V, k = 32, 5
        logits = np.random.default_rng(4).normal(size=(3, V)).astype(np.float32)
        _, j_ids, j_probs = js.sample_with_topk(jnp.asarray(logits), jax.random.key(0), k, 0.9)
        res, t_ids, t_probs = ts.sample_with_topk(torch.from_numpy(logits), _gen(0), k, 0.9)
        np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
        np.testing.assert_allclose(t_probs.numpy(), np.asarray(j_probs), rtol=1e-5)
        assert res.token.dtype == torch.int32 and res.token.shape == (3,)


class TestSpeculativeAccept:
    @staticmethod
    def _one_step(p_logits, q_logits, B, seed=0):
        V = p_logits.shape[-1]
        g = _gen(seed)
        q_rows = torch.from_numpy(np.broadcast_to(q_logits, (B, V)).copy())
        res, q_ids, q_probs = ts.sample_with_topk(q_rows, g, V, 1.0)
        draft = res.token[:, None]
        target_logp = torch.log_softmax(
            torch.from_numpy(np.broadcast_to(p_logits, (B, 2, V)).copy()), dim=-1)
        n_acc, nxt, _ = ts.speculative_accept(
            g, draft, res.logprob[:, None], q_ids[:, None, :], q_probs[:, None, :],
            target_logp, torch.ones(B, dtype=torch.int32))
        emitted = torch.where(n_acc >= 1, draft[:, 0], nxt)
        return emitted.numpy(), n_acc.numpy()

    def test_preserves_target_marginal(self):
        V, B = 16, 60000
        rng = np.random.default_rng(3)
        p_logits = rng.normal(0, 1.5, V).astype(np.float32)
        q_logits = rng.normal(0, 1.5, V).astype(np.float32)
        emitted, n_acc = self._one_step(p_logits, q_logits, B)
        p = np.asarray(jax.nn.softmax(jnp.asarray(p_logits)))
        assert _tv(emitted, p, V) < TV_MAX
        assert 0.05 < n_acc.mean() < 1.0

    def test_acceptance_rate_matches_jax(self):
        """Mean acceptance of one step is sum_x min(p, q) in both packages."""
        V, B = 16, 60000
        rng = np.random.default_rng(5)
        p_logits = rng.normal(0, 1.5, V).astype(np.float32)
        q_logits = rng.normal(0, 1.5, V).astype(np.float32)
        _, n_acc = self._one_step(p_logits, q_logits, B, seed=1)
        expect = np.minimum(np.asarray(jax.nn.softmax(jnp.asarray(p_logits))),
                            np.asarray(jax.nn.softmax(jnp.asarray(q_logits)))).sum()
        assert abs(n_acc.mean() - expect) < 0.01

    def test_identical_distributions_accept_everything(self):
        V, B, D = 8, 512, 4
        rng = np.random.default_rng(4)
        logp = torch.log_softmax(torch.from_numpy(rng.normal(0, 1, V).astype(np.float32)), -1)
        draft = torch.from_numpy(rng.integers(0, V, (B, D)).astype(np.int32))
        draft_lp = logp[draft.long()]
        q_ids = torch.arange(V, dtype=torch.int32).expand(B, D, V)
        q_probs = logp.exp().expand(B, D, V)
        n_acc, _, _ = ts.speculative_accept(_gen(1), draft, draft_lp, q_ids, q_probs,
                                            logp.expand(B, D + 1, V),
                                            torch.full((B,), D, dtype=torch.int32))
        assert (n_acc == D).all()

    def test_impossible_draft_always_rejected(self):
        V, B = 8, 256
        p_logits = torch.tensor([-40.0] + [1.0] * (V - 1))
        target_logp = torch.log_softmax(p_logits, -1).expand(B, 2, V)
        q_probs = torch.zeros(B, 1, V)
        q_probs[:, :, 0], q_probs[:, :, 1] = 0.9, 0.1
        n_acc, nxt, _ = ts.speculative_accept(
            _gen(2), torch.zeros(B, 1, dtype=torch.int32), torch.full((B, 1), np.log(0.9)),
            torch.arange(V, dtype=torch.int32).expand(B, 1, V), q_probs, target_logp,
            torch.ones(B, dtype=torch.int32))
        assert (n_acc == 0).all() and (nxt != 0).all()

    def test_draft_len_bounds_acceptance(self):
        V, B, D = 8, 64, 6
        logp = torch.log_softmax(torch.zeros(V), -1)
        lens = torch.from_numpy((np.arange(B) % (D + 1)).astype(np.int32))
        n_acc, _, _ = ts.speculative_accept(
            _gen(3), torch.zeros(B, D, dtype=torch.int32), logp[0].expand(B, D),
            torch.arange(V, dtype=torch.int32).expand(B, D, V), logp.exp().expand(B, D, V),
            logp.expand(B, D + 1, V), lens)
        np.testing.assert_array_equal(n_acc.numpy(), lens.numpy())


class TestRowVariants:
    """The per-row (lane) variants the continuous-batching scheduler uses."""

    TEMPS = np.array([0.0, 0.7, 1.0, 1.3, 0.0], np.float32)
    TOP_PS = np.array([1.0, 1.0, 0.8, 0.5, 0.3], np.float32)

    @pytest.mark.parametrize("ndim", [2, 3])
    @pytest.mark.parametrize("with_top_p", [False, True])
    def test_row_adjusted_logits_match(self, ndim, with_top_p):
        shape = (5, 64) if ndim == 2 else (5, 3, 64)
        logits = np.random.default_rng(4).normal(size=shape).astype(np.float32)
        jtp = jnp.asarray(self.TOP_PS) if with_top_p else None
        ttp = torch.from_numpy(self.TOP_PS) if with_top_p else None
        j = np.asarray(js.row_adjusted_logits(jnp.asarray(logits), jnp.asarray(self.TEMPS), jtp))
        t = ts.row_adjusted_logits(torch.from_numpy(logits), torch.from_numpy(self.TEMPS),
                                   ttp).numpy()
        np.testing.assert_array_equal(np.isinf(t), np.isinf(j))
        np.testing.assert_allclose(t[~np.isinf(t)], j[~np.isinf(j)], rtol=1e-6)
        # greedy rows pass through unscaled and unfiltered
        np.testing.assert_array_equal(t[0], logits[0])
        np.testing.assert_array_equal(t[4], logits[4])

    def test_sample_rows_greedy_rows_exact_and_sampled_rows_in_support(self):
        logits = np.random.default_rng(5).normal(0, 2.0, (5, 64)).astype(np.float32)
        j = js.sample_rows(jnp.asarray(logits), jax.random.key(0), jnp.asarray(self.TEMPS),
                           jnp.asarray(self.TOP_PS))
        t = ts.sample_rows(torch.from_numpy(logits), _gen(0), torch.from_numpy(self.TEMPS),
                           torch.from_numpy(self.TOP_PS))
        assert t.token.dtype == torch.int32
        for row in (0, 4):  # temperature 0: argmax, log-softmax of the raw logits
            assert int(t.token[row]) == int(j.token[row]) == int(logits[row].argmax())
            np.testing.assert_allclose(float(t.logprob[row]), float(j.logprob[row]), rtol=1e-6)
        adj = ts.row_adjusted_logits(torch.from_numpy(logits), torch.from_numpy(self.TEMPS),
                                     torch.from_numpy(self.TOP_PS))
        for row in (1, 2, 3):  # drawn from the row's own nucleus, scored under it
            assert torch.isfinite(adj[row, int(t.token[row])])
            want = torch.log_softmax(adj[row], -1)[int(t.token[row])]
            np.testing.assert_allclose(float(t.logprob[row]), float(want), rtol=1e-6)

    def test_tiny_top_p_row_is_greedy(self):
        logits = np.random.default_rng(6).normal(size=(3, 32)).astype(np.float32)
        temps = torch.tensor([1.0, 0.9, 1.5])
        t = ts.sample_rows(torch.from_numpy(logits), _gen(1), temps, torch.full((3,), 1e-6))
        assert t.token.tolist() == logits.argmax(-1).tolist()
        np.testing.assert_allclose(t.logprob.numpy(), 0.0, atol=1e-6)

    def test_sample_rows_distribution_per_row(self):
        """Two rows with different temperature and top_p, 30k draws each: every
        row follows its own adjusted distribution (JAX's, computed exactly)."""
        V, n = 16, 30000
        base = np.random.default_rng(7).normal(0, 1.5, V).astype(np.float32)
        temps = np.repeat(np.array([0.7, 1.2], np.float32), n)
        tps = np.repeat(np.array([1.0, 0.6], np.float32), n)
        res = ts.sample_rows(torch.from_numpy(np.broadcast_to(base, (2 * n, V)).copy()), _gen(8),
                             torch.from_numpy(temps), torch.from_numpy(tps))
        toks = res.token.numpy()
        for i, (T, p) in enumerate([(0.7, 1.0), (1.2, 0.6)]):
            target = np.asarray(jax.nn.softmax(js.adjusted_logits(jnp.asarray(base), T, p)))
            assert _tv(toks[i * n:(i + 1) * n], target, V) < TV_MAX

    def test_sample_rows_with_topk_support_matches(self):
        logits = np.random.default_rng(9).normal(size=(5, 64)).astype(np.float32)
        _, jids, jprobs = js.sample_rows_with_topk(
            jnp.asarray(logits), jax.random.key(1), jnp.asarray(self.TEMPS), 6,
            jnp.asarray(self.TOP_PS))
        res, tids, tprobs = ts.sample_rows_with_topk(
            torch.from_numpy(logits), _gen(2), torch.from_numpy(self.TEMPS), 6,
            torch.from_numpy(self.TOP_PS))
        assert tids.dtype == torch.int32 and tids.shape == (5, 6)
        np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs), rtol=1e-5, atol=1e-7)
        # ids agree wherever the probability is not zero (zeros tie in any order)
        live = np.asarray(jprobs) > 0
        np.testing.assert_array_equal(tids.numpy()[live], np.asarray(jids)[live])
        assert ts.sample_rows_with_topk(torch.from_numpy(logits), _gen(2),
                                        torch.from_numpy(self.TEMPS), 0)[1] is None

    @pytest.mark.parametrize("length", [0, 3, 8])
    def test_logprob_stats_match(self, length):
        lps = -np.abs(np.random.default_rng(10).normal(1.5, 1.5, 8)).astype(np.float32)
        j = js.logprob_stats(jnp.asarray(lps), jnp.asarray(length))
        t = ts.logprob_stats(torch.from_numpy(lps), torch.tensor(length))
        assert set(t) == set(j) == {"mean", "std", "min", "frac_low_conf"}
        for k in j:
            np.testing.assert_allclose(float(t[k]), float(j[k]), rtol=1e-6, atol=1e-7)
