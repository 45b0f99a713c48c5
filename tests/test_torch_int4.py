"""INT4 weight-only matmul of the PyTorch port against the JAX package on
the CPU: the port's ``quantized_matmul(bits=4)`` (its plain version, because
the tensors lie on the CPU) against the JAX Pallas INT4 kernels in interpret
mode, per-channel and grouped, f32 and bf16; shapes the JAX wrapper hands to
its reference (a group that straddles the packed halves, ragged N); the plan
that picks the CUDA kernel's variant; and an INT4 ``TierEngine`` against the
JAX engine. Inputs are made by numpy from fixed seeds and fed to both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_sd_tpu.engine import TierEngine as JEngine
from adaptive_sd_tpu.models import TINY128 as JTINY128
from adaptive_sd_tpu.models import qwen as jq
from adaptive_sd_tpu.ops import matmul_q as jmm
from adaptive_sd_tpu.ops import quant as jquant
from adaptive_sd_tpu.ops.quant import QuantizedTensor as JQT
from adaptive_sd_tpu_torch.engine import TierEngine
from adaptive_sd_tpu_torch.models import TINY128, init_params_quantized, params_from_jax
from adaptive_sd_tpu_torch.models.qwen import quantize_model
from adaptive_sd_tpu_torch.ops import matmul_q as tmm
from adaptive_sd_tpu_torch.ops import quant as tquant

torch.set_num_threads(2)

# f32 sums taken in another order (torch against a Pallas block schedule that
# contracts the two nibble halves as separate dots): a few ulps of the result
F32 = dict(rtol=1e-4, atol=1e-4)
# bf16 outputs: both sides round an f32 sum once, so they differ by at most
# one bf16 step (2^-8 relative) where the sums differ in their last bits
BF16 = dict(rtol=1e-2, atol=2e-2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16(a: np.ndarray) -> torch.Tensor:
    return _t(a).to(torch.bfloat16)


@pytest.mark.parametrize("group_size", [None, 128])
@pytest.mark.parametrize("M", [1, 5, 600])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_int4_matmul_matches_jax_pallas_interpret(group_size, M, dtype):
    rng = np.random.default_rng(M + (group_size or 0))
    K, N = 512, 256
    w = rng.normal(size=(K, N)).astype(np.float32)
    x = rng.normal(size=(M, K)).astype(np.float32)
    jt = jquant.quantize_int4(jnp.asarray(w), group_size=group_size)
    tt = tquant.quantize_int4(_t(w), group_size=group_size)
    np.testing.assert_array_equal(tt.q.numpy(), np.asarray(jt.q))
    np.testing.assert_array_equal(tt.scale.numpy(), np.asarray(jt.scale))
    if dtype == "f32":
        jx, tx, tol = jnp.asarray(x), _t(x), F32
    else:
        jx, tx, tol = jnp.asarray(x).astype(jnp.bfloat16), _bf16(x), BF16
    jout = jmm.quantized_matmul(jx, jt.q, jt.scale, bits=4, interpret=True)
    tout = tmm.quantized_matmul(tx, tt.q, tt.scale, bits=4)
    assert tout.dtype == tx.dtype and tuple(tout.shape) == (M, N)
    np.testing.assert_allclose(tout.float().numpy(),
                               np.asarray(jout.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("K,N,gs", [(384, 200, 128), (768, 130, 32), (1000, 96, None)])
def test_int4_shapes_outside_the_pallas_blocking(K, N, gs):
    """K = 384 with groups of 128 puts a group across the two packed halves;
    N = 200 is no multiple of 128. The JAX wrapper sends these to its
    reference; the port's plain version must agree with it (and the CUDA
    kernel is held against the plain version on the card)."""
    rng = np.random.default_rng(K + N)
    w = rng.normal(size=(K, N)).astype(np.float32)
    x = rng.normal(size=(7, K)).astype(np.float32)
    jt = jquant.quantize_int4(jnp.asarray(w), group_size=gs)
    jout = jmm.quantized_matmul_ref(jnp.asarray(x), jt.q, jt.scale, bits=4)
    tout = tmm.quantized_matmul(_t(x), _t(np.asarray(jt.q)), _t(np.asarray(jt.scale)), bits=4)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **F32)
    # and equals the float product with the dequantised weight
    wq = tquant.unpack_int4(_t(np.asarray(jt.q))).float()
    s = _t(np.asarray(jt.scale))
    wd = wq * s[None, :] if gs is None else (
        wq.reshape(-1, gs, N) * s[:, None, :]).reshape(K, N)
    np.testing.assert_allclose(tout.numpy(), (_t(x) @ wd).numpy(), **F32)


def test_int4_k_mismatch_raises():
    with pytest.raises(ValueError, match="K mismatch"):
        tmm.quantized_matmul(torch.zeros(2, 100), torch.zeros(64, 8, dtype=torch.int8),
                             torch.ones(8), bits=4)


@pytest.mark.parametrize("M,N,K,gs", [
    (1, 7168, 5120, 128), (4, 5120, 27648, 128), (8, 152064, 5120, 128), (16, 200, 384, 128),
    (4, 256, 4096, 256), (3, 130, 768, 32), (2, 96, 1000, 0),
])
def test_int4_plan_small_m_splits_cover_k_on_group_boundaries(M, N, K, gs):
    large, splits, r_per = tmm._int4_plan(M, N, K, gs, 132)
    Kh = K // 2
    assert large == 0 and splits >= 1
    assert (splits - 1) * r_per < Kh <= splits * r_per      # every packed row, no empty split
    assert r_per % 128 == 0                                 # whole kernel steps
    if gs:
        assert r_per % gs == 0                              # a split ends where a group ends


@pytest.mark.parametrize("M,N", [(17, 5120), (300, 5120), (2300, 55296), (132, 152064)])
def test_int4_plan_large_m_tile(M, N):
    """Above 16 rows the larger tiles; the K split is the one decode takes
    (it depends on N and K only), so a row sums in the same order at every M."""
    large, splits, r_per = tmm._int4_plan(M, N, 5120, 128, 132)
    assert large == 1
    assert (splits, r_per) == tmm._int4_plan(1, N, 5120, 128, 132)[1:]


@pytest.mark.parametrize("M,N,K,gs", [
    (1, 7168, 5120, 128), (4, 5120, 27648, 128), (16, 200, 384, 128), (8, 152064, 5120, 128),
    (3, 130, 768, 32), (2, 96, 1000, 0), (16, 4112, 2000, 0),
])
def test_int4_decode_buffers_fit_the_split(M, N, K, gs):
    """A decode call's stream buffers: one [M, N] f32 slab of partial sums a
    K split and a tile counter for every 256-column decode tile (the
    counters' zeroed default of 1024 covers every width up to 262144), none
    where K is not split (one block a column tile writes the output)."""
    _, splits, _ = tmm._int4_plan(M, N, K, gs, 132)
    n_ws, n_counters = tmm._int4_decode_buffers(M, N, K, gs, 132)
    if splits == 1:
        assert (n_ws, n_counters) == (0, 0)
    else:
        assert n_ws == splits * M * N
        assert n_counters == -(-N // 256) <= 1024


def test_int4_cuda_wrapper_refuses_cpu_and_wrong_types():
    x, q, s = torch.zeros(2, 256), torch.zeros(128, 8, dtype=torch.int8), torch.ones(8)
    with pytest.raises(ValueError, match="CUDA"):
        tmm.int4_matmul_cuda(x, q, s)
    with pytest.raises(TypeError):
        tmm.int4_matmul_cuda(x.half(), q, s)
    with pytest.raises(TypeError):
        tmm.int4_matmul_cuda(x, q.to(torch.int32), s)


def _jax_to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _jax_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_jax_to_numpy(v) for v in tree]
    if isinstance(tree, JQT):
        return (np.asarray(tree.q), np.asarray(tree.scale), tree.bits)
    return np.asarray(tree)


def test_params_from_jax_carries_grouped_scales():
    jp = jq.init_params_quantized(JTINY128, jax.random.key(1), bits=4, dtype=jnp.float32)
    tp = params_from_jax(_jax_to_numpy(jp), device="cpu")
    jl, tl = jp["layers"][0]["down_proj"], tp["layers"][0]["down_proj"]
    assert tl.bits == 4 and tuple(tl.scale.shape) == (JTINY128.ffn // 128, JTINY128.hidden)
    np.testing.assert_array_equal(tl.scale.numpy(), np.asarray(jl.scale))
    np.testing.assert_array_equal(tl.q.numpy(), np.asarray(jl.q))


@pytest.mark.parametrize("group_size", [128, None])
def test_int4_engine_matches_jax_engine(group_size):
    """TINY128 quantised to INT4 (grouped, and per-channel through
    ``quantize_model(group_size=None)``): the port's engine gives the JAX
    engine's greedy tokens and acceptance counts."""
    raw = jq.init_params(JTINY128, jax.random.key(3), dtype=jnp.float32)
    jp = jq.quantize_model(jq.fuse_projections(raw), bits=4, group_size=group_size)
    tp = params_from_jax(_jax_to_numpy(jp), device="cpu")
    assert tp["layers"][0]["qkv_proj"].scale.ndim == (2 if group_size else 1)
    kw = dict(page_size=16, n_pages=64, enable_prefix_cache=True)
    je = JEngine(JTINY128, jp, use_pallas=False, **kw)
    te = TierEngine(TINY128, tp, device="cpu", **kw)
    rng = np.random.default_rng(4)
    prompts = [[int(t) for t in rng.integers(1, JTINY128.vocab_size, n)] for n in (20, 35)]
    jg, tg = je.generate(prompts, max_new=8), te.generate(prompts, max_new=8)
    for j, t in zip(jg, tg):
        np.testing.assert_array_equal(t.token_ids, j.token_ids)
        # f32 log-softmax of logits that differ by sum order
        np.testing.assert_allclose(t.logprobs, j.logprobs, atol=1e-3)
    drafts = [list(o.token_ids[:5]) + [3, 4, 5] for o in jg]
    jv = je.verify_continue(prompts, drafts, max_new=8)
    tv = te.verify_continue(prompts, drafts, max_new=8)
    assert [n for _, n in tv] == [n for _, n in jv]
    for (j, _), (t, _) in zip(jv, tv):
        np.testing.assert_array_equal(t.token_ids, j.token_ids)


def test_port_int4_init_and_quantize_model_layouts():
    p = init_params_quantized(TINY128, 0, bits=4, device="cpu", dtype=torch.float32)
    assert p["layers"][0]["gateup_proj"].scale.ndim == 2
    p = init_params_quantized(TINY128, 0, bits=4, device="cpu", dtype=torch.float32,
                              group_size=None)
    assert p["layers"][0]["gateup_proj"].scale.ndim == 1
    raw = init_params_quantized(TINY128, 0, bits=16, device="cpu", dtype=torch.float32)
    q = quantize_model(raw, bits=4, group_size=None)
    assert q["lm_head"].bits == 4 and q["lm_head"].scale.ndim == 1


@pytest.mark.parametrize("exp_range", [(-30, -10), (-10, 10), (10, 38), (-33, 38)])
def test_split_bf16x3_sums_back_exactly(exp_range):
    """The three bf16 terms of f32 activations (the CUDA kernel's split for
    f32 x) sum back to x exactly, from tiny to huge magnitudes, with zeros and
    both signs."""
    rng = np.random.default_rng(exp_range[0] + 100)
    mant = rng.uniform(1.0, 10.0, 4096) * rng.choice([-1.0, 1.0], 4096)
    x = (mant * 10.0 ** rng.integers(*exp_range, 4096)).astype(np.float32)
    x[:7] = [0.0, -0.0, 1.0, -1.0, np.float32(2.0 ** -110), np.float32(3.3e38), 1 + 2.0 ** -23]
    hi, mid, lo = tmm.split_bf16x3(_t(x))
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    back = hi.double() + mid.double() + lo.double()
    np.testing.assert_array_equal(back.numpy(), x.astype(np.float64))
    # each term is what the next cannot hold: |mid| <= ulp_bf16(hi) / 2
    np.testing.assert_array_less(mid.double().abs().numpy(),
                                 hi.double().abs().numpy() * 2.0 ** -8 + 1e-300)


@pytest.mark.parametrize("M", [1, 5, 600])
@pytest.mark.parametrize("group_size", [128, 32])
def test_int4_three_term_product_matches_jax_pallas_interpret(M, group_size):
    """The grouped INT4 product as the CUDA kernel forms it for f32 x: each
    bf16 term times the INT4 weights, each group's sub-dot scaled after the
    dot (sums in f64 here), agrees with the JAX Pallas kernel in interpret
    mode on f32 x."""
    rng = np.random.default_rng(M + group_size)
    K, N = 512, 256
    w = rng.normal(size=(K, N)).astype(np.float32)
    x = rng.normal(size=(M, K)).astype(np.float32)
    jt = jquant.quantize_int4(jnp.asarray(w), group_size=group_size)
    jout = np.asarray(jmm.quantized_matmul(jnp.asarray(x), jt.q, jt.scale, bits=4,
                                           interpret=True))
    wq = tquant.unpack_int4(_t(np.asarray(jt.q))).double()       # [K, N] in [-8, 7]
    s = _t(np.asarray(jt.scale)).double()                        # [K / gs, N]
    terms = tmm.split_bf16x3(_t(x))
    y = torch.zeros(M, N, dtype=torch.float64)
    for gi in range(K // group_size):
        rows = slice(gi * group_size, (gi + 1) * group_size)
        sub = sum(t[:, rows].double() @ wq[rows] for t in terms)  # exact products
        y += sub * s[gi]
    np.testing.assert_allclose(y.numpy(), jout, **F32)


@pytest.mark.parametrize("M,N,K,gs", [
    (1, 7168, 5120, 128), (16, 200, 384, 128), (3, 130, 768, 32), (2, 96, 1000, 0),
    (300, 5120, 5120, 128), (2304, 55296, 27648, 128),
])
def test_int4_plan_workspace_fits_every_split(M, N, K, gs):
    """The partial-sum workspace [splits, M, N] of the decode tiles holds one
    slab per split; the splits' packed rows (whole 32-row kernel stages, on
    group boundaries) tile K/2 with none empty; the window tiles take the
    same splits, in turn or (``_window_plan``) in blocks of their own with
    the same workspace."""
    large, splits, r_per = tmm._int4_plan(M, N, K, gs, 132)
    Kh = K // 2
    assert large == int(M > 16)
    spans = [(i * r_per, min(Kh, (i + 1) * r_per)) for i in range(splits)]
    assert spans[0][0] == 0 and spans[-1][1] == Kh and all(a < b for a, b in spans)
    assert r_per % 32 == 0 and (not gs or r_per % gs == 0)
