"""The port's W8A8 matmul (plain version; the CUDA kernel is held to it on the
card, tests/test_torch_cuda.py) against the JAX package's
``quantized_matmul_w8a8`` in interpret mode on the same numpy inputs, the
``act_quant`` route of ``linear_q``, and an ``act_quant`` forward of the
port's Qwen2 against the JAX one."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_sd_tpu.engine.kv_cache import PagedKVCache as JCache
from adaptive_sd_tpu.models import TINY as JTINY
from adaptive_sd_tpu.models import qwen as jq
from adaptive_sd_tpu.ops import matmul_q as jmq
from adaptive_sd_tpu.ops.quant import quantize_int8 as j_quantize_int8
from adaptive_sd_tpu_torch.engine.kv_cache import PagedKVCache as TCache
from adaptive_sd_tpu_torch.models import TINY as TTINY
from adaptive_sd_tpu_torch.models import params_from_jax
from adaptive_sd_tpu_torch.models import qwen as tq
from adaptive_sd_tpu_torch.ops import matmul_q as tmq
from adaptive_sd_tpu_torch.ops.quant import QuantizedTensor, quantize_int4
from tests.test_torch_common import _to_numpy

torch.set_num_threads(2)

# (M, K, N): aligned shapes reach the Pallas kernel (interpret mode); ragged
# N or K take the JAX wrapper's XLA integer product (matmul_q.py:357-363)
ALIGNED = [(4, 256, 256), (40, 384, 128), (1, 1280, 256)]
RAGGED = [(5, 200, 130), (3, 130, 256), (33, 256, 100)]


def _inputs(M, K, N, dtype, seed=0):
    rng = np.random.default_rng(seed + M + K + N)
    w = rng.normal(size=(K, N)).astype(np.float32) / np.sqrt(K)
    x = (rng.normal(size=(M, K)) * 2).astype(np.float32)
    x[0, :3] = [0.5, 1.5, 2.5]          # exact halves after scaling are possible
    qt = j_quantize_int8(jnp.asarray(w))
    q, scale = np.asarray(qt.q), np.asarray(qt.scale)
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    return jx, tx, q, scale


@jax.jit
def _jit_row_scale(x):
    return jnp.maximum(jnp.max(jnp.abs(x.astype(jnp.float32)), axis=1, keepdims=True) / 127.0,
                       1e-8)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("M,K,N", ALIGNED + RAGGED)
def test_w8a8_matches_jax_interpret(M, K, N, dtype):
    jx, tx, q, scale = _inputs(M, K, N, dtype)
    # activation quantisation, op by op (matmul_q.py:351-353): bytes and scales identical
    jxs = jnp.maximum(jnp.max(jnp.abs(jx.astype(jnp.float32)), axis=1, keepdims=True) / 127.0,
                      1e-8)
    jxq = jnp.clip(jnp.round(jx.astype(jnp.float32) / jxs), -127, 127).astype(jnp.int8)
    txq, txs = tmq.quantize_rows_int8(tx)
    np.testing.assert_array_equal(txs.numpy(), np.asarray(jxs))
    np.testing.assert_array_equal(txq.numpy(), np.asarray(jxq))
    # Under jit XLA's CPU compiler turns ``/ 127.0`` into a multiplication by
    # the reciprocal, which moves the scale of some rows by one f32 ulp (the
    # bytes stay the same); the port divides, as the un-jitted expression does.
    jxs_jit = np.asarray(_jit_row_scale(jx))
    np.testing.assert_allclose(txs.numpy(), jxs_jit, rtol=2.0 ** -23, atol=0)

    want = jmq.quantized_matmul_w8a8(jx, jnp.asarray(q), jnp.asarray(scale), interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    got = tmq.quantized_matmul_w8a8(tx, torch.from_numpy(q.copy()), torch.from_numpy(scale.copy()))
    assert got.dtype == tx.dtype and got.shape == (M, N)
    got = got.float().numpy()
    # The integer sum is exact and both sides multiply acc * xs * ws in f32 in
    # that order, so rows whose scale agrees are equal bit for bit; a row whose
    # scale differs by one ulp differs by at most two ulps in f32 (one rounding
    # step in bf16).
    same = (txs.numpy() == jxs_jit)[:, 0]
    np.testing.assert_array_equal(got[same], want[same])
    tol = 2.0 ** -22 if dtype == "f32" else 2.0 ** -7
    np.testing.assert_allclose(got, want, rtol=tol, atol=0)
    if dtype == "f32":
        # with the JAX side's own scales the port's arithmetic gives its bytes
        acc = (txq.to(torch.int32) @ torch.from_numpy(q.copy()).to(torch.int32)).numpy()
        np.testing.assert_array_equal((acc.astype(np.float32) * jxs_jit) * scale[None, :], want)


def test_w8a8_ref_is_exact_where_f32_matmul_is_not():
    """K * 127**2 passes 2**24: the plain version must sum in integers."""
    K, N = 4096, 8
    x = torch.full((2, K), 3.0)
    q = torch.full((K, N), 127, dtype=torch.int8)
    scale = torch.ones(N)
    out = tmq.quantized_matmul_w8a8_ref(x, q, scale)
    exact = np.float32(K * 127 * 127) * np.float32(3.0 / 127.0)
    assert float(out[0, 0]) == float(np.float32(exact))
    assert tmq.quantized_matmul_w8a8_ref(torch.zeros(1, K), q, scale).abs().max() == 0


def test_linear_q_act_quant_route():
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.normal(size=(64, 48)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(2, 3, 64)).astype(np.float32))
    from adaptive_sd_tpu_torch.ops.quant import quantize_int8

    t8 = quantize_int8(w)
    y = tmq.linear_q(x, t8, act_quant=True)
    assert y.shape == (2, 3, 48)
    assert torch.equal(y.reshape(6, 48),
                       tmq.quantized_matmul_w8a8_ref(x.reshape(6, 64), t8.q, t8.scale))
    # W8A8 is lossier than weight-only, not equal to it, and close to it
    y_w = tmq.linear_q(x, t8)
    assert not torch.equal(y, y_w)
    # (activation rounding error: a step of max|x|/127 ~ 0.025 over 64 weights of size ~1)
    torch.testing.assert_close(y, y_w, rtol=0.0, atol=0.3)
    # act_quant applies to INT8 weights only: INT4 keeps its weight-only path
    t4 = quantize_int4(w, group_size=32)
    assert isinstance(t4, QuantizedTensor) and t4.bits == 4
    assert torch.equal(tmq.linear_q(x, t4, act_quant=True), tmq.linear_q(x, t4))
    with pytest.raises(ValueError):
        tmq.quantized_matmul_w8a8(x.reshape(6, 64), t8.q[:32], t8.scale)


# as tests/test_torch_qwen.py: f32 forward, the only divergence is sum order in
# the f32 parts (norms, attention), which can move an INT8 KV or activation
# value across a rounding boundary now and then
ATOL, RTOL = 2e-3, 1e-3


def test_act_quant_forward_matches_jax(monkeypatch):
    """``prefill``, ``logits_at`` and ``decode_step`` with ``act_quant``: the
    JAX side runs its W8A8 Pallas kernel in interpret mode (``use_pallas``
    with no TPU) and, for the decode step, its paged attention kernel in
    interpret mode too."""
    jp = jq.init_params_quantized(JTINY, jax.random.key(0), dtype=jnp.float32)
    tp = params_from_jax(_to_numpy(jp), device="cpu")
    rng = np.random.default_rng(0)
    B, S, n_pages, PAGE = 2, 21, 16, 16
    tokens = rng.integers(1, JTINY.vocab_size, (B, S)).astype(np.int32)
    lens = np.array([21, 13], np.int32)
    tables = np.array([[0, 1, 2, 3, 4], [5, 6, 7, 8, 9]], np.int32)
    jc = JCache.create(JTINY, n_pages, PAGE)
    tc = TCache.create(TTINY, n_pages, PAGE, device="cpu")
    T = torch.from_numpy

    def close(t, j):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)

    j_prefill = jax.jit(lambda *a: jq.prefill(jp, JTINY, *a, use_pallas=True, act_quant=True,
                                              return_hidden=True))
    jl, jc, jh = j_prefill(jnp.asarray(tokens), jnp.asarray(lens), jc, jnp.asarray(tables))
    tl, _, th = tq.prefill(tp, TTINY, T(tokens), T(lens), tc, T(tables), return_hidden=True,
                           act_quant=True)
    close(tl, jl)
    for b in range(B):
        close(th[b, : lens[b]], jh[b, : lens[b]])
    close(tq.logits_at(tp, TTINY, th[:, :5], act_quant=True),
          jq.logits_at(jp, JTINY, jh[:, :5], use_pallas=True, act_quant=True))
    # act_quant changes the numbers: it is not silently ignored
    tl_w, _ = tq.prefill(tp, TTINY, T(tokens), T(lens),
                         TCache.create(TTINY, n_pages, PAGE, device="cpu"), T(tables))
    assert float((tl - tl_w).abs().max()) > 1e-4

    from adaptive_sd_tpu.ops import attention as jattn

    monkeypatch.setattr(jq, "paged_attention",
                        functools.partial(jattn.paged_attention, interpret=True))
    tok = rng.integers(1, JTINY.vocab_size, (B,)).astype(np.int32)
    jl, jc = jq.decode_step(jp, JTINY, jnp.asarray(tok), jnp.asarray(lens), jc,
                            jnp.asarray(tables), use_pallas=True, act_quant=True)
    tl, _ = tq.decode_step(tp, TTINY, T(tok), T(lens), tc, T(tables), act_quant=True)
    close(tl, jl)


@pytest.mark.parametrize("M,K,N", [
    (1, 3584, 4608), (8, 3584, 152064), (16, 18944, 3584), (5, 100, 130), (17, 3584, 4608),
    (192, 3584, 3584), (2304, 3584, 37888), (300, 2050, 4099),
])
def test_w8a8_plan_splits_and_workspace(M, K, N):
    """Every split of K is whole 64-row stages and none is empty; the split-K
    counters hold one per output tile of the kernel's grid (16-row tiles up
    to M = 16, 128-row tiles above, 128 columns), and the int32 sums [M, N]
    one per output."""
    large, splits, k_per = tmq._w8a8_plan(M, N, K, 132)
    assert large == int(M > 16)
    spans = [(i * k_per, min(K, (i + 1) * k_per)) for i in range(splits)]
    assert k_per % 64 == 0 and spans[-1][1] == K and all(a < b for a, b in spans)
    bm = 128 if large else 16
    grid = (-(-N // 128), splits, -(-M // bm))
    assert tmq._w8a8_tiles(M, N, large) == grid[0] * grid[2]
    last_tile = (grid[2] - 1) * grid[0] + (grid[0] - 1)      # blockIdx.z * gridDim.x + x
    assert last_tile < tmq._w8a8_tiles(M, N, large)
    if M <= 16:
        assert splits > 1 or -(-K // 64) == 1 or grid[0] >= 4 * 132
