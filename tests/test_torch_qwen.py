"""Logit parity of the PyTorch port's Qwen2 forward with the JAX package
(``use_pallas=False``) on the same weights, moved across with
``params_from_jax``: ``prefill``, ``decode_step``, ``prefill_window`` and
``logits_at`` over the paged INT8 KV cache, f32 params at TINY size."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_sd_tpu.engine.kv_cache import PagedKVCache as JCache
from adaptive_sd_tpu.models import TINY as JTINY
from adaptive_sd_tpu.models import qwen as jq
from adaptive_sd_tpu.ops.quant import QuantizedTensor as JQT
from adaptive_sd_tpu_torch.engine.kv_cache import PagedKVCache as TCache
from adaptive_sd_tpu_torch.models import TINY as TTINY
from adaptive_sd_tpu_torch.models import params_from_jax
from adaptive_sd_tpu_torch.models import qwen as tq
from adaptive_sd_tpu_torch.ops.quant import QuantizedTensor

torch.set_num_threads(2)

PAGE = 16
# f32 forward through two layers; the only divergence is sum order, which can
# move an INT8 KV value across a rounding boundary now and then: logits agree
# to ~1e-3 of their O(1) magnitude.
ATOL, RTOL = 2e-3, 1e-3


def jax_to_numpy(tree):
    """The JAX params pytree as numpy, QuantizedTensor -> (q, scale, bits)."""
    if isinstance(tree, dict):
        return {k: jax_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [jax_to_numpy(v) for v in tree]
    if isinstance(tree, JQT):
        return (np.asarray(tree.q), np.asarray(tree.scale), tree.bits)
    return np.asarray(tree)


VARIANTS = {
    "int8_fused": lambda spec: jq.init_params_quantized(spec, jax.random.key(0), dtype=jnp.float32),
    "f32_unfused": lambda spec: jq.init_params(spec, jax.random.key(1), dtype=jnp.float32),
    "int8_tied": lambda spec: jq.init_params_quantized(spec, jax.random.key(2), dtype=jnp.float32),
}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def model(request):
    jspec = dataclasses.replace(JTINY, tie_embeddings=request.param == "int8_tied")
    tspec = dataclasses.replace(TTINY, tie_embeddings=jspec.tie_embeddings)
    jp = VARIANTS[request.param](jspec)
    return jspec, tspec, jp, params_from_jax(jax_to_numpy(jp), device="cpu")


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)


def test_params_from_jax_bytes(model):
    _, _, jp, tp = model
    layer_j, layer_t = jp["layers"][0], tp["layers"][0]
    for k, v in layer_j.items():
        if isinstance(v, JQT):
            assert isinstance(layer_t[k], QuantizedTensor)
            np.testing.assert_array_equal(layer_t[k].q.numpy(), np.asarray(v.q))
        else:
            np.testing.assert_array_equal(layer_t[k].numpy(), np.asarray(v))


def test_prefill_decode_window_logits(model):
    jspec, tspec, jp, tp = model
    rng = np.random.default_rng(0)
    B, S, n_pages = 2, 21, 16
    tokens = rng.integers(1, jspec.vocab_size, (B, S)).astype(np.int32)
    lens = np.array([21, 13], np.int32)
    tables = np.array([[0, 1, 2, 3, 4], [5, 6, 7, 8, 9]], np.int32)
    jc = JCache.create(jspec, n_pages, PAGE)
    tc = TCache.create(tspec, n_pages, PAGE, device="cpu")
    T = torch.from_numpy

    # jit: eager JAX compiles every op of the forward on its own, which is slow
    j_prefill = jax.jit(lambda *a: jq.prefill(jp, jspec, *a, use_pallas=False, return_hidden=True))
    j_decode = jax.jit(lambda *a: jq.decode_step(jp, jspec, *a, use_pallas=False))
    j_window = jax.jit(lambda *a: jq.prefill_window(jp, jspec, *a, use_pallas=False))
    jl, jc, jh = j_prefill(jnp.asarray(tokens), jnp.asarray(lens), jc, jnp.asarray(tables))
    tl, _, th = tq.prefill(tp, tspec, T(tokens), T(lens), tc, T(tables), return_hidden=True)
    _close(tl, jl)
    for b in range(B):
        _close(th[b, : lens[b]], jh[b, : lens[b]])
    _close(tq.logits_at(tp, tspec, th[:, :5]), jq.logits_at(jp, jspec, jh[:, :5], use_pallas=False))

    # one decode step at the next position (row 0 writes position 21, page 1)
    tok = rng.integers(1, jspec.vocab_size, (B,)).astype(np.int32)
    jl, jc = j_decode(jnp.asarray(tok), jnp.asarray(lens), jc, jnp.asarray(tables))
    tl, _ = tq.decode_step(tp, tspec, T(tok), T(lens), tc, T(tables))
    _close(tl, jl)

    # a window over the cached prefix, ragged lengths, crossing a page boundary
    W = 6
    win = rng.integers(1, jspec.vocab_size, (B, W)).astype(np.int32)
    offs, wl = lens + 1, np.array([6, 3], np.int32)
    jh, jc = j_window(jnp.asarray(win), jnp.asarray(offs), jnp.asarray(wl), jc,
                      jnp.asarray(tables))
    th, _ = tq.prefill_window(tp, tspec, T(win), T(offs), T(wl), tc, T(tables))
    for b in range(B):
        n = wl[b]
        _close(th[b, :n], jh[b, :n])
        _close(tq.logits_at(tp, tspec, th[b, :n]),
               jq.logits_at(jp, jspec, jh[b, :n], use_pallas=False))


def test_fuse_then_quantize_matches_jax():
    jp = jq.init_params(JTINY, jax.random.key(3), dtype=jnp.float32)
    tp = params_from_jax(jax_to_numpy(jp), device="cpu")
    jf = jq.quantize_model(jq.fuse_projections(jp))
    tf = tq.quantize_model(tq.fuse_projections(tp))
    for name in ("qkv_proj", "gateup_proj", "o_proj", "down_proj"):
        np.testing.assert_array_equal(tf["layers"][1][name].q.numpy(),
                                      np.asarray(jf["layers"][1][name].q))
        np.testing.assert_array_equal(tf["layers"][1][name].scale.numpy(),
                                      np.asarray(jf["layers"][1][name].scale))
    np.testing.assert_array_equal(tf["lm_head"].q.numpy(), np.asarray(jf["lm_head"].q))


def test_init_params_quantized_shapes_and_device():
    tp = tq.init_params_quantized(TTINY, torch.Generator().manual_seed(0), device="cpu")
    layer = tp["layers"][0]
    D = TTINY.head_dim
    assert layer["qkv_proj"].q.shape == (TTINY.hidden, (TTINY.n_heads + 2 * TTINY.n_kv_heads) * D)
    assert layer["gateup_proj"].q.shape == (TTINY.hidden, 2 * TTINY.ffn)
    assert tp["embed"].dtype == torch.bfloat16 and tp["embed"].device.type == "cpu"
    # seeded: the same generator seed gives the same weights
    again = tq.init_params_quantized(TTINY, 0, device="cpu")
    assert torch.equal(again["layers"][1]["down_proj"].q, tp["layers"][1]["down_proj"].q)
