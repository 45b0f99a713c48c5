"""Parity of the PyTorch port's operators with the JAX package on the CPU:
quantization bytes, the INT8 matmul, paged decode / window attention (held
against the JAX Pallas kernels in interpret mode), prefill attention and the
paged KV-cache writers. Inputs are made by numpy from fixed seeds and fed to
both packages."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_sd_tpu.engine.kv_cache import PagedKVCache as JCache
from adaptive_sd_tpu.models.config import ModelSpec as JSpec
from adaptive_sd_tpu.ops import attention as jattn
from adaptive_sd_tpu.ops import matmul_q as jmm
from adaptive_sd_tpu.ops import quant as jquant
from adaptive_sd_tpu_torch.engine.kv_cache import PagedKVCache as TCache
from adaptive_sd_tpu_torch.models.config import ModelSpec as TSpec
from adaptive_sd_tpu_torch.ops import attention as tattn
from adaptive_sd_tpu_torch.ops import matmul_q as tmm
from adaptive_sd_tpu_torch.ops import quant as tquant

torch.set_num_threads(2)

# f32 sums taken in another order (torch vs XLA, or vs a Pallas block
# schedule): agreement to a few ulps of the f32 result magnitude.
F32_ATOL = 2e-5
F32_RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


class TestQuantBytes:
    """Both frameworks round half to even: bytes and scales are identical."""

    def test_int8_per_channel(self):
        w = np.random.default_rng(0).normal(size=(256, 192)).astype(np.float32)
        j, t = jquant.quantize_int8(jnp.asarray(w)), tquant.quantize_int8(_t(w))
        np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))
        np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))
        assert t.bits == j.bits == 8

    def test_int8_round_half_to_even(self):
        # max 127 -> scale 1: values at exact .5 boundaries exercise rounding
        w = np.array([[127.0, 0.5], [1.5, -2.5], [-0.5, 2.5]], np.float32)
        j, t = jquant.quantize_int8(jnp.asarray(w)), tquant.quantize_int8(_t(w))
        np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))

    def test_kv_int8(self):
        kv = np.random.default_rng(1).normal(size=(2, 9, 3, 32)).astype(np.float32)
        jq, js = jquant.quantize_kv_int8(jnp.asarray(kv))
        tq, ts = tquant.quantize_kv_int8(_t(kv))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))

    @pytest.mark.parametrize("group_size", [None, 128])
    def test_int4(self, group_size):
        w = np.random.default_rng(2).normal(size=(256, 96)).astype(np.float32)
        j = jquant.quantize_int4(jnp.asarray(w), group_size=group_size)
        t = tquant.quantize_int4(_t(w), group_size=group_size)
        np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))
        np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))

    def test_int4_pack_unpack(self):
        q = np.random.default_rng(3).integers(-8, 8, size=(64, 40)).astype(np.int8)
        packed = tquant.pack_int4(_t(q))
        np.testing.assert_array_equal(packed.numpy(), np.asarray(jquant.pack_int4(jnp.asarray(q))))
        np.testing.assert_array_equal(tquant.unpack_int4(packed).numpy(), q)
        lo, hi = tquant.unpack_int4_halves(packed)
        jlo, jhi = jquant.unpack_int4_halves(jnp.asarray(packed.numpy()))
        np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
        np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))


class TestQuantizedMatmul:
    @pytest.mark.parametrize("M", [1, 5, 64])
    def test_int8_matches_pallas_interpret_and_ref(self, M):
        rng = np.random.default_rng(10 + M)
        K, N = 256, 384
        w = rng.normal(size=(K, N)).astype(np.float32)
        x = rng.normal(size=(M, K)).astype(np.float32)
        jt = jquant.quantize_int8(jnp.asarray(w))
        ker = jmm.quantized_matmul(jnp.asarray(x), jt.q, jt.scale, bits=8, interpret=True)
        ref = jmm.quantized_matmul_ref(jnp.asarray(x), jt.q, jt.scale, bits=8)
        out = tmm.quantized_matmul(_t(x), _t(jt.q), _t(jt.scale), bits=8)
        assert out.dtype == torch.float32 and out.shape == (M, N)
        tol = dict(rtol=F32_RTOL, atol=F32_ATOL * K ** 0.5)
        np.testing.assert_allclose(out.numpy(), np.asarray(ker), **tol)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **tol)
        np.testing.assert_allclose(
            tmm.quantized_matmul_ref(_t(x), _t(jt.q), _t(jt.scale)).numpy(), np.asarray(ref), **tol
        )

    @pytest.mark.parametrize("group_size", [None, 128])
    def test_int4_ref(self, group_size):
        rng = np.random.default_rng(20)
        K, N, M = 256, 128, 3
        w = rng.normal(size=(K, N)).astype(np.float32)
        x = rng.normal(size=(M, K)).astype(np.float32)
        jt = jquant.quantize_int4(jnp.asarray(w), group_size=group_size)
        ref = jmm.quantized_matmul_ref(jnp.asarray(x), jt.q, jt.scale, bits=4)
        out = tmm.quantized_matmul(_t(x), _t(jt.q), _t(jt.scale), bits=4)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=F32_RTOL,
                                   atol=F32_ATOL * K ** 0.5)

    def test_linear_q_leading_dims(self):
        rng = np.random.default_rng(21)
        w = rng.normal(size=(64, 96)).astype(np.float32)
        x = rng.normal(size=(2, 7, 64)).astype(np.float32)
        jt = jquant.quantize_int8(jnp.asarray(w))
        ref = jmm.linear_q(jnp.asarray(x), jt, use_pallas=False)
        out = tmm.linear_q(_t(x), tquant.QuantizedTensor(_t(jt.q), _t(jt.scale), 8))
        assert out.shape == (2, 7, 96)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=F32_RTOL, atol=2e-4)

    def test_shape_validation(self):
        with pytest.raises(ValueError):
            tmm.quantized_matmul(torch.zeros(2, 64), torch.zeros(128, 32, dtype=torch.int8),
                                 torch.ones(32))

    @pytest.mark.parametrize("N,K", [(3584, 18944), (152064, 5120), (5120, 13824), (16, 100),
                                     (4608, 3584), (7168, 5120)])
    def test_split_k_covers_k(self, N, K):
        """The INT8 kernel's K split covers K in whole 128-row units, and it
        takes no M: the decode tiles and the window tiles of every M walk the
        same splits, so a row sums in one order at every M."""
        assert list(inspect.signature(tmm._int8_plan).parameters) == ["N", "K", "n_sm"]
        splits, k_per = tmm._int8_plan(N, K, 132)
        assert k_per % 128 == 0 and splits * k_per >= K > (splits - 1) * k_per
        # a decode tile's column blocks times the splits about fill the SMs
        blocks = -(-N // 256)
        per_sm = tmm._INT8_BLOCKS_PER_SM[blocks >= 66]
        assert splits == 1 or blocks * (splits - 1) < per_sm * 132


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M,N,K", [
    (17, 4608, 3584), (64, 3584, 18944), (128, 7168, 5120), (129, 5120, 13824),
    (192, 37888, 3584), (512, 4608, 3584), (2304, 55296, 5120), (2311, 4112, 1000),
])
def test_window_plan_covers_m_once_with_the_decode_split(bits, M, N, K):
    """The wgmma window tiles (M > 16) cover M and N once in 128 x 128
    tiles, take the K split of the decode tiles (``_int8_plan`` /
    ``_int4_plan``, which depend on N and K only) unchanged, and run its
    splits in blocks of their own only where the tiles leave SMs idle and
    the partial sums fit their workspace."""
    assert list(inspect.signature(tmm._window_plan).parameters) == ["M", "N", "splits", "n_sm"]
    if bits == 8:
        splits, _ = tmm._int8_plan(N, K, 132)
    else:
        large, splits, _ = tmm._int4_plan(M, N, K, 128, 132)
        assert large == 1 and splits == tmm._int4_plan(1, N, K, 128, 132)[1]
    m_tiles, n_tiles, split_blocks = tmm._window_plan(M, N, splits, 132)
    assert (m_tiles - 1) * 128 < M <= m_tiles * 128
    assert (n_tiles - 1) * 128 < N <= n_tiles * 128
    assert split_blocks == (splits > 1 and m_tiles * n_tiles < 132
                            and splits * M * N * 4 <= tmm._WINDOW_PARTIAL_BYTES)


def _paged_inputs(rng, n_kv, n_pages, page, D):
    kq = rng.integers(-127, 128, (n_kv, n_pages, page, D)).astype(np.int8)
    ks = rng.uniform(0.001, 0.02, (n_kv, n_pages, 1, page)).astype(np.float32)
    vq = rng.integers(-127, 128, (n_kv, n_pages, page, D)).astype(np.int8)
    vs = rng.uniform(0.001, 0.02, (n_kv, n_pages, 1, page)).astype(np.float32)
    return kq, ks, vq, vs


class TestPagedAttention:
    """Plain versions against the JAX Pallas kernels run in interpret mode.
    Same f32 math, different sum order: tight f32 tolerance."""

    @pytest.mark.parametrize("G", [2, 3])
    def test_decode_ref_matches_pallas_kernel(self, G):
        rng = np.random.default_rng(30 + G)
        B, n_kv, D, page, n_pages, maxp = 3, 2, 64, 16, 9, 4
        kq, ks, vq, vs = _paged_inputs(rng, n_kv, n_pages, page, D)
        q = rng.normal(size=(B, n_kv, G, D)).astype(np.float32)
        tables = np.array([[0, 3, 5, 7], [8, 1, 2, 4], [n_pages] * maxp], np.int32)
        lens = np.array([37, 17, 1], np.int32)  # crosses pages; lane 2 parked on the sentinel
        args = (q, kq, ks, vq, vs, tables, lens)
        ker = jattn.paged_attention(*map(jnp.asarray, args), sm_scale=D ** -0.5, interpret=True)
        out = tattn.paged_attention(*map(_t, args), sm_scale=D ** -0.5)
        ref = tattn.paged_attention_ref(*map(_t, args), sm_scale=D ** -0.5)
        np.testing.assert_allclose(out.numpy(), np.asarray(ker), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ref.numpy(), np.asarray(ker), rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("D", [40, 48])
    def test_decode_ref_matches_pallas_kernel_at_head_dims_40_48(self, D):
        """The rehearsal tiers' head dims: the Pallas kernel takes any D."""
        rng = np.random.default_rng(D)
        B, n_kv, G, page, n_pages, maxp = 2, 2, 3, 16, 6, 3
        kq, ks, vq, vs = _paged_inputs(rng, n_kv, n_pages, page, D)
        q = rng.normal(size=(B, n_kv, G, D)).astype(np.float32)
        tables = np.array([[0, 3, 5], [4, 1, 2]], np.int32)
        lens = np.array([37, 9], np.int32)
        args = (q, kq, ks, vq, vs, tables, lens)
        ker = jattn.paged_attention(*map(jnp.asarray, args), sm_scale=D ** -0.5, interpret=True)
        out = tattn.paged_attention(*map(_t, args), sm_scale=D ** -0.5)
        np.testing.assert_allclose(out.numpy(), np.asarray(ker), rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("D,ok", [(40, True), (48, True), (64, True), (120, True),
                                      (128, True), (36, False), (136, False), (0, False)])
    def test_kernel_checks_take_head_dims_in_steps_of_8(self, D, ok):
        """The kernels' wrapper checks take every head dim that is a multiple
        of 8 up to 128 (the kernels zero-pad it to 16); on the CPU the check
        then stops at the device."""
        q = torch.zeros(1, 1, 2, D)
        kp = torch.zeros(1, 2, 16, D, dtype=torch.int8)
        sc = torch.zeros(1, 2, 1, 16)
        i32 = torch.zeros(1, 1, dtype=torch.int32)
        want = "CUDA tensors" if ok else "head_dim"
        with pytest.raises(ValueError, match=want):
            tattn._check_paged(q, kp, sc, kp, sc, i32, i32[0])

    @pytest.mark.parametrize("G", [2, 5])
    def test_window_ref_matches_pallas_kernel(self, G):
        rng = np.random.default_rng(40 + G)
        B, n_kv, D, page, n_pages, maxp, W = 3, 2, 64, 16, 10, 4, 6
        kq, ks, vq, vs = _paged_inputs(rng, n_kv, n_pages, page, D)
        q = rng.normal(size=(B, n_kv, W * G, D)).astype(np.float32)
        tables = np.array([[0, 3, 5, 7], [9, 1, 2, 4], [n_pages] * maxp], np.int32)
        offsets = np.array([13, 32, 0], np.int32)
        win_lens = np.array([W, 3, 1], np.int32)   # row 1 has padding rows; row 2 parked
        ctx = offsets + win_lens
        args = (q, kq, ks, vq, vs, tables, ctx, offsets)
        ker = np.asarray(jattn.paged_window_attention(
            *map(jnp.asarray, args), group=G, sm_scale=D ** -0.5, interpret=True))
        out = tattn.paged_window_attention(*map(_t, args), group=G, sm_scale=D ** -0.5).numpy()
        for b in range(B):  # only valid rows: padding rows are never read downstream
            r = win_lens[b] * G
            np.testing.assert_allclose(out[b, :, :r], ker[b, :, :r], rtol=1e-5, atol=1e-5)
        assert np.isfinite(out).all()

    @pytest.mark.parametrize("G", [5, 7])
    def test_window_ref_matches_pallas_kernel_across_pages(self, G):
        """Windows that cross three or more pages (page 16), with offsets on
        and off page boundaries and a parked lane."""
        rng = np.random.default_rng(45 + G)
        B, n_kv, D, page, n_pages, maxp, W = 4, 2, 32, 16, 14, 6, 40
        kq, ks, vq, vs = _paged_inputs(rng, n_kv, n_pages, page, D)
        q = rng.normal(size=(B, n_kv, W * G, D)).astype(np.float32)
        tables = np.array([[0, 3, 5, 7, 9, 11], [13, 1, 2, 4, 6, 8], [10, 12, 0, 1, 2, 3],
                           [n_pages] * maxp], np.int32)
        offsets = np.array([32, 13, 0, 0], np.int32)   # on a boundary, off one, none; parked
        win_lens = np.array([W, 35, 40, 1], np.int32)  # windows over 3-4 pages
        ctx = offsets + win_lens
        args = (q, kq, ks, vq, vs, tables, ctx, offsets)
        ker = np.asarray(jattn.paged_window_attention(
            *map(jnp.asarray, args), group=G, sm_scale=D ** -0.5, interpret=True))
        out = tattn.paged_window_attention(*map(_t, args), group=G, sm_scale=D ** -0.5).numpy()
        for b in range(B):  # only valid rows: padding rows are never read downstream
            r = win_lens[b] * G
            np.testing.assert_allclose(out[b, :, :r], ker[b, :, :r], rtol=1e-5, atol=1e-5)
        assert np.isfinite(out).all()

    @pytest.mark.parametrize("R", [16, 32])
    @pytest.mark.parametrize("G,W,offset,win,page,max_pages", [
        (5, 192, 384, 148, 128, 6), (7, 512, 0, 512, 128, 6), (5, 64, 128, 40, 128, 10),
        (7, 64, 512, 33, 128, 10), (8, 70, 4030, 70, 128, 34), (2, 40, 13, 35, 16, 6),
        (5, 10, 0, 1, 16, 1), (7, 1024, 6000, 1024, 128, 64)])
    def test_window_plan_covers_rows_and_pages_once(self, G, W, offset, win, page, max_pages,
                                                    R):
        """The window kernel's host-side sizing for row tiles of R rows: row
        tiles cover every row once and the launches every tile once; a
        tile's splits cover each page of each of its valid rows (the pages
        below ctx_len up to the row's own position) exactly once, in
        decode_splits' order and boundaries; the grid's split axis holds the
        largest split count, and a launch's workspace a partial of every
        split of each of its tiles, within WINDOW_WS_BYTES unless one tile
        alone needs more (the long window: 6-13 MB a tile, 2.9 GB for all)."""
        B, n_kv, D = 3, 4, 128
        WG, ctx = W * G, offset + win
        n_tiles, tiles, n_splits, ws, n_counters = tattn.window_plan(B, n_kv, WG, max_pages,
                                                                     D, R)
        assert n_tiles * R >= WG > (n_tiles - 1) * R
        launched = [t for t0 in range(0, n_tiles, tiles)
                    for t in range(t0, min(n_tiles, t0 + tiles))]
        assert launched == list(range(n_tiles))
        seen, most = {}, 0
        for t in range(n_tiles):
            splits = tattn.window_tile_splits(t, R, WG, G, offset, ctx, max_pages, page)
            most = max(most, len(splits))
            assert splits == tattn.decode_splits(ctx, max_pages, page)[: len(splits)]
            for r in range(t * R, min(WG, (t + 1) * R)):
                for a, b in splits:
                    for p in range(a, b):
                        if p * page <= offset + r // G:
                            seen[r, p] = seen.get((r, p), 0) + 1
        want = {(r, p) for r in range(WG) if offset + r // G < ctx
                for p in range(min(-(-ctx // page), max_pages)) if p * page <= offset + r // G}
        assert {k for k in seen if k[0] < win * G} == want
        assert all(v == 1 for v in seen.values())
        assert most <= n_splits
        if n_splits > 1:
            per_tile = B * n_kv * n_splits * R * (D + 2)
            assert per_tile >= B * n_kv * most * R * (D + 2)
            assert ws == tiles * per_tile and n_counters == B * n_kv * tiles
            assert 4 * ws <= max(tattn.WINDOW_WS_BYTES, 4 * per_tile)
            if tiles < n_tiles:  # cut into launches: no fewer would fit
                assert 4 * per_tile * -(-n_tiles // (-(-n_tiles // tiles) - 1)) > \
                    tattn.WINDOW_WS_BYTES
        else:
            assert ws == n_counters == 0 and most <= 1 and tiles == n_tiles

    @pytest.mark.parametrize("page", [16, 128])
    def test_decode_splits_cover_pages_once(self, page):
        """The kernels' split plan: every page below ctx_len (within the
        table) lies in exactly one split, splits are runs of PAGES_PER_SPLIT
        pages in order, and their boundaries do not depend on the length: a
        shorter context's splits are those of a longer one, the last cut."""
        pps, max_pages = tattn.PAGES_PER_SPLIT, 40
        longest = tattn.decode_splits(max_pages * page, max_pages, page)
        for ctx in (0, 1, page - 1, page, page + 1, 1000, max_pages * page, max_pages * page + 7):
            splits = tattn.decode_splits(ctx, max_pages, page)
            pages = [p for a, b in splits for p in range(a, b)]
            n_used = min(-(-ctx // page), max_pages)
            assert pages == list(range(n_used))
            assert all(a % pps == 0 and 0 < b - a <= pps for a, b in splits)
            assert splits[:-1] == longest[: max(len(splits) - 1, 0)]
            if splits:
                assert splits[-1][0] == longest[len(splits) - 1][0]

    def test_window_of_one_equals_decode(self):
        rng = np.random.default_rng(50)
        B, n_kv, G, D, page, n_pages = 2, 2, 3, 32, 16, 6
        kq, ks, vq, vs = _paged_inputs(rng, n_kv, n_pages, page, D)
        q = _t(rng.normal(size=(B, n_kv, G, D)).astype(np.float32))
        tables = _t(np.array([[0, 1, 2], [3, 4, 5]], np.int32))
        pos = _t(np.array([9, 40], np.int32))
        pages = tuple(map(_t, (kq, ks, vq, vs)))
        dec = tattn.paged_attention(q, *pages, tables, pos + 1, sm_scale=0.2)
        win = tattn.paged_window_attention(q, *pages, tables, pos + 1, pos, group=G, sm_scale=0.2)
        np.testing.assert_allclose(win.numpy(), dec.numpy(), rtol=1e-6, atol=1e-6)


class TestPrefillAttention:
    def test_matches_jax_and_ref(self):
        rng = np.random.default_rng(60)
        B, S, H, n_kv, D = 2, 12, 6, 2, 16
        q = rng.normal(size=(B, S, H, D)).astype(np.float32)
        k = rng.normal(size=(B, S, n_kv, D)).astype(np.float32)
        v = rng.normal(size=(B, S, n_kv, D)).astype(np.float32)
        lens = np.array([12, 7], np.int32)
        j = np.asarray(jattn.prefill_attention(*map(jnp.asarray, (q, k, v)), sm_scale=0.25,
                                               seq_lens=jnp.asarray(lens)))
        out = tattn.prefill_attention(*map(_t, (q, k, v)), sm_scale=0.25, seq_lens=_t(lens))
        ref = tattn.prefill_attention_ref(*map(_t, (q, k, v)), sm_scale=0.25, seq_lens=_t(lens))
        for b in range(B):  # valid query rows only
            n = lens[b]
            np.testing.assert_allclose(out.numpy()[b, :n], j[b, :n], rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(ref.numpy()[b, :n], j[b, :n], rtol=1e-5, atol=1e-5)


class TestKVCacheWriters:
    """Page bytes and scales after prefill, decode and window writes,
    including padding rows routed to the sentinel page (dropped)."""

    def test_pages_identical_after_prefill_decode_window(self):
        rng = np.random.default_rng(70)
        args = ("t", 256, 64, 1, 4, 2, 16, 128)
        jspec, tspec = JSpec(*args), TSpec(*args)
        n_pages, page, B, S, W = 8, 16, 3, 20, 5
        jc = JCache.create(jspec, n_pages, page)
        tc = TCache.create(tspec, n_pages, page, device="cpu")
        tables = np.array([[0, 1, 2, 3], [4, 5, 6, 7], [n_pages] * 4], np.int32)

        def kv(*shape):
            return (rng.normal(size=shape).astype(np.float32),
                    rng.normal(size=shape).astype(np.float32))

        k, v = kv(B, S, 2, 16)
        lens = np.array([20, 9, 4], np.int32)   # rows past seq_len and row 2 dropped
        jc = jc.write_prefill(0, jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
                              jnp.asarray(lens))
        tc.write_prefill(0, _t(k), _t(v), _t(tables), _t(lens))
        k, v = kv(B, 2, 16)
        pos = np.array([20, 9, 4], np.int32)
        jc = jc.write_decode(0, jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
                             jnp.asarray(pos))
        tc.write_decode(0, _t(k), _t(v), _t(tables), _t(pos))
        k, v = kv(B, W, 2, 16)
        offs, wl = np.array([21, 10, 0], np.int32), np.array([5, 2, 1], np.int32)
        jc = jc.write_window(0, jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
                             jnp.asarray(offs), jnp.asarray(wl))
        tc.write_window(0, _t(k), _t(v), _t(tables), _t(offs), _t(wl))
        for name in ("k_pages", "k_scales", "v_pages", "v_scales"):
            np.testing.assert_array_equal(getattr(tc, name)[0].numpy(),
                                          np.asarray(getattr(jc, name)[0]), err_msg=name)
        assert tc.k_pages[0].abs().sum() > 0
