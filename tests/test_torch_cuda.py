"""The port's hand-written CUDA kernels against their plain PyTorch versions,
and the engine on the card against the engine on the CPU. Needs an NVIDIA
GPU with nvcc; elsewhere every test skips. Run on the card with
``python -m pytest -m cuda tests/test_torch_cuda.py``."""

import gc
import threading
import weakref

import numpy as np
import pytest
import torch

from adaptive_sd_tpu_torch.engine import TierEngine
from adaptive_sd_tpu_torch.engine import decode as D
from adaptive_sd_tpu_torch.models import TINY128, init_params_quantized
from adaptive_sd_tpu_torch.ops import _kernels
from adaptive_sd_tpu_torch.ops import attention as A
from adaptive_sd_tpu_torch.ops import matmul_q as MQ
from adaptive_sd_tpu_torch.ops.quant import quantize_int4, quantize_int8

pytestmark = pytest.mark.cuda

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("M,K,N", [(1, 256, 384), (4, 1000, 200), (7, 512, 4099), (300, 384, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_matmul_kernel_matches_plain(cuda, M, K, N, dtype):
    g = torch.Generator(device=cuda).manual_seed(M + K)
    t = quantize_int8(torch.randn(K, N, generator=g, device=cuda))
    x = torch.randn(M, K, generator=g, device=cuda).to(dtype)
    before = MQ.int8_matmul_counter.launches
    out = MQ.quantized_matmul(x, t.q, t.scale)
    ref = MQ.quantized_matmul_ref(x, t.q, t.scale)
    torch.cuda.synchronize()
    assert MQ.int8_matmul_counter.launches == before + 1
    # f32 sums in another order; bf16 outputs may differ by one rounding step
    tol = dict(rtol=1e-5, atol=1e-4) if dtype == torch.float32 else dict(rtol=1e-2, atol=2e-2)
    torch.testing.assert_close(out.float(), ref.float(), **tol)


# (M, K, N, group_size): decode and large M, ragged N and K, a group that
# straddles the two packed halves (K=384, gs=128), a group smaller than the
# kernel's K step (gs=32), and per-channel scales (gs=None)
_INT4_SHAPES = [
    (1, 256, 384, 128), (4, 1024, 512, 128), (4, 384, 200, 128), (7, 1000, 4099, None),
    (13, 768, 130, 32), (4, 4096, 256, 256), (4, 512, 256, None), (33, 384, 200, 128),
    (100, 512, 384, 128), (300, 1000, 130, None), (300, 768, 256, 32), (1100, 1024, 640, 128),
]


@pytest.mark.parametrize("M,K,N,gs", _INT4_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int4_matmul_kernel_matches_plain(cuda, M, K, N, gs, dtype):
    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    t = quantize_int4(torch.randn(K, N, generator=g, device=cuda), group_size=gs)
    x = torch.randn(M, K, generator=g, device=cuda).to(dtype)
    counter = MQ.int4g_matmul_counter if gs else MQ.int4_matmul_counter
    before = counter.launches
    out = MQ.quantized_matmul(x, t.q, t.scale, bits=4)
    ref = MQ.quantized_matmul_ref(x, t.q, t.scale, bits=4)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    # f32 sums in another order; bf16 outputs may differ by one rounding step
    tol = dict(rtol=1e-5, atol=1e-4) if dtype == torch.float32 else dict(rtol=1e-2, atol=2e-2)
    torch.testing.assert_close(out.float(), ref.float(), **tol)


def test_int4_matmul_offset_views(cuda):
    """Unaligned q and scale views take the kernel's scalar-load path."""
    g = torch.Generator(device=cuda).manual_seed(5)
    t = quantize_int4(torch.randn(512, 257, generator=g, device=cuda), group_size=128)
    q, scale = t.q[:, 1:], t.scale[:, 1:]
    x = torch.randn(4, 512, generator=g, device=cuda)
    out = MQ.quantized_matmul(x, q, scale, bits=4)
    ref = MQ.quantized_matmul_ref(x, q.contiguous(), scale.contiguous(), bits=4)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-4)


# decode and window M, ragged N and K (K not a multiple of 4 or 16, N not a
# multiple of 16), K split across blocks, several 128-row tiles
_W8A8_SHAPES = [
    (1, 256, 384), (4, 1000, 200), (7, 515, 4099), (13, 3584, 512), (16, 4096, 130),
    (17, 384, 256), (100, 1001, 203), (192, 3584, 512), (300, 2048, 384), (1100, 520, 640),
]


@pytest.mark.parametrize("M,K,N", _W8A8_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_w8a8_matmul_kernel_equals_plain(cuda, M, K, N, dtype):
    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    t = quantize_int8(torch.randn(K, N, generator=g, device=cuda))
    x = (torch.randn(M, K, generator=g, device=cuda) * 3).to(dtype)
    before = MQ.w8a8_matmul_counter.launches
    out = MQ.quantized_matmul_w8a8(x, t.q, t.scale)
    ref = MQ.quantized_matmul_w8a8_ref(x, t.q, t.scale)
    torch.cuda.synchronize()
    assert MQ.w8a8_matmul_counter.launches == before + 1
    # the integer sum is exact in any order: f32 outputs are equal bit for bit,
    # and so are their roundings to bf16
    assert torch.equal(out, ref), float((out.float() - ref.float()).abs().max())
    # and equal to the plain version on the CPU (int32 product, true division)
    on_cpu = MQ.quantized_matmul_w8a8_ref(x.cpu(), t.q.cpu(), t.scale.cpu())
    assert torch.equal(out.cpu(), on_cpu)


def test_w8a8_offset_view_and_zero_row(cuda):
    """An unaligned q view takes the scalar-load path; an all-zero row
    quantises with the floor scale and gives zeros."""
    g = torch.Generator(device=cuda).manual_seed(9)
    t = quantize_int8(torch.randn(512, 257, generator=g, device=cuda))
    q, scale = t.q[:, 1:], t.scale[1:]
    x = torch.randn(5, 512, generator=g, device=cuda)
    x[2] = 0
    out = MQ.quantized_matmul_w8a8(x, q, scale)
    ref = MQ.quantized_matmul_w8a8_ref(x, q.contiguous(), scale.contiguous())
    assert torch.equal(out, ref) and float(out[2].abs().max()) == 0.0


def _pages(g, n_kv, n_pages, page, D, dev):
    kq = torch.randint(-127, 128, (n_kv, n_pages, page, D), generator=g, device=dev,
                       dtype=torch.int8)
    vq = torch.randint(-127, 128, (n_kv, n_pages, page, D), generator=g, device=dev,
                       dtype=torch.int8)
    ks = torch.rand(n_kv, n_pages, 1, page, generator=g, device=dev) * 0.02 + 1e-3
    vs = torch.rand(n_kv, n_pages, 1, page, generator=g, device=dev) * 0.02 + 1e-3
    return kq, ks, vq, vs


@pytest.mark.parametrize("G,page", [(7, 128), (5, 128), (2, 16)])
def test_paged_decode_kernel_matches_plain(cuda, G, page):
    g = torch.Generator(device=cuda).manual_seed(G)
    B, n_kv, D, n_pages = 3, 2, 128, 12
    kp, ks, vp, vs = _pages(g, n_kv, n_pages, page, D, cuda)
    q = torch.randn(B, n_kv, G, D, generator=g, device=cuda)
    tables = torch.tensor([[3, 1, 7, 5, 2, 0, 4, 6, 8], [9, 10, 11, 0, 1, 2, 3, 4, 5],
                           [n_pages] * 9], dtype=torch.int32, device=cuda)
    lens = torch.tensor([min(1000, 9 * page), min(300, 9 * page), 1], dtype=torch.int32,
                        device=cuda)
    out = A.paged_attention(q, kp, ks, vp, vs, tables, lens, sm_scale=D ** -0.5)
    ref = A.paged_attention_ref(q, kp, ks, vp, vs, tables, lens, sm_scale=D ** -0.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("D", [40, 48, 64, 96])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,page", [(7, 128), (2, 16)])
def test_paged_decode_kernel_any_head_dim(cuda, D, dtype, G, page):
    """Head dims besides 128 (the rehearsal tiers' 48, 40 and 64, and 96):
    the kernel pads D to the MMA's k-step with zeros (40 is no multiple of
    16) and stores the D real columns."""
    g = torch.Generator(device=cuda).manual_seed(G + D)
    B, n_kv, n_pages = 3, 2, 12
    kp, ks, vp, vs = _pages(g, n_kv, n_pages, page, D, cuda)
    q = torch.randn(B, n_kv, G, D, generator=g, device=cuda).to(dtype)
    tables = torch.tensor([[3, 1, 7, 5, 2, 0, 4, 6, 8], [9, 10, 11, 0, 1, 2, 3, 4, 5],
                           [n_pages] * 9], dtype=torch.int32, device=cuda)
    lens = torch.tensor([min(1000, 9 * page), min(300, 9 * page), 1], dtype=torch.int32,
                        device=cuda)
    out = A.paged_attention(q, kp, ks, vp, vs, tables, lens, sm_scale=D ** -0.5)
    ref = A.paged_attention_ref(q, kp, ks, vp, vs, tables, lens, sm_scale=D ** -0.5)
    torch.cuda.synchronize()
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(out.float(), ref.float(), **tol)


@pytest.mark.parametrize("D", [40, 48, 64, 96])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,W", [(7, 33), (2, 150)])
def test_paged_window_kernel_any_head_dim(cuda, D, dtype, G, W):
    """The window kernel at head dims 40, 48, 64 and 96 against its plain version:
    windows over cached prefixes, a lane with padding rows, a parked lane."""
    g = torch.Generator(device=cuda).manual_seed(G + W + D)
    B, n_kv, page, n_pages = 3, 2, 128, 12
    kp, ks, vp, vs = _pages(g, n_kv, n_pages, page, D, cuda)
    offsets = torch.tensor([256, 37, 0], dtype=torch.int32, device=cuda)
    win = torch.tensor([W, W // 2, 1], dtype=torch.int32, device=cuda)
    q = torch.randn(B, n_kv, W * G, D, generator=g, device=cuda).to(dtype)
    tables = torch.tensor([[3, 1, 7, 5, 2], [9, 10, 11, 0, 4], [n_pages] * 5],
                          dtype=torch.int32, device=cuda)
    ctx = offsets + win
    out = A.paged_window_attention(q, kp, ks, vp, vs, tables, ctx, offsets, group=G,
                                   sm_scale=D ** -0.5)
    ref = A.paged_window_attention_ref(q, kp, ks, vp, vs, tables, ctx, offsets, group=G,
                                       sm_scale=D ** -0.5)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    for b in range(B):
        r = int(win[b]) * G
        torch.testing.assert_close(out[b, :, :r].float(), ref[b, :, :r].float(), **tol)


# (G, W, dtype, n_kv, offsets, window lengths): verify-sized windows over
# cached prefixes (a lane with padding rows, a parked lane); the pipeline's
# verify over a cached prefix (Qwen2.5-14B heads, 148 positions bucketed to
# 192 after 384 cached tokens); a 512-token prefill through the window path
# (7B heads in bf16, 14B heads in f32)
_WINDOW_SHAPES = [
    (7, 33, torch.float32, 2, (256, 37, 0), (33, 16, 1)),
    (5, 64, torch.float32, 2, (256, 37, 0), (64, 32, 1)),
    (2, 5, torch.float32, 2, (256, 37, 0), (5, 2, 1)),
    (5, 192, torch.float32, 8, (384,), (148,)),
    (5, 192, torch.bfloat16, 8, (384,), (148,)),
    (7, 512, torch.bfloat16, 4, (0,), (512,)),
    (5, 512, torch.float32, 8, (0,), (512,)),
]


@pytest.mark.parametrize("G,W,dtype,n_kv,offsets,wins", _WINDOW_SHAPES)
def test_paged_window_kernel_matches_plain(cuda, G, W, dtype, n_kv, offsets, wins):
    g = torch.Generator(device=cuda).manual_seed(G + W)
    B, D, page, n_pages = len(offsets), 128, 128, 12
    kp, ks, vp, vs = _pages(g, n_kv, n_pages, page, D, cuda)
    q = torch.randn(B, n_kv, W * G, D, generator=g, device=cuda).to(dtype)
    tables = torch.tensor([[3, 1, 7, 5, 2], [9, 10, 11, 0, 4], [n_pages] * 5][:B],
                          dtype=torch.int32, device=cuda)
    offsets = torch.tensor(offsets, dtype=torch.int32, device=cuda)
    win = torch.tensor(wins, dtype=torch.int32, device=cuda)
    ctx = offsets + win
    out = A.paged_window_attention(q, kp, ks, vp, vs, tables, ctx, offsets, group=G,
                                   sm_scale=D ** -0.5)
    ref = A.paged_window_attention_ref(q, kp, ks, vp, vs, tables, ctx, offsets, group=G,
                                       sm_scale=D ** -0.5)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    for b in range(B):
        r = int(win[b]) * G
        torch.testing.assert_close(out[b, :, :r].float(), ref[b, :, :r].float(), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_window_long_context_workspace(cuda, dtype, monkeypatch):
    """A window of 2048 positions over a 64-page table (contexts of 8048 and
    2048 tokens): the partials of every tile would take 1.9 GB, so the call
    runs as launches over ranges of row tiles whose workspace stays within
    WINDOW_WS_BYTES. The result matches the plain version on valid rows and
    equals, bit for bit, the same call in one launch with the whole
    workspace (tiles are independent)."""
    g = torch.Generator(device=cuda).manual_seed(11)
    B, n_kv, G, D, page, maxp, W = 2, 2, 7, 128, 128, 64, 2048
    n_pages = B * maxp
    kp, ks, vp, vs = _pages(g, n_kv, n_pages, page, D, cuda)
    tables = torch.randperm(n_pages, generator=g, device=cuda).view(B, maxp).to(torch.int32)
    offsets = torch.tensor([6000, 0], dtype=torch.int32, device=cuda)
    ctx = offsets + W
    q = torch.randn(B, n_kv, W * G, D, generator=g, device=cuda).to(dtype)
    args = (q, kp, ks, vp, vs, tables, ctx, offsets)
    n_tiles, tiles, _, ws, _ = A.window_plan(B, n_kv, W * G, maxp, D, A.window_rows())
    assert tiles < n_tiles and 4 * ws <= A.WINDOW_WS_BYTES
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    before = torch.cuda.memory_allocated(cuda)
    launches = A.paged_window_counter.launches
    out = A.paged_window_attention(*args, group=G, sm_scale=D ** -0.5)
    torch.cuda.synchronize()
    assert A.paged_window_counter.launches - launches == -(-n_tiles // tiles)
    # the output, the workspace and at most a fresh buffer of tile counters
    took = torch.cuda.max_memory_allocated(cuda) - before
    assert took <= out.numel() * out.element_size() + A.WINDOW_WS_BYTES + (1 << 20), took
    monkeypatch.setattr(A, "WINDOW_WS_BYTES", 1 << 40)
    assert A.window_plan(B, n_kv, W * G, maxp, D, A.window_rows())[1] == n_tiles
    assert torch.equal(A.paged_window_attention(*args, group=G, sm_scale=D ** -0.5), out)
    ref = A.paged_window_attention_ref(*args, group=G, sm_scale=D ** -0.5)
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(out.float(), ref.float(), **tol)


def _engine_on_card_matches_cpu(cuda, params, prefix_cache, monkeypatch, accept_all):
    """Greedy tokens and accepted counts of the engine on the card against the
    engine on the CPU. Over the prefix cache the verify window reads the INT8
    pages that decoding read, so each engine accepts its own output in full.
    Without it the verify pass attends exact K/V while the draft was decoded
    over INT8 K/V, so either engine may reject a token of its own; then the
    card must still reject where the CPU does, wherever the CPU's verify
    logits are not near a tie (top-2 gap above 1e-3 and above twice the
    engines' largest logit difference, about 2e-5 without the cache: f32 sums
    in another order)."""
    on_card = {k: v for k, v in params.items()}
    on_card["embed"] = params["embed"].to(cuda)
    on_card["final_norm"] = params["final_norm"].to(cuda)
    on_card["lm_head"] = params["lm_head"].to(cuda)
    on_card["layers"] = [{k: v.to(cuda) for k, v in layer.items()} for layer in params["layers"]]
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, TINY128.vocab_size, n)] for n in (37, 150, 300)]
    kw = dict(page_size=128, n_pages=32, enable_prefix_cache=prefix_cache)
    cpu = TierEngine(TINY128, params, device="cpu", **kw)
    gpu = TierEngine(TINY128, on_card, device=cuda, **kw)
    a, b = cpu.generate(prompts, max_new=16), gpu.generate(prompts, max_new=16)
    assert [o.token_ids.tolist() for o in a] == [o.token_ids.tolist() for o in b]
    drafts = [o.token_ids.tolist() for o in a]

    verify_logits = {}   # device type -> the verify pass's logits [B, draft + 1, V]
    real = D.logits_at

    def spy(p, spec, h):
        out = real(p, spec, h)
        verify_logits[h.device.type] = out.detach().float().cpu()
        return out

    monkeypatch.setattr(D, "logits_at", spy)
    n_cpu = [n for _, n in cpu.verify_continue(prompts, drafts, max_new=16)]
    n_card = [n for _, n in gpu.verify_continue(prompts, drafts, max_new=16)]
    lc, lg = verify_logits["cpu"][:3], verify_logits["cuda"][:3]
    # over the prefix cache a sum-order difference now and then moves an INT8
    # K/V value across a rounding boundary, which moves a logit by up to ~5e-3
    d = float((lc - lg).abs().max())
    assert d < (2e-2 if prefix_cache else 1e-3)
    tie = max(1e-3, 2 * d)                                # a flip needs a gap below 2 d
    top2 = torch.topk(lc, 2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]                     # [3, draft + 1]
    for i in range(3):
        decided = gap[i, : min(n_cpu[i] + 1, 16)]         # the positions n_acc depends on
        if float(decided.min()) > tie:
            assert n_card[i] == n_cpu[i], (i, n_card, n_cpu, decided.tolist())
    if accept_all:
        assert n_card == n_cpu == [16] * 3


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_engine_on_card_matches_cpu(cuda, prefix_cache, monkeypatch):
    """f32 TINY128 weights: the kernels' engine gives the plain engine's tokens,
    and with these INT8 weights both accept in full in either mode."""
    params = init_params_quantized(TINY128, 0, device="cpu", dtype=torch.float32)
    _engine_on_card_matches_cpu(cuda, params, prefix_cache, monkeypatch, accept_all=True)


@pytest.mark.parametrize("prefix_cache", [False, True])
@pytest.mark.parametrize("group_size", [128, None])
def test_int4_engine_on_card_matches_cpu(cuda, group_size, prefix_cache, monkeypatch):
    """The same with INT4 weights, grouped and per-channel, with and without
    the prefix cache (without it the verify window of 4 x 320 rows goes
    through the large-M kernel)."""
    params = init_params_quantized(TINY128, 0, device="cpu", dtype=torch.float32, bits=4,
                                   group_size=group_size)
    _engine_on_card_matches_cpu(cuda, params, prefix_cache, monkeypatch,
                                accept_all=prefix_cache)


def _on_card(params, cuda):
    out = {k: v.to(cuda) for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: v.to(cuda) for k, v in layer.items()} for layer in params["layers"]]
    return out


def _scheduler_walk(engine, tight):
    """Plain requests, then their own outputs as drafts over the prefix cache,
    then two long lanes in a 4-page pool under swap preemption."""
    from adaptive_sd_tpu_torch.engine import ContinuousBatchingScheduler

    rng = np.random.default_rng(4)
    prompts = [[int(t) for t in rng.integers(1, TINY128.vocab_size, n)] for n in (37, 150, 300)]
    sched = ContinuousBatchingScheduler(engine, max_batch=4, max_context=512, scan_steps=4)
    plain = [sched.submit(p, max_new=16) for p in prompts]
    sched.run_until_idle()
    drafted = [sched.submit(p, max_new=16, draft=r.out_tokens) for p, r in zip(prompts, plain)]
    sched.run_until_idle()
    long_prompts = [[int(t) for t in rng.integers(1, TINY128.vocab_size, n)] for n in (120, 100)]
    runs = []
    for eng in (engine, tight):
        s = ContinuousBatchingScheduler(eng, max_batch=2, max_context=512, scan_steps=4,
                                        preemption_mode="swap")
        reqs = [s.submit(p, max_new=140) for p in long_prompts]
        s.run_until_idle()
        assert all(r.done and r.error is None for r in reqs)
        runs.append(([r.out_tokens for r in reqs], s.preemptions, s.swap_preemptions))
    assert all(r.error is None for r in plain + drafted)
    return {"plain": [r.out_tokens for r in plain], "n_accepted": [r.n_accepted for r in drafted],
            "n_reused": [r.n_reused for r in drafted], "roomy": runs[0], "tight": runs[1],
            "prompts": prompts}


def _teacher_forced_logprobs(engine, prompts, drafts):
    """One dense verify admission of [prompt + draft] rows: the logprobs the
    engine gives the draft tokens, whatever it would have chosen itself."""
    n, d = len(prompts), len(drafts[0])
    tokens = np.zeros((4, 512), np.int32)
    p_lens, t_lens = np.ones(4, np.int32), np.ones(4, np.int32)
    tables = np.full((4, 4), engine.allocator.n_pages, np.int32)
    rids = [f"forced_{i}" for i in range(n)]
    try:
        for i, (p, dr) in enumerate(zip(prompts, drafts)):
            tokens[i, : len(p) + d] = list(p) + list(dr)
            p_lens[i], t_lens[i] = len(p), len(p) + d
            tables[i] = engine.allocator.alloc(rids[i], 4)
        dlp = engine.verify_admit_sample_batch(tokens, p_lens, t_lens, tables,
                                               np.zeros(4, np.float32), 0, max_draft=d)[3]
    finally:
        for r in rids:
            engine.allocator.free_request(r)
    return dlp[:n]


@pytest.mark.parametrize("act_quant", [False, True])
def test_scheduler_on_card_matches_cpu(cuda, act_quant):
    """ContinuousBatchingScheduler over f32 TINY128 engines on the card and on
    the CPU. Host-side counts are equal, each device accepts its own drafts
    in full over the prefix cache, and a swap-preempted run equals the
    unpressured one on the same device. Weight-only engines also give the
    CPU's tokens; W8A8 re-rounds every activation, so there the two devices'
    greedy walks may part at a near-tie: there their first tokens are held to
    each other, and on the CPU's tokens (teacher-forced) the card's logprobs
    to the CPU's at 0.08, twice what an NVIDIA H100 80GB HBM3 measured;
    weight-only engines at 1e-3, as the CPU tests hold the engines to JAX."""
    params = init_params_quantized(TINY128, 7, device="cpu", dtype=torch.float32)
    kw = dict(page_size=128, enable_prefix_cache=True, act_quant=act_quant)
    walks, roomy = {}, {}
    for where, prm, device in (("cpu", params, "cpu"), ("card", _on_card(params, cuda), cuda)):
        roomy[where] = TierEngine(TINY128, prm, device=device, n_pages=32, **kw)
        walks[where] = _scheduler_walk(
            roomy[where], TierEngine(TINY128, prm, device=device, n_pages=4, **kw))
    cpu, card = walks["cpu"], walks["card"]
    forced = {where: _teacher_forced_logprobs(e, cpu["prompts"], cpu["plain"])
              for where, e in roomy.items()}
    assert np.abs(forced["cpu"] - forced["card"]).max() <= (0.08 if act_quant else 1e-3)
    before = MQ.w8a8_matmul_counter.launches
    for w in (cpu, card):
        assert w["n_accepted"] == [16, 16, 16] and w["n_reused"] == [0, 128, 256]
        assert w["tight"][0] == w["roomy"][0]                  # swap restore is bit-exact
        assert w["roomy"][1:] == (0, 0) and w["tight"][1] >= 1 and w["tight"][2] >= 1
    assert card["tight"][1:] == cpu["tight"][1:]
    if act_quant:
        assert before > 0
        assert [t[0] for t in card["plain"]] == [t[0] for t in cpu["plain"]]
    else:
        assert card["plain"] == cpu["plain"]
        assert [t[:32] for t in card["roomy"][0]] == [t[:32] for t in cpu["roomy"][0]]


# Tile edges of the tensor-core matmul kernels: decode tiles of 8 and 16
# tokens (W8A8: 16 rows) up to M = 16; above, the INT8 and INT4 wgmma window
# tiles of 128 tokens (64 for INT4 f32), the mma.sync window tiles of 64 and
# 128 rows, W8A8's 128-row tiles, every partial tile, and a ragged M past
# the largest prefill.
_EDGE_M = [1, 2, 7, 8, 9, 15, 16, 17, 63, 64, 65, 127, 128, 129, 255, 257, 300, 2304, 2311]
# Window rows held bit for bit against the whole batch's: the edges above M =
# 16, from row 5
_WINDOW_ROWS = [slice(5, 5 + m) for m in _EDGE_M if m > 16]
# the matmul tolerance of chip_smoke.py (MM_TOL): f32 sums in another order,
# bf16 outputs rounded once
_MM_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4), torch.bfloat16: dict(rtol=1e-2, atol=2e-2)}


def _f64_sum(x, q, scale, bits):
    """The weight-only matmul's math in f64: x, the integer weights and the
    f32 scales as doubles; grouped INT4 as each group's sub-dot times its
    scale."""
    from adaptive_sd_tpu_torch.ops.quant import unpack_int4

    w = (unpack_int4(q) if bits == 4 else q).double()
    x64 = x.double()
    if scale.ndim == 2:
        gs = w.shape[0] // scale.shape[0]
        return sum((x64[:, a:a + gs] @ w[a:a + gs]) * scale[a // gs].double()[None]
                   for a in range(0, w.shape[0], gs))
    return (x64 @ w) * scale.double()[None, :]


def _f64_ref(x, q, scale, bits):
    """:func:`_f64_sum` rounded once to f32. At the large tile-edge shapes the plain
    version's f32 ``torch.matmul`` strays from this sum by up to 4.5e-4 where
    the kernels stay within 1.0e-4 (scripts/torch_f32_sum_probe.py), so the
    f32 cases there are held against it."""
    return _f64_sum(x, q, scale, bits).float()


def _tile_edge_ref(x, q, scale, bits):
    """The reference of the tile-edge tests: the f64 sum for f32 x, the
    plain version for bf16 x (its outputs are rounded to bf16)."""
    if x.dtype == torch.float32:
        return _f64_ref(x, q, scale, bits)
    return MQ.quantized_matmul_ref(x, q, scale, bits=bits)


@pytest.mark.parametrize("M", _EDGE_M)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int4_matmul_tile_edges(cuda, M, dtype):
    """A group that straddles the packed halves (K = 384, gs = 128) with
    ragged N, ragged K (K/2 = 500) per-channel, an aligned grouped shape
    that splits K at small M, aligned ragged N and K (the wgmma window tile's
    partial column block and last stage), and groups of 96 rows, whose
    boundaries fall inside K splits and between stages."""
    for K, N, gs in ((384, 200, 128), (1000, 130, None), (4096, 512, 128), (2000, 4112, None),
                     (3072, 512, 96)):
        g = torch.Generator(device=cuda).manual_seed(M + K + N)
        t = quantize_int4(torch.randn(K, N, generator=g, device=cuda), group_size=gs)
        x = torch.randn(M, K, generator=g, device=cuda).to(dtype)
        out = MQ.quantized_matmul(x, t.q, t.scale, bits=4)
        ref = _tile_edge_ref(x, t.q, t.scale, 4)
        torch.testing.assert_close(out.float(), ref.float(), **_MM_TOL[dtype])


def _offset(t: torch.Tensor, shift: int) -> torch.Tensor:
    """A contiguous view of t's values whose data pointer is `shift` elements
    past an aligned allocation (no 16-byte alignment)."""
    buf = torch.empty(t.numel() + shift, dtype=t.dtype, device=t.device)
    view = buf[shift:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("M", [4, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int4_matmul_unaligned_x_and_q(cuda, M, dtype):
    """x and q at unaligned addresses take the kernel's element-wise staging."""
    g = torch.Generator(device=cuda).manual_seed(M)
    t = quantize_int4(torch.randn(512, 256, generator=g, device=cuda), group_size=128)
    x = _offset(torch.randn(M, 512, generator=g, device=cuda).to(dtype), 1)
    q = _offset(t.q, 3)
    out = MQ.quantized_matmul(x, q, t.scale, bits=4)
    ref = MQ.quantized_matmul_ref(x, q, t.scale, bits=4)
    torch.testing.assert_close(out.float(), ref.float(), **_MM_TOL[dtype])


@pytest.mark.parametrize("M", range(1, 17))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gs", [128, None])
def test_int4_decode_at_every_m(cuda, M, dtype, gs):
    """Every M of the INT4 decode tiles (8 and 16 tokens), K split across
    blocks and added by the tile's last block, within MM_TOL of the plain
    version (f32: of the f64 sum, as at the tile edges); and the last row
    equal bit for bit to the same row alone (one sum order at every M)."""
    g = torch.Generator(device=cuda).manual_seed(M)
    t = quantize_int4(torch.randn(5120, 7168, generator=g, device=cuda), group_size=gs)
    x = torch.randn(M, 5120, generator=g, device=cuda).to(dtype)
    assert MQ._int4_plan(M, 7168, 5120, gs or 0, 132)[1] > 1
    out = MQ.quantized_matmul(x, t.q, t.scale, bits=4)
    torch.testing.assert_close(out.float(), _tile_edge_ref(x, t.q, t.scale, 4).float(),
                               **_MM_TOL[dtype])
    assert torch.equal(MQ.quantized_matmul(x[M - 1:], t.q, t.scale, bits=4), out[M - 1:])


@pytest.mark.parametrize("M", range(1, 17))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_w8a8_equal_at_every_decode_m(cuda, M, dtype):
    """Every M of the 16-row tile, K split across blocks (integer atomics)."""
    g = torch.Generator(device=cuda).manual_seed(M)
    t = quantize_int8(torch.randn(3584, 512, generator=g, device=cuda))
    x = (torch.randn(M, 3584, generator=g, device=cuda) * 3).to(dtype)
    assert MQ._w8a8_plan(M, 512, 3584, 132)[1] > 1
    out = MQ.quantized_matmul_w8a8(x, t.q, t.scale)
    assert torch.equal(out, MQ.quantized_matmul_w8a8_ref(x, t.q, t.scale))


@pytest.mark.parametrize("M", _EDGE_M)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_w8a8_tile_edges(cuda, M, dtype):
    """Ragged K and N at every tile edge, and an unaligned q."""
    g = torch.Generator(device=cuda).manual_seed(M)
    for K, N in ((515, 4099), (1024, 256)):
        t = quantize_int8(torch.randn(K, N, generator=g, device=cuda))
        x = (torch.randn(M, K, generator=g, device=cuda) * 3).to(dtype)
        for q in (t.q, _offset(t.q, 5)):
            out = MQ.quantized_matmul_w8a8(x, q, t.scale)
            assert torch.equal(out, MQ.quantized_matmul_w8a8_ref(x, q, t.scale)), (K, N)


@pytest.mark.parametrize("kernel", ["int4", "w8a8", "int8", "paged_decode", "paged_window"])
def test_two_streams_give_the_sequential_results(cuda, kernel):
    """Two calls at once on two streams (their split-K or split workspaces
    are the calls' own, their tile counters the streams' own) give the
    results of two calls in sequence, the matmuls at decode and window M."""
    g = torch.Generator(device=cuda).manual_seed(11)
    K, N = 5120, 7168
    if kernel == "int4":
        t = quantize_int4(torch.randn(K, N, generator=g, device=cuda), group_size=128)
        fn = lambda x: MQ.quantized_matmul(x, t.q, t.scale, bits=4)  # noqa: E731
    elif kernel in ("w8a8", "int8"):
        t = quantize_int8(torch.randn(K, N, generator=g, device=cuda))
        fn = ((lambda x: MQ.quantized_matmul_w8a8(x, t.q, t.scale)) if kernel == "w8a8"
              else (lambda x: MQ.int8_matmul_cuda(x, t.q, t.scale)))
    if kernel == "paged_decode":
        n_kv, D, page, n_pages = 8, 128, 128, 64
        pages = _pages(g, n_kv, n_pages, page, D, cuda)
        tables = torch.randperm(n_pages, generator=g, device=cuda)[:32].to(torch.int32)
        fn = lambda x: A.paged_attention(  # noqa: E731
            x, *pages, tables.view(4, 8), torch.tensor([900, 1, 300, 1024], dtype=torch.int32,
                                                       device=cuda), sm_scale=D ** -0.5)
        xs = [torch.randn(4, n_kv, G, D, generator=g, device=cuda) for G in (5, 7, 8)]
    elif kernel == "paged_window":
        n_kv, D, page, n_pages = 8, 128, 128, 64
        pages = _pages(g, n_kv, n_pages, page, D, cuda)
        tables = torch.randperm(n_pages, generator=g, device=cuda)[:32].to(torch.int32)
        offs = torch.tensor([800, 0, 300, 900], dtype=torch.int32, device=cuda)
        ctx = offs + torch.tensor([100, 1, 64, 24], dtype=torch.int32, device=cuda)
        fn = lambda x: A.paged_window_attention(  # noqa: E731
            x, *pages, tables.view(4, 8), ctx, offs, group=5, sm_scale=D ** -0.5)
        xs = [torch.randn(4, n_kv, W * 5, D, generator=g, device=cuda) for W in (24, 64, 100)]
    else:  # decode, a window whose K splits run in blocks of their own, one in turn
        xs = [torch.randn(M, K, generator=g, device=cuda) for M in (4, 8, 64, 300)]
    want = [fn(x) for x in xs]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in range(2)]
    for _ in range(3):
        outs = [[], []]
        for s in streams:
            s.wait_stream(torch.cuda.current_stream())
        for x in xs:
            for i, s in enumerate(streams):
                with torch.cuda.stream(s):
                    outs[i].append(fn(x))
        torch.cuda.synchronize()
        for o in outs:
            for a, b in zip(o, want):
                assert torch.equal(a, b)


@pytest.mark.parametrize("kernel", ["int8", "int4", "paged_decode", "paged_window"])
def test_split_counters_are_left_zero(cuda, kernel):
    """The INT8 and INT4 decode tiles and the paged decode and window kernels
    find a tile's last block with the stream's tile counters, which that
    block returns to 0: after calls of every split count the buffer is zero
    again, and a call repeated many times gives the first call's result."""
    g = torch.Generator(device=cuda).manual_seed(12)
    if kernel == "int8":
        t = quantize_int8(torch.randn(5120, 7168, generator=g, device=cuda))
        x = torch.randn(4, 5120, generator=g, device=cuda)
        assert MQ._int8_plan(7168, 5120, 132)[0] > 1
        fn = lambda: MQ.int8_matmul_cuda(x, t.q, t.scale)  # noqa: E731
    elif kernel == "int4":
        t = quantize_int4(torch.randn(5120, 7168, generator=g, device=cuda), group_size=128)
        x = torch.randn(4, 5120, generator=g, device=cuda).to(torch.bfloat16)
        assert MQ._int4_plan(4, 7168, 5120, 128, 132)[1] > 1
        fn = lambda: MQ.int4_matmul_cuda(x, t.q, t.scale)  # noqa: E731
    else:
        n_kv, D, page, n_pages = 8, 128, 128, 64
        pages = _pages(g, n_kv, n_pages, page, D, cuda)
        tables = torch.randperm(n_pages, generator=g, device=cuda)[:32].to(torch.int32)
        lens = torch.tensor([900, 1, 300, 1024], dtype=torch.int32, device=cuda)
        if kernel == "paged_decode":
            q = torch.randn(4, n_kv, 5, D, generator=g, device=cuda)
            fn = lambda: A.paged_attention(q, *pages, tables.view(4, 8), lens,  # noqa: E731
                                           sm_scale=D ** -0.5)
        else:  # windows of 100, 1, 64 and 24 positions ending at the same lengths
            offs = lens - torch.tensor([100, 1, 64, 24], dtype=torch.int32, device=cuda)
            q = torch.randn(4, n_kv, 100 * 5, D, generator=g, device=cuda)
            fn = lambda: A.paged_window_attention(  # noqa: E731
                q, *pages, tables.view(4, 8), lens, offs, group=5, sm_scale=D ** -0.5)
    first = fn()
    for _ in range(20):
        assert torch.equal(fn(), first)
    key = (torch.cuda.current_device(), torch.cuda.current_stream(cuda).cuda_stream)
    torch.cuda.synchronize()
    assert not _kernels._tile_counters[key].any()


@pytest.mark.parametrize("gs", [128, None])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int4_row_results_do_not_depend_on_m(cuda, gs, dtype):
    """A row's output is the same bit for bit whether it is computed in a
    decode tile (8 or 16 tokens, K split across blocks) or a window tile of
    any M (splits in turn, or in blocks of their own at small M): all sum a
    row in one order, so decode and verify agree. Rows also at the window
    tiles' edges (M = 17 to 2311)."""
    g = torch.Generator(device=cuda).manual_seed(3)
    K, N = 5120, 7168
    t = quantize_int4(torch.randn(K, N, generator=g, device=cuda), group_size=gs)
    x = torch.randn(2400, K, generator=g, device=cuda).to(dtype)
    assert MQ._int4_plan(1, N, K, gs or 0, 132)[1] > 1
    full = MQ.quantized_matmul(x, t.q, t.scale, bits=4)
    rows = [slice(0, 1), slice(5, 9), slice(3, 12), slice(100, 116), slice(17, 81)]
    for r in rows + _WINDOW_ROWS:
        assert torch.equal(MQ.quantized_matmul(x[r], t.q, t.scale, bits=4), full[r]), r


@pytest.mark.parametrize("M", _EDGE_M)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_matmul_tile_edges(cuda, M, dtype):
    """Every tile edge of the INT8 kernel (decode tiles of 8 and 16 tokens,
    the wgmma window tile of 128 tokens, the mma.sync window tiles of 64 and
    128 rows) with ragged N and K (element-wise staging), aligned ragged N
    and K (the wgmma tile's partial column block and last stage), and an
    aligned shape whose K is split across blocks."""
    for K, N in ((1000, 130), (515, 4099), (4096, 512), (1000, 4112)):
        g = torch.Generator(device=cuda).manual_seed(M + K + N)
        t = quantize_int8(torch.randn(K, N, generator=g, device=cuda))
        x = torch.randn(M, K, generator=g, device=cuda).to(dtype)
        out = MQ.int8_matmul_cuda(x, t.q, t.scale)
        ref = _tile_edge_ref(x, t.q, t.scale, 8)
        torch.testing.assert_close(out.float(), ref.float(), **_MM_TOL[dtype])


# The f32 cases that failed against the plain version: (kernel, M, K, N, group size)
_F32_EDGE_CASES = [("int4", 255, 2000, 4112, None), ("int4", 2304, 2000, 4112, None),
                   ("int4", 2311, 2000, 4112, None), ("int4", 2311, 4096, 512, 128),
                   ("int4", 2304, 3072, 512, 96), ("int8", 2311, 1000, 4112, None),
                   ("int8", 2311, 4096, 512, None)]


@pytest.mark.parametrize("kernel,M,K,N,gs", _F32_EDGE_CASES)
def test_f32_kernel_strays_less_than_the_plain_version(cuda, kernel, M, K, N, gs):
    """At the tile-edge tests' data, the kernel's f32 output against the f64
    sum of the same operands: no output past MM_TOL, and a largest error no
    larger than the plain version's f32 torch.matmul (margin 1x; measured 0.11
    to 0.26x of it here): the tensor cores' 16-product sums, folded with
    round-to-nearest f32 every 32 rows, lose less than one f32 product summed
    over K in one chain does."""
    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    w = torch.randn(K, N, generator=g, device=cuda)
    t = quantize_int4(w, group_size=gs) if kernel == "int4" else quantize_int8(w)
    x = torch.randn(M, K, generator=g, device=cuda)
    bits = 4 if kernel == "int4" else 8
    out = MQ.quantized_matmul(x, t.q, t.scale, bits=bits)
    plain = MQ.quantized_matmul_ref(x, t.q, t.scale, bits=bits)
    exact = _f64_sum(x, t.q, t.scale, bits)
    err = (out.double() - exact).abs()
    assert not (err > 1e-4 + 1e-4 * exact.abs()).any()
    assert float(err.max()) <= float((plain.double() - exact).abs().max())


@pytest.mark.parametrize("M", [4, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_matmul_unaligned_x_and_q(cuda, M, dtype):
    """x and q at unaligned addresses, and an offset view of q and scale,
    take the kernel's element-wise staging."""
    g = torch.Generator(device=cuda).manual_seed(M)
    t = quantize_int8(torch.randn(512, 257, generator=g, device=cuda))
    x = _offset(torch.randn(M, 512, generator=g, device=cuda).to(dtype), 1)
    for q, scale in ((_offset(t.q, 3), t.scale), (t.q[:, 1:], t.scale[1:])):
        out = MQ.int8_matmul_cuda(x, q, scale)
        ref = MQ.quantized_matmul_ref(x, q.contiguous(), scale.contiguous())
        torch.testing.assert_close(out.float(), ref.float(), **_MM_TOL[dtype])


@pytest.mark.parametrize("kernel", ["int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_rows_equal_decode_rows_at_tile_edges(cuda, kernel, dtype):
    """At the tile-edge shapes (ragged N and K, aligned or not; INT4 groups
    of 96 rows and a group that straddles the packed halves), a window of
    2311 rows gives every row the bits of the decode tiles, 16 rows at a
    time: the window tiles' sums are the decode tiles', so where the f32
    sums stray from the plain version (the tensor cores' truncating adds),
    decode strays alike."""
    shapes = ({"int8": ((1000, 4112, None), (4096, 512, None), (1000, 130, None)),
               "int4": ((2000, 4112, None), (3072, 512, 96), (384, 200, 128))})[kernel]
    for K, N, gs in shapes:
        g = torch.Generator(device=cuda).manual_seed(K + N)
        w = torch.randn(K, N, generator=g, device=cuda)
        t = quantize_int8(w) if kernel == "int8" else quantize_int4(w, group_size=gs)
        bits = 8 if kernel == "int8" else 4
        x = torch.randn(2311, K, generator=g, device=cuda).to(dtype)
        window = MQ.quantized_matmul(x, t.q, t.scale, bits=bits)
        decode = torch.cat([MQ.quantized_matmul(x[i:i + 16], t.q, t.scale, bits=bits)
                            for i in range(0, x.shape[0], 16)])
        assert torch.equal(window, decode), (K, N, gs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_row_results_do_not_depend_on_m(cuda, dtype):
    """A row's output is the same bit for bit whether it is computed in a
    decode tile (8 or 16 tokens, K split across blocks) or a window tile of
    any M: all sum a row in one order, so decode and verify agree. Rows are
    taken at M = 1, 4, 9-16, 64, 300 and 600, and at the window tiles' edges
    (M = 17 to 2311; the kernel takes every M)."""
    g = torch.Generator(device=cuda).manual_seed(3)
    K, N = 5120, 7168
    t = quantize_int8(torch.randn(K, N, generator=g, device=cuda))
    x = torch.randn(2400, K, generator=g, device=cuda).to(dtype)
    assert MQ._int8_plan(N, K, 132)[0] > 1
    full = MQ.quantized_matmul(x, t.q, t.scale)
    rows = [slice(0, 1), slice(5, 9), slice(3, 12), slice(100, 116), slice(17, 81), slice(0, 300),
            slice(0, 600)]
    rows += [slice(a, a + m) for a, m in ((20, 9), (40, 13))] + _WINDOW_ROWS
    for r in rows:
        assert torch.equal(MQ.quantized_matmul(x[r], t.q, t.scale), full[r]), r


@pytest.mark.parametrize("W", [5, 70])
@pytest.mark.parametrize("G", [5, 7, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_row_equals_window_row(cuda, G, dtype, W):
    """A query row's decode output equals, bit for bit, the window kernel's
    output for the same query position: both walk the same page splits with
    the same split body (a row's MMA column gives it the same bits in any
    n-tile) and merge them in the same order. Contexts on both sides of split
    boundaries, one long enough for many splits, and a lane parked on the
    sentinel page; the window holds the row among others (positions before
    and after it): in a window of 5, or in one of 70 spread over several row
    tiles, where the row's G query heads straddle two tiles (G = 5, 7)."""
    _decode_row_equals_window_row(cuda, G, dtype, W, 128)


@pytest.mark.parametrize("D", [40, 48])
@pytest.mark.parametrize("W", [5, 70])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_row_equals_window_row_any_head_dim(cuda, dtype, W, D):
    """The same bits from both kernels at the zero-padded head dims 40 and 48
    (G = 7: a row's heads straddle two row tiles in the window of 70)."""
    _decode_row_equals_window_row(cuda, 7, dtype, W, D)


def _decode_row_equals_window_row(cuda, G, dtype, W, D):
    g = torch.Generator(device=cuda).manual_seed(G + W + (D != 128) * D)
    n_kv, page, n_pages, maxp = 2, 128, 80, 34
    kp, ks, vp, vs = _pages(g, n_kv, n_pages, page, D, cuda)
    lens = [127, 128, 129, 1000, 4100, 1]
    B = len(lens)
    tables = torch.randint(0, n_pages, (B, maxp), generator=g, device=cuda, dtype=torch.int32)
    tables[-1] = n_pages  # parked lane: every page index clamps to the last page
    seq = torch.tensor(lens, dtype=torch.int32, device=cuda)
    q = torch.randn(B, n_kv, G, D, generator=g, device=cuda).to(dtype)
    dec = A.paged_attention(q, kp, ks, vp, vs, tables, seq, sm_scale=D ** -0.5)
    # the row of interest at w = 2, or where its heads cross the first row tile
    at = 2 if W == 5 else -(-A.window_rows() // G) - 1
    offsets = (seq - 1 - at).clamp(min=0)
    wi = seq - 1 - offsets
    qw = torch.randn(B, n_kv, W, G, D, generator=g, device=cuda).to(dtype)
    qw[torch.arange(B), :, wi.long()] = q
    ctx = offsets + W
    win = A.paged_window_attention(qw.reshape(B, n_kv, W * G, D), kp, ks, vp, vs, tables, ctx,
                                   offsets, group=G, sm_scale=D ** -0.5)
    win = win.reshape(B, n_kv, W, G, D)[torch.arange(B), :, wi.long()]
    assert torch.equal(dec, win), float((dec.float() - win.float()).abs().max())
    ref = A.paged_attention_ref(q, kp, ks, vp, vs, tables, seq, sm_scale=D ** -0.5)
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(dec.float(), ref.float(), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_rows_do_not_depend_on_batch(cuda, dtype):
    """RMSNorm gives a row the same bits in a batch of any size (PyTorch's
    row reduction sums fewer than 16 rows in another order): a decode step's
    norms equal a verify window's."""
    from adaptive_sd_tpu_torch.models.qwen import rms_norm

    g = torch.Generator(device=cuda).manual_seed(8)
    for H in (3584, 5120):
        x = (torch.randn(300, H, generator=g, device=cuda) * 3).to(dtype)
        w = torch.rand(H, generator=g, device=cuda).to(dtype)
        full = rms_norm(x, w, 1e-6)
        for M in (1, 2, 4, 7, 8, 15, 16, 17, 64):
            assert torch.equal(rms_norm(x[:M], w, 1e-6), full[:M]), (H, M)


@pytest.mark.parametrize("bits", [8, 4])
def test_load_params_on_card_equals_quantize_model(cuda, bits, tmp_path):
    """A BF16 checkpoint written by the port, loaded on the card: every
    QuantizedTensor equals ``quantize_model`` of the same weights upcast to
    f32, on the card, bit for bit; the float leaves keep their bf16 values."""
    from adaptive_sd_tpu_torch.models import init_params, loader
    from adaptive_sd_tpu_torch.models.qwen import fuse_projections, quantize_model

    params = init_params(TINY128, 5, torch.bfloat16, device=cuda)
    f32 = {k: v.float() for k, v in params.items() if k != "layers"}
    f32["layers"] = [{k: v.float() for k, v in la.items()} for la in params["layers"]]
    loader.save_checkpoint(f32, TINY128, str(tmp_path))  # f32 tensors, then rewrite as bf16
    tensors = loader.load_safetensors(tmp_path / "model.safetensors")
    loader.save_safetensors({k: v.bfloat16() for k, v in tensors.items()},
                            tmp_path / "model.safetensors")
    got = loader.load_params(str(tmp_path), TINY128, bits=bits, device=cuda)
    want = quantize_model(fuse_projections(f32), bits=bits)
    for li, (g_, w_) in enumerate(zip(got["layers"], want["layers"])):
        for k in ("qkv_proj", "gateup_proj", "o_proj", "down_proj"):
            assert g_[k].q.is_cuda and torch.equal(g_[k].q, w_[k].q), (li, k)
            assert torch.equal(g_[k].scale, w_[k].scale), (li, k)
        assert torch.equal(g_["input_norm"], params["layers"][li]["input_norm"])
    assert torch.equal(got["lm_head"].q, want["lm_head"].q)
    assert torch.equal(got["embed"], params["embed"])


# ---------------------------------------------------------------------------
# CUDA graphs of the decode loops (engine/graphs.py): a graphed engine against
# the same engine without capture (``cuda_graphs=False``), bit for bit

_COUNTERS = {"int8": MQ.int8_matmul_counter, "int4": MQ.int4_matmul_counter,
             "int4g": MQ.int4g_matmul_counter, "w8a8": MQ.w8a8_matmul_counter,
             "paged_decode": A.paged_decode_counter, "paged_window": A.paged_window_counter}


def _counted(fn):
    """(fn(), launches by kernel during the call)."""
    before = {k: c.launches for k, c in _COUNTERS.items()}
    out = fn()
    torch.cuda.synchronize()
    return out, {k: c.launches - before[k] for k, c in _COUNTERS.items()}


def _graph_pair(cuda, seed=2, **kw):
    """Two engines over the same TINY128 weights on the card: graphed, eager."""
    params = _on_card(init_params_quantized(TINY128, seed, device="cpu", dtype=torch.float32),
                      cuda)
    return tuple(TierEngine(TINY128, params, device=cuda, page_size=128, n_pages=32,
                            cuda_graphs=graphs, **kw) for graphs in (True, False))


def _gen_rows(outs):
    return [(o.token_ids.tolist(), o.logprobs.tobytes(),
             None if o.topk_ids is None else (o.topk_ids.tobytes(), o.topk_probs.tobytes()))
            for o in outs]


@pytest.mark.parametrize("prefix_cache", [False, True])
@pytest.mark.parametrize("temperature,topk", [(0.0, 0), (0.8, 4)])
def test_graphed_generate_and_verify_equal_eager(cuda, prefix_cache, temperature, topk):
    """``generate`` then ``verify_continue`` of its drafts (the exact
    stochastic rule at T > 0), twice on each engine in turn (graphed,
    eager, graphed, eager: the first graphed run captures, the second only
    replays; over the prefix cache the second runs hit it): tokens,
    logprobs, top-K supports, accepted counts and launch counts are equal,
    with a lane stopping at eos."""
    graphed, eager = _graph_pair(cuda, enable_prefix_cache=prefix_cache)
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(1, TINY128.vocab_size, n)] for n in (37, 150, 300)]
    probe = eager.generate(prompts, max_new=24)
    graphed.eos_id = eager.eos_id = int(probe[0].token_ids[5])
    runs = {}
    for i, eng in enumerate((graphed, eager, graphed, eager)):
        kw = dict(max_new=24, temperature=temperature, seed=3 + i // 2, return_topk=topk)
        outs, n_gen = _counted(lambda: eng.generate(prompts, **kw))
        drafts = [o.token_ids[:10].tolist() for o in outs]
        dq = ([(o.logprobs[:10], o.topk_ids[:10], o.topk_probs[:10]) for o in outs]
              if topk else None)
        ver, n_ver = _counted(lambda: eng.verify_continue(prompts, drafts, draft_q=dq, **kw))
        runs.setdefault(i // 2, []).append(
            (_gen_rows(outs), _gen_rows([o for o, _ in ver]), [n for _, n in ver], n_gen, n_ver))
    for first, second in runs.values():
        assert first == second
    # generate and verify_continue share a bucket where their shapes agree
    assert graphed.loops.stats()["captures"] >= 1 and graphed.loops.stats()["replays"] > 0
    assert eager.loops.stats()["captures"] == 0
    if temperature == 0.0:
        assert min(len(r[0]) for r in runs[0][0][0]) < 24           # eos stopped a lane


def test_graphed_scan_equals_eager(cuda):
    """Chained carry scans and the host-array scan with a parked lane, a
    lane that samples eos mid-scan, a T > 0 lane and top-K supports: tokens,
    logprobs, emitted counts, supports, the carry and launch counts equal."""
    graphed, eager = _graph_pair(cuda, seed=4)
    rng = np.random.default_rng(4)
    lens = np.array([37, 150, 300, 1], np.int32)
    toks = np.zeros((4, 320), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(1, TINY128.vocab_size, n)
    tables = np.full((4, 4), 32, np.int32)
    for i in range(3):
        tables[i] = np.arange(4 * i, 4 * i + 4)
    temps = np.array([0.0, 0.9, 0.0, 0.0], np.float32)
    tps = np.array([1.0, 0.8, 1.0, 1.0], np.float32)
    rem = np.array([12, 12, 3, 0], np.int32)
    first, _, _ = eager.prefill_sample_batch(toks, lens, tables, temps, 0, top_ps=tps)
    probe = eager.decode_sample_scan(first, lens, tables, temps, 1, rem, n_steps=8, top_ps=tps)
    eos = int(probe[0][0, 2])
    got = {}
    for name, eng in (("graphed", graphed), ("eager", eager)):
        eng.eos_id = eos
        eng.prefill_sample_batch(toks, lens, tables, temps, 0, top_ps=tps)
        carry = eng.scan_carry_init(first, lens, rem, temps, tps, seed=7)
        tdev = eng.tables_to_device(tables)
        rounds = []
        for _ in range(3):
            (out, carry), n = _counted(lambda: eng.decode_sample_scan_carry(
                carry, tdev, n_steps=4, return_topk=2))
            rounds.append(([a.tobytes() for a in out[:3]], [q.tobytes() for q in out[3]], n,
                           [carry[k].cpu().numpy().tobytes() for k in ("tok", "pos", "rem")]))
        legacy, n = _counted(lambda: eng.decode_sample_scan(
            first, lens, tables, temps, 5, rem, n_steps=8, return_topk=2, top_ps=tps))
        rounds.append(([a.tobytes() for a in legacy[:3]], [q.tobytes() for q in legacy[3]], n))
        got[name] = rounds
    assert got["graphed"] == got["eager"]
    assert graphed.loops.stats()["captures"] == 2
    emitted = np.frombuffer(got["eager"][0][0][2], np.int32)
    assert emitted[3] == 0 and emitted[2] == 3 and 0 < emitted[0] < 4   # parked, budget, eos


def test_pipelined_scheduler_with_graphs_equals_unpipelined(cuda):
    """The scheduler enqueues round N + 1 from the carry before it fetches
    round N, whose outputs the next replay overwrites in the graph's static
    buffers: pipelined with graphs, unpipelined with graphs and pipelined
    without capture give the same tokens."""
    from adaptive_sd_tpu_torch.engine import ContinuousBatchingScheduler

    rng = np.random.default_rng(6)
    prompts = [[int(t) for t in rng.integers(1, TINY128.vocab_size, n)]
               for n in (37, 150, 300, 64, 90, 20)]
    params = _on_card(init_params_quantized(TINY128, 6, device="cpu", dtype=torch.float32),
                      cuda)
    outs = {}
    for graphs, pipelined in ((True, True), (True, False), (False, True)):
        eng = TierEngine(TINY128, params, device=cuda, page_size=128, n_pages=32,
                         cuda_graphs=graphs)
        sched = ContinuousBatchingScheduler(eng, max_batch=4, max_context=512, scan_steps=4,
                                            pipeline_scans=pipelined)
        reqs = [sched.submit(p, max_new=40 + 3 * i) for i, p in enumerate(prompts)]
        sched.run_until_idle()
        assert all(r.done and r.error is None for r in reqs)
        outs[graphs, pipelined] = [(r.out_tokens, r.out_logprobs) for r in reqs]
        assert (eng.loops.stats()["replays"] > 0) == graphs
    assert outs[True, True] == outs[True, False] == outs[False, True]


def test_capture_failure_raises(cuda, monkeypatch):
    """A host read inside the captured steps fails the capture, and the
    error reaches the caller: no eager fallback. Without it the same
    bucket captures and runs."""
    graphed, _ = _graph_pair(cuda)
    real = D.decode_step

    def reading(*a, **k):
        out = real(*a, **k)
        float(out[0].sum())
        return out

    monkeypatch.setattr(D, "decode_step", reading)
    with pytest.raises(RuntimeError):
        graphed.generate([[1, 2, 3]], max_new=8)
    assert graphed.loops.stats()["captures"] == 0
    monkeypatch.setattr(D, "decode_step", real)
    out = graphed.generate([[1, 2, 3]], max_new=8)
    assert out[0].num_tokens == 8 and graphed.loops.stats()["captures"] == 1


def test_capture_survives_a_collection_of_dead_graphs(cuda, monkeypatch):
    """A dead engine's graphs, freed by a cyclic garbage collection while
    another engine captures, would invalidate that capture: no collection
    runs inside one, and the capture gives the eager tokens."""
    held = [_graph_pair(cuda)[0]]
    held[0].generate([[1, 2, 3]], max_new=8)
    assert held[0].loops.stats()["captures"] == 1
    ref = weakref.ref(held[0])
    graphed, eager = _graph_pair(cuda, seed=3)
    real = D.decode_step

    def collecting(*a, **k):
        if held and torch.cuda.is_current_stream_capturing():
            held.clear()
            assert ref() is not None       # a reference cycle holds it (its buckets)
            if gc.isenabled():
                gc.collect()
        return real(*a, **k)

    monkeypatch.setattr(D, "decode_step", collecting)
    got = graphed.generate([[4, 5, 6]], max_new=8)
    want = eager.generate([[4, 5, 6]], max_new=8)
    assert not held and graphed.loops.stats()["captures"] == 1
    assert got[0].token_ids.tolist() == want[0].token_ids.tolist()
    gc.collect()
    assert ref() is None


def test_engines_capture_concurrently(cuda):
    """Three engines capturing their buckets in three threads at once (tiers
    warming together, as ScheduledCascadePipeline.warmup does): no capture
    fails, and each engine gives what the same calls give without graphs."""
    engines = [_graph_pair(cuda, seed=s) for s in (11, 12, 13)]
    rng = np.random.default_rng(11)
    prompts = [[int(t) for t in rng.integers(1, TINY128.vocab_size, n)] for n in (37, 150)]
    budgets = (8, 40, 72, 104)  # 32, 64, 96, 128 steps: a new bucket (and capture) each call

    def calls(engine):
        return [_gen_rows(engine.generate(prompts, max_new=m)) for m in budgets]

    want = [calls(eager) for _, eager in engines]
    got = [None] * 3
    errors = []
    start = threading.Barrier(3)

    def run(i):
        start.wait()
        try:
            got[i] = calls(engines[i][0])
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(repr(exc))

    threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert got == want
    assert all(g.loops.stats()["captures"] >= len(budgets) for g, _ in engines)


@pytest.mark.parametrize("graphs", [True, False])
def test_concurrent_generates_and_verifies_equal_one_at_a_time(cuda, graphs):
    """Calls of one shape share a loop bucket's state (and, graphed, its
    generator): four threads calling ``generate`` and ``verify_continue``
    at once on one engine get what each gets alone, bit for bit."""
    engine = _graph_pair(cuda, seed=5)[0 if graphs else 1]
    rng = np.random.default_rng(5)
    prompts = [[[int(t) for t in rng.integers(1, TINY128.vocab_size, n)] for n in (37, 150)]
               for _ in range(4)]
    drafts = [[o.token_ids[:6].tolist() for o in engine.generate(p, max_new=8)]
              for p in prompts]

    def call(i):
        outs = engine.generate(prompts[i], max_new=24, temperature=0.8, seed=i)
        ver = engine.verify_continue(prompts[i], drafts[i], max_new=24, temperature=0.8,
                                     seed=i)
        return _gen_rows(outs), _gen_rows([o for o, _ in ver]), [n for _, n in ver]

    alone = [call(i) for i in range(4)]
    got = [None] * 4
    start = threading.Barrier(4)

    def run(i):
        start.wait()
        got[i] = call(i)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert got == alone
    assert (engine.loops.stats()["replays"] > 0) == graphs


# what a tensor-parallel engine built from the host tree may keep on the card
# beyond its weight shard and its KV cache; while it is built, the card may
# also hold three times the largest piece sent whole (a layer or the lm_head)
TP_BUILD_SLACK = 64 << 20
TP_BUILD_PIECES = 3


def _tp_rank_7b(rank: int, device) -> dict:
    """One of two ranks sharing the card over gloo: Qwen2.5-7B widths at 2
    layers, INT8 fused, f32 activations, prefix cache on; rank 0 first runs
    the tp=1 engine on the same weights (made from one seed on the card).
    The tp engine is built from the whole model's host tree, and the card's
    peak allocation while it is built is recorded."""
    from adaptive_sd_tpu_torch.models import QWEN25_7B, scaled_spec
    from adaptive_sd_tpu_torch.models.qwen_tp import tree_to
    from adaptive_sd_tpu_torch.parallel import build_mesh

    mesh = build_mesh(dp=1, tp=2)
    spec = scaled_spec(QWEN25_7B, layers=2)
    params = init_params_quantized(spec, torch.Generator(device=device).manual_seed(7), bits=8,
                                   device=device, dtype=torch.float32)
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(1, spec.vocab_size, n)] for n in (37, 150)]
    kw = dict(page_size=128, n_pages=32, device=device, enable_prefix_cache=True,
              cuda_graphs=False)
    out = {}
    if rank == 0:
        single = TierEngine(spec, params, **kw)
        out["tp1"] = [o.token_ids.tolist() for o in single.generate(prompts, max_new=16)]
        del single
    host = tree_to(params, "cpu")
    out["whole_bytes"] = D._param_bytes(host)
    out["piece_bytes"] = max(D._param_bytes(p) for p in [*host["layers"], host["lm_head"]])
    del params
    gc.collect()
    torch.cuda.empty_cache()
    try:
        TierEngine(spec, host, mesh=mesh, **{**kw, "cuda_graphs": True})
        out["refused"] = ""
    except ValueError as exc:
        out["refused"] = str(exc)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    engine = TierEngine(spec, host, mesh=mesh, **kw)
    out["build_peak"] = torch.cuda.max_memory_allocated(device) - base
    out["resident"] = torch.cuda.memory_allocated(device) - base
    out["shard_bytes"] = D._param_bytes(engine.params)
    out["cache_bytes"] = engine.cache.memory_bytes()
    counters = (MQ.int8_matmul_counter, A.paged_decode_counter, A.paged_window_counter)
    before = [c.launches for c in counters]
    outs = engine.generate(prompts, max_new=16)
    ver = engine.verify_continue(prompts, [o.token_ids[:8].tolist() for o in outs], max_new=16)
    out.update(tp_mode=engine.tp_mode, tokens=[o.token_ids.tolist() for o in outs],
               n_acc=[int(a) for _, a in ver],
               continued=[v.token_ids.tolist() for v, _ in ver],
               launches=[c.launches - b for c, b in zip(counters, before)])
    return out


def test_tp_two_ranks_on_one_card_equal_tp1(cuda):
    """Tensor parallelism at 7B widths, two ranks sharing the card over gloo:
    every rank's greedy tokens equal the tp=1 engine's, verify of half the
    output is accepted in full, the kernels ran on each rank, CUDA graphs
    over a gloo group are refused, and a rank built from the host tree keeps
    no more on the card than its shard and its KV cache (and held no more
    than three layers' worth beside them while it was built)."""
    from adaptive_sd_tpu_torch.parallel import spawn_ranks

    ranks = spawn_ranks(_tp_rank_7b, 2, devices=["cuda:0", "cuda:0"], timeout_s=300)
    for r in ranks:
        assert r["tp_mode"]
        assert r["tokens"] == ranks[0]["tp1"]
        assert r["n_acc"] == [8, 8] and r["continued"] == r["tokens"]
        assert all(n > 0 for n in r["launches"]), r["launches"]
        assert "gloo" in r["refused"] and "cuda_graphs=False" in r["refused"]
        assert r["shard_bytes"] < 0.6 * r["whole_bytes"]
        assert r["resident"] <= r["shard_bytes"] + r["cache_bytes"] + TP_BUILD_SLACK, r
        assert r["build_peak"] <= r["resident"] + TP_BUILD_PIECES * r["piece_bytes"], r
