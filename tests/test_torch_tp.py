"""Tensor parallelism of the PyTorch port against the JAX package.

Layout (no ranks): ``transform_params_for_tp``, ``_fused_perm``,
``local_spec``, ``tp_compatible`` (TINY and the published Qwen2.5 widths,
from shapes alone) and ``plan_tier_placements`` equal the JAX functions'.

On gloo ranks on the CPU (tests/torch_tp_workers.py; one spawn per world
size, every check of that world inside it): the sharded ops at tp 2 and 4
against JAX's ``quantized_matmul_ref`` on one device; row-parallel W8A8 at
tp 2 against the sum of JAX's W8A8 kernel (interpret mode) over each K
slice; the forward at tp 2 against JAX's single-device ``use_pallas=False``
forward at atol 2e-4 (the tolerance of tests/test_qwen_tp.py); the ring
overlap against the all_reduce ending; the engine, the scheduler and
``generate_with_policy`` over a tp=2 tier against the JAX single-device
engine; (dp 2, tp 2), the replicated fallback at tp 4 (TINY has 2 kv heads)
and tp 4 on a 4-kv-head tiny spec. Every rank must return the same tokens.
"""

import dataclasses
import itertools
import threading
import time
import types
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_sd_tpu.core.exceptions import ShardingError as JShardingError
from adaptive_sd_tpu.engine import PagedKVCache as JCache
from adaptive_sd_tpu.engine import TierEngine as JEngine
from adaptive_sd_tpu.models import TINY as JTINY
from adaptive_sd_tpu.models import config as jconfig
from adaptive_sd_tpu.models import qwen as jq
from adaptive_sd_tpu.models import qwen_tp as jtp
from adaptive_sd_tpu.ops import matmul_q as jmm
from adaptive_sd_tpu.ops import quant as jquant
from adaptive_sd_tpu.parallel import mesh as jmesh
from adaptive_sd_tpu.predict import inline as jinline
from adaptive_sd_tpu_torch.core.exceptions import ShardingError
from adaptive_sd_tpu_torch.models import config as tconfig
from adaptive_sd_tpu_torch.models import params_from_jax
from adaptive_sd_tpu_torch.models import qwen_tp as ttp
from adaptive_sd_tpu_torch.ops.quant import QuantizedTensor
from adaptive_sd_tpu_torch.parallel import mesh as tmesh
from adaptive_sd_tpu_torch.parallel import spawn_ranks

from . import torch_tp_workers as workers
from .test_torch_common import COSTS, PRIORS, _jax_predictor, _predictor_arrays
from .test_torch_engine import jax_to_numpy

torch.set_num_threads(2)

PAGE = 16
FWD_ATOL = 2e-4
# greedy logprobs of a tensor-parallel engine against the JAX engine on one
# device
LP_ATOL = 1e-4
VARIANTS = ("f32", "int8_unfused", "int8_fused", "int4_per_channel", "int4_grouped")
# a tiny spec whose 4 kv heads divide by 4 (TINY's 2 do not)
KV4 = dict(name="tiny-kv4", vocab_size=256, hidden=64, n_layers=2, n_heads=4, n_kv_heads=4,
           head_dim=16, ffn=128, max_seq_len=128, rope_theta=10_000.0)
PROMPTS = [[5, 9, 13], [7, 2, 21, 4]]
MAX_NEW = 6
POLICY_LAM = 0.5


# ---------------------------------------------------------------------------
# inputs, made once in the parent


# jitted JAX calls: eager JAX compiles every primitive of every new shape,
# which costs tens of seconds at these sizes
_init = jax.jit(lambda key: jq.init_params(JTINY, key, dtype=jnp.float32))
_quantize = jax.jit(jq.quantize_model, static_argnames=("bits", "group_size"))
_fuse = jax.jit(jq.fuse_projections)
_qint8 = jax.jit(jquant.quantize_int8)
_qint4 = jax.jit(jquant.quantize_int4, static_argnames=("group_size",))
_qmm = jax.jit(jmm.quantized_matmul_ref, static_argnames=("bits",))


def _jax_variants() -> dict:
    raw = _init(jax.random.key(0))
    return {
        "f32": raw,
        "int8_unfused": _quantize(raw, bits=8),
        "int8_fused": _quantize(_fuse(raw), bits=8),
        "int4_per_channel": _quantize(raw, bits=4, group_size=None),
        "int4_grouped": _quantize(raw, bits=4, group_size=32),
    }


@pytest.fixture(scope="module")
def jparams():
    return _jax_variants()


def _ops_inputs() -> tuple[dict, dict]:
    """Sharded-op data as numpy, and JAX's single-device references."""
    rng = np.random.default_rng(0)
    K, N, M = 256, 512, 8
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = rng.normal(size=(K, N)).astype(np.float32)
    wj = jnp.asarray(w)
    weights = {"int8": _qint8(wj), "int4_per_channel": _qint4(wj, group_size=None),
               "int4_grouped": _qint4(wj, group_size=32)}
    refs = {}
    for name, t in weights.items():
        ref = np.asarray(_qmm(jnp.asarray(x), t.q, t.scale, bits=t.bits))
        refs[f"col/{name}"] = refs[f"row/{name}"] = ref
    H, F = 128, 512
    mx = rng.normal(size=(M, H)).astype(np.float32)
    mlp = {k: _qint8(jnp.asarray(rng.normal(size=s).astype(np.float32)))
           for k, s in (("gate", (H, F)), ("up", (H, F)), ("down", (F, H)))}
    g = _qmm(jnp.asarray(mx), mlp["gate"].q, mlp["gate"].scale, bits=8)
    u = _qmm(jnp.asarray(mx), mlp["up"].q, mlp["up"].scale, bits=8)
    refs["mlp"] = np.asarray(_qmm(jax.nn.silu(g) * u, mlp["down"].q, mlp["down"].scale, bits=8))
    pair_row = _qint8(jnp.asarray(rng.normal(size=(N, 128)).astype(np.float32)))
    mid = _qmm(jnp.asarray(x), weights["int8"].q, weights["int8"].scale, bits=8)
    refs["pair"] = np.asarray(_qmm(mid, pair_row.q, pair_row.scale, bits=8))
    # the ring: a [64, 48] weight, raw f32 and quantized (the INT4 ones get
    # their packed rows made shard-local by the port's own repack, per tp)
    rk, rn = 64, 48
    rx = rng.normal(size=(4, rk)).astype(np.float32)
    rw = rng.normal(size=(rk, rn)).astype(np.float32)
    rwj = jnp.asarray(rw)
    ring = {"int8": _qint8(rwj), "int4_per_channel": _qint4(rwj, group_size=None),
            "int4_grouped": _qint4(rwj, group_size=8)}
    refs["ring/f32"] = rx @ rw
    for name, t in ring.items():
        refs[f"ring/{name}"] = np.asarray(_qmm(jnp.asarray(rx), t.q, t.scale, bits=t.bits))
    data = {"x": x, "weights": {k: jax_to_numpy(v) for k, v in weights.items()},
            "mlp": {k: jax_to_numpy(v) for k, v in mlp.items()}, "mlp_x": mx,
            "pair_row": jax_to_numpy(pair_row), "ring_x": rx,
            "ring": {"f32": rw, **{k: jax_to_numpy(v) for k, v in ring.items()}}}
    return data, refs


@pytest.fixture(scope="module")
def ops_case():
    return _ops_inputs()


def _ring_repacked(data: dict, tp: int) -> dict:
    """The ring's INT4 weights with their packed rows made shard-local."""
    out = dict(data)
    out["ring"] = dict(data["ring"])
    for name in ("int4_per_channel", "int4_grouped"):
        q, s, bits = data["ring"][name]
        t = ttp._repack_int4_rows(
            QuantizedTensor(torch.from_numpy(q.copy()), torch.from_numpy(s.copy()), bits), tp)
        out["ring"][name] = (t.q.numpy(), t.scale.numpy(), 4)
    return out


def _fwd_inputs():
    rng = np.random.default_rng(0)
    B, S = 2, 11
    return {"toks": rng.integers(1, JTINY.vocab_size, (B, S)).astype(np.int32),
            "seq_lens": np.array([S, S - 3], np.int32),
            "tables": np.array([[0, 1, 2], [3, 4, 5]], np.int32),
            "win_toks": rng.integers(1, JTINY.vocab_size, (B, 4)).astype(np.int32),
            "win_lens": np.array([4, 3], np.int32)}


@jax.jit
def _jax_forward_fn(params, toks, lens, tables, win_toks, win_lens):
    cache = JCache.create(JTINY, 32, PAGE)
    logits, cache, h = jq.prefill(params, JTINY, toks, lens, cache, tables, use_pallas=False,
                                  return_hidden=True)
    nxt = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    logits2, cache = jq.decode_step(params, JTINY, nxt, lens, cache, tables, use_pallas=False)
    hw, cache = jq.prefill_window(params, JTINY, win_toks, lens + 1, win_lens, cache, tables,
                                  use_pallas=False)
    return logits, h, logits2, hw, jq.logits_at(params, JTINY, hw, use_pallas=False)


def _jax_forward(params, d) -> dict:
    """JAX's single-device plain forward on the inputs the ranks get."""
    outs = _jax_forward_fn(params, *(jnp.asarray(d[k]) for k in (
        "toks", "seq_lens", "tables", "win_toks", "win_lens")))
    return dict(zip(("logits", "h", "logits2", "hw", "logits_w"), map(np.asarray, outs)))


def _jax_engine(spec, params, **kw):
    return JEngine(spec, params, page_size=PAGE, n_pages=64, use_pallas=False, **kw)


def _jax_engine_outputs(spec, params, prefix_cache=False) -> dict:
    eng = _jax_engine(spec, params, enable_prefix_cache=prefix_cache)
    outs = eng.generate(PROMPTS, max_new=MAX_NEW)
    (vout, n_acc), = eng.verify_continue([PROMPTS[0]], [outs[0].token_ids[:4].tolist()],
                                         max_new=MAX_NEW)
    return {"tokens": [o.token_ids.tolist() for o in outs],
            "logprobs": [np.asarray(o.logprobs) for o in outs],
            "verify": (np.asarray(vout.token_ids).tolist(), int(n_acc))}


def _policy_arrays():
    inl = _predictor_arrays(1, 16, (64, 32), 0)
    jinl = _jax_predictor(*inl, 16, (64, 32), 0)
    jinl.calibration, jinl.group_calibration = (1.0, 0.0), {}
    return inl, jinl


class _Ranks(threading.Thread):
    """``spawn_ranks`` in a thread, so that the parent computes the JAX
    references while the ranks run."""

    def __init__(self, fn, world: int, payload: dict, threads: int):
        super().__init__(daemon=True)
        self.args, self.result, self.error = (fn, world, payload, threads), None, None
        self.start()

    def run(self):
        fn, world, payload, threads = self.args
        try:
            self.result = spawn_ranks(fn, world, payload, threads=threads)
        except BaseException as exc:  # noqa: BLE001 - re-raised in the test's thread
            self.error = exc

    def get(self) -> list:
        self.join(timeout=600)
        assert not self.is_alive(), "the ranks did not finish in 600 s"
        if self.error is not None:
            raise self.error
        return self.result


@pytest.fixture(scope="module")
def worlds(jparams, ops_case):
    """Both worlds' ranks start at once; the JAX references are computed in
    threads meanwhile (XLA compiles outside the interpreter lock)."""
    ops, ops_refs = ops_case
    rng = np.random.default_rng(1)
    xw = rng.normal(size=(8, 256)).astype(np.float32)
    ww = _qint8(jnp.asarray(rng.normal(size=(256, 128)).astype(np.float32)))
    fwd = _fwd_inputs()
    inl, jinl = _policy_arrays()
    cum = np.cumsum(COSTS[:2]).tolist()
    jkv4 = jconfig.ModelSpec(**KV4)
    kv4_params = _quantize(_fuse(jq.init_params(jkv4, jax.random.key(3), dtype=jnp.float32)),
                           bits=8)
    engine = {"prompts": PROMPTS, "max_new": MAX_NEW}
    ranks2 = _Ranks(workers.world2, 2, {
        "spec": tconfig.TINY, "ops": _ring_repacked(ops, 2),
        "w8a8": {"x": xw, "w": jax_to_numpy(ww)},
        "params": {k: jax_to_numpy(v) for k, v in jparams.items()}, "fwd": fwd,
        "engine": {**engine, "policy": {"arrays": inl, "cum": cum, "priors": PRIORS[:2],
                                        "lam": POLICY_LAM}},
    }, threads=1)
    ranks4 = _Ranks(workers.world4, 4, {
        "spec": tconfig.TINY, "ops": _ring_repacked(ops, 4),
        "params": {"int8_fused": jax_to_numpy(jparams["int8_fused"])},
        "spec_kv4": tconfig.ModelSpec(**KV4), "params_kv4": jax_to_numpy(kv4_params),
        "engine": engine,
    }, threads=1)

    def w8a8():
        return sum(np.asarray(jmm.quantized_matmul_w8a8(
            jnp.asarray(xw[:, s * 128:(s + 1) * 128]), ww.q[s * 128:(s + 1) * 128], ww.scale,
            interpret=True)) for s in range(2))

    def policy():
        jpol = jinline.policy_from_predictor(jinl, cum, PRIORS[:2], POLICY_LAM)
        jo, jesc, _ = _jax_engine(JTINY, jparams["int8_fused"]).generate_with_policy(
            PROMPTS, jpol, 0, max_new=MAX_NEW)
        return {"tokens": [np.asarray(o.token_ids).tolist() for o in jo],
                "escalate": np.asarray(jesc).tolist()}

    def scheduler():
        out = _jax_engine(JTINY, jparams["int8_fused"]).generate([PROMPTS[0]], max_new=8)
        return np.asarray(out[0].token_ids).tolist()

    jobs = {"w8a8": w8a8, "policy": policy, "scheduler": scheduler,
            "engine": lambda: _jax_engine_outputs(JTINY, jparams["int8_fused"]),
            "engine_prefix": lambda: _jax_engine_outputs(JTINY, jparams["int8_fused"],
                                                         prefix_cache=True),
            "kv4": lambda: _jax_engine_outputs(jkv4, kv4_params),
            **{f"forward/{k}": (lambda v=v: _jax_forward(v, fwd)) for k, v in jparams.items()}}
    with ThreadPoolExecutor(max_workers=4) as pool:
        futures = {k: pool.submit(fn) for k, fn in jobs.items()}
        refs = {k: f.result() for k, f in futures.items()}
    refs["ops"] = ops_refs
    refs["forward"] = {k: refs.pop(f"forward/{k}") for k in jparams}
    return ranks2.get(), ranks4.get(), refs


@pytest.fixture(scope="module")
def world2(worlds):
    return worlds[0], worlds[2]


@pytest.fixture(scope="module")
def world4(worlds):
    return worlds[1], worlds[2]


# ---------------------------------------------------------------------------
# layout: bit for bit against the JAX functions


def _same_tree(jtree, ttree):
    jn = jax_to_numpy(jtree)

    def visit(a, b, path):
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for k in a:
                visit(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, list):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                visit(x, y, f"{path}/{i}")
        elif isinstance(a, tuple):
            assert isinstance(b, QuantizedTensor) and b.bits == a[2], path
            visit(a[0], b.q, f"{path}.q")
            visit(a[1], b.scale, f"{path}.scale")
        else:
            bb = b.view(torch.uint16).numpy() if b.dtype == torch.bfloat16 else b.numpy()
            aa = a.view(np.uint16) if a.dtype.name == "bfloat16" else a
            assert aa.shape == bb.shape and aa.dtype == bb.dtype, path
            np.testing.assert_array_equal(bb, aa, err_msg=path)

    visit(jn, ttree, "params")


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("variant", ["f32", "int8_fused", "int4_per_channel", "int4_grouped"])
def test_transform_params_matches_jax(jparams, variant, tp):
    jp = jparams[variant]
    tparams = params_from_jax(jax_to_numpy(jp), device="cpu")
    _same_tree(jtp.transform_params_for_tp(jp, JTINY, tp),
               ttp.transform_params_for_tp(tparams, tconfig.TINY, tp))


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("sizes", [(64, 32, 32), (128, 128), (3584, 512, 512)])
def test_fused_perm_matches_jax(sizes, tp):
    np.testing.assert_array_equal(ttp._fused_perm(sizes, tp), jtp._fused_perm(sizes, tp))


@pytest.mark.parametrize("name,tp", [("tiny", 2), ("qwen2.5-7b", 2), ("qwen2.5-7b", 4),
                                     ("qwen2.5-14b", 4), ("qwen2.5-72b", 4)])
def test_local_spec_matches_jax(name, tp):
    j = jtp.local_spec(jconfig.get_spec(name), tp)
    assert dataclasses.asdict(ttp.local_spec(tconfig.get_spec(name), tp)) == \
        dataclasses.asdict(j)


def _shape_params(spec, fmt: str, pkg: str, down_int4_grouped: bool = False):
    """A params tree of ``spec`` with every weight's SHAPE as ``fmt``
    (int8, or int4 as quantize_model lays it out: grouped at 128 where K
    divides, INT8 where no even packed-row split exists) and no memory
    behind it (broadcast zeros). ``down_int4_grouped`` forces down_proj to
    grouped INT4 whatever K (72B's K = 29568 has 231 groups of 128)."""
    H, D, F = spec.hidden, spec.head_dim, spec.ffn

    def weight(K, N, force4=False):
        bits = 8
        if fmt == "int4" and (force4 or not (K % 256 and K > 256)):
            bits = 4
        rows = K if bits == 8 else K // 2
        gs = 128 if bits == 4 and K % 128 == 0 else None
        srows = (K // gs,) if gs else ()
        if pkg == "jax":
            return jquant.QuantizedTensor(q=np.broadcast_to(np.int8(0), (rows, N)),
                                          scale=np.broadcast_to(np.float32(1), (*srows, N)),
                                          bits=bits)
        return QuantizedTensor(torch.zeros((), dtype=torch.int8).expand(rows, N),
                               torch.ones(()).expand(*srows, N), bits)

    layer = {"qkv_proj": weight(H, (spec.n_heads + 2 * spec.n_kv_heads) * D),
             "o_proj": weight(spec.n_heads * D, H),
             "gateup_proj": weight(H, 2 * F),
             "down_proj": weight(F, H, force4=down_int4_grouped)}
    return {"layers": [layer] * spec.n_layers, "lm_head": weight(H, spec.vocab_size)}


_COMPAT = [(n, f, False) for n in ("tiny", "qwen2.5-7b", "qwen2.5-14b", "qwen2.5-32b",
                                   "qwen2.5-72b") for f in ("int8", "int4")]
_COMPAT.append(("qwen2.5-72b", "int4", True))


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name,fmt,down4", _COMPAT)
def test_tp_compatible_matches_jax(name, fmt, down4, tp):
    j = jtp.tp_compatible(jconfig.get_spec(name), _shape_params(
        jconfig.get_spec(name), fmt, "jax", down4), tp)
    t = ttp.tp_compatible(tconfig.get_spec(name), _shape_params(
        tconfig.get_spec(name), fmt, "torch", down4), tp)
    assert t == j
    if down4:
        # 231 scale groups of 128 rows: no tp of 2 or 4 divides them
        assert not t


_PLANS = [
    (("a", "b", "c"), (10 << 30, 20 << 30, 40 << 30), 8, 16 << 30),
    (("a", "b"), (1 << 30, 1 << 30), 4, 16 << 30),
    (("a",), (100 << 30,), 8, 16 << 30),
    (("a", "b", "c", "d"), (15 << 30, 28 << 30, 64 << 30, 150 << 30), 8, 80 << 30),
    (("a", "b"), (60 << 30, 60 << 30), 2, 16 << 30),   # needs 16: ShardingError
    (("a",), (1 << 30,), 0, 16 << 30),                 # no devices: ShardingError
]


@pytest.mark.parametrize("names,weights,n,hbm", _PLANS)
def test_plan_tier_placements_matches_jax(names, weights, n, hbm):
    try:
        j = jmesh.plan_tier_placements(names, weights, n, device_hbm_bytes=hbm)
    except JShardingError as exc:
        with pytest.raises(ShardingError, match="cascade needs"):
            tmesh.plan_tier_placements(names, weights, n, device_hbm_bytes=hbm)
        assert "cascade needs" in str(exc)
        return
    t = tmesh.plan_tier_placements(names, weights, n, device_hbm_bytes=hbm)
    assert [dataclasses.asdict(p) for p in t] == [dataclasses.asdict(p) for p in j]


def test_plan_tier_placements_mismatch_raises():
    with pytest.raises(ValueError):
        tmesh.plan_tier_placements(["a"], [1, 2], 4)


@pytest.mark.parametrize("variant", ["int8_fused", "int4_grouped"])
def test_prepare_tp_params_shards_are_contiguous_blocks(jparams, variant):
    """Each rank's shard is a contiguous copy, and the ranks' shards put
    back together are the transformed params."""
    jp = jparams[variant]
    full = ttp.transform_params_for_tp(params_from_jax(jax_to_numpy(jp), "cpu"),
                                       tconfig.TINY, 2)
    shards = [ttp.prepare_tp_params(jax_to_numpy(jp), tconfig.TINY,
                                    tmesh.Mesh({"dp": 1, "tp": 2}, {"dp": 0, "tp": r}, {}))
              for r in range(2)]
    keys = [(k, 1) for k in ttp.COL_KEYS] + [(k, 0) for k in ttp.ROW_KEYS]
    for key, dim in ((k, d) for k, d in keys if k in full["layers"][1]):
        parts = [s["layers"][1][key] for s in shards]
        assert all(p.q.is_contiguous() and p.scale.is_contiguous() for p in parts)
        torch.testing.assert_close(torch.cat([p.q for p in parts], dim=dim),
                                   full["layers"][1][key].q, rtol=0, atol=0)
    emb = torch.cat([s["embed"] for s in shards])
    torch.testing.assert_close(emb, full["embed"], rtol=0, atol=0)


def test_build_mesh_needs_an_initialised_world():
    with pytest.raises(ShardingError, match="torch.distributed is not initialised"):
        tmesh.build_mesh(1, 2)


# ---------------------------------------------------------------------------
# on gloo ranks, tp = 2


def _same_on_every_rank(ranks, key):
    first = ranks[0][key]
    for r in ranks[1:]:
        assert r[key] == first if not isinstance(first, np.ndarray) else \
            np.array_equal(r[key], first)
    return first


OPS_KEYS = [f"{k}/{n}" for k in ("col", "row")
            for n in ("int8", "int4_per_channel", "int4_grouped")] + ["mlp", "pair"]


@pytest.mark.parametrize("key", OPS_KEYS)
def test_sharded_ops_match_jax_tp2(world2, key):
    ranks, refs = world2
    tol = 2e-3 if key in ("mlp", "pair") else 1e-4
    for r in ranks:
        np.testing.assert_allclose(r["ops"][key], refs["ops"][key], rtol=tol, atol=tol)
    np.testing.assert_array_equal(ranks[0]["ops"][key], ranks[1]["ops"][key])


def test_w8a8_row_parallel_is_the_sum_over_k_slices(world2):
    """Each rank quantizes its own K slice of the activations (JAX's
    shard-local rule); the all_reduce adds the two slices' W8A8 results."""
    ranks, refs = world2
    for r in ranks:
        np.testing.assert_allclose(r["w8a8"], refs["w8a8"], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("variant", VARIANTS)
def test_forward_matches_jax_tp2(world2, variant):
    ranks, refs = world2
    ref = refs["forward"][variant]
    fwd = _fwd_inputs()
    for r in ranks:
        out = r["forward"][variant]
        for k in ("logits", "logits2"):
            np.testing.assert_allclose(out[k], ref[k], atol=FWD_ATOL, rtol=0, err_msg=k)
        # hidden states of valid positions (padding rows are never read)
        for b in range(2):
            n, w = fwd["seq_lens"][b], fwd["win_lens"][b]
            np.testing.assert_allclose(out["h"][b, :n], ref["h"][b, :n], atol=FWD_ATOL, rtol=0)
            for k in ("hw", "logits_w"):
                np.testing.assert_allclose(out[k][b, :w], ref[k][b, :w], atol=FWD_ATOL, rtol=0,
                                           err_msg=k)
    for k in ("logits", "logits2", "logits_w"):
        np.testing.assert_array_equal(ranks[0]["forward"][variant][k],
                                      ranks[1]["forward"][variant][k])


@pytest.mark.parametrize("name", ["f32", "int8", "int4_per_channel", "int4_grouped"])
def test_ring_overlap_matches_all_reduce_tp2(world2, name):
    ranks, refs = world2
    for r in ranks:
        np.testing.assert_allclose(r["overlap"][f"ring/{name}"], r["overlap"][f"psum/{name}"],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["overlap"][f"ring/{name}"], refs["ops"][f"ring/{name}"],
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["f32", "int8", "int4_per_channel", "int4_grouped"])
def test_chunked_weight_all_reduce_ending_matches_whole_tp2(world2, name):
    """A row-parallel weight held as its column chunks (for the ring) ends
    prefill and window passes with the chunks' matmuls concatenated, then
    the all_reduce: the whole weight's result."""
    ranks, _ = world2
    for r in ranks:
        np.testing.assert_array_equal(r["overlap"][f"psum_chunks/{name}"],
                                      r["overlap"][f"psum/{name}"])


def _check_host_memory(ranks, gloo_bits: bool):
    """Every rank gets the same sums and gathers; a sum is the rank-order
    sum (bit for bit) and gloo's (bit for bit at two ranks, where both are
    ``a + b``; at four gloo rounds in another order: within a few bf16
    roundings of four N(0, 1) summands, or 1e-6 in f32)."""
    for r in ranks:
        hm = r["host_memory"]
        assert hm["fits"] == [True, False]
        assert hm["stress_mismatches"] == 0
        for i, (got, order, gloo) in enumerate(zip(hm["sum"], hm["order_sum"], hm["gloo_sum"])):
            np.testing.assert_array_equal(got, order)
            if gloo_bits:
                np.testing.assert_array_equal(got, gloo)
            else:
                bf16 = i in (1, 4)
                np.testing.assert_allclose(got, gloo, rtol=0 if bf16 else 1e-6,
                                           atol=0.0625 if bf16 else 1e-6)
            np.testing.assert_array_equal(got, ranks[0]["host_memory"]["sum"][i])
        for got, gloo in zip(hm["gather"], hm["gloo_gather"]):
            np.testing.assert_array_equal(got, gloo)


def test_host_memory_collectives_match_gloo_tp2(world2):
    """parallel/host_memory.py, which carries CUDA tensors of a gloo group
    on one host, on CPU tensors here: two ranks, slots reused by turns."""
    _check_host_memory(world2[0], gloo_bits=True)


def test_host_memory_collectives_match_gloo_tp4(world4):
    _check_host_memory(world4[0], gloo_bits=False)


def test_overlap_forward_rings_decode_only(world2):
    """With overlap_collectives the decode step ends both row-parallel
    sublayers of every layer with the ring; prefill and window do not."""
    ranks, refs = world2
    for r in ranks:
        fo = r["forward_overlap"]
        # the ring's weight chunks were cut once, by prepare_tp_params: the
        # passes themselves copy no weight
        assert fo["rings"] == {"prefill": 0, "decode": 2 * JTINY.n_layers, "window": 0,
                               "weight_slices": 0}
        np.testing.assert_array_equal(fo["logits"], r["forward"]["int8_fused"]["logits"])
        np.testing.assert_allclose(fo["logits2"], refs["forward"]["int8_fused"]["logits2"],
                                   atol=FWD_ATOL, rtol=0)


@pytest.mark.parametrize("tp_mode", [False, True])
def test_tp_scheduler_admits_without_the_clock(jparams, monkeypatch, tp_mode):
    """Every rank of a tensor-parallel engine must admit the same batch, or
    the ranks' collectives fall out of step (gloo: "Received data size
    doesn't match expected size"). A clock that passes the admission
    deadline after the first of two queued requests cuts a single-device
    batch to one; over a tensor-parallel engine both are admitted."""
    from adaptive_sd_tpu_torch.engine import ContinuousBatchingScheduler, TierEngine
    from adaptive_sd_tpu_torch.engine import scheduler as tsched

    eng = TierEngine(tconfig.TINY, params_from_jax(jax_to_numpy(jparams["int8_fused"]), "cpu"),
                     page_size=16, n_pages=64, device="cpu")
    eng.tp_mode = tp_mode  # what the scheduler reads; the forward stays single-device
    sched = ContinuousBatchingScheduler(eng, max_batch=2, max_context=64, scan_steps=1)
    for p in PROMPTS:
        sched.submit(p, max_new=4)
    clock = itertools.count(0.0, 0.01)  # every read of the clock is 10 ms later
    monkeypatch.setattr(tsched, "time", types.SimpleNamespace(
        monotonic=lambda: next(clock), perf_counter=time.perf_counter, sleep=time.sleep,
        monotonic_ns=time.monotonic_ns))
    sched.step(1)
    assert sum(lane is not None for lane in sched._lanes) == (2 if tp_mode else 1)


def test_overlap_compatible_matches_jax():
    from adaptive_sd_tpu.parallel.overlap import overlap_compatible as jcompat
    from adaptive_sd_tpu_torch.parallel.overlap import overlap_compatible as tcompat

    for n in (48, 50, 64):
        for tp in (1, 2, 4):
            w = np.zeros((8, n), np.float32)
            assert tcompat(torch.from_numpy(w), tp) == jcompat(jnp.asarray(w), tp)


def _rank_bytes(tree: dict, tp: int) -> int:
    """Bytes of the params one rank of a tp group holds, from the whole
    model's numpy tree: the norms and a row-parallel weight's per-channel
    scales whole, every other array a 1/tp share."""
    def nbytes(a):
        return a[0].nbytes + a[1].nbytes if isinstance(a, tuple) else a.nbytes

    total = tree["final_norm"].nbytes + sum(nbytes(tree[k]) // tp
                                            for k in ("embed", "lm_head") if k in tree)
    for layer in tree["layers"]:
        for key, w in layer.items():
            if key in ("input_norm", "post_norm"):
                total += w.nbytes
            elif key in ttp.ROW_KEYS and isinstance(w, tuple) and w[1].ndim == 1:
                total += w[0].nbytes // tp + w[1].nbytes
            else:
                total += nbytes(w) // tp
    return total


def test_engine_from_a_host_tree_holds_only_its_shard(jparams, world2, world4):
    """Every engine over a mesh was built from the whole model's host
    (numpy) tree: a tensor-parallel rank holds its shard and no more, a
    replicated one the whole tier."""
    tree = jax_to_numpy(jparams["int8_fused"])
    for r in world2[0]:
        assert r["engine"]["param_bytes"] == _rank_bytes(tree, 2)
    for r in world4[0]:
        assert r["dp2"]["param_bytes"] == _rank_bytes(tree, 2)
        assert r["fallback"]["param_bytes"] == _rank_bytes(tree, 1)


def _same_engine(out, ref, lp_atol):
    assert out["tokens"] == ref["tokens"]
    for a, b in zip(out["logprobs"], ref["logprobs"]):
        np.testing.assert_allclose(a, b, atol=lp_atol)
    assert out["verify"] == ref["verify"]
    assert out["verify"][1] == 4                     # accepts its own output in full
    assert out["verify"][0] == ref["tokens"][0]


@pytest.mark.parametrize("prefix", [False, True])
def test_engine_matches_jax_tp2(world2, prefix):
    ranks, refs = world2
    key = "engine_prefix" if prefix else "engine"
    for r in ranks:
        assert r[key]["tp_mode"] and r[key]["kv_heads"] == JTINY.n_kv_heads // 2
        _same_engine(r[key], refs[key], LP_ATOL)
    # every rank samples the same gathered logits: the same tokens and logprobs
    assert ranks[0][key]["tokens"] == ranks[1][key]["tokens"]
    for a, b in zip(ranks[0][key]["logprobs"], ranks[1][key]["logprobs"]):
        np.testing.assert_array_equal(a, b)


def test_scheduler_lanes_over_tp_engine(world2):
    """A plain request and a draft with one wrong token through the
    continuous-batching scheduler over a tp=2 engine."""
    ranks, refs = world2
    for r in ranks:
        assert r["scheduler"]["greedy"] == refs["scheduler"]
        assert r["scheduler"]["plain"] == refs["scheduler"]
        assert r["scheduler"]["draft"] == refs["scheduler"]
        assert r["scheduler"]["n_accepted"] == 2


def test_generate_with_policy_over_tp_engine(world2):
    ranks, refs = world2
    for r in ranks:
        assert r["policy"]["tokens"] == refs["policy"]["tokens"]
        assert r["policy"]["escalate"] == refs["policy"]["escalate"]


def test_cuda_graphs_over_gloo_refused(world2):
    ranks, _ = world2
    for r in ranks:
        assert "gloo" in r["graphs_refused"] and "cuda_graphs=False" in r["graphs_refused"]


def test_ranks_hold_their_coordinates(world2, world4):
    assert [r["coords"] for r in world2[0]] == [{"dp": 0, "tp": 0}, {"dp": 0, "tp": 1}]
    assert [r["coords_dp2"] for r in world4[0]] == [
        {"dp": 0, "tp": 0}, {"dp": 0, "tp": 1}, {"dp": 1, "tp": 0}, {"dp": 1, "tp": 1}]


# ---------------------------------------------------------------------------
# on gloo ranks, world 4


def test_multihost_mesh_and_size_mismatch(world4):
    ranks, _ = world4
    for r in ranks:
        shape, coords = r["multihost"]
        assert shape == {"dcn": 2, "dp": 1, "tp": 2}
        assert coords == {"dcn": r["rank"] // 2, "dp": 0, "tp": r["rank"] % 2}
        assert r["mismatch"].endswith("mesh 1x3 needs 3 devices, have 4")


def test_tier_placements_give_each_rank_its_tier(world4):
    ranks, _ = world4
    tiers = [r["tiers"] for r in ranks]
    assert [t["b"] is None for t in tiers] == [True, True, False, False]
    assert tiers[0]["a"] == ({"dp": 0, "tp": 0}, (0, 1)) and tiers[0]["b"] is None
    assert tiers[3]["b"] == ({"dp": 0, "tp": 1}, (2, 3)) and tiers[3]["a"] is None


@pytest.mark.parametrize("key", OPS_KEYS)
def test_sharded_ops_match_jax_tp4(world4, key):
    ranks, refs = world4
    tol = 2e-3 if key in ("mlp", "pair") else 1e-4
    for r in ranks:
        np.testing.assert_allclose(r["ops"][key], refs["ops"][key], rtol=tol, atol=tol)


@pytest.mark.parametrize("name", ["f32", "int8", "int4_per_channel", "int4_grouped"])
def test_ring_overlap_matches_all_reduce_tp4(world4, name):
    ranks, refs = world4
    for r in ranks:
        np.testing.assert_allclose(r["overlap"][f"ring/{name}"], r["overlap"][f"psum/{name}"],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["overlap"][f"ring/{name}"], refs["ops"][f"ring/{name}"],
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["f32", "int8", "int4_per_channel", "int4_grouped"])
def test_chunked_weight_all_reduce_ending_matches_whole_tp4(world4, name):
    ranks, _ = world4
    for r in ranks:
        np.testing.assert_array_equal(r["overlap"][f"psum_chunks/{name}"],
                                      r["overlap"][f"psum/{name}"])


def test_dp2_tp2_replicates(world4):
    ranks, refs = world4
    for r in ranks:
        assert r["dp2"]["tp_mode"]
        _same_engine(r["dp2"], refs["engine"], LP_ATOL)


def test_tp4_on_two_kv_heads_runs_replicated(world4):
    """TINY's 2 kv heads do not divide by 4: every rank runs the whole tier
    (the port's stand-in for the JAX engine's GSPMD fallback)."""
    ranks, refs = world4
    for r in ranks:
        assert not r["fallback"]["tp_mode"] and r["fallback"]["kv_heads"] == JTINY.n_kv_heads
        _same_engine(r["fallback"], refs["engine"], LP_ATOL)


def test_tp4_tokens_match_jax_on_four_kv_heads(world4):
    ranks, refs = world4
    for r in ranks:
        assert r["kv4"]["tp_mode"] and r["kv4"]["kv_heads"] == 1
        _same_engine(r["kv4"], refs["kv4"], LP_ATOL)
    assert len({str(r["kv4"]["tokens"]) for r in ranks}) == 1
