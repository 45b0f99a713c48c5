"""The port's checkpoint path (``models/loader.py``) against the JAX
package's on the CPU: the cases of ``tests/test_loader.py`` run on the port,
the port's own safetensors reader and writer against the ``safetensors``
package, ``load_params`` of both packages on one checkpoint, npz files
crossing between the packages, and a BF16 checkpoint loading through the
port (upcast to f32 before quantizing; the JAX loader quantizes it in
bf16)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_sd_tpu.engine import PagedKVCache as JCache
from adaptive_sd_tpu.models import TINY as JTINY
from adaptive_sd_tpu.models import loader as jloader
from adaptive_sd_tpu.models import qwen as jq
from adaptive_sd_tpu.ops.quant import QuantizedTensor as JQT
from adaptive_sd_tpu_torch.core.exceptions import ModelLoadError
from adaptive_sd_tpu_torch.engine.kv_cache import PagedKVCache as TCache
from adaptive_sd_tpu_torch.models import TINY, params_from_jax
from adaptive_sd_tpu_torch.models import loader as tloader
from adaptive_sd_tpu_torch.models import qwen as tq
from adaptive_sd_tpu_torch.ops.quant import QuantizedTensor
from tests.test_torch_qwen import jax_to_numpy

torch.set_num_threads(2)

# f32 forward of two layers over the INT8 KV cache (tests/test_torch_qwen.py)
ATOL, RTOL = 2e-3, 1e-3


def _write_hf(tmp_path, params, spec, dtype=np.float32, writer="safetensors"):
    """An HF-style Qwen2 shard of a JAX params tree, written by the
    ``safetensors`` package (as tests/test_loader.py writes it) or by the
    port's writer, in ``dtype``."""
    def arr(x):
        return np.asarray(x, np.float32).astype(dtype)

    tensors = {
        "model.embed_tokens.weight": arr(params["embed"]),
        "model.norm.weight": arr(params["final_norm"]),
        "lm_head.weight": arr(params["lm_head"]).T.copy(),
    }
    name_map = {"q_proj": "self_attn.q_proj.weight", "k_proj": "self_attn.k_proj.weight",
                "v_proj": "self_attn.v_proj.weight", "o_proj": "self_attn.o_proj.weight",
                "gate_proj": "mlp.gate_proj.weight", "up_proj": "mlp.up_proj.weight",
                "down_proj": "mlp.down_proj.weight"}
    for li, layer in enumerate(params["layers"]):
        base = f"model.layers.{li}."
        for ours, hf in name_map.items():
            tensors[base + hf] = arr(layer[ours]).T.copy()
        for ours, hf in [("q_bias", "self_attn.q_proj.bias"), ("k_bias", "self_attn.k_proj.bias"),
                         ("v_bias", "self_attn.v_proj.bias")]:
            tensors[base + hf] = arr(layer[ours])
        tensors[base + "input_layernorm.weight"] = arr(layer["input_norm"])
        tensors[base + "post_attention_layernorm.weight"] = arr(layer["post_norm"])
    tmp_path.mkdir(parents=True, exist_ok=True)
    if writer == "safetensors":
        from safetensors.numpy import save_file

        save_file(tensors, str(tmp_path / "model.safetensors"))
    else:
        tloader.save_safetensors({k: _torch(v) for k, v in tensors.items()},
                                 tmp_path / "model.safetensors")
    (tmp_path / "config.json").write_text(json.dumps({
        "hidden_size": spec.hidden, "num_hidden_layers": spec.n_layers,
        "num_attention_heads": spec.n_heads, "num_key_value_heads": spec.n_kv_heads,
        "intermediate_size": spec.ffn, "vocab_size": spec.vocab_size,
        "head_dim": spec.head_dim, "rope_theta": spec.rope_theta,
        "max_position_embeddings": spec.max_seq_len}))
    return tmp_path


def _torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    params = jq.init_params(JTINY, jax.random.key(0), dtype=jnp.float32)
    return _write_hf(tmp_path_factory.mktemp("ckpt"), params, JTINY), params


def _logits_of(params, spec=TINY):
    """Logits of one decode step of token 7 at position 0 (the port)."""
    cache = TCache.create(spec, n_pages=4, page_size=16, device="cpu")
    tables = torch.tensor([[0, 1]], dtype=torch.int32)
    logits, _ = tq.decode_step(params, spec, torch.tensor([7], dtype=torch.int32),
                               torch.tensor([0], dtype=torch.int32), cache, tables)
    return logits[0].float().numpy()


def _jax_logits_of(params):
    cache = JCache.create(JTINY, n_pages=4, page_size=16)
    logits, _ = jq.decode_step(params, JTINY, jnp.asarray([7], jnp.int32),
                               jnp.asarray([0], jnp.int32), cache,
                               jnp.asarray([[0, 1]], jnp.int32), use_pallas=False)
    return np.asarray(logits[0])


class TestLoaderCases:
    """tests/test_loader.py's cases, run on the port."""

    def test_verify_checkpoint(self, checkpoint):
        rep = tloader.verify_checkpoint(str(checkpoint[0]), TINY)
        assert rep["ok"], rep

    def test_verify_detects_mismatch(self, checkpoint):
        wrong = dataclasses.replace(TINY, hidden=999, name="wrong")
        assert not tloader.verify_checkpoint(str(checkpoint[0]), wrong)["ok"]

    def test_unquantized_load_matches_source(self, checkpoint):
        tmp, params = checkpoint
        loaded = tloader.load_params(str(tmp), TINY, bits=None, dtype=torch.float32, device="cpu")
        np.testing.assert_allclose(_logits_of(loaded), _jax_logits_of(params), rtol=RTOL,
                                   atol=ATOL)

    def test_quantized_load_matches_offline_quant(self, checkpoint):
        tmp, params = checkpoint
        loaded = tloader.load_params(str(tmp), TINY, bits=8, device="cpu")
        reference = tq.quantize_model(params_from_jax(jax_to_numpy(params), device="cpu"), bits=8)
        np.testing.assert_allclose(_logits_of(loaded), _logits_of(reference), rtol=5e-2,
                                   atol=5e-2)

    def test_missing_dir_raises(self):
        with pytest.raises(ModelLoadError):
            tloader.load_params("/nonexistent", TINY, device="cpu")

    def test_spec_from_checkpoint_infers_dims(self, checkpoint):
        spec = tloader.spec_from_checkpoint(str(checkpoint[0]))
        assert (spec.hidden, spec.n_layers, spec.n_heads, spec.n_kv_heads, spec.ffn,
                spec.head_dim) == (TINY.hidden, TINY.n_layers, TINY.n_heads, TINY.n_kv_heads,
                                   TINY.ffn, TINY.head_dim)

    def test_spec_from_checkpoint_missing_config(self, tmp_path):
        with pytest.raises(ModelLoadError):
            tloader.spec_from_checkpoint(str(tmp_path))

    def test_smoke_build_cascade_from_dirs(self, checkpoint):
        """dir -> inferred spec -> verified -> loaded -> an engine-backed
        stage that generates (scripts/torch_real_smoke.py)."""
        import importlib.util
        import pathlib

        root = pathlib.Path(__file__).resolve().parents[1]
        spec_mod = importlib.util.spec_from_file_location(
            "torch_real_smoke", root / "scripts" / "torch_real_smoke.py")
        smoke = importlib.util.module_from_spec(spec_mod)
        spec_mod.loader.exec_module(smoke)
        stages, reports = smoke.build_cascade([str(checkpoint[0])], [8], device="cpu",
                                              n_pages=32)
        assert reports[0]["ok"]
        out = stages[0].generate_text(["hello world"], max_new=4)[0]
        assert len(out.token_ids) >= 1

    def test_npz_roundtrip_quantized(self, checkpoint, tmp_path):
        q = tq.quantize_model(params_from_jax(jax_to_numpy(checkpoint[1]), device="cpu"), bits=8)
        tloader.save_params_npz(q, str(tmp_path / "model.npz"))
        back = tloader.load_params_npz(str(tmp_path / "model.npz"), device="cpu")
        np.testing.assert_allclose(_logits_of(back), _logits_of(q), rtol=1e-5, atol=1e-5)


_DTYPES = {"F32": np.float32, "F16": np.float16, "BF16": "bfloat16"}


def _sample(dtype):
    rng = np.random.default_rng(4)
    out = {"w.a": rng.normal(size=(5, 7)), "w.b": rng.normal(size=(3,)),
           "e": rng.normal(size=(0, 4)), "s": rng.normal(size=())}
    import ml_dtypes

    dt = ml_dtypes.bfloat16 if dtype == "BF16" else _DTYPES[dtype]
    out = {k: v.astype(np.float32).astype(dt) for k, v in out.items()}
    out["i8"] = rng.integers(-128, 128, size=(4, 3)).astype(np.int8)
    out["i64"] = rng.integers(-5, 5, size=(2,)).astype(np.int64)
    return out


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
def test_reader_takes_package_files(tmp_path, dtype):
    """The port's reader on files the ``safetensors`` package writes: every
    tensor bit for bit, with its dtype."""
    from safetensors.torch import save_file

    want = {k: _torch(v) for k, v in _sample(dtype).items()}
    save_file(want, str(tmp_path / "x.safetensors"), metadata={"format": "pt"})
    got = tloader.load_safetensors(tmp_path / "x.safetensors")
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape
        assert torch.equal(got[k].reshape(-1).view(torch.uint8), v.reshape(-1).view(torch.uint8)), k


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
def test_package_reads_port_files_and_writes_the_same_bytes(tmp_path, dtype):
    """The package reads the port's files bit for bit, and the port's writer
    lays a file out byte for byte as the package's does."""
    from safetensors.torch import load_file, save_file

    want = {k: _torch(v) for k, v in _sample(dtype).items()}
    tloader.save_safetensors(want, tmp_path / "port.safetensors", metadata={"format": "pt"})
    got = load_file(str(tmp_path / "port.safetensors"))
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    save_file(want, str(tmp_path / "pkg.safetensors"), metadata={"format": "pt"})
    assert ((tmp_path / "port.safetensors").read_bytes()
            == (tmp_path / "pkg.safetensors").read_bytes())


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}.{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}.{i}")
    else:
        yield path, tree


@pytest.mark.parametrize("bits", [8, 4, None])
def test_load_params_equals_jax(checkpoint, bits):
    """Both packages' ``load_params`` on one checkpoint: quantized bytes
    equal, scales within 1 f32 ulp (XLA may divide by 127 or 7 as a product
    with the reciprocal), float leaves equal. TINY has K = 64 (INT4 per
    channel) and K = 128 (groups of 128)."""
    tmp, _ = checkpoint
    jp = jloader.load_params(str(tmp), JTINY, bits=bits, dtype=jnp.float32)
    tp = tloader.load_params(str(tmp), TINY, bits=bits, dtype=torch.float32, device="cpu")
    jl, tl = dict(_leaves(jp)), dict(_leaves(tp))
    assert jl.keys() == tl.keys()
    for k, j in jl.items():
        t = tl[k]
        if isinstance(j, JQT):
            assert isinstance(t, QuantizedTensor) and t.bits == j.bits, k
            np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q), err_msg=k)
            np.testing.assert_array_max_ulp(t.scale.numpy(), np.asarray(j.scale), maxulp=1)
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=k)


def test_save_checkpoint_equals_jax(tmp_path):
    """The port's ``save_checkpoint`` writes the JAX writer's tensors (f32)
    and config; the JAX loader reads the port's file."""
    params = jq.init_params(JTINY, jax.random.key(5), dtype=jnp.float32)
    jdir = jloader.save_checkpoint(params, JTINY, str(tmp_path / "jax"))
    tdir = tloader.save_checkpoint(params_from_jax(jax_to_numpy(params), device="cpu"), TINY,
                                   str(tmp_path / "torch"))
    from safetensors.numpy import load_file

    a = load_file(f"{jdir}/model.safetensors")
    b = load_file(f"{tdir}/model.safetensors")
    assert a.keys() == b.keys()
    for k in a:
        assert b[k].dtype == np.float32
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert (tmp_path / "jax" / "config.json").read_text() == (
        tmp_path / "torch" / "config.json").read_text()
    back = jloader.load_params(tdir, JTINY, bits=8)
    assert isinstance(back["layers"][0]["qkv_proj"], JQT)


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_npz_crosses_between_packages(checkpoint, tmp_path, direction):
    """A quantized params npz written by one package loads in the other with
    the same keys, bytes and scales (the key scheme: ``#q{bits}``, ``#s``)."""
    jp = jq.quantize_model(checkpoint[1], bits=8)
    path = str(tmp_path / "m.npz")
    if direction == "jax_to_torch":
        jloader.save_params_npz(jp, path)
        tp = tloader.load_params_npz(path, device="cpu")
    else:
        tloader.save_params_npz(params_from_jax(jax_to_numpy(jp), device="cpu"), path)
        tp = params_from_jax(jax_to_numpy(jloader.load_params_npz(path)), device="cpu")
    jl, tl = dict(_leaves(jp)), dict(_leaves(tp))
    assert jl.keys() == tl.keys()
    for k, j in jl.items():
        if isinstance(j, JQT):
            assert tl[k].bits == j.bits
            np.testing.assert_array_equal(tl[k].q.numpy(), np.asarray(j.q))
            np.testing.assert_array_equal(tl[k].scale.numpy(), np.asarray(j.scale))
        else:
            np.testing.assert_array_equal(tl[k].numpy(), np.asarray(j))


def test_npz_keeps_bf16_leaves(tmp_path):
    """bf16 leaves are stored as numpy's 2-byte void (what the JAX package's
    bf16 arrays become in an npz) and come back as bf16."""
    p = {"embed": torch.randn(4, 3).bfloat16(), "layers": [{"n": torch.ones(3).bfloat16()}]}
    tloader.save_params_npz(p, str(tmp_path / "b.npz"))
    back = tloader.load_params_npz(str(tmp_path / "b.npz"), device="cpu")
    assert back["embed"].dtype == torch.bfloat16 and torch.equal(back["embed"], p["embed"])
    jnp_bf16 = np.asarray(jnp.asarray(p["embed"].float().numpy(), jnp.bfloat16))
    np.savez(tmp_path / "j.npz", embed=jnp_bf16)
    assert torch.equal(tloader.load_params_npz(str(tmp_path / "j.npz"), device="cpu")["embed"],
                       p["embed"])


@pytest.mark.parametrize("bits", [8, 4])
def test_bf16_checkpoint_loads_through_the_port(tmp_path, bits):
    """Qwen2.5 checkpoints ship in BF16. ``safetensors``' numpy reader
    takes them only where ml_dtypes has registered bfloat16 with numpy (the
    JAX loader imports jax.numpy, which does), and the JAX loader then
    quantizes in bf16 arithmetic: its scales are bf16 values. The port reads
    BF16 itself, upcasts to f32 and quantizes: the same as
    ``quantize_model`` of the f32 weights; its float leaves are the bf16
    values."""
    params = jq.init_params(JTINY, jax.random.key(6), dtype=jnp.bfloat16)
    import ml_dtypes

    d = _write_hf(tmp_path / "bf16", params, JTINY, dtype=ml_dtypes.bfloat16, writer="port")
    hdr, _ = tloader.read_header(d / "model.safetensors")
    assert {v["dtype"] for v in hdr.values()} == {"BF16"}
    js = jloader.load_params(str(d), JTINY, bits=bits)["layers"][0]["qkv_proj"].scale
    js = np.asarray(js)
    assert np.array_equal(js, np.asarray(jnp.asarray(js, jnp.bfloat16), np.float32))
    got = tloader.load_params(str(d), TINY, bits=bits, device="cpu")
    f32 = params_from_jax(jax_to_numpy(params), device="cpu")
    f32 = {**{k: v.float() for k, v in f32.items() if k != "layers"},
           "layers": [{k: v.float() for k, v in la.items()} for la in f32["layers"]]}
    want = tq.quantize_model(tq.fuse_projections(f32), bits=bits)
    for li, layer in enumerate(want["layers"]):
        for k in ("qkv_proj", "gateup_proj", "o_proj", "down_proj"):
            assert torch.equal(got["layers"][li][k].q, layer[k].q), (li, k)
            assert torch.equal(got["layers"][li][k].scale, layer[k].scale), (li, k)
    assert torch.equal(got["lm_head"].q, want["lm_head"].q)
    assert got["embed"].dtype == torch.bfloat16
    assert torch.equal(got["embed"], _torch(np.asarray(params["embed"])))
