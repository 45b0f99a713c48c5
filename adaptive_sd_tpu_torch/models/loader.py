"""HF safetensors weight loading and writing, and streaming quantization
(counterpart of ``adaptive_sd_tpu/models/loader.py``).

Weights stream tensor by tensor from the safetensors shards: each tensor is
copied out of a memory map of its shard, the pages it occupied are dropped
again (``madvise``), it goes to the device, and projections are fused and
quantized there, so host memory stays O(largest tensor), not O(model).

The safetensors format is read and written by this module's own code (the
card's machine has no ``safetensors`` package): a little-endian u64 header
length, a JSON header ``{name: {dtype, shape, data_offsets}}`` (with an
optional ``__metadata__`` entry, skipped), the header padded with spaces to
a multiple of 8 bytes, then the raw little-endian tensor bytes. The writer
lays a file out as the ``safetensors`` package does (tensors ordered by
dtype, widest first, then name; compact JSON), so the package reads its
files and writes the same bytes for the same tensors. Unlike the JAX
loader, which reads through numpy and so cannot take BF16 (the dtype
Qwen2.5 checkpoints ship in), this reader takes F32, F16, BF16, F64 and the
integer types.

Name mapping (HF Qwen2 -> ours): weights arrive [out, in] and are transposed
to [in, out] to match the engine's x @ W convention.
"""

from __future__ import annotations

import json
import mmap
import pathlib
import struct
from typing import Any, Iterator, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.exceptions import ModelLoadError
from ..ops.quant import QuantizedTensor, quantize_int4, quantize_int8
from .config import ModelSpec
from .qwen import Params

_LAYER_MAP = {
    "self_attn.q_proj.weight": ("q_proj", True),
    "self_attn.k_proj.weight": ("k_proj", True),
    "self_attn.v_proj.weight": ("v_proj", True),
    "self_attn.o_proj.weight": ("o_proj", True),
    "mlp.gate_proj.weight": ("gate_proj", True),
    "mlp.up_proj.weight": ("up_proj", True),
    "mlp.down_proj.weight": ("down_proj", True),
    "self_attn.q_proj.bias": ("q_bias", False),
    "self_attn.k_proj.bias": ("k_bias", False),
    "self_attn.v_proj.bias": ("v_bias", False),
    "input_layernorm.weight": ("input_norm", False),
    "post_attention_layernorm.weight": ("post_norm", False),
}

QUANTIZABLE = {"q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj"}

# ---------------------------------------------------------------------------
# the safetensors format

# safetensors dtype name -> torch dtype, in the package's dtype order (its
# writer sorts tensors by this order, last first)
_DTYPES = {
    "BOOL": torch.bool,
    "U8": torch.uint8,
    "I8": torch.int8,
    "I16": torch.int16,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I32": torch.int32,
    "F32": torch.float32,
    "F64": torch.float64,
    "I64": torch.int64,
}
_NAMES = {v: k for k, v in _DTYPES.items()}
_RANK = {name: i for i, name in enumerate(_DTYPES)}


def read_header(path) -> tuple[dict, int]:
    """(the tensors' entries, the byte offset their data starts at) of a
    safetensors file; ``__metadata__`` is dropped."""
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ModelLoadError(f"{path}: not a safetensors file (no header length)")
        (n,) = struct.unpack("<Q", raw)
        blob = f.read(n)
    if len(blob) != n:
        raise ModelLoadError(f"{path}: header of {n} bytes cut short")
    try:
        header = json.loads(blob)
    except json.JSONDecodeError as exc:
        raise ModelLoadError(f"{path}: bad safetensors header: {exc}") from exc
    header.pop("__metadata__", None)
    return header, 8 + n


def _entry_tensor(buf, start: int, name: str, info: dict, path) -> torch.Tensor:
    """A fresh CPU tensor with the bytes of one header entry."""
    dtype = _DTYPES.get(info["dtype"])
    if dtype is None:
        raise ModelLoadError(f"{path}: {name} has unsupported dtype {info['dtype']}")
    shape = [int(d) for d in info["shape"]]
    b, e = (int(x) for x in info["data_offsets"])
    nbytes = int(np.prod(shape, dtype=np.int64)) * torch.empty(0, dtype=dtype).element_size()
    if e - b != nbytes:
        raise ModelLoadError(f"{path}: {name} spans {e - b} bytes, its shape needs {nbytes}")
    if nbytes == 0:
        return torch.empty(shape, dtype=dtype)
    raw = np.frombuffer(buf, dtype=np.uint8, count=nbytes, offset=start + b).copy()
    return torch.from_numpy(raw).view(dtype).reshape(shape)


def iter_safetensors_file(path) -> Iterator[tuple[str, torch.Tensor]]:
    """(name, CPU tensor) of every tensor of one file, in name order (as
    ``safe_open(...).keys()``). Each tensor is copied out of a memory map
    of the file, whose pages are dropped again once it is copied."""
    header, start = read_header(path)
    with open(path, "rb") as f:
        size = f.seek(0, 2)
        if size == start:
            for name in sorted(header):
                yield name, _entry_tensor(b"", start, name, header[name], path)
            return
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    for name in sorted(header):
        info = header[name]
        end = start + int(info["data_offsets"][1])
        if end > size:
            raise ModelLoadError(f"{path}: {name} runs past the end of the file")
        t = _entry_tensor(mm, start, name, info, path)
        lo = (start + int(info["data_offsets"][0])) // mmap.PAGESIZE * mmap.PAGESIZE
        if end > lo:
            mm.madvise(mmap.MADV_DONTNEED, lo, end - lo)
        yield name, t
    mm.close()  # the tensors handed out are copies


def load_safetensors(path, device="cpu") -> dict[str, torch.Tensor]:
    """Every tensor of one file, on ``device``."""
    return {name: t.to(device) for name, t in iter_safetensors_file(path)}


def save_safetensors(tensors: dict[str, torch.Tensor], path,
                     metadata: Optional[dict[str, str]] = None) -> None:
    """Write ``tensors`` (on any device) as a safetensors file laid out as
    the ``safetensors`` package lays it out; one tensor at a time passes
    through host memory."""
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors name")
    order = sorted(tensors, key=lambda n: (-_RANK[_NAMES[tensors[n].dtype]], n))
    header: dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name in order:
        t = tensors[name]
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in order:
            t = tensors[name].detach().to("cpu").contiguous()
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy().data)


def _iter_safetensors(model_dir: pathlib.Path) -> Iterator[tuple[str, torch.Tensor]]:
    shards = sorted(model_dir.glob("*.safetensors"))
    if not shards:
        raise ModelLoadError(f"no .safetensors files under {model_dir}")
    for shard in shards:
        yield from iter_safetensors_file(shard)


# ---------------------------------------------------------------------------
# checkpoints


def spec_from_checkpoint(model_dir: str, *, name: Optional[str] = None) -> ModelSpec:
    """Infer a ModelSpec from an HF checkpoint's ``config.json``, so the
    real-weight path runs on any Qwen2-family checkpoint directory without a
    hand-registered spec."""
    p = pathlib.Path(model_dir)
    cfg_path = p / "config.json"
    if not cfg_path.exists():
        raise ModelLoadError(f"{model_dir}: config.json missing — cannot infer spec")
    cfg = json.loads(cfg_path.read_text())
    try:
        hidden = int(cfg["hidden_size"])
        n_heads = int(cfg["num_attention_heads"])
        spec = ModelSpec(
            name=name or cfg.get("_name_or_path") or p.name or "checkpoint",
            vocab_size=int(cfg.get("vocab_size", 151_936)),
            hidden=hidden,
            n_layers=int(cfg["num_hidden_layers"]),
            n_heads=n_heads,
            n_kv_heads=int(cfg.get("num_key_value_heads", n_heads)),
            head_dim=int(cfg.get("head_dim", hidden // n_heads)),
            ffn=int(cfg["intermediate_size"]),
            rope_theta=float(cfg.get("rope_theta", 1_000_000.0)),
            rms_eps=float(cfg.get("rms_norm_eps", 1e-6)),
            max_seq_len=int(cfg.get("max_position_embeddings", 4096)),
            tie_embeddings=bool(cfg.get("tie_word_embeddings", False)),
            attn_bias=True,
        )
    except KeyError as exc:
        raise ModelLoadError(f"{model_dir}: config.json missing field {exc}") from exc
    return spec


def verify_checkpoint(model_dir: str, spec: ModelSpec) -> dict:
    """Light-weight checkpoint sanity: config.json dims vs spec, shard
    presence."""
    p = pathlib.Path(model_dir)
    report = {"dir": str(p), "ok": True, "issues": []}
    cfg_path = p / "config.json"
    if cfg_path.exists():
        cfg = json.loads(cfg_path.read_text())
        checks = {
            "hidden_size": spec.hidden,
            "num_hidden_layers": spec.n_layers,
            "num_attention_heads": spec.n_heads,
            "num_key_value_heads": spec.n_kv_heads,
            "intermediate_size": spec.ffn,
        }
        for key, want in checks.items():
            have = cfg.get(key)
            if have is not None and have != want:
                report["ok"] = False
                report["issues"].append(f"{key}: checkpoint {have} != spec {want}")
    else:
        report["issues"].append("config.json missing (skipping dim check)")
    if not list(p.glob("*.safetensors")):
        report["ok"] = False
        report["issues"].append("no safetensors shards found")
    return report


def load_params(
    model_dir: str,
    spec: ModelSpec,
    *,
    bits: Optional[int] = 8,
    dtype=torch.bfloat16,
    fuse: bool = True,
    device=None,
) -> Params:
    """Load a Qwen2-style HF checkpoint into the engine's params tree on
    ``device`` (default CUDA).

    ``bits``: 8 quantizes every projection to per-channel INT8, 4 to INT4
    with groups of 128 rows where K allows and per channel otherwise; None
    keeps ``dtype``. Quantization runs on the device with ops/quant.py from
    f32: a BF16 or F16 tensor is upcast to f32 first, so the result is
    :func:`~adaptive_sd_tpu_torch.models.qwen.quantize_model` of the f32
    weights. ``fuse``: fuse q/k/v and gate/up per layer BEFORE quantizing
    (7 -> 4 projection kernels per layer); staged per layer on the device,
    so host memory stays O(tensor).
    """
    device = resolve_device(device)

    def _int4_grouped(w, _gs=128):
        gs = _gs if w.shape[0] % _gs == 0 else None
        return quantize_int4(w, group_size=gs)

    quant = {8: quantize_int8, 4: _int4_grouped, None: None}[bits]
    layers: list[dict] = [dict() for _ in range(spec.n_layers)]
    params: Params = {"layers": layers}
    staging: dict[int, dict] = {}

    def matrix(t: torch.Tensor) -> torch.Tensor:
        """[out, in] as read -> [in, out] f32 on the device."""
        return t.to(device).float().t().contiguous()

    def finish(w: torch.Tensor):
        return quant(w) if quant else w.to(dtype)

    def _try_fuse(li: int) -> None:
        st = staging.get(li, {})
        if {"q_proj", "k_proj", "v_proj"} <= st.keys():
            w = torch.cat([st.pop("q_proj"), st.pop("k_proj"), st.pop("v_proj")], dim=1)
            layers[li]["qkv_proj"] = finish(w)
            if {"q_bias", "k_bias", "v_bias"} <= st.keys():
                layers[li]["qkv_bias"] = torch.cat(
                    [st.pop("q_bias"), st.pop("k_bias"), st.pop("v_bias")]).to(dtype)
        if {"gate_proj", "up_proj"} <= st.keys():
            w = torch.cat([st.pop("gate_proj"), st.pop("up_proj")], dim=1)
            layers[li]["gateup_proj"] = finish(w)

    for name, tensor in _iter_safetensors(pathlib.Path(model_dir)):
        if name == "model.embed_tokens.weight":
            params["embed"] = tensor.to(device=device, dtype=dtype)
        elif name == "model.norm.weight":
            params["final_norm"] = tensor.to(device=device, dtype=dtype)
        elif name == "lm_head.weight":
            params["lm_head"] = finish(matrix(tensor))
        elif name.startswith("model.layers."):
            rest = name[len("model.layers."):]
            idx_str, _, suffix = rest.partition(".")
            try:
                li = int(idx_str)
            except ValueError as exc:
                raise ModelLoadError(f"bad layer index in {name}") from exc
            if li >= spec.n_layers:
                continue
            mapped = _LAYER_MAP.get(suffix)
            if mapped is None:
                continue  # rotary inv_freq etc.
            ours, is_matrix = mapped
            fusable = ours in ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj",
                               "q_bias", "k_bias", "v_bias")
            if fuse and fusable:
                value = matrix(tensor) if is_matrix else tensor.to(device).float()
                staging.setdefault(li, {})[ours] = value
                _try_fuse(li)
            elif is_matrix:
                w = matrix(tensor)
                layers[li][ours] = quant(w) if (quant and ours in QUANTIZABLE) else w.to(dtype)
            else:
                layers[li][ours] = tensor.to(device=device, dtype=dtype)

    if "embed" not in params:
        raise ModelLoadError("checkpoint missing model.embed_tokens.weight")
    if "lm_head" not in params:
        if not spec.tie_embeddings:
            raise ModelLoadError("checkpoint missing lm_head.weight for untied spec")
    attn_keys = ("qkv_proj",) if fuse else ("q_proj", "k_proj", "v_proj")
    mlp_keys = ("gateup_proj",) if fuse else ("gate_proj", "up_proj")
    missing = [
        (li, key)
        for li, layer in enumerate(layers)
        for key in (*attn_keys, "o_proj", *mlp_keys, "down_proj", "input_norm", "post_norm")
        if key not in layer
    ]
    if missing:
        raise ModelLoadError(f"checkpoint incomplete; first missing: {missing[:4]}")
    return params


def save_checkpoint(params: Params, spec: ModelSpec, model_dir: str) -> str:
    """Write an UNFUSED float params tree as an HF-format Qwen2 checkpoint
    (config.json + model.safetensors, every tensor f32 as the JAX writer
    writes it): the inverse of :func:`load_params`. Trained tiny tiers
    (models/tiny_train.py) and rehearsal checkpoints enter the production
    load -> verify -> quantize path through it."""
    d = pathlib.Path(model_dir)
    d.mkdir(parents=True, exist_ok=True)

    def f32(t):
        return t.detach().float().cpu()

    tensors = {
        "model.embed_tokens.weight": f32(params["embed"]),
        "model.norm.weight": f32(params["final_norm"]),
    }
    if not spec.tie_embeddings:
        tensors["lm_head.weight"] = f32(params["lm_head"]).t().contiguous()
    inv_map = {ours: hf for hf, (ours, transpose) in _LAYER_MAP.items() if transpose}
    bias_map = {ours: hf for hf, (ours, transpose) in _LAYER_MAP.items()
                if not transpose and ours.endswith("_bias")}
    for li, layer in enumerate(params["layers"]):
        pre = f"model.layers.{li}."
        for ours, hf in inv_map.items():
            tensors[pre + hf] = f32(layer[ours]).t().contiguous()
        for ours, hf in bias_map.items():
            if ours in layer:
                tensors[pre + hf] = f32(layer[ours])
        tensors[pre + "input_layernorm.weight"] = f32(layer["input_norm"])
        tensors[pre + "post_attention_layernorm.weight"] = f32(layer["post_norm"])
    save_safetensors(tensors, d / "model.safetensors")
    (d / "config.json").write_text(json.dumps({
        "hidden_size": spec.hidden,
        "num_hidden_layers": spec.n_layers,
        "num_attention_heads": spec.n_heads,
        "num_key_value_heads": spec.n_kv_heads,
        "intermediate_size": spec.ffn,
        "vocab_size": spec.vocab_size,
        "head_dim": spec.head_dim,
        "rope_theta": spec.rope_theta,
        "rms_norm_eps": spec.rms_eps,
        "max_position_embeddings": spec.max_seq_len,
        "tie_word_embeddings": spec.tie_embeddings,
    }))
    return str(d)


# ---------------------------------------------------------------------------
# flat .npz of a (possibly quantized) params tree

_BF16_NP = np.dtype("V2")  # how numpy stores the JAX package's bf16 arrays


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_NP)
    return t.numpy()


def _from_numpy(a: np.ndarray, device) -> torch.Tensor:
    if a.dtype == _BF16_NP:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def save_params_npz(params: Params, path: str) -> None:
    """Flat .npz export of a (possibly quantized) params tree, so the offline
    quantization pass runs once. Keys as the JAX package writes them:
    dotted paths, ``#q{bits}`` and ``#s`` for a QuantizedTensor's payload and
    scales; bf16 leaves are stored as the 2-byte void numpy gives the JAX
    package's bf16 arrays."""
    flat = {}

    def visit(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                visit(f"{prefix}.{k}" if prefix else k, v)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                visit(f"{prefix}.{i}", v)
        elif isinstance(node, QuantizedTensor):
            flat[f"{prefix}#q{node.bits}"] = _to_numpy(node.q)
            flat[f"{prefix}#s"] = _to_numpy(node.scale)
        else:
            flat[prefix] = _to_numpy(node)

    visit("", params)
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    np.savez(p, **flat)


def load_params_npz(path: str, device=None) -> Params:
    """The params tree of a :func:`save_params_npz` file (either package's),
    on ``device`` (default CUDA)."""
    device = resolve_device(device)
    data = np.load(path)
    root: dict = {}
    pending_scales = {k[:-2]: data[k] for k in data.files if k.endswith("#s")}

    def insert(tree, parts, value):
        head = parts[0]
        if len(parts) == 1:
            if head.isdigit():
                idx = int(head)
                while len(tree) <= idx:
                    tree.append(None)
                tree[idx] = value
            else:
                tree[head] = value
            return
        nxt_is_list = parts[1].isdigit()
        if head.isdigit():
            idx = int(head)
            while len(tree) <= idx:
                tree.append(None)
            if tree[idx] is None:
                tree[idx] = [] if nxt_is_list else {}
            insert(tree[idx], parts[1:], value)
        else:
            if head not in tree:
                tree[head] = [] if nxt_is_list else {}
            insert(tree[head], parts[1:], value)

    for key in data.files:
        if key.endswith("#s"):
            continue
        if "#q" in key:
            base, bits = key.rsplit("#q", 1)
            value = QuantizedTensor(q=_from_numpy(data[key], device),
                                    scale=_from_numpy(pending_scales[base], device),
                                    bits=int(bits))
            insert(root, base.split("."), value)
        else:
            insert(root, key.split("."), _from_numpy(data[key], device))
    return root
