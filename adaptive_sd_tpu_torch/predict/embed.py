"""Learned text embedding for the quality predictor.

Role parity: the reference appends 5 DistilBERT embedding dims to its
handcrafted features (``src/models/enhanced_predictor.py:54-245``). This
environment has no pretrained weights, so the embedding is LEARNED JOINTLY
with the predictor MLP: texts are hashed into bag-of-ngram indices (word
unigrams + character trigrams, FNV-1a), an embedding table [EMBED_VOCAB, d]
is trained end-to-end with the BCE objective, and the masked mean-pooled
vector is concatenated to the 64 handcrafted features.

Deterministic (no Python ``hash`` seeding), dependency-free, and cheap at
serve time: hashing is ~10 us and the pooled gather is a [L, d] slice.
"""

from __future__ import annotations

import re

import numpy as np

EMBED_VOCAB = 4096   # hash-table rows (row 0 reserved for padding)
EMBED_LEN = 48       # max hashed ngrams kept per (prompt, draft) pair

_WORD_RE = re.compile(r"[a-z0-9]+")


def _fnv1a(data: bytes) -> int:
    h = 0xCBF29CE484222325
    for byte in data:
        h ^= byte
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def _ngrams(text: str, prefix: str) -> list[bytes]:
    """Word unigrams + char trigrams, namespaced by ``prefix`` so prompt and
    draft tokens hash to distinct rows."""
    text = text.lower()
    words = _WORD_RE.findall(text)[:24]
    grams = [f"{prefix}w:{w}".encode() for w in words]
    compact = "".join(words)[:48]
    grams += [f"{prefix}c:{compact[i:i + 3]}".encode() for i in range(len(compact) - 2)]
    return grams


def hash_indices(prompt: str, draft: str = "") -> tuple[np.ndarray, np.ndarray]:
    """(idx [EMBED_LEN] int32, mask [EMBED_LEN] float32). Index 0 = pad."""
    grams = _ngrams(prompt, "p")
    grams += _ngrams(draft, "d")
    idx = np.zeros(EMBED_LEN, np.int32)
    mask = np.zeros(EMBED_LEN, np.float32)
    n = min(len(grams), EMBED_LEN)
    for i in range(n):
        idx[i] = (_fnv1a(grams[i]) % (EMBED_VOCAB - 1)) + 1
        mask[i] = 1.0
    return idx, mask


def hash_batch(texts) -> tuple[np.ndarray, np.ndarray]:
    """texts: sequence of (prompt, draft) pairs or plain strings.
    Returns (IDX [N, EMBED_LEN], MASK [N, EMBED_LEN])."""
    idxs, masks = [], []
    for t in texts:
        if isinstance(t, str):
            i, m = hash_indices(t)
        else:
            i, m = hash_indices(t[0], t[1] if len(t) > 1 else "")
        idxs.append(i)
        masks.append(m)
    return np.stack(idxs), np.stack(masks)


def pool_np(table: np.ndarray, idx: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Host-side masked mean-pool: [N, L] indices -> [N, d]."""
    e = table[idx]                                   # [N, L, d]
    m = mask[..., None]
    return (e * m).sum(axis=-2) / np.maximum(m.sum(axis=-2), 1.0)
