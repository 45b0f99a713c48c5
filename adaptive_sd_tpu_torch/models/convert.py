"""Parameters handed across from the JAX package, as numpy.

The port imports nothing of JAX, so the caller (a test) first turns the JAX
params pytree into numpy: every array leaf becomes an ``np.ndarray`` (bf16
arrays keep their ``bfloat16`` numpy dtype) and every ``QuantizedTensor``
becomes the tuple ``(q, scale, bits)``. :func:`params_from_jax` rebuilds the
port's params from that, byte for byte, on the requested device.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..core.device import resolve_device
from ..ops.quant import QuantizedTensor


def tensor_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """np.ndarray -> tensor with the same bytes (bfloat16 included)."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def params_from_jax(tree: Any, device=None) -> Any:
    """Rebuild a params tree: dicts and lists recurse, ``(q, scale, bits)``
    tuples become :class:`QuantizedTensor`, arrays become tensors."""
    device = resolve_device(device)

    def visit(node):
        if isinstance(node, dict):
            return {k: visit(v) for k, v in node.items()}
        if isinstance(node, list):
            return [visit(v) for v in node]
        if isinstance(node, tuple) and len(node) == 3 and isinstance(node[2], int):
            q, scale, bits = node
            return QuantizedTensor(tensor_from_numpy(q, device),
                                   tensor_from_numpy(scale, device), bits)
        if isinstance(node, np.ndarray):
            return tensor_from_numpy(node, device)
        raise TypeError(f"unexpected leaf {type(node).__name__} in params tree")

    return visit(tree)
