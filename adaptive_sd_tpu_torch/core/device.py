"""Device selection: the port runs on CUDA unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``cuda``. Asking for CUDA where there is none raises:
    the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested (the default) but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def describe_device(device: Union[str, torch.device]) -> dict:
    """``{"name", "power_limit"}`` of the card as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them, for the
    measuring scripts' reports; on the CPU ``{"name": "cpu", "power_limit":
    None}``."""
    import subprocess

    if torch.device(device).type != "cuda":
        return {"name": "cpu", "power_limit": None}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        out = None
    if out is None or out.returncode != 0 or not out.stdout.strip():
        return {"name": torch.cuda.get_device_name(0), "power_limit": "nvidia-smi failed"}
    name, _, limit = out.stdout.strip().splitlines()[0].rpartition(",")
    return {"name": name.strip(), "power_limit": limit.strip()}
