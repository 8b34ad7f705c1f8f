"""The port's device rule: entry points run on the card unless asked not to.

``device=None`` means ``"cuda"``; with no CUDA device that raises instead of
carrying on quietly on the CPU. Tests pass ``device="cpu"``.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "koifish_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch paths on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def same_device(a: torch.device, b: torch.device) -> bool:
    """Device equality that treats ``cuda`` and ``cuda:<current>`` alike."""
    if a.type != b.type:
        return False
    if a.type == "cuda":
        cur = torch.cuda.current_device()
        return (a.index if a.index is not None else cur) == \
            (b.index if b.index is not None else cur)
    return True


def check_on(t: torch.Tensor, dev: torch.device, what: str) -> None:
    if not same_device(t.device, dev):
        raise ValueError(f"{what} lies on {t.device}, expected {dev}")
