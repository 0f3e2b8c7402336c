"""Device selection for the port's entry points.

JAX counterpart: ``spearmint_tpu/utils/platform.py`` (``ensure_backend``).
Here the rule is strict: an entry point runs on ``cuda`` unless the caller
asks for the CPU, and raises when no card is present — it never moves to
the CPU on its own.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "spearmint_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
