"""Device resolution for the port's entry points.

Every entry point that places tensors (``TesseraeScheduler``,
``MatchContext``, ``solve_lap_batched``, ``plan_migration``) takes an
explicit ``device``.  ``None`` means the card: the port runs on CUDA unless
the caller asks for the CPU (the CPU tests pass ``device="cpu"``).  There is
no silent fallback — asking for CUDA on a host without it raises.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise if a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: a CUDA device was requested (the default) but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "on the CPU explicitly"
        )
    return dev
