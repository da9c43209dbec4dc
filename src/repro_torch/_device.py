"""Device resolution shared by every constructor and entry point."""

from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device" = "cuda") -> torch.device:
    """The ``torch.device`` to place column data on.

    ``"cuda"`` is the default everywhere in the port; it raises when no
    GPU is visible instead of running on the CPU behind the caller's back.
    The CPU runs the kernels' plain PyTorch versions and is only taken
    when asked for by name.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: no CUDA device is available; pass device='cpu' "
            "to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"repro_torch: unsupported device {dev}")
    return dev
