"""PyTorch + CUDA port of the Manu reproduction (``repro``), for NVIDIA Hopper.

The package imports ``torch`` and never ``jax``.  Column data (vectors,
cosine unit columns, pks, timestamps, visibility masks) lives as device
tensors; control state (tombstone maps, plans, the log) stays in host
Python.  Every constructor and entry point takes ``device=`` (default
``"cuda"``) and raises when no GPU is present unless the caller passed
``device="cpu"`` explicitly -- it never drops to the CPU silently.
"""

from ._device import resolve_device

__all__ = ["resolve_device"]
