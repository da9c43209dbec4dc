"""What one forward pass shows a caller that asks: spans of its sublayers
and counts of its routing, in the port's telemetry (``core/telemetry.py``).

``Embedder.embed`` makes one ``ForwardProbe`` a micro-batch when it is
given a ``TraceContext`` or a ``MetricsRegistry``, and hands it down
``model.hidden_states``; without one the model code takes no probe and
runs exactly as before (no span, no count, no launch, no readback).

Spans (children of the micro-batch's span, ``detail`` ``layer=<i>``,
device-timed on CUDA events where the model is on a card): ``attention``,
``mlp`` (a dense SwiGLU: the leading layers' and the shared experts'),
and on a dropless MoE layer ``moe_route``, ``moe_experts`` (the grouped
matrix products) and ``moe_combine``.  Counters, fed on the device (``inc_device``,
no readback until the registry is read), summed over layers:
``embedder_moe_expert_slots_total{expert}`` (slots routed to each expert)
and ``embedder_moe_dropped_slots_total`` (0 on a dropless path).
"""

from __future__ import annotations

import contextlib

import torch

SLOTS = "embedder_moe_expert_slots_total"
DROPPED = "embedder_moe_dropped_slots_total"

_NO_SPAN = contextlib.nullcontext()


def span(probe: "ForwardProbe | None", name: str):
    """``probe.span(name)``, or a context that does nothing without a probe."""
    return _NO_SPAN if probe is None else probe.span(name)


class ForwardProbe:
    """Spans under ``parent`` of ``trace`` (either may be None) and counts
    into ``metrics`` (or None) for one forward pass on ``device``."""

    def __init__(self, trace=None, parent=None, metrics=None, device=None):
        self.trace, self.parent, self.metrics = trace, parent, metrics
        self.device = None if device is None else torch.device(device)
        self.layer = -1
        self._slots: torch.Tensor | None = None
        self._dropped: torch.Tensor | None = None

    def next_layer(self) -> None:
        self.layer += 1

    def span(self, name: str):
        if self.trace is None:
            return _NO_SPAN
        s = self.trace.span(name, parent=self.parent, detail=f"layer={self.layer}")
        return self.trace.timed(s, self.device)

    def count_slots(self, per_expert: torch.Tensor) -> None:
        """Add one layer's slots routed to each expert ([E], on the device)."""
        if self.metrics is not None:
            self._slots = per_expert if self._slots is None else self._slots + per_expert

    def count_dropped(self, n: torch.Tensor) -> None:
        """Add one layer's dropped slots (a 0-d tensor on the device)."""
        if self.metrics is not None:
            self._dropped = n if self._dropped is None else self._dropped + n

    def flush(self) -> None:
        """Hand the pass's counts to the registry, still on the device."""
        if self.metrics is None or self._slots is None:
            return
        for e in range(self._slots.numel()):
            self.metrics.inc_device(SLOTS, self._slots[e], {"expert": str(e)})
        if self._dropped is None:
            self.metrics.inc(DROPPED, 0.0)
        else:
            self.metrics.inc_device(DROPPED, self._dropped)
