"""Embedder model (``models/embedder.py``, ``models/model.py``,
``models/layers.py``): the mean milliseconds of the benchmark's clock
around each ``Embedder.embed`` micro-batch of the window, ending in
``torch.cuda.synchronize()``."""


def read(rec: dict) -> float | None:
    calls = [(e["t1"] - e["t0"]) * 1e3 for e in rec["embeds"]]
    return sum(calls) / len(calls) if calls else None
