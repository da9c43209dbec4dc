"""Write path (``core/proxy.py`` mutate, ``core/logger_node.py``,
``core/log.py``, ``core/data_node.py``): the mean milliseconds of the
benchmark's clock around each ``ManuCollection.insert`` call of the
window."""


def read(rec: dict) -> float | None:
    calls = [(i["t1"] - i["t0"]) * 1e3 for i in rec["inserts"]]
    return sum(calls) / len(calls) if calls else None
