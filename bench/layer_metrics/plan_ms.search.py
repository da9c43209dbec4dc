"""Query node (``core/query_node.py``, ``core/segment.py``): the mean per
request of the port's ``plan_search`` spans (host work on the host clock:
visibility masks, the tombstone probe, the plan), summed over the nodes a
request dispatched to."""


def _plans(span) -> float:
    own = span.duration_us if span.name == "plan_search" else 0.0
    return own + sum(_plans(c) for c in span.children)


def read(rec: dict) -> float | None:
    plans = [_plans(r["trace"].root) / 1e3 for r in rec["requests"] if r["trace"] is not None]
    return sum(plans) / len(plans) if plans else None
