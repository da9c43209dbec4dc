"""Device: the share of the traced window in which the card ran nothing
(``torch.profiler``'s device records), in percent, in cells that search."""


def read(rec: dict) -> float | None:
    dev = rec["device"]
    if not rec["requests"] or dev is None:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])
