"""The embedder's whole step against the card's peak: model FLOPs of the
tokens embedded in the window (from the shapes, the ``flops_per_token`` of
the reference module the configuration names) over the seconds from the
window's start to the last micro-batch's end inside it, times the dense
bf16 peak, in percent."""

from bench.lib import spec, yardstick


def read(rec: dict) -> float | None:
    end = rec["t0"] + rec["seconds"]
    done = [e for e in rec["embeds"] if e["t1"] <= end]
    if not done or rec["device"] is None:
        return None
    seq = rec["traffic"]["ingest"]["doc_tokens"]
    config = rec["config"]
    per_token = spec.reference(config["reference"]).flops_per_token(config["model"], seq)
    tokens = sum(e["tokens"] for e in done)
    last = max(e["t1"] for e in done)
    return 100.0 * tokens * per_token / ((last - rec["t0"]) * yardstick.PEAK_BF16_FLOPS)
