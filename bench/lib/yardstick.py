"""Peaks of the card and the work a request or a token needs, from shapes.

The constants are NVIDIA's data sheet for the H100 SXM at its 700 W power
limit, dense rates (copied from ``chip_smoke.py``'s ``PEAK_*`` constants and
``launch/dryrun.py``'s ``PEAK_FLOPS_BF16`` / ``HBM_BW``).  A card set to a
lower limit runs slower under load: ``card()`` reads the limit, and every
result carries it beside these numbers.

The work is counted from the shapes the benchmark handed in, never from
what a kernel does, so it reads the same whatever implements it.
"""

from __future__ import annotations

import subprocess

PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_S = 3.35e12
DATASHEET_POWER_W = 700.0


def search_least_s(nq: int, n_rows: int, dim: int, k: int) -> float:
    """The least time one exact top-k request can take on the card: the
    larger of its products at the TF32 tensor-core rate (the least time any
    tensor-core product of float32 inputs takes) and its bytes at the HBM
    rate (every row read once, the queries read once, k (score, pk) pairs
    of 12 bytes written per query)."""
    compute = 2.0 * nq * n_rows * dim / PEAK_TF32_FLOPS
    moved = (n_rows * dim * 4 + nq * dim * 4 + nq * k * 12) / PEAK_BYTES_S
    return max(compute, moved)


def requests_least_s(requests: list[dict], dim: int) -> float:
    """``search_least_s`` summed over recorded requests, each over the
    live rows it was sent against (``n_live``)."""
    return sum(search_least_s(r["nq"], r["n_live"], dim, r["k"]) for r in requests)


def decoder_flops_per_token(model: dict, seq_len: int) -> float:
    """Model FLOPs of one token through a dense decoder's layers to the
    final norm (an embedder: no LM head, and the table lookup multiplies
    nothing): 2 per weight of the attention projections and the SwiGLU MLP
    (``launch/dryrun.py``'s 2 x active parameters x tokens, less the
    embedding table and the head), plus the causal attention products, QK
    and PV over the (S + 1) / 2 keys a token sees on average
    (``chip_smoke.embed_flops``)."""
    d = model["hidden_size"]
    hd = model.get("head_dim") or d // model["num_attention_heads"]
    q_dim = model["num_attention_heads"] * hd
    kv_dim = model["num_key_value_heads"] * hd
    weights = d * q_dim + 2 * d * kv_dim + q_dim * d + 3 * d * model["intermediate_size"]
    layers = model["num_hidden_layers"]
    attention = 2 * 2 * q_dim * (seq_len + 1) / 2
    return layers * (2.0 * weights + attention)


def card(query: str = "name,power.limit") -> str:
    """What ``nvidia-smi`` reads of the card: by default its name and power
    limit; the harness also logs clocks, power and temperature beside the
    window."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return out[0] if out else "not read"
