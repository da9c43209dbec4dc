"""Everything a run feeds the system, made from ``--seed``.

Each stream (the rows set up, the query pool, the writer's rows, the
deletes, the documents, each layer's weights) has a generator of its own,
seeded from the run's seed and the stream's name, so one stream's draws
never depend on how much of another a run used.  Tensors are drawn on the
device in a few large calls.  Nothing here imports the program: the plain
references draw the same inputs from the same functions.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def stream_seed(seed: int, *names) -> int:
    """A 63-bit seed for one named stream of the run ``seed``."""
    s = int(seed) % (1 << 64)
    words = [s & 0xFFFFFFFF, s >> 32]
    for name in names:
        words += [ord(c) for c in str(name)] + [0x2F]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(device, seed: int, *names) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, *names))
    return gen


def mixture_centers(data: dict, dim: int, device, seed: int) -> torch.Tensor:
    """The Gaussian mixture's unit-normal centers (``chip_smoke.py``'s
    indexed and facade collections: 1,024 centers)."""
    gen = generator(device, seed, "centers")
    return torch.randn((data["centers"], dim), generator=gen, device=device)


def mixture_rows(data: dict, centers: torch.Tensor, n: int, device, seed: int, *stream) -> torch.Tensor:
    """``n`` rows of the mixture: a random center plus ``noise`` times
    unit-normal noise (``chip_smoke.mixture``), scaled to unit length where
    the configuration says so (embeddings, as the Cohere vectors are)."""
    gen = generator(device, seed, *stream)
    pick = torch.randint(0, len(centers), (n,), generator=gen, device=device)
    rows = centers[pick]
    rows.add_(torch.randn(rows.shape, generator=gen, device=device), alpha=data["noise"])
    if data.get("normalize"):
        rows.div_(torch.linalg.vector_norm(rows, dim=1, keepdim=True))
    return rows


def doomed_pks(n_rows: int, fraction: float, device, seed: int) -> torch.Tensor:
    """The pks (insert ordinals) set-up deletes: ``fraction`` of them,
    drawn without repeats, sorted."""
    gen = generator(device, seed, "deletes")
    n = int(n_rows * fraction)
    return torch.randperm(n_rows, generator=gen, device=device)[:n].sort().values


def synth_docs(rng: np.random.Generator, n: int, seq_len: int, vocab: int, n_topics: int):
    """``examples/serve_embedder.py``'s topic-biased documents, copied from
    ``chip_smoke.synth_docs``: each draws its tokens uniformly from its
    topic's slice of the vocabulary, so documents of one topic share a
    token distribution."""
    topics = rng.integers(0, n_topics, n)
    lo, hi = (topics * vocab) // n_topics, ((topics + 1) * vocab) // n_topics
    return rng.integers(lo[:, None], hi[:, None], (n, seq_len))


# --------------------------------------------------------- decoder weights
def layer_shapes(model: dict) -> list[tuple[str, tuple[int, ...], float]]:
    """(name, shape, scale) of one dense decoder layer's matrices, in the
    order they are drawn: normal draws times 1/sqrt(fan-in), the port's and
    the reference's initial distribution."""
    d = model["hidden_size"]
    hd = model.get("head_dim") or d // model["num_attention_heads"]
    q, kv, f = model["num_attention_heads"] * hd, model["num_key_value_heads"] * hd, model["intermediate_size"]
    return [
        ("attn.w_q", (d, q), 1 / math.sqrt(d)),
        ("attn.w_k", (d, kv), 1 / math.sqrt(d)),
        ("attn.w_v", (d, kv), 1 / math.sqrt(d)),
        ("attn.w_o", (q, d), 1 / math.sqrt(q)),
        ("mlp.w_gate", (d, f), 1 / math.sqrt(d)),
        ("mlp.w_up", (d, f), 1 / math.sqrt(d)),
        ("mlp.w_down", (f, d), 1 / math.sqrt(f)),
    ]


def norm_scales(model: dict, n: int, device, seed: int, *stream, dtype=torch.bfloat16) -> torch.Tensor:
    """``n`` RMSNorm scales [n, d]: 1 + 0.1 times a normal draw, so a
    program that skips or misplaces a norm's weight reads apart from the
    reference."""
    gen = generator(device, seed, "norms", *stream)
    return torch.randn((n, model["hidden_size"]), generator=gen, device=device, dtype=dtype).mul_(0.1).add_(1.0)


def layer_weights(model: dict, layer: int, device, seed: int, dtype=torch.bfloat16) -> dict:
    """Layer ``layer``'s matrices, drawn in one call into one buffer of
    ``dtype`` (bf16, the type they are served in) and scaled in place, and
    its two RMSNorm scales (``norm_scales``)."""
    shapes = layer_shapes(model)
    flat = torch.randn(sum(math.prod(s) for _n, s, _c in shapes), generator=generator(
        device, seed, "layer", layer), device=device, dtype=dtype)
    out, lo = {}, 0
    for name, shape, scale in shapes:
        n = math.prod(shape)
        out[name] = flat[lo:lo + n].view(shape).mul_(scale)
        lo += n
    out["ln_attn"], out["ln_mlp"] = norm_scales(model, 2, device, seed, layer, dtype=dtype)
    return out


def final_norm(model: dict, device, seed: int, dtype=torch.bfloat16) -> torch.Tensor:
    """The final RMSNorm's scale [d] (``norm_scales``)."""
    return norm_scales(model, 1, device, seed, "final", dtype=dtype)[0]


def embedding_table(model: dict, device, seed: int, dtype=torch.bfloat16) -> torch.Tensor:
    """The token embedding [vocab, d]: a normal draw times 0.02."""
    gen = generator(device, seed, "embed")
    shape = (model["vocab_size"], model["hidden_size"])
    return torch.randn(shape, generator=gen, device=device, dtype=dtype).mul_(0.02)
