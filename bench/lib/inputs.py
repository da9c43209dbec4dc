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


# ----------------------------------------------------------- model weights
def layer_weights(parameters, layer: int, device, seed: int, dtype=torch.bfloat16) -> dict:
    """Layer ``layer``'s parameters as a reference's ``layer_parameters``
    lists them, ``(name, shape, init)``, in ``dtype`` (bf16, the type they
    are served in).  Those whose ``init`` is a scale are drawn in list
    order into one buffer from the stream ``("layer", layer)`` and scaled in
    place (normal draws times the scale: 1/sqrt(fan-in), the port's and the
    references' initial distribution); those whose ``init`` is ``"norm"``
    are drawn in list order into one buffer from ``("norms", layer)`` as
    1 + 0.1 times a normal draw, so a program that skips or misplaces a
    norm's weight reads apart from the reference."""
    out = {}
    for stream, norm in (("layer", False), ("norms", True)):
        picked = [(n, s, i) for n, s, i in parameters if (i == "norm") == norm]
        if not picked:
            continue
        flat = torch.randn(sum(math.prod(s) for _n, s, _i in picked), generator=generator(
            device, seed, stream, layer), device=device, dtype=dtype)
        lo = 0
        for name, shape, init in picked:
            n = math.prod(shape)
            w = flat[lo:lo + n].view(shape)
            out[name] = w.mul_(0.1).add_(1.0) if norm else w.mul_(init)
            lo += n
    return out


def model_weights(model: dict, layer_parameters, num_layers: int, device, seed: int) -> dict:
    """Every parameter of an embedder by the port's state-dict names: the
    token embedding (``embed``), ``layers.<i>.<name>`` for each of
    ``num_layers`` layers as ``layer_parameters(model, i)`` lists them
    (``layer_weights``), and the final norm (``ln_final``)."""
    state = {"embed": embedding_table(model, device, seed), "ln_final": final_norm(model, device, seed)}
    for layer in range(num_layers):
        for name, w in layer_weights(layer_parameters(model, layer), layer, device, seed).items():
            state[f"layers.{layer}.{name}"] = w
    return state


def final_norm(model: dict, device, seed: int, dtype=torch.bfloat16) -> torch.Tensor:
    """The final RMSNorm's scale [d]: 1 + 0.1 times a normal draw from the
    stream ``("norms", "final")``."""
    gen = generator(device, seed, "norms", "final")
    return torch.randn(model["hidden_size"], generator=gen, device=device, dtype=dtype).mul_(0.1).add_(1.0)


def embedding_table(model: dict, device, seed: int, dtype=torch.bfloat16) -> torch.Tensor:
    """The token embedding [vocab, d]: a normal draw times 0.02."""
    gen = generator(device, seed, "embed")
    shape = (model["vocab_size"], model["hidden_size"])
    return torch.randn(shape, generator=gen, device=device, dtype=dtype).mul_(0.02)
