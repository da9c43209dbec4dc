"""End-to-end serving driver: a small LM serves batched embedding requests
feeding a Manu collection — the paper's "embedding generation toolbox"
integrated with the database — on the PyTorch port
(``examples/serve_embedder.py`` on ``repro_torch``).

    PYTHONPATH=src python examples/torch_serve_embedder.py [--requests 64] [--device cpu]

Pipeline: (1) instantiate a reduced `yi-9b`-family embedder, (2) embed a
synthetic document corpus and ingest it through the log backbone, (3) serve
batched query requests: each batch is embedded by the jitted model and
searched with bounded staleness, with fresh documents streaming in
concurrently — demonstrating the delta-consistency trade-off end to end.

Runs on the card unless ``--device cpu`` is given.  Exits non-zero unless
every batch is answered (k hits per query) while the streamed documents
land in the collection.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.core import ManuConfig, ManuSystem, Metric  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.embedder import Embedder  # noqa: E402


def synth_docs(rng, n, seq_len, vocab, n_topics=16):
    """Synthetic 'documents': topic-biased token streams (related docs share
    token distributions, so embeddings cluster meaningfully)."""
    topics = rng.integers(0, n_topics, n)
    toks = np.empty((n, seq_len), np.int32)
    for i, t in enumerate(topics):
        lo = (t * vocab) // n_topics
        hi = ((t + 1) * vocab) // n_topics
        toks[i] = rng.integers(lo, hi, seq_len)
    return toks, topics


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--docs", type=int, default=512)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = ARCHS["yi-9b"].reduced(d_model=128, num_layers=2, vocab_size=512)
    params = M.init_params(cfg, seed=0, device=args.device)
    embedder = Embedder(cfg, params, max_batch=args.batch)
    print(f"embedder: {cfg.name}-reduced d={embedder.dim} "
          f"({sum(p.numel() for p in params.parameters())/1e6:.1f}M params) on {embedder.device}")

    rng = np.random.default_rng(0)
    docs, topics = synth_docs(rng, args.docs, 32, cfg.vocab_size)
    t0 = time.time()
    doc_embeds = embedder.embed(docs)
    print(f"embedded {args.docs} docs in {time.time()-t0:.2f}s")

    manu = ManuSystem(ManuConfig(num_query_nodes=2, seal_rows=256), device=args.device)
    coll = manu.create_collection("docs", dim=embedder.dim, metric=Metric.IP)
    coll.create_index("vector", kind="ivf_flat", params={"nlist": 8, "nprobe": 4})
    coll.insert({"vector": doc_embeds})
    coll.flush()

    # serve batched requests while new docs stream in
    hits = answered = streamed = 0
    lat = []
    for step in range(0, args.requests, args.batch):
        fresh, fresh_topics = synth_docs(rng, 8, 32, cfg.vocab_size)
        coll.insert({"vector": embedder.embed(fresh)})
        streamed += len(fresh)
        q_toks, q_topics = synth_docs(rng, args.batch, 32, cfg.vocab_size)
        t0 = time.perf_counter()
        q_emb = embedder.embed(q_toks)
        res = coll.search(q_emb, limit=5, staleness_ms=200.0)
        pks = res.pks.cpu().numpy()
        lat.append(time.perf_counter() - t0)
        answered += int((pks >= 0).all(1).sum())
        # quality: does the top hit share the query's topic?
        for r in range(args.batch):
            top = pks[r][0]
            if top >= 0 and top < len(topics) and topics[top] == q_topics[r]:
                hits += 1
    total = args.requests
    print(f"served {total} requests in batches of {args.batch}: "
          f"mean latency {np.mean(lat)*1e3:.1f} ms/batch "
          f"(embed+search), topic-match@1 = {hits/total:.2f}")
    print("stats:", {k: v for k, v in manu.stats().items() if k != 'log'})
    rows = coll.num_entities()
    ok = answered == total and rows == args.docs + streamed
    print(f"check: {answered} of {total} queries answered with 5 hits at staleness 200 ms; "
          f"{rows} rows ({args.docs} docs + {streamed} streamed): {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
