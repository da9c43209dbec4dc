"""Fault-tolerant embedder training with checkpoint / restart and ingestion,
on the PyTorch port (``examples/train_embedder.py`` on ``repro_torch``).

    PYTHONPATH=src python examples/torch_train_embedder.py --steps 120
    PYTHONPATH=src python examples/torch_train_embedder.py --steps 120 --crash-at 60
    # run again with the same arguments: training RESUMES from the last
    # committed checkpoint in the object store and runs to the end.

Trains a small LM on the synthetic corpus (the loss visibly falls), commits
step-atomic checkpoints to a ``FileObjectStore`` under ``--ckpt-dir``,
optionally simulates a crash (a fresh run exits with code 17 at
``--crash-at``; a resumed run does not crash again), then embeds a corpus
with the port's ``Embedder``, ingests it into the port's ``ManuSystem`` and
checks self-retrieval.  Runs on the card unless ``--device cpu`` is given.
``--preset full`` trains a ~100M-parameter model.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.core import ManuConfig, ManuSystem, Metric  # noqa: E402
from repro_torch.core.object_store import FileObjectStore  # noqa: E402
from repro_torch.models.embedder import Embedder  # noqa: E402
from repro_torch.train.loop import TrainConfig, train  # noqa: E402

CRASH_EXIT = 17


def build_cfg(preset: str):
    if preset == "full":  # ~100M parameters
        return ARCHS["yi-9b"].reduced(d_model=512, num_layers=12, num_heads=8, num_kv_heads=4,
                                      head_dim=64, d_ff=2048, vocab_size=8192)
    return ARCHS["yi-9b"].reduced(d_model=128, num_layers=2, vocab_size=512)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--crash-at", type=int, default=0,
                    help="simulate preemption after N steps of a fresh run (a rerun resumes)")
    ap.add_argument("--preset", choices=["small", "full"], default="small")
    ap.add_argument("--ckpt-dir", default="repro_torch_ckpts")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = build_cfg(args.preset)
    store = FileObjectStore(args.ckpt_dir)
    tc = TrainConfig(steps=args.steps, batch=8, seq_len=64, checkpoint_every=20,
                     run_name=f"embedder-{args.preset}")
    first_step = []

    def on_step(step, loss):
        first_step.append(step)
        if args.crash_at and first_step[0] == 0 and step + 1 >= args.crash_at:
            print(f"[train] simulating node failure at step {step + 1} "
                  f"(rerun this script: it resumes from the last checkpoint)")
            raise SystemExit(CRASH_EXIT)

    model, _opt, losses = train(cfg, store, tc, on_step=on_step, device=args.device)
    if losses:
        print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} over {len(losses)} steps")

    embedder = Embedder(cfg, model)
    corpus = np.random.default_rng(0).integers(0, cfg.vocab_size, (256, 64))
    embeds = embedder.embed(corpus)

    manu = ManuSystem(ManuConfig(num_query_nodes=2, seal_rows=128), device=args.device)
    coll = manu.create_collection("corpus", dim=cfg.d_model, metric=Metric.IP)
    coll.insert({"vector": embeds})
    coll.flush()
    res = coll.search(embeds[:3], limit=3, staleness_ms=0.0)
    top = res.pks[:, 0].cpu().numpy()
    print("self-retrieval sanity (row i should find pk i):", top)
    if not (top == np.arange(3)).all():
        raise AssertionError(f"self-retrieval failed: {top}")
    print("trained, checkpointed, ingested, searchable: done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
