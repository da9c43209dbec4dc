"""Fault-tolerant training loop; mirrors ``repro.train.loop``.

Resume from the newest committed checkpoint, periodic commits with the two
newest kept, and the reference's synthetic LM corpus: the same numpy
``default_rng`` draws, so the batches are the reference's token for token.
Used by ``examples/torch_train_embedder.py`` and ``launch/train.py``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from .._device import resolve_device
from ..core.object_store import ObjectStore
from ..launch.steps import build_local_train_cell
from ..models import model as M
from ..models.config import ModelConfig
from .checkpoint import prune_checkpoints, restore_latest, save_checkpoint
from .optimizer import AdamWConfig, init_opt_state


@dataclass
class TrainConfig:
    steps: int = 100
    batch: int = 8
    seq_len: int = 64
    checkpoint_every: int = 25
    log_every: int = 10
    run_name: str = "run0"
    seed: int = 0


def synthetic_lm_batches(cfg: ModelConfig, tc: TrainConfig, device="cuda"):
    """Deterministic synthetic corpus: a Zipfian unigram stream in which
    every fourth position repeats the one four before it, so the loss falls
    visibly.  Yields ``{"tokens", "labels"}`` int64 [batch, seq_len] on
    ``device``; labels are the next tokens, -100 at the last position."""
    dev = resolve_device(device)
    rng = np.random.default_rng(tc.seed)
    zipf_p = 1.0 / np.arange(1, cfg.vocab_size + 1)
    zipf_p /= zipf_p.sum()
    while True:
        toks = rng.choice(cfg.vocab_size, size=(tc.batch, tc.seq_len), p=zipf_p)
        toks[:, 4::4] = toks[:, : tc.seq_len - 4 : 4][:, : toks[:, 4::4].shape[1]]
        tokens = toks.astype(np.int64)
        labels = np.roll(tokens, -1, axis=1)
        labels[:, -1] = -100
        yield {"tokens": torch.from_numpy(tokens).to(dev), "labels": torch.from_numpy(labels).to(dev)}


def train(cfg: ModelConfig, store: ObjectStore, tc: TrainConfig, adamw: AdamWConfig | None = None,
          batch_iter=None, on_step: Callable[[int, float], None] | None = None,
          device="cuda") -> tuple[M.Transformer, dict, list[float]]:
    """Run (or resume) training on ``device``; returns (the model, the
    optimizer state, the loss of every step this call ran)."""
    adamw = adamw or AdamWConfig(lr=3e-3, warmup_steps=20)
    dev = resolve_device(device)
    model = M.init_params(cfg, seed=tc.seed, device=dev)
    params = dict(model.named_parameters())
    opt_state = init_opt_state(params)
    start_step = 0
    resumed = restore_latest(cfg, store, tc.run_name, params, opt_state)
    if resumed is not None:
        start_step, saved, opt_state, _extra = resumed
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(saved[name])
        print(f"[train] resumed '{tc.run_name}' from step {start_step}")
    step_fn = build_local_train_cell(cfg, adamw, remat=True, seq_chunk=min(64, tc.seq_len))

    batches = batch_iter or synthetic_lm_batches(cfg, tc, dev)
    # data-pipeline restore: advance the stream to the resume point so a
    # resumed run consumes exactly the batches the lost run would have
    for _ in range(start_step):
        next(batches)
    losses: list[float] = []
    t0 = time.time()
    for step in range(start_step, tc.steps):
        model, opt_state, metrics = step_fn(model, opt_state, next(batches))
        loss = float(metrics["loss"])
        losses.append(loss)
        if on_step:
            on_step(step, loss)
        if (step + 1) % tc.log_every == 0:
            rate = (step + 1 - start_step) / max(time.time() - t0, 1e-9)
            print(f"[train] step {step + 1}/{tc.steps} loss={loss:.4f} ({rate:.1f} steps/s)")
        if (step + 1) % tc.checkpoint_every == 0 or step + 1 == tc.steps:
            save_checkpoint(cfg, store, tc.run_name, step + 1, params, opt_state)
            prune_checkpoints(store, tc.run_name, keep=2)
    return model, opt_state, losses
