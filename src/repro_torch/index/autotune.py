"""BOHB-style automatic index-parameter configuration (paper §4.2)
(mirrors ``repro.index.autotune``).

Bayesian Optimization with Hyperband: successive halving allocates budget
(training-sample size) across configurations; a TPE-lite density model
(good/bad quantile split, Gaussian KDE per dimension) proposes new
candidates near historically good regions.  Users supply a utility function
over (recall, qps) and a total budget.

No external dependency — this is a faithful, self-contained BOHB-lite.
The proposals are the reference's numpy draws; each trial builds and
searches the port's index on ``device``: the clock starts once the build's
device work is done and stops once the answer is back on the host, so a
trial's time covers the search's device work and nothing of the build.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from .._device import resolve_device
from ..core.collection import Metric
from .base import IndexSpec
from .kmeans import _as_rows
from .registry import create_index


@dataclass
class ParamSpace:
    """Discrete/log-int search dimensions: name -> sorted candidate values."""

    dims: dict[str, list[Any]]

    def sample(self, rng: np.random.Generator) -> dict[str, Any]:
        return {k: v[rng.integers(len(v))] for k, v in self.dims.items()}

    def index_of(self, cfg: dict[str, Any]) -> np.ndarray:
        return np.array(
            [self.dims[k].index(cfg[k]) for k in sorted(self.dims)], dtype=np.float64
        )

    def from_indices(self, idx: np.ndarray) -> dict[str, Any]:
        keys = sorted(self.dims)
        return {
            k: self.dims[k][int(np.clip(round(i), 0, len(self.dims[k]) - 1))]
            for k, i in zip(keys, idx)
        }


DEFAULT_SPACES: dict[str, ParamSpace] = {
    "ivf_flat": ParamSpace({"nlist": [16, 32, 64, 128, 256], "nprobe": [1, 2, 4, 8, 16, 32]}),
    "ivf_sq": ParamSpace({"nlist": [16, 32, 64, 128, 256], "nprobe": [1, 2, 4, 8, 16, 32]}),
    "ivf_pq": ParamSpace({"nlist": [16, 32, 64], "nprobe": [2, 4, 8, 16], "m": [4, 8, 16]}),
    "hnsw": ParamSpace({"m": [8, 16, 32], "ef_construction": [50, 100, 200], "ef_search": [16, 32, 64, 128]}),
    "bucket": ParamSpace({"target_bucket_rows": [48, 96, 120], "replicas": [1, 2, 3], "nprobe_buckets": [4, 8, 16, 32]}),
}


@dataclass
class Trial:
    config: dict[str, Any]
    budget_rows: int
    utility: float
    recall: float
    qps: float


@dataclass
class TuneResult:
    best_config: dict[str, Any]
    best_utility: float
    trials: list[Trial] = field(default_factory=list)


def evaluate_config(
    kind: str,
    metric: Metric,
    config: dict[str, Any],
    base,
    queries,
    gt_idx: np.ndarray,
    k: int,
    device="cuda",
) -> tuple[float, float]:
    """Returns (recall@k, qps) for one configuration on one budget slice."""
    device = resolve_device(device)
    q = _as_rows(queries, device)
    idx = create_index(IndexSpec(kind=kind, metric=metric, params=config), device=device)
    idx.build(_as_rows(base, device))
    if device.type == "cuda":
        torch.cuda.synchronize(device)  # the build's queued kernels stay off the clock
    t0 = time.perf_counter()
    _s, found = idx.search(q, k)
    found = found.cpu().numpy()  # the read-back waits for the device
    dt = max(time.perf_counter() - t0, 1e-9)
    qps = len(queries) / dt
    hits = 0
    for r in range(len(queries)):
        hits += len(set(found[r].tolist()) & set(gt_idx[r].tolist()))
    recall = hits / (len(queries) * k)
    return recall, qps


def _tpe_propose(
    space: ParamSpace,
    history: list[Trial],
    rng: np.random.Generator,
    n_candidates: int = 24,
    gamma: float = 0.3,
) -> dict[str, Any]:
    """TPE-lite: sample candidates, score by good/bad KDE ratio."""
    if len(history) < 6:
        return space.sample(rng)
    utilities = np.array([t.utility for t in history])
    cut = np.quantile(utilities, 1 - gamma)
    good = np.stack([space.index_of(t.config) for t in history if t.utility >= cut])
    bad_trials = [t for t in history if t.utility < cut]
    bad = (
        np.stack([space.index_of(t.config) for t in bad_trials])
        if bad_trials
        else np.zeros((1, good.shape[1]))
    )

    def kde(pts: np.ndarray, x: np.ndarray) -> float:
        bw = 1.0
        d2 = np.sum((pts - x[None, :]) ** 2, axis=1)
        return float(np.exp(-d2 / (2 * bw * bw)).mean() + 1e-9)

    best_cfg, best_score = None, -np.inf
    for _ in range(n_candidates):
        cfg = space.sample(rng)
        x = space.index_of(cfg)
        score = kde(good, x) / kde(bad, x)
        if score > best_score:
            best_cfg, best_score = cfg, score
    return best_cfg


def bohb_tune(
    kind: str,
    base: np.ndarray,
    queries: np.ndarray,
    metric: Metric = Metric.L2,
    k: int = 10,
    utility: Callable[[float, float], float] | None = None,
    max_trials: int = 16,
    min_budget_rows: int = 2_000,
    eta: int = 2,
    seed: int = 0,
    space: ParamSpace | None = None,
    device="cuda",
) -> TuneResult:
    """Hyperband outer loop + TPE proposals (paper §4.2).

    Budget = number of base rows used for the trial build; successive
    halving promotes the best configs to larger row budgets.
    """
    from .flat import FlatIndex

    rng = np.random.default_rng(seed)
    space = space or DEFAULT_SPACES[kind]
    utility = utility or (lambda recall, qps: recall + 0.05 * np.log10(max(qps, 1.0)))

    max_budget = len(base)
    budgets = [min(min_budget_rows * (eta ** i), max_budget) for i in range(8)]
    budgets = sorted(set(b for b in budgets if b <= max_budget)) or [max_budget]

    # Ground truth per budget slice, computed once with FLAT.
    gt_cache: dict[int, np.ndarray] = {}

    def gt_for(b: int) -> np.ndarray:
        if b not in gt_cache:
            flat = FlatIndex(metric=metric, device=device)
            flat.build(_as_rows(base[:b], flat.device))
            _s, i = flat.search(_as_rows(queries, flat.device), k)
            gt_cache[b] = i.cpu().numpy()
        return gt_cache[b]

    history: list[Trial] = []
    n_initial = max(2, max_trials // 2)
    ladder: list[dict[str, Any]] = [
        _tpe_propose(space, history, rng) for _ in range(n_initial)
    ]
    trials_done = 0
    rung = 0
    while trials_done < max_trials and ladder:
        b = budgets[min(rung, len(budgets) - 1)]
        scored: list[tuple[float, dict[str, Any]]] = []
        for cfg in ladder:
            if trials_done >= max_trials:
                break
            recall, qps = evaluate_config(kind, metric, cfg, base[:b], queries, gt_for(b), k,
                                          device=device)
            u = utility(recall, qps)
            history.append(Trial(cfg, b, u, recall, qps))
            scored.append((u, cfg))
            trials_done += 1
        scored.sort(key=lambda t: -t[0])
        keep = max(1, len(scored) // eta)
        ladder = [cfg for _u, cfg in scored[:keep]]
        if len(ladder) <= 1 and trials_done < max_trials:
            ladder.append(_tpe_propose(space, history, rng))
        rung += 1

    best = max(history, key=lambda t: t.utility)
    return TuneResult(best_config=best.config, best_utility=best.utility, trials=history)
