"""HNSW proximity graph (Malkov & Yashunin), a host index (mirrors
``repro.index.hnsw``).

Graph walks are pointer-chasing; the reference keeps HNSW a host numpy
index, as production Milvus does, and so does the port: the same float32
numpy distance code, heap walk, neighbour heuristic, back-edge pruning,
level draw from ``default_rng(seed)`` and thread-local visited stamps, so
the port's graph is bit-identical to the reference's for the same rows and
seed (another summation order would give another graph).  ``search`` takes
the query node's tensors (queries and the ``valid`` mask move to the host)
and returns tensors on the index's device, per the port's search contract.

Parameters: M (graph degree), ef_construction, ef_search.  These are the
knobs the BOHB auto-tuner (autotune.py) explores.
"""

from __future__ import annotations

import heapq
import threading

import numpy as np
import torch

from ..core.collection import Metric
from .base import VectorIndex


def _host_rows(x) -> np.ndarray:
    """Rows (a tensor or host data) as a float32 numpy array."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def _normalize_if_cosine(metric: Metric, x: np.ndarray) -> np.ndarray:
    """The reference's numpy normalization (``repro.index.base``): the
    graph is built on exactly its unit vectors."""
    if metric is Metric.COSINE:
        norms = np.linalg.norm(x, axis=1, keepdims=True)
        return x / np.maximum(norms, 1e-12)
    return x


class HNSWIndex(VectorIndex):
    KIND = "hnsw"

    def __init__(
        self,
        metric: Metric = Metric.L2,
        m: int = 16,
        ef_construction: int = 100,
        ef_search: int = 64,
        seed: int = 0,
        device="cuda",
        **params,
    ):
        super().__init__(metric, device=device, m=m, ef_construction=ef_construction,
                         ef_search=ef_search, **params)
        self.m = m
        self.ef_construction = ef_construction
        self.ef_search = ef_search
        self.seed = seed
        self.vectors: np.ndarray | None = None
        self.levels: np.ndarray | None = None  # [n] max level per node
        self.graph: list[np.ndarray] = []  # per level: [n, M_l] neighbors (-1 pad)
        self.entry_point: int = -1
        self._tls = threading.local()  # per-thread visited scratch

    # ------------------------------------------------------------ distances
    def _dist(self, q: np.ndarray, ids: np.ndarray) -> np.ndarray:
        x = self.vectors[ids]
        if self.metric is Metric.L2:
            diff = x - q[None, :]
            return np.sum(diff * diff, axis=1)
        return -(x @ q)  # negated similarity => smaller is better everywhere

    # --------------------------------------------------------------- search
    def _visited_scratch(self) -> tuple[np.ndarray, int]:
        """Epoch-stamped visited array: `stamp[i] == epoch` means visited.

        Bumping the per-thread epoch resets the whole array in O(1), so a
        beam search costs O(nodes actually visited) instead of an O(n)
        allocation per call (build runs ~levels calls per inserted row).
        Thread-local keeps concurrent searches (hedged requests)
        independent.
        """
        tls = self._tls
        stamp = getattr(tls, "stamp", None)
        n = len(self.vectors)
        if stamp is None or len(stamp) < n:
            tls.stamp = np.zeros(n, np.int64)
            tls.epoch = 0
        tls.epoch += 1
        return tls.stamp, tls.epoch

    def _search_layer(self, q: np.ndarray, entry: int, ef: int, level: int) -> list[tuple[float, int]]:
        """Best-first beam search on one layer; returns [(dist, id)] sorted."""
        stamp, epoch = self._visited_scratch()
        stamp[entry] = epoch
        d0 = float(self._dist(q, np.array([entry]))[0])
        candidates = [(d0, entry)]  # min-heap
        results = [(-d0, entry)]  # max-heap of negatives
        graph = self.graph[level]
        while candidates:
            d_c, c = heapq.heappop(candidates)
            if d_c > -results[0][0] and len(results) >= ef:
                break
            neigh = graph[c]
            neigh = neigh[neigh >= 0]
            fresh = neigh[stamp[neigh] != epoch]  # vectorized visited mask
            if len(fresh) == 0:
                continue
            stamp[fresh] = epoch
            dists = self._dist(q, fresh)
            for dn, n in zip(dists.tolist(), fresh.tolist()):
                if len(results) < ef or dn < -results[0][0]:
                    heapq.heappush(candidates, (dn, n))
                    heapq.heappush(results, (-dn, n))
                    if len(results) > ef:
                        heapq.heappop(results)
        out = sorted((-nd, i) for nd, i in results)
        return out

    def _select_neighbors(self, q: np.ndarray, cand: list[tuple[float, int]], m: int) -> np.ndarray:
        """Heuristic neighbor selection (keeps diverse edges)."""
        selected: list[int] = []
        for d_c, c in sorted(cand):
            if len(selected) >= m:
                break
            ok = True
            if selected:
                d_to_sel = self._dist(self.vectors[c], np.array(selected))
                ok = bool((d_to_sel >= d_c).all())
            if ok:
                selected.append(c)
        # fill remainder with closest unselected
        if len(selected) < m:
            for d_c, c in sorted(cand):
                if c not in selected:
                    selected.append(c)
                    if len(selected) >= m:
                        break
        return np.array(selected[:m], dtype=np.int64)

    # ---------------------------------------------------------------- build
    def build(self, vectors) -> None:
        x = _normalize_if_cosine(self.metric, _host_rows(vectors))
        self.vectors = x
        n = len(x)
        self.num_rows = n
        if n == 0:
            return
        rng = np.random.default_rng(self.seed)
        ml = 1.0 / np.log(max(self.m, 2))
        self.levels = np.minimum(
            (-np.log(rng.random(n)) * ml).astype(np.int64), 8
        )
        max_level = int(self.levels.max())
        m0 = self.m * 2  # level-0 degree, per the paper
        self.graph = [
            np.full((n, m0 if l == 0 else self.m), -1, dtype=np.int64)
            for l in range(max_level + 1)
        ]
        self.entry_point = 0
        self.levels[0] = max_level  # first node spans all levels

        for i in range(1, n):
            q = x[i]
            lvl = int(self.levels[i])
            ep = self.entry_point
            # zoom down from top to lvl+1 greedily
            for l in range(int(self.levels[self.entry_point]), lvl, -1):
                if l >= len(self.graph):
                    continue
                res = self._search_layer(q, ep, 1, l)
                ep = res[0][1]
            # insert at each level from min(lvl, top) down to 0
            for l in range(min(lvl, len(self.graph) - 1), -1, -1):
                cand = self._search_layer(q, ep, self.ef_construction, l)
                m_l = self.graph[l].shape[1]
                neighbors = self._select_neighbors(q, cand, min(m_l, len(cand)))
                self.graph[l][i, : len(neighbors)] = neighbors
                # back-edges with pruning
                for nb in neighbors.tolist():
                    row = self.graph[l][nb]
                    free = np.nonzero(row < 0)[0]
                    if len(free):
                        row[free[0]] = i
                    else:
                        # prune with the DIVERSITY heuristic (plain
                        # closest-m pruning drops long-range bridge edges
                        # and disconnects clusters; -1 padding must never
                        # enter the ranking)
                        ids = np.concatenate([row[row >= 0], [i]])
                        d = self._dist(x[nb], ids)
                        cand = sorted(zip(d.tolist(), ids.tolist()))
                        keep = self._select_neighbors(x[nb], cand, m_l)
                        new_row = np.full(m_l, -1, dtype=np.int64)
                        new_row[: len(keep)] = keep
                        self.graph[l][nb] = new_row
                ep = cand[0][1]
        self.entry_point = int(np.argmax(self.levels))

    def search(self, queries, k, valid=None):
        q_all = _normalize_if_cosine(self.metric, _host_rows(queries))
        if torch.is_tensor(valid):
            valid = valid.cpu().numpy()
        nq = len(q_all)
        ef = max(int(self.params.get("ef_search", self.ef_search)), k)
        out_s = np.full((nq, k), np.inf, np.float32)
        out_i = np.full((nq, k), -1, np.int64)
        if self.num_rows == 0:
            return self._device_result(out_s, out_i)
        for r in range(nq):
            q = q_all[r]
            ep = self.entry_point
            for l in range(int(self.levels[self.entry_point]), 0, -1):
                if l >= len(self.graph):
                    continue
                ep = self._search_layer(q, ep, 1, l)[0][1]
            res = self._search_layer(q, ep, ef, 0)
            if valid is not None:
                res = [(d, i) for d, i in res if valid[i]]
            for j, (d, i) in enumerate(res[:k]):
                out_s[r, j] = d
                out_i[r, j] = i
        if self.metric is not Metric.L2:
            out_s = np.where(out_i >= 0, -out_s, -np.inf).astype(np.float32)
        return self._device_result(out_s, out_i)

    def _device_result(self, out_s: np.ndarray, out_i: np.ndarray):
        return (torch.from_numpy(out_s).to(self.device), torch.from_numpy(out_i).to(self.device))

    # ------------------------------------------------------------ serialize
    def _state(self):
        state = {
            "vectors": self.vectors,
            "levels": self.levels,
            "entry_point": np.int64(self.entry_point),
            "n_levels": np.int64(len(self.graph)),
        }
        for l, g in enumerate(self.graph):
            state[f"graph_{l}"] = g
        return state

    def _load_state(self, state):
        self.vectors = state["vectors"]
        self.levels = state["levels"]
        self.entry_point = int(state["entry_point"])
        self.graph = [state[f"graph_{l}"] for l in range(int(state["n_levels"]))]
        self.num_rows = len(self.vectors)
