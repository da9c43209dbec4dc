"""The comparisons that decide ``correct``, run once the window has closed.

Each returns numbers by short plain names; the configuration's ``limits``
give each its limit, and a run is correct when every number is at or
under its limit and no call failed.

- ``search_gap`` (sampled requests): the widest of (a) a returned score's
  distance from the reference's float64 score of the same pk, and (b) by
  how much the best row the request was bound to see and did not return
  beats the worst row it did return (0 for an exact top-k; near-ties give
  rounding).  The rows a request is bound to see are those acknowledged
  more than the staleness bound before it was sent (every row, at STRONG
  or with no writes in flight), less the deleted ones.
- ``bad_pks``: returned pks that are deleted, were not yet inserted when
  the answer came back, repeat within a query, or are missing (-1) where
  the request was bound to see k rows.
- ``embed_gap`` (sampled documents): the largest L2 distance between an
  embedding the program made in the window and the plain float32
  reference's embedding of the same document (the reference module the
  configuration names).
- ``readback_bad``: of a sample of the rows acknowledged in the window, the
  ones a STRONG top-1 search by their own vector does not answer with
  their own pk and, hydrated, exactly the vector that was inserted.

Samples are drawn from the seed; each holds the last request or row of
the window (the one most likely to be cut short) and, for search, the
slowest request.
"""

from __future__ import annotations

import numpy as np
import torch

from bench.reference import exact_search

from . import inputs, spec


def _sample(n: int, want: int, seed: int, name: str, always=()) -> list[int]:
    rng = np.random.default_rng(inputs.stream_seed(seed, "check", name))
    picked = set(int(i) for i in always if 0 <= i < n)
    rest = [i for i in rng.permutation(n).tolist() if i not in picked]
    return sorted(picked | set(rest[: max(0, want - len(picked))]))


def host(rows) -> np.ndarray:
    return rows.cpu().numpy() if isinstance(rows, torch.Tensor) else rows


def all_rows(dep) -> torch.Tensor:
    """Every row inserted, on the card (run once the program's state is
    freed)."""
    out = torch.empty((dep.n_rows, dep.config["dim"]), dtype=torch.float32, device=dep.device)
    lo = 0
    for chunk in dep.rows:
        out[lo:lo + len(chunk)].copy_(torch.as_tensor(chunk))
        lo += len(chunk)
    return out


def search(rec, dep, traffic_pool, seed: int, want: int, control: bool = False) -> dict:
    """``search_gap`` and ``bad_pks`` over a seeded sample of the window's
    requests (``control``: the TF32 reference's answers in the program's
    place)."""
    reqs = rec.requests
    if not reqs:
        return {"search_gap": float("inf"), "bad_pks": 1}
    slowest = max(range(len(reqs)), key=lambda i: reqs[i]["t1"] - reqs[i]["t0"])
    rows = all_rows(dep)
    metric = dep.metric
    larger = exact_search.LARGER_IS_BETTER[metric]
    sign = 1.0 if larger else -1.0
    deleted = dep.deleted
    gap, bad = 0.0, 0
    for idx in _sample(len(reqs), want, seed, "search", (len(reqs) - 1, slowest)):
        r = reqs[idx]
        q = traffic_pool[r["pool"]]
        must, may, k = r["must"], r["may"], r["k"]
        dead = deleted[deleted < must]
        ref_s, ref_i = exact_search.topk(q, rows[:must], k, metric, exclude=dead)
        got_s, got_p = r["scores"].to(rows.device), r["pks"].to(rows.device)
        if control:
            got_s, got_p = exact_search.topk(q, rows[:must], k, metric, exclude=dead, precision="tf32")
        valid = got_p >= 0
        srt = got_p.sort(dim=1).values
        dup = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
        missing = (~valid) & (must - len(dead) >= k)
        wrong = valid & ((got_p >= may) | torch.isin(got_p, deleted))
        bad += int(dup.sum() + missing.sum() + wrong.sum())
        ok = valid & (got_p < may)
        ref_got = exact_search.scores_of(q, rows, torch.where(ok, got_p, 0), metric)
        if bool(ok.any()):
            gap = max(gap, float((got_s.double() - ref_got).abs()[ok].max()))
        # The best row bound to be seen and not returned, against the worst
        # row returned (both by the reference's scores).
        worst = torch.where(ok, sign * ref_got, float("inf")).min(1).values
        unseen = ~(ref_i[:, :, None] == got_p[:, None, :]).any(2)
        best_unseen = torch.where(unseen, sign * ref_s, float("-inf")).max(1).values
        gap = max(gap, float((best_unseen - worst).clamp_min(0).max()))
    return {"search_gap": gap, "bad_pks": bad}


def readback(rec, dep, seed: int, want: int) -> dict:
    """``readback_bad`` over a seeded sample of the rows the window's
    inserts acknowledged."""
    if not rec.inserts:
        return {"readback_bad": 1}
    # Each acknowledged insert holds one chunk of ``dep.rows``, the window's last.
    rows = np.concatenate([host(r) for r in dep.rows[-len(rec.inserts):]])
    picks = torch.tensor(_sample(len(rows), want, seed, "readback", (len(rows) - 1,)), dtype=torch.int64)
    vecs = rows[picks.numpy()]
    pks, stored = dep.readback(vecs)
    same = np.all(stored == vecs, axis=1)
    want_pks = picks + (dep.n_rows - len(rows))
    return {"readback_bad": int((~(pks == want_pks).numpy() | ~same).sum())}


def embeddings(rec, config: dict, seed: int, want: int, device, control: bool = False) -> dict:
    """``embed_gap`` over a seeded sample of the documents embedded in the
    window (``control``: the fp8 reference's embeddings in the program's
    place)."""
    if not rec.docs:
        return {"embed_gap": float("inf")}
    docs = np.concatenate(rec.docs)
    picks = _sample(len(docs), want, seed, "embed", (len(docs) - 1,))
    got = torch.cat(rec.embeddings)[torch.tensor(picks, device=rec.embeddings[0].device)].float()
    tokens = torch.as_tensor(docs[picks])
    reference = spec.reference(config["reference"])
    ref = reference.embed(tokens, config["model"], seed, device)
    if control:
        got = reference.embed(tokens, config["model"], seed, device, precision="fp8")
    return {"embed_gap": float(torch.linalg.vector_norm(got.to(ref.device) - ref, dim=1).max())}
