"""The one general traffic generator: it reads a mix's parameters and
drives the deployment with them, in a warm-up and then in the measured
window.

A mix (``bench/traffic/<name>.json``) holds any of three streams:

- ``search``: one closed-loop client, sending its next request when the
  last answer is in host memory: ``nq`` queries from a
  pool of ``pool_requests`` requests drawn at set-up from the
  configuration's mixture, top ``k``, at consistency ``consistency``;
- ``write``: one open-loop writer thread inserting ``rows_per_batch`` fresh mixture rows every 1 /
  ``batches_per_s`` seconds, timed from when each batch was due (its
  lateness is how far the writer fell behind);
- ``ingest``: a closed loop embedding ``micro_batch`` documents of
  ``doc_tokens`` tokens (``topics`` topics) and inserting the embeddings
  as soon as they are made.

Every call into the program is timed on the host clock and recorded with
what the checks and the per-layer readers need.  The benchmark's ranges
(``search``, ``insert``, ``embed``, ``writer``) mark the calls for the
device trace.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from . import inputs

record = torch.profiler.record_function


class Records:
    """What one pass over the streams recorded: ``requests`` (search),
    ``inserts`` (each with ``t_ack`` and the rows acknowledged so far),
    ``embeds``, the documents embedded and their embeddings, and the
    exceptions raised (``errors``)."""

    def __init__(self):
        self.requests: list[dict] = []
        self.inserts: list[dict] = []
        self.embeds: list[dict] = []
        self.docs: list[np.ndarray] = []
        self.embeddings: list[torch.Tensor] = []
        self.errors: list[str] = []
        self.t0 = self.t1 = 0.0


class Traffic:
    def __init__(self, mix: dict, dep, seed: int, seconds: float):
        self.mix, self.dep = mix, dep
        self.device = dep.device
        self.lock = threading.Lock()
        # (host time the insert returned, rows acknowledged then) and
        # (host time an insert was called, rows that insert takes it to)
        self.acked: list[tuple[float, int]] = [(0.0, dep.n_rows)]
        self.called: list[tuple[float, int]] = [(0.0, dep.n_rows)]
        s = mix.get("search")
        if s:
            n = s["pool_requests"] * s["nq"]
            pool = inputs.mixture_rows(dep.config["data"], dep.centers, n, self.device, seed, "queries")
            self.pool = pool.view(s["pool_requests"], s["nq"], -1)
            self.staleness_s = dep.config["bounded_staleness_ms"] / 1e3 \
                if s["consistency"] == "BOUNDED" else 0.0
        w = mix.get("write")
        if w:
            # Every batch the warm-up and the window can ask for, drawn at
            # set-up in one call on the card and kept on the host only.
            n_batches = int(np.ceil(seconds * w["batches_per_s"])) + 2 + w.get("warmup_batches", 1)
            rows = inputs.mixture_rows(dep.config["data"], dep.centers, n_batches * w["rows_per_batch"],
                                       self.device, seed, "writer")
            self.writer_rows = rows.cpu().numpy().reshape(n_batches, w["rows_per_batch"], -1)
            del rows
            self.next_batch = 0
        g = mix.get("ingest")
        if g:
            self.doc_rng = np.random.default_rng(inputs.stream_seed(seed, "docs"))
        self.next_request = 0

    # -------------------------------------------------------- bookkeeping
    def _count_at(self, log: list[tuple[float, int]], t: float) -> int:
        with self.lock:
            return max(n for ts, n in log if ts <= t)

    def _insert(self, rows, rec: Records) -> None:
        t0 = time.perf_counter()
        with self.lock:
            self.called.append((t0, self.dep.n_rows + len(rows)))
        with record("insert"):
            res = self.dep.insert(rows)
        t1 = time.perf_counter()
        with self.lock:
            self.acked.append((t1, self.dep.n_rows))
        rec.inserts.append({"t0": t0, "t1": t1, "rows": len(rows), "n_after": self.dep.n_rows,
                            "lsn": int(res.watermark_ts)})

    # ------------------------------------------------------------ streams
    def _search_loop(self, rec: Records, until, trace: bool, count: int | None) -> None:
        s = self.mix["search"]
        done = 0
        while (count is None or done < count) and until():
            i = self.next_request
            self.next_request += 1
            q = self.pool[i % len(self.pool)]
            req = self.dep.search_request(q, s, trace)
            t0 = time.perf_counter()
            try:
                with record("search"):
                    res = self.dep.search(req)
                    scores, pks = res.scores.cpu(), res.pks.cpu()
            except Exception as exc:  # a failed request counts; the run goes on
                rec.errors.append(f"search {i}: {type(exc).__name__}: {exc}")
                continue
            finally:
                done += 1
            t1 = time.perf_counter()
            rec.requests.append({
                "i": i, "t0": t0, "t1": t1, "nq": len(q), "k": s["k"], "pool": i % len(self.pool),
                "must": self._count_at(self.acked, t0 - self.staleness_s),
                "visible": self._count_at(self.acked, t0), "may": self._count_at(self.called, t1),
                "scores": scores, "pks": pks, "trace": res.trace,
            })

    def _writer_loop(self, rec: Records, start: float, until, count: int | None) -> None:
        w = self.mix["write"]
        period = 1.0 / w["batches_per_s"]
        j = 0
        while (count is None or j < count) and self.next_batch < len(self.writer_rows):
            due = start + j * period
            if count is None:
                delay = due - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                if not until(due):
                    return
            b = self.next_batch
            self.next_batch += 1
            j += 1
            try:
                with record("writer"):
                    self._insert(self.writer_rows[b], rec)
            except Exception as exc:
                rec.errors.append(f"insert batch {b}: {type(exc).__name__}: {exc}")
                continue
            rec.inserts[-1]["due"] = due

    def _ingest_loop(self, rec: Records, until, count: int | None) -> None:
        g = self.mix["ingest"]
        vocab = self.dep.config["model"]["vocab_size"]
        done = 0
        while (count is None or done < count) and until():
            done += 1
            docs = inputs.synth_docs(self.doc_rng, g["micro_batch"], g["doc_tokens"], vocab, g["topics"])
            try:
                t0 = time.perf_counter()
                with record("embed"):
                    emb = self.dep.embed(docs)
                    if emb.device.type == "cuda":
                        torch.cuda.synchronize()
                t1 = time.perf_counter()
                rec.embeds.append({"t0": t0, "t1": t1, "docs": len(docs), "tokens": docs.size})
                self._insert(emb, rec)
            except Exception as exc:
                rec.errors.append(f"ingest batch {done}: {type(exc).__name__}: {exc}")
                continue
            rec.docs.append(docs)
            rec.embeddings.append(emb)

    # ------------------------------------------------------------ a pass
    def run(self, seconds: float | None, trace: bool = False, warmup: dict | None = None) -> Records:
        """One pass: for ``seconds`` of the host clock (the window), or the
        ``warmup`` counts of each stream.  Clients stop sending at the
        window's close; a call in flight then finishes and is recorded."""
        rec = Records()
        start = time.perf_counter()
        end = start + seconds if seconds is not None else None
        within = (lambda t=None: True) if end is None else \
            (lambda t=None: (time.perf_counter() if t is None else t) < end)
        warm = warmup or {}
        threads = []
        if "write" in self.mix:
            args = (self._writer_loop, rec, start, within, warm.get("write") if seconds is None else None)
            threads.append(threading.Thread(target=self._guard, args=args, name="bench-writer"))
        rec.t0 = start
        for t in threads:
            t.start()
        try:
            if "search" in self.mix:
                self._search_loop(rec, within, trace, warm.get("search") if seconds is None else None)
            if "ingest" in self.mix:
                self._ingest_loop(rec, within, warm.get("ingest") if seconds is None else None)
        finally:
            for t in threads:
                t.join()
        rec.t1 = end if end is not None else time.perf_counter()
        return rec

    @staticmethod
    def _guard(loop, rec: Records, *args) -> None:
        try:
            loop(rec, *args)
        except Exception as exc:
            rec.errors.append(f"{loop.__name__}: {type(exc).__name__}: {exc}")
