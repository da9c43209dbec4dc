"""The system under test, built from a configuration file.

This is the only module of the benchmark that imports the program, the
PyTorch port ``repro_torch`` (from ``src/`` of the checkout).  It builds
what the configuration describes and returns the handles the traffic
drives:

- ``"kind": "vectors"``: a threaded ``ManuSystem`` holding one collection
  of ``rows`` mixture vectors inserted through ``ManuCollection.insert``
  and flushed, with ``delete_fraction`` of the pks deleted after the flush;
- ``"kind": "embedder"``: a dense decoder (the configuration's ``model``,
  weights drawn by the benchmark) as the port's ``Embedder``, feeding an
  empty collection of a threaded ``ManuSystem``.

Each set-up step's seconds go into ``phases``.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from . import inputs
from .spec import ROOT

COLLECTION = "bench"


def import_port():
    """The port's modules the benchmark drives."""
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    from repro_torch.core import (  # noqa: PLC0415 - the program loads here, not at import
        ConsistencyLevel, InsertRequest, ManuConfig, ManuSystem, Metric, SearchRequest,
    )
    return dict(ConsistencyLevel=ConsistencyLevel, InsertRequest=InsertRequest, ManuConfig=ManuConfig,
                ManuSystem=ManuSystem, Metric=Metric, SearchRequest=SearchRequest)


class Deployment:
    """Handles of a built system: ``manu``, ``coll``, the rows inserted so
    far (``rows``, pk = insert ordinal: host arrays for drawn rows, the
    program's embeddings as it made them), the deleted pks, and for an
    embedder ``embedder``.  The benchmark keeps no copy of the drawn rows
    on the card, so the card holds the deployment alone."""

    def __init__(self, config: dict, device, seed: int, phases: dict):
        self.config, self.device, self.seed, self.phases = config, device, seed, phases
        self.port = import_port()
        self.metric = config["metric"]
        self.rows: list = []
        self.n_rows = 0
        self.deleted = torch.empty(0, dtype=torch.int64, device=device)
        self.embedder = None
        self.manu = None
        self.coll = None

    # ------------------------------------------------------------ set-up
    def start(self) -> None:
        p, c = self.port, self.config
        t = time.perf_counter()
        cfg = dict(c["manu"])
        cfg.setdefault("bounded_staleness_ms", c.get("bounded_staleness_ms", 2_000.0))
        self.manu = p["ManuSystem"](p["ManuConfig"](**cfg, threaded=True, manual_clock=False),
                                    device=self.device)
        self.coll = self.manu.create_collection(COLLECTION, dim=c["dim"], metric=p["Metric"](self.metric))
        if c.get("index"):
            self.coll.create_index("vector", c["index"]["kind"], c["index"].get("params") or {})
        self.phases["system_start_s"] = time.perf_counter() - t

    def insert(self, rows):
        """Insert ``rows`` (a host array or a tensor) through
        ``ManuCollection.insert``; returns the ``MutationResult`` and
        records the rows under the pks it acknowledged."""
        res = self.coll.insert(self.port["InsertRequest"]({"vector": rows}))
        want = np.arange(self.n_rows, self.n_rows + len(rows))
        if not np.array_equal(np.asarray(res.pks), want):
            raise AssertionError(f"insert acknowledged pks {np.asarray(res.pks)[:4]}..., not the "
                                 f"insert ordinals {want[:4]}...")
        self.rows.append(rows)
        self.n_rows += len(rows)
        return res

    def load_rows(self) -> None:
        """``rows`` mixture vectors through the proxy in ``insert_batch``
        batches, ``flush()`` until every sealed segment is loaded with its
        index, then the deletes."""
        c = self.config
        t = time.perf_counter()
        self.centers = inputs.mixture_centers(c["data"], c["dim"], self.device, self.seed)
        host = inputs.mixture_rows(c["data"], self.centers, c["rows"], self.device, self.seed,
                                   "rows").cpu().numpy()
        self.phases["data_s"] = time.perf_counter() - t
        t = time.perf_counter()
        batch = c["insert_batch"]
        for lo in range(0, c["rows"], batch):
            self.insert(host[lo:lo + batch])
        self.phases["insert_calls_s"] = time.perf_counter() - t
        # The pump thread consumes the log behind the inserts; flush() waits
        # only 30 s for it, so the backlog is drained first.
        self.manu.wait_idle(timeout_s=600.0)
        self.phases["ingest_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.coll.flush()
        self.wait_loaded()
        self.phases["flush_s"] = time.perf_counter() - t
        t = time.perf_counter()
        if c.get("delete_fraction"):
            self.deleted = inputs.doomed_pks(c["rows"], c["delete_fraction"], self.device, self.seed)
            self.coll.delete(self.deleted.cpu().numpy())
        self.manu.wait_idle(timeout_s=120.0)
        self.phases["delete_s"] = time.perf_counter() - t

    def wait_loaded(self, timeout_s: float = 300.0) -> None:
        """Until every sealed segment is loaded on a query node with the
        configured index and the sealed segments hold every row."""
        kind = (self.config.get("index") or {}).get("kind")
        nodes = list(self.manu.query_nodes.values())
        deadline = time.time() + timeout_s
        while True:
            self.manu.wait_idle(timeout_s=max(1.0, deadline - time.time()))
            held = {sid: h for n in nodes for (cn, sid), h in n.sealed.items() if cn == COLLECTION}
            sealed = self.manu.data_coord.sealed_segments(COLLECTION)
            if (sorted(held) == sealed and all(h.index is not None and h.index.KIND == kind
                                               for h in held.values() if kind)
                    and sum(h.segment.num_rows for h in held.values()) == self.n_rows):
                return
            if time.time() > deadline:
                raise TimeoutError(f"flush left {sealed} sealed, {sorted(held)} loaded")
            time.sleep(0.01)

    def load_embedder(self, max_batch: int) -> None:
        """The configuration's decoder with the benchmark's weights, as the
        port's ``Embedder``."""
        from repro_torch.models import model as M  # noqa: PLC0415
        from repro_torch.models.config import ModelConfig  # noqa: PLC0415
        from repro_torch.models.embedder import Embedder  # noqa: PLC0415

        m = self.config["model"]
        t = time.perf_counter()
        cfg = ModelConfig(
            name=self.config["name"], family="dense", num_layers=m["num_hidden_layers"],
            d_model=m["hidden_size"], num_heads=m["num_attention_heads"],
            num_kv_heads=m["num_key_value_heads"], head_dim=m["head_dim"], d_ff=m["intermediate_size"],
            vocab_size=m["vocab_size"], rope_theta=m["rope_theta"], norm_eps=m["rms_norm_eps"],
        )
        state = {"embed": inputs.embedding_table(m, self.device, self.seed),
                 "ln_final": inputs.final_norm(m, self.device, self.seed)}
        for layer in range(m["num_hidden_layers"]):
            for name, w in inputs.layer_weights(m, layer, self.device, self.seed).items():
                state[f"layers.{layer}.{name}"] = w
        model = M.params_shape(cfg)
        missing, unexpected = model.load_state_dict(state, strict=False, assign=True)
        # An embedder stops at the final norm: the LM head is never read.
        if missing != ["lm_head"] or unexpected:
            raise AssertionError(f"weights do not fit the port's model: missing {missing}, "
                                 f"unexpected {unexpected}")
        self.model_cfg = cfg
        self.embedder = Embedder(cfg, model, max_batch=max_batch)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.phases["model_s"] = time.perf_counter() - t

    # ----------------------------------------------------------- requests
    def search_request(self, queries: torch.Tensor, traffic: dict, trace: bool):
        p = self.port
        return p["SearchRequest"].single(
            queries, k=traffic["k"], consistency=p["ConsistencyLevel"][traffic["consistency"]],
            trace=trace,
        )

    def search(self, request):
        return self.coll.search(request)

    def embed(self, tokens: np.ndarray) -> torch.Tensor:
        return self.embedder.embed(tokens)

    def readback(self, vectors: np.ndarray):
        """A STRONG top-1 of each vector with its stored vector hydrated:
        (pks [n], stored vectors [n, d] on the host)."""
        p = self.port
        res = self.coll.search(p["SearchRequest"].single(
            torch.from_numpy(vectors).to(self.device), k=1, consistency=p["ConsistencyLevel"].STRONG, output_fields=("vector",)))
        return res.pks[:, 0].cpu(), np.asarray(res.fields["vector"])[:, 0]

    def stop(self) -> None:
        if self.manu is not None:
            self.manu.stop_threads()
