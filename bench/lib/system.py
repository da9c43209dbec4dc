"""The system under test, built from a configuration file.

This is the only module of the benchmark that imports the program, the
PyTorch port ``repro_torch`` (from ``src/`` of the checkout).  It builds
what the configuration describes and returns the handles the traffic
drives:

- ``"kind": "vectors"``: a threaded ``ManuSystem`` holding one collection
  of ``rows`` mixture vectors inserted through ``ManuCollection.insert``
  and flushed, with ``delete_fraction`` of the pks deleted after the flush;
- ``"kind": "embedder"``: the port's model of the configuration's
  ``port_model`` (``ModelConfig``'s keyword arguments), with the weights
  its ``reference`` module lists drawn by the benchmark, as the port's
  ``Embedder``, feeding an empty collection of a threaded ``ManuSystem``.

Each set-up step's seconds go into ``phases``.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from . import inputs, spec
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


def model_config(name: str, port_model: dict):
    """The port's ``ModelConfig(name=name, **port_model)``, a JSON list read
    as the tuple it stands for (``layer_pattern``)."""
    from repro_torch.models.config import ModelConfig  # noqa: PLC0415

    return ModelConfig(name=name, **{k: tuple(v) if isinstance(v, list) else v for k, v in port_model.items()})


def load_weights(model: torch.nn.Module, state: dict) -> None:
    """Load the drawn ``state`` into the port's ``model`` (built on the meta
    device) strictly: every parameter but the LM head drawn (an embedder
    stops at the final norm), nothing the model lacks, every shape the
    model's; each tensor cast to the dtype of the model's parameter of that
    name.  Raises ``ValueError`` naming the parameters that do not fit."""
    want = model.state_dict(keep_vars=True)
    faults = [f"{what} {names}" for what, names in (
        ("missing", sorted(set(want) - set(state) - {"lm_head"})),
        ("not in the port's model", sorted(set(state) - set(want))),
        ("of another shape", [f"{n} {tuple(t.shape)} (port {tuple(want[n].shape)})" for n, t in state.items()
                              if n in want and t.shape != want[n].shape]),
    ) if names]
    if faults:
        raise ValueError("the drawn weights do not fit the port's model: " + "; ".join(faults))
    model.load_state_dict({n: t.to(want[n].dtype) for n, t in state.items()}, strict=False, assign=True)


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
        """The configuration's model as the port's ``Embedder``: the port's
        ``ModelConfig`` of its ``port_model``, with the weights its
        ``reference`` module lists drawn by the benchmark."""
        from repro_torch.models import model as M  # noqa: PLC0415
        from repro_torch.models.embedder import Embedder  # noqa: PLC0415

        c = self.config
        for key in ("reference", "port_model"):
            if key not in c:
                raise KeyError(f"embedder configuration {c['name']!r} has no {key!r} key")
        ref = spec.reference(c["reference"])
        t = time.perf_counter()
        cfg = model_config(c["name"], c["port_model"])
        model = M.params_shape(cfg)
        load_weights(model, inputs.model_weights(c["model"], ref.layer_parameters, cfg.num_layers,
                                                 self.device, self.seed))
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
