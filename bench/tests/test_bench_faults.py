"""How ``correct`` is decided: the control and faults planted underneath
the timed path each bring it out false (tiny cells on the CPU; the harness's
look for a chip is skipped)."""

import pytest
import torch


@pytest.mark.parametrize("cell", ["cohere1m-flat-batch", "cohere1m-flat-mixed", "yi9b-rag-ingest"])
def test_control_comes_out_not_correct(run_tiny, cell):
    res, _ = run_tiny(cell, control=True)
    assert res["correct"] is False


@pytest.mark.parametrize("cell", ["cohere1m-flat-batch", "cohere1m-flat-mixed"])
def test_an_answer_altered_where_it_is_produced(run_tiny, monkeypatch, cell):
    from repro_torch.kernels import ops

    merge = ops.merge_topk

    def altered(scores, pks, k, metric="l2"):
        s, p = merge(scores, pks, k, metric)
        p = p.clone()
        p[:, 0] = (p[:, 0] + 1) % 3000  # the best row's pk names a neighbour
        return s, p

    monkeypatch.setattr(ops, "merge_topk", altered)
    res, _ = run_tiny(cell)
    assert res["correct"] is False


@pytest.mark.parametrize("cell", ["cohere1m-flat-batch", "cohere1m-flat-mixed"])
def test_half_of_the_batch_left_out(run_tiny, monkeypatch, cell):
    from repro_torch.core.query_node import QueryNode

    serve = QueryNode.search_request

    def half(self, request):
        out = []
        for s, p in serve(self, request):
            s, p = s.clone(), p.clone()
            p[len(p) // 2:] = -1
            s[len(s) // 2:] = float("-inf")
            out.append((s, p))
        return out

    monkeypatch.setattr(QueryNode, "search_request", half)
    res, _ = run_tiny(cell)
    assert res["correct"] is False
    assert res["checks"]["bad_pks"]["value"] > 0


@pytest.mark.parametrize("cell", ["cohere1m-flat-mixed", "yi9b-rag-ingest"])
def test_an_insert_acknowledged_and_left_unapplied(run_tiny, monkeypatch, cell, tiny_cell):
    from repro_torch.core.log import EntryType
    from repro_torch.core.query_node import QueryNode

    consume = QueryNode._consume
    applied = {"n": 0}

    def stale(self, entry):
        # Set-up's rows apply; the window's inserts leave the state as it was.
        if entry.type is EntryType.INSERT and entry.payload["pk"].min() >= STALE_FROM[cell]:
            applied["n"] += 1
            return True
        return consume(self, entry)

    STALE_FROM = {"cohere1m-flat-mixed": 3000 + 256, "yi9b-rag-ingest": 8}
    monkeypatch.setattr(QueryNode, "_consume", stale)
    res, _ = run_tiny(cell)
    assert applied["n"] > 0
    assert res["correct"] is False
    assert res["checks"]["readback_bad"]["value"] > 0


def test_an_embedding_altered_where_it_is_produced(run_tiny, monkeypatch):
    from repro_torch.models import embedder

    make = embedder.embed_tokens

    def altered(cfg, params, tokens, mask=None):
        e = make(cfg, params, tokens, mask)
        e = e.clone()
        # The last document of each micro-batch: the check's sample always
        # holds the window's last document.
        e[-1] = torch.roll(e[-1], 1)
        return e

    monkeypatch.setattr(embedder, "embed_tokens", altered)
    res, _ = run_tiny("yi9b-rag-ingest")
    assert res["correct"] is False
    assert res["checks"]["embed_gap"]["value"] > res["checks"]["embed_gap"]["limit"]
