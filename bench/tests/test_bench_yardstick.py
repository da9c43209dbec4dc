"""The arithmetic of the yardstick, from shapes."""

import json

import pytest

from bench.lib import yardstick
from conftest import ROOT


def test_least_time_of_the_batch_cells_request():
    # nq 1,000 x 1M rows x 768, top 100: the products at the TF32 rate bound it.
    least = yardstick.search_least_s(1000, 1_000_000, 768, 100)
    assert least == pytest.approx(3.10e-3, abs=0.005e-3)
    assert least == pytest.approx(2 * 1000 * 1_000_000 * 768 / 495e12)


def test_least_time_of_one_query_is_bytes_bound():
    least = yardstick.search_least_s(1, 1_000_000, 768, 100)
    assert least == pytest.approx((1_000_000 * 768 * 4 + 768 * 4 + 1200) / 3.35e12)


def test_yi9b_flops_per_token_from_its_config():
    model = json.loads((ROOT / "bench/configs/yi9b-embed-rag.json").read_text())["model"]
    weights_per_layer = 4096 * 4096 * 2 + 2 * 4096 * 512 + 3 * 4096 * 11008
    want = 48 * (2 * weights_per_layer + 2 * 2 * 4096 * 129 / 2)
    assert yardstick.decoder_flops_per_token(model, 128) == pytest.approx(want)
    # ~2 x the 8.29 B weights the layers multiply by
    assert yardstick.decoder_flops_per_token(model, 128) == pytest.approx(16.64e9, rel=0.01)


def test_requests_least_sums_each_over_its_live_rows():
    reqs = [{"nq": 1000, "n_live": 990_000, "k": 100}, {"nq": 1000, "n_live": 1_000_000, "k": 100}]
    assert yardstick.requests_least_s(reqs, 768) == pytest.approx(
        yardstick.search_least_s(1000, 990_000, 768, 100) + yardstick.search_least_s(1000, 1_000_000, 768, 100))
