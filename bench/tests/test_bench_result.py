"""The result's last line, the per-layer readers and the trace reader."""

import json

import pytest

from bench.lib import trace

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("cell", ["cohere1m-flat-batch", "cohere1m-flat-mixed", "yi9b-rag-ingest"])
def test_result_holds_exactly_the_contracts_keys(run_tiny, cell):
    res, lines = run_tiny(cell)
    assert list(res) == KEYS  # the numbers compared come last
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert "setup_s" in res["metrics"] and len(res["metrics"]) >= 2
    assert all(set(m) == {"value", "unit"} for m in res["metrics"].values())
    assert all(set(c) == {"value", "limit"} for c in res["checks"].values())
    json.dumps(res)
    assert any(line.startswith("set-up phases") for line in lines)


def test_traced_run_reports_per_layer_metrics(run_tiny):
    res, _ = run_tiny("cohere1m-flat-mixed", trace=True)
    # The CPU has no device trace: the readers of program spans and host
    # clocks report, the device's are left out rather than read as 0.
    assert set(res["metrics"]) == {"proxy_self_ms.search", "plan_ms.search", "insert_ms.ingest"}
    assert res["metrics"]["plan_ms.search"]["value"] > 0


def test_traced_result_carries_the_device_trace(run_tiny, monkeypatch):
    fake = {"busy_s": 0.5, "window_s": 1.5, "device_ops": [["scan", 0.4]], "idle_gaps": [["search", 1.0]]}
    monkeypatch.setattr(trace.DeviceTrace, "read", lambda self: fake)
    res, _ = run_tiny("cohere1m-flat-batch", trace=True)
    assert list(res) == KEYS[:-1] + ["breakdown", "checks"]
    assert res["device"]["busy_s"] == 0.5 and res["device"]["window_s"] == 1.5
    assert res["breakdown"] == {"device_ops": [["scan", 0.4]], "idle_gaps": [["search", 1.0]]}
    assert res["metrics"]["device_idle.search"]["value"] == pytest.approx(100 * (1 - 0.5 / 1.5))
    assert 0 < res["metrics"]["search_kernels_roofline"]["value"]


class _Event:
    def __init__(self, name, start_us, dur_us, cuda):
        self._n, self._s, self._d, self._c = name, start_us, dur_us, cuda

    def name(self):
        return self._n

    def start_ns(self):
        return self._s * 1000

    def duration_ns(self):
        return self._d * 1000

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self._c else DeviceType.CPU


def test_trace_reader_busy_breakdown_and_gaps():
    events = [
        _Event("window", 0, 1000, False),
        _Event("search", 0, 600, False), _Event("insert", 600, 400, False),
        _Event("search", 0, 600, True),  # the range's mirror on the device: not work
        _Event("scan_kernel", 100, 300, True), _Event("scan_kernel", 350, 100, True),
        _Event("Memcpy DtoH", 700, 100, True), _Event("late", 1200, 50, True),
    ]
    got = trace.read_events(events)
    assert got["window_s"] == pytest.approx(1e-3)
    assert got["busy_s"] == pytest.approx(450e-6)  # [100, 450] and [700, 800]
    assert got["device_ops"][0] == ["scan_kernel", pytest.approx(400e-6)]
    gaps = dict(got["idle_gaps"])
    assert gaps["search"] == pytest.approx(350e-6)  # [0, 100] and [450, 700]: its middle in search
    assert gaps["insert"] == pytest.approx(200e-6)  # [800, 1000]
    assert trace.read_events([_Event("window", 0, 10, False)]) is None
