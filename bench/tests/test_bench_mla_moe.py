"""The DeepSeek-V2-Lite cell's new files: a tiny run of the cell on the CPU
is correct and its fp8 control is not, and the grouped kernels' roofline
reader reads the device trace it is given (its reference's parameter list
is held to the port's model at published widths by
``test_bench_embedder_configs.py``, which finds every embedder
configuration in ``BENCHMARK.json``)."""

import copy
import json
import time

import pytest

from bench.lib import harness, spec, yardstick
from bench.reference import mla_moe_decoder
from conftest import ROOT

CELL = "dsv2lite-rag-ingest-512"
SEED = 2**33 + 17
# DeepSeek-V2-Lite's keys at the CPU's widths: 3 layers (the dense layer 0
# and two MoE layers), 8 experts, top 3, 2 shared, YaRN as published.
TINY = dict(num_hidden_layers=3, hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
            qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, kv_lora_rank=32, intermediate_size=128,
            moe_intermediate_size=32, n_routed_experts=8, num_experts_per_tok=3, vocab_size=512)
TINY_PORT = dict(num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512,
                 kv_lora_rank=32, qk_rope_head_dim=8, qk_nope_head_dim=16, v_head_dim=16, moe_num_experts=8,
                 moe_top_k=3, moe_d_ff=32)


def tiny_cell():
    cell = spec.load_cell(CELL)
    cfg = copy.deepcopy(cell.config)
    cfg["model"].update(TINY)
    cfg["port_model"].update(TINY_PORT)
    cfg["dim"] = 64
    cfg["index"]["params"] = {"nlist": 8, "nprobe": 4}
    mix = copy.deepcopy(cell.traffic)
    mix["ingest"].update(doc_tokens=16, micro_batch=4)
    mix["check"].update(docs=8, readback_rows=64)
    cell.config, cell.traffic = cfg, mix
    return cell


@pytest.mark.parametrize("control", [False, True], ids=["program", "fp8_control"])
def test_tiny_run_of_the_cell(control):
    res = harness.run_cell(tiny_cell(), SEED, 1.5, False, "cpu", time.time(), log=lambda m: None, control=control)
    gap = res["checks"]["embed_gap"]
    if control:
        assert res["correct"] is False and gap["value"] > gap["limit"]
    else:
        assert res["correct"] is True and res["failed"] == 0
        assert {"ingest_rows_s", "setup_s"} <= set(res["metrics"])
        assert res["checks"]["readback_bad"]["value"] == 0


def _rec(device_ops, tokens=(16384, 16384)):
    config = json.loads((ROOT / "bench/configs/dsv2lite-embed-rag.json").read_text())
    embeds = [{"t0": 0.1 * i, "t1": 0.1 * i + 0.4, "docs": 32, "tokens": n} for i, n in enumerate(tokens)]
    embeds.append({"t0": 19.9, "t1": 20.3, "docs": 32, "tokens": 16384})  # past the close: not counted
    device = None if device_ops is None else {"busy_s": 1.0, "window_s": 20.0, "device_ops": device_ops,
                                              "idle_gaps": []}
    return {"seconds": 20.0, "t0": 0.0, "t1": 20.0, "embeds": embeds, "device": device, "config": config,
            "traffic": {"ingest": {"doc_tokens": 512}}}


def test_moe_experts_roofline_reads_the_grouped_kernels():
    read = spec.metric_reader("moe_experts_roofline")
    grouped = ("_ZN7cutlass13device_kernelIN2at4cuda6detail25enable_3x_kernel_for_sm9xINS_4gemm6kernel13"
               "GemmUniversalINS5_17GroupProblem")
    ops = [["nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT", 3.0], [grouped, 0.3]]
    model = json.loads((ROOT / "bench/configs/dsv2lite-embed-rag.json").read_text())["model"]
    want = 100.0 * 2 * 16384 * mla_moe_decoder.routed_expert_flops_per_token(model) / (
        0.3 * yardstick.PEAK_BF16_FLOPS)
    assert read(_rec(ops)) == pytest.approx(want)
    assert 0 < read(_rec(ops)) < 100
    # No grouped kernel in the trace (the parent's program), no trace, or
    # no micro-batch done: nothing to read.
    assert read(_rec(ops[:1])) is None
    assert read(_rec(None)) is None
    assert read(_rec(ops, tokens=())) is None
