"""The port's dry-run (``repro_torch.launch.dryrun``) and
``distributed.search.dryrun_search`` on a fake world of 256 ranks, on the
CPU: rank 0 runs a cell on its meta shards of the (16, 16) mesh.

- ``dryrun_search`` at the reference test's sizes
  (``tests/test_distributed.py:172``: 256 x 4096 rows of 128, 64 queries,
  k 50): FLOPs per rank of 2 nq (N / 256) D plus the norms' share, and the
  all-gather of 256 x nq x k (score, id) pairs;
- ``run_cell`` for yi-9b x train_4k and minicpm3-4b x decode_32k: the
  parameter and moment bytes on rank 0 equal the spec arithmetic
  (``partition.param_specs`` and ``local_shape``), and the useful-FLOP
  ratio lies in the band ``USEFUL`` states with its reason;
- ``report`` renders the files ``run_cell`` wrote.
"""

import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.distributed import partition  # noqa: E402
from repro_torch.distributed.search import dryrun_search  # noqa: E402
from repro_torch.launch import dryrun, report  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

MESH = {"data": 16, "model": 16}
#: MODEL_FLOPS over the rank's counted FLOPs.  Training: 6·N·D against the
#: forward and backward, the remat recompute (one more forward: at most
#: 6/8) and flash attention's full causal square (the block loop computes
#: every tile); yi-9b at 4k reads 0.65.  Decode: 2·N per token against a
#: step whose attention reads the whole 32k cache, and MLA's 40 heads do
#: not split over 16 ranks, so attention runs on every rank; minicpm3-4b
#: reads 0.07.
USEFUL = {("yi-9b", "train_4k"): (0.5, 0.75), ("minicpm3-4b", "decode_32k"): (0.02, 0.5)}


def test_dryrun_search_on_the_production_mesh():
    nq, k, d, n = 64, 50, 128, 256 * 4096
    with dryrun.fake_world(256):
        res = dryrun_search(make_production_mesh(), n_rows=n, dim=d, nq=nq, k=k)
    rows = n // 256
    assert res["rows_per_device"] == rows and res["world"] == 256
    product = 2 * nq * rows * d
    assert product <= res["flops_per_device"] <= product * (1 + 2 / nq + 2 / rows)
    # operand bytes per rank: nq x k scores (float32) and ids (int64)
    assert res["collectives"] == {"all-gather": nq * k * (4 + 8)}
    assert 256 * res["collectives"]["all-gather"] == 256 * nq * k * 12


def _spec_bytes(cfg, fsdp: bool, moments: bool) -> tuple[int, int]:
    shape = M.params_shape(cfg)
    specs = partition.param_specs(cfg, MESH, shape, fsdp)
    params = opt = 0
    for name, p in shape.named_parameters():
        n = math.prod(partition.local_shape(p.shape, specs[name], MESH))
        params += n * p.element_size()
        opt += 2 * 4 * n if moments else 0
    return params, opt


@pytest.mark.parametrize("arch,shape", sorted(USEFUL))
def test_run_cell_bytes_and_useful_flops(arch, shape, tmp_path):
    res = dryrun.run_cell(arch, shape, multi_pod=False, out_dir=str(tmp_path))
    cfg = get_arch(arch)
    train = shape == "train_4k"
    params, opt = _spec_bytes(cfg, fsdp=train, moments=train)
    assert res["ok"] and res["mesh"] == "16x16" and res["n_devices"] == 256
    assert res["memory"]["param_bytes"] == params
    assert res["memory"]["opt_state_bytes"] == opt
    assert res["memory"]["argument_bytes"] >= params + opt
    assert res["memory"]["peak_bytes_per_device"] > res["memory"]["argument_bytes"]
    lo, hi = USEFUL[(arch, shape)]
    assert lo <= res["useful_flops_ratio"] <= hi, res["useful_flops_ratio"]
    assert res["links"] == {"data": "network", "model": "network"}
    assert res["roofline"]["bound"] in ("compute", "memory", "collective")
    if train:  # FSDP gathers over data and the tensor-parallel sums over model
        assert res["collectives"]["data"]["all-gather"]["bytes"] > 0
        assert res["collectives"]["model"]["all-reduce"]["bytes"] > 0
    assert (tmp_path / f"{arch}--{shape}.json").exists()


def test_report_renders_the_files(tmp_path, capsys):
    out = tmp_path / "16x16"
    dryrun.run_cell("mamba2-370m", "long_500k", multi_pod=False, out_dir=str(out))
    report.main(["--dir", str(tmp_path)])
    text = capsys.readouterr().out
    assert "| mamba2-370m | long_500k | decode |" in text
    assert "single-pod: 1/1 cells pass" in text
