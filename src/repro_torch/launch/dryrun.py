"""Dry-run of every (architecture x shape) cell on the production meshes,
on one CPU process: the per-device cost and memory of the port's sharded
cells at H100 constants; mirrors ``repro.launch.dryrun``.

The reference forces 512 host devices, lowers and compiles each cell for
the TPU mesh and reads XLA's analyses.  Here one process joins a fake
process group (``torch.testing._internal.distributed.fake_pg``: every
collective returns at once) of 256 or 512 ranks as rank 0, builds the
(16, 16) or (2, 16, 16) mesh over it, and runs the cell's step function
(``launch.steps.build_cell``) on rank 0's shards as meta tensors (shapes
only, no memory, no arithmetic).  For each cell it records:

* the peak live device bytes on rank 0: the arguments (parameters,
  moments, batch, cache shards) and every temporary, tallied from the
  storages the step creates while they live (``LiveBytes``);
* the per-rank FLOPs (``torch.utils.flop_counter.FlopCounterMode`` over
  the local shards, so the count is the rank's own);
* the bytes each operation reads and writes, summed with no fusion (an
  eager run's traffic; views excluded);
* the collective operand bytes per kind and per mesh axis
  (``act_sharding.tally``);
* MODEL_FLOPS = 6·N·D for training, 2·N·D for prefill and decode (N the
  active parameters);
* the roofline terms at the NVIDIA H100 SXM5 80 GB datasheet constants
  (700 W board power): 989 TFLOP/s dense bf16, 3.35 TB/s HBM3; a
  collective over a mesh axis whose ranks share one 8-GPU node moves at
  450 GB/s per direction over NVLink 4, one that spans nodes at 50 GB/s
  per GPU (400 Gb/s NDR).  Each result names the link of each axis.

Cost and memory come from 1 and 2 effective periods and are extrapolated
to the architecture's depth, C(L) = C1 + (periods - 1)(C2 - C1), as the
reference's cost pass does (``dryrun.py:135``).  FLOPs and collectives are
counted with flash attention's tiles enlarged (``layers.cost_tiles``: the
operations do not depend on the blocking, and a 32k sequence at the
serving tiles is a few hundred thousand meta dispatches per layer);
memory with the serving tiles.  This is a model at datasheet constants,
not a measurement.

Results go to ``results/dryrun_torch/<mesh>/<arch>--<shape>.json``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod-only]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..configs import SHAPES, cells, get_arch, skipped_cells
from ..distributed import act_sharding
from ..models import layers as L
from ..models import model as M
from ..train.optimizer import init_opt_state
from . import mesh as mesh_mod
from .steps import build_cell, shard_model, shard_tensor

# NVIDIA H100 SXM5 80 GB datasheet, 700 W board power (per GPU)
PEAK_FLOPS_BF16 = 989e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9  # per direction, NVLink 4 inside an 8-GPU node
NETWORK_BW = 50e9  # per GPU, 400 Gb/s NDR InfiniBand between nodes
GPUS_PER_NODE = 8

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "results", "dryrun_torch")


@contextlib.contextmanager
def fake_world(world: int):
    """A fake default process group of ``world`` ranks, joined as rank 0."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("dryrun: a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


class LiveBytes(TorchDispatchMode):
    """Live and peak bytes of the storages created under it (plus those
    ``add``ed), each counted once while it lives; and the bytes every
    non-view operation reads and writes."""

    def __init__(self):
        super().__init__()
        self.sizes: dict[int, int] = {}
        self.live = self.peak = self.traffic = 0

    def add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.sizes:
            return
        n = st.nbytes()
        self.sizes[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self.sizes.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.traffic += sum(t.numel() * t.element_size() for t in tree_leaves((args, kwargs, out))
                                if isinstance(t, torch.Tensor))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.add(t)
        return out


def axis_links(mesh) -> dict[str, str]:
    """"nvlink" for a mesh axis whose groups lie inside one node of
    GPUS_PER_NODE consecutive ranks, else "network"."""
    names, shape = list(mesh.mesh_dim_names), list(mesh.shape)
    out = {}
    for i, name in enumerate(names):
        span = math.prod(shape[i:])  # the ranks from a group's first to its last, and one
        out[name] = "nvlink" if span <= GPUS_PER_NODE and GPUS_PER_NODE % span == 0 else "network"
    return out


def _local_args(cfg, shape, mesh, specs, structs):
    """Rank 0's shards of a cell's arguments, as meta tensors."""
    kind = shape.kind
    if kind == "train":
        params = shard_model(cfg, mesh, fsdp=True)
        opt = init_opt_state(dict(params.named_parameters()))
        batch = {k: shard_tensor(v, specs[2][k], mesh) for k, v in structs[2].items()}
        return (params, opt, batch)
    params = shard_model(cfg, mesh, fsdp=False)
    if kind == "prefill":
        batch = {k: shard_tensor(v, specs[1][k], mesh) for k, v in structs[1].items()}
        return (params, batch, _cache(cfg, mesh, structs[2], specs[2]))
    batch = {k: shard_tensor(v, specs[2][k], mesh) for k, v in structs[2].items()}
    return (params, _cache(cfg, mesh, structs[1], specs[1]), batch)


def _cache(cfg, mesh, cache, c_specs) -> dict:
    return {"length": cache["length"],
            "layers": [{k: shard_tensor(v, c_specs["layers"][i][k], mesh) for k, v in lc.items()}
                       for i, lc in enumerate(cache["layers"])]}


def _arg_tensors(args):
    params = args[0]
    rest = [t for t in tree_leaves(args[1:]) if isinstance(t, torch.Tensor)]
    return list(params.parameters()) + rest


def measure(cfg, shape, mesh, kw: dict, cost: bool) -> dict:
    """One run of the cell's step on rank 0's meta shards: peak live bytes
    (arguments included), operation traffic and collectives; with
    ``cost`` the FLOPs too, at the enlarged attention tiles.  The memory
    pass runs without the FLOP counter: its module tracker keeps tensors
    alive that the step would have freed."""
    from torch.utils.flop_counter import FlopCounterMode

    step, specs, structs, _donate = build_cell(cfg, shape, mesh, **kw)
    args = _local_args(cfg, shape, mesh, specs, structs)
    if shape.kind == "decode":  # a full cache: decode the last position
        args[1]["length"] = shape.seq_len - 1
    live = LiveBytes()
    for t in _arg_tensors(args):
        live.add(t)
    arg_bytes = live.live
    param_bytes = sum(p.numel() * p.element_size() for p in args[0].parameters())
    opt_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(args[1])
                    if isinstance(t, torch.Tensor)) if shape.kind == "train" else 0
    flops = FlopCounterMode(display=False) if cost else None
    with act_sharding.tally() as coll, flops or contextlib.nullcontext(), live, \
            L.cost_tiles() if cost else contextlib.nullcontext():
        out = step(*args)
    del out, args
    return {"peak_bytes": live.peak, "argument_bytes": arg_bytes, "param_bytes": param_bytes,
            "opt_state_bytes": opt_bytes, "flops": float(flops.get_total_flops()) if cost else 0.0,
            "traffic": float(live.traffic), "collectives": coll.counts}


def _extrapolate(c1, c2, periods: int):
    if isinstance(c1, dict):
        return {k: _extrapolate(c1.get(k, 0), c2.get(k, 0), periods) for k in set(c1) | set(c2)}
    return max(c1 + (periods - 1) * (c2 - c1), c1, 0)


def depth_cost(cfg, shape, mesh, kw: dict, cost: bool) -> dict:
    """``measure`` at 1 and 2 effective periods, extrapolated to the
    architecture's depth."""
    period = len(M.effective_pattern(cfg))
    periods = M.num_periods(cfg)
    c1 = measure(dataclasses.replace(cfg, num_layers=period), shape, mesh, kw, cost)
    if periods == 1:
        return c1
    c2 = measure(dataclasses.replace(cfg, num_layers=2 * period), shape, mesh, kw, cost)
    return _extrapolate(c1, c2, periods)


def roofline_terms(flops: float, traffic: float, coll: dict, links: dict[str, str]) -> dict:
    """Per-device terms: compute at the bf16 peak, operation traffic at the
    HBM rate, each axis's collective bytes at its link's rate."""
    t_coll = sum(row["bytes"] / (NVLINK_BW if links.get(axis) == "nvlink" else NETWORK_BW)
                 for axis, kinds in coll.items() for row in kinds.values())
    terms = {"compute_s": flops / PEAK_FLOPS_BF16, "memory_s": traffic / HBM_BW, "collective_s": t_coll}
    terms["bound"] = max(terms, key=terms.get).replace("_s", "")
    return terms


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str | None = None,
             flash_decode: bool = True, remat: bool = True, cost_pass: bool = True, **cell_kw) -> dict:
    """Dry-run one cell on the (16, 16) or, with ``multi_pod``, the
    (2, 16, 16) mesh in a fake world of that size.  ``cost_pass=False``
    records memory only (the fit pass)."""
    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    mesh_shape, _axes = mesh_mod.production_shape(multi_pod)
    n_dev = math.prod(mesh_shape)
    kw = dict(cell_kw)
    if shape.kind == "decode":
        kw["flash_decode"] = flash_decode
    else:
        kw["remat"] = remat
    t0 = time.time()
    with fake_world(n_dev), torch.no_grad() if shape.kind != "train" else contextlib.nullcontext():
        mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod)
        links = axis_links(mesh)
        mem = depth_cost(cfg, shape, mesh, kw, cost=False)
        cost = depth_cost(cfg, shape, mesh, kw, cost=True) if cost_pass else None
    mesh_name = "x".join(str(n) for n in mesh_shape)
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "n_devices": n_dev, "kind": shape.kind,
        "ok": True, "seconds": round(time.time() - t0, 2),
        "memory": {"peak_bytes_per_device": int(mem["peak_bytes"]),
                   "argument_bytes": int(mem["argument_bytes"]),
                   "param_bytes": int(mem["param_bytes"]), "opt_state_bytes": int(mem["opt_state_bytes"]),
                   "method": f"live meta storages, extrapolated(1,2)x{M.num_periods(cfg)}"},
        "links": links,
        "constants": {"peak_flops_bf16": PEAK_FLOPS_BF16, "hbm_bw": HBM_BW, "nvlink_bw": NVLINK_BW,
                      "network_bw": NETWORK_BW, "gpus_per_node": GPUS_PER_NODE,
                      "source": "NVIDIA H100 SXM5 80 GB datasheet, 700 W"},
    }
    if cost is not None:
        flops = cost["flops"]
        tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
        model_flops = 2.0 * cfg.active_params() * tokens * (3.0 if shape.kind == "train" else 1.0)
        per_dev = model_flops / n_dev
        terms = roofline_terms(flops, cost["traffic"], cost["collectives"], links)
        bound_s = max(terms["compute_s"], terms["memory_s"], terms["collective_s"])
        result.update({
            "cost": {"flops_per_device": flops, "bytes_accessed_per_device": cost["traffic"],
                     "method": f"extrapolated(1,2)x{M.num_periods(cfg)}, enlarged attention tiles"},
            "collectives": cost["collectives"],
            "model_flops_global": model_flops, "model_flops_per_device": per_dev,
            "useful_flops_ratio": per_dev / flops if flops else 0.0,
            "roofline": terms, "step_time_bound_s": bound_s,
            "roofline_fraction": (per_dev / PEAK_FLOPS_BF16) / bound_s if bound_s > 0 else 0.0,
        })
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{arch}--{shape_name}.json"), "w") as f:
            json.dump(result, f, indent=1)
    return result


def summary(res: dict) -> str:
    """One line of a result."""
    mem = res["memory"]["peak_bytes_per_device"] / 2**30
    if "roofline" not in res:
        return f"mem/dev={mem:.2f}GiB (fit pass)"
    r = res["roofline"]
    return (f"mem/dev={mem:.2f}GiB compute={r['compute_s'] * 1e3:.1f}ms memory={r['memory_s'] * 1e3:.1f}ms "
            f"coll={r['collective_s'] * 1e3:.1f}ms bound={r['bound']} "
            f"useful={res['useful_flops_ratio']:.2f} roofline_frac={res['roofline_fraction']:.3f}")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--no-flash-decode", action="store_true",
                    help="baseline: dense decode attention over whole caches")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--no-cost-pass", action="store_true", help="memory only")
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--resume", action="store_true", help="skip cells with existing results")
    args = ap.parse_args(argv)

    if args.all:
        todo = cells()
        meshes = [m for m, skip in ((False, args.multi_pod_only), (True, args.single_pod_only)) if not skip]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        todo = [(args.arch, args.shape)]
        meshes = [args.multi_pod]

    failures = []
    for multi_pod in meshes:
        mesh_name = "2x16x16" if multi_pod else "16x16"
        out_dir = os.path.join(args.out, mesh_name)
        for arch, shape_name in todo:
            tag = f"[{mesh_name}] {arch} x {shape_name}"
            path = os.path.join(out_dir, f"{arch}--{shape_name}.json")
            if args.resume and os.path.exists(path):
                print(f"{tag}: cached, skipping", flush=True)
                continue
            try:
                res = run_cell(arch, shape_name, multi_pod, out_dir, flash_decode=not args.no_flash_decode,
                               remat=not args.no_remat,
                               # the roofline table is single-pod; the multi-pod pass proves fit
                               cost_pass=not (multi_pod and args.all) and not args.no_cost_pass)
                print(f"{tag}: OK {res['seconds']:.1f}s {summary(res)}", flush=True)
            except Exception as e:  # noqa: BLE001 - report and continue the sweep
                failures.append((tag, repr(e)))
                print(f"{tag}: FAIL {e!r}", flush=True)
                traceback.print_exc()
                os.makedirs(out_dir, exist_ok=True)
                with open(path, "w") as f:
                    json.dump({"arch": arch, "shape": shape_name, "mesh": mesh_name, "ok": False,
                               "error": repr(e)}, f, indent=1)
    if args.all:
        for arch, shape_name, reason in skipped_cells():
            print(f"[skip] {arch} x {shape_name}: {reason}", flush=True)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for tag, err in failures:
            print(f"  {tag}: {err}")
        return 1
    print("\nALL CELLS PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
