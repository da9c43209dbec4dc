#!/usr/bin/env python3
"""The port's scan and index kernels at the main path's shapes, in one tree.

    python3 chip_ab.py [--root DIR] [--tag NAME]      (on a machine with a GPU)

Times, with the package under ``DIR/src`` (default: this checkout):
``l2_topk`` over 1M x 768 in the FLAT cell's eight segments at nq 1, 8
and 100; ``sq_l2_topk`` over 131,072 x 768 codes at nq 1 and 100;
``pq_adc_topk`` over 131,072 x 48 uint8 codes with 256-entry tables at nq
1 and 100; ``kmeans_assign`` at an IVF Lloyd step (100,000 x 128 x 768), a
PQ subspace (131,072 x 256 x 16) and an interim slice (2,048 x 16 x 768);
``merge_topk`` at every (nq, M, k) the three paths of ``chip_smoke.py``
launch it at (``MERGE_SHAPES``, the three most launched first), on pools
with the main path's structure (``chip_smoke.merge_pool``), beside an empty
kernel's device time; ``sq_encode`` at a segment (131,072 x 768) and a
bucket index's payload (262,144 x 768); ``sq_decode`` at the 65,536 x 768
chunks an IVF-SQ index decodes.  Each on seeded data, k = 100, as CUDA-event time of
back-to-back calls (``event_ms``) and as device time with the calls queued
behind a sleep kernel (``device_ms``, see ``chip_smoke.device_ms``).
Prints one JSON line.  To compare two trees on one card, run it in one machine once per
tree, in turns (parent, change, change, parent), e.g. with the parent
unpacked by ``git archive`` under ``build/``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
# merge_topk's (nq, M, k) on the FLAT, indexed and facade paths of
# chip_smoke.py (its per-shape launch counts), the three most launched
# first: the global reduce, the FLAT node reduce, the facade node reduce.
MERGE_SHAPES = (
    (1, 200, 100), (1, 400, 100), (1, 4800, 100), (1, 8192, 100), (1, 300, 100), (1, 716, 100),
    (1, 3200, 100), (1, 1700, 100), (100, 200, 100), (100, 400, 100), (100, 4800, 100),
    (100, 8192, 100), (100, 300, 100), (100, 716, 100), (100, 3200, 100), (100, 1700, 100),
)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE), help="tree whose src/repro_torch is timed")
    ap.add_argument("--tag", default="this tree")
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device is available", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(1, str(HERE))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import kmeans_assign as km
    from repro_torch.kernels import l2_topk as l2
    from repro_torch.kernels import merge_topk as mt
    from repro_torch.kernels import pq_adc as pq
    from repro_torch.kernels import sq_codec as sq

    if not Path(_build.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {_build.__file__}, not the tree under {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    t = time.perf_counter()
    _build.build_all()
    out = {"tag": args.tag, "build_s": round(time.perf_counter() - t, 1)}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)

    def both(key, fn, reps):
        out[key] = {"event_ms": cs.cuda_ms(torch, fn, reps), "device_ms": cs.device_ms(torch, fn, reps)}

    x = torch.randn((cs.N_ROWS, cs.DIM), generator=gen, device=dev)
    bases = [x[s * cs.SEG_ROWS:(s + 1) * cs.SEG_ROWS] for s in range(cs.N_SEALED)]
    bases.append(x[cs.N_SEALED * cs.SEG_ROWS:])
    valids = [torch.ones(b.shape[0], dtype=torch.bool, device=dev) for b in bases]
    for nq in (1, 8, 100):
        q = torch.randn((nq, cs.DIM), generator=gen, device=dev)
        both(f"l2_topk nq={nq}", lambda: l2.l2_topk(q, bases, valids, cs.K), 10)
    xs = x[:cs.SEG_ROWS].contiguous()
    lo, hi = xs.min(0).values, xs.max(0).values
    codes = sq.sq_encode(xs, lo, hi)
    for nq in (1, 100):
        q = torch.randn((nq, cs.DIM), generator=gen, device=dev)
        both(f"sq_l2_topk nq={nq}", lambda: sq.sq_l2_topk(q, codes, lo, hi, None, cs.K), 20)
    pcodes = torch.randint(0, 256, (cs.SEG_ROWS, 48), generator=gen, device=dev, dtype=torch.uint8)
    for nq in (1, 100):
        luts = torch.randn((nq, 48, 256), generator=gen, device=dev)
        both(f"pq_adc_topk nq={nq}", lambda: pq.pq_adc_topk(luts, pcodes, cs.K), 20)
    for n, c, d in ((cs.KMEANS_SAMPLE, 128, cs.DIM), (cs.SEG_ROWS, 256, 16), (cs.SLICE_ROWS, 16, cs.DIM)):
        xa = torch.randn((n, d), generator=gen, device=dev)
        ca = torch.randn((c, d), generator=gen, device=dev)
        both(f"kmeans_assign {n}x{c}x{d}", lambda: km.kmeans_assign(xa, ca), 20)
    out["empty kernel"] = {"device_ms": cs.empty_kernel_ms(torch)}
    for nq, m, k in MERGE_SHAPES:
        ps, pp = cs.merge_pool(torch, gen, dev, nq, m, k)
        both(f"merge_topk nq={nq} M={m} k={k}", lambda: mt.merge_topk(ps, pp, k, "l2"), 100)
    for rows in cs.ENCODE_ROWS:
        xe = x[:rows].contiguous()
        lo, hi = xe.min(0).values, xe.max(0).values
        both(f"sq_encode {rows}x{cs.DIM}", lambda: sq.sq_encode(xe, lo, hi), 20)
        del xe
    codes = torch.randint(0, 256, (cs.DECODE_CHUNK_ROWS, cs.DIM), generator=gen, device=dev,
                          dtype=torch.uint8)
    lo = torch.randn(cs.DIM, generator=gen, device=dev)
    hi = lo + 4 * torch.rand(cs.DIM, generator=gen, device=dev)
    both(f"sq_decode {cs.DECODE_CHUNK_ROWS}x{cs.DIM}", lambda: sq.sq_decode(codes, lo, hi), 50)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
