#!/usr/bin/env python3
"""Smoke run of the repro_torch port on one NVIDIA GPU.

    python3 chip_smoke.py            (from the root of a checkout)

1. Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, all started together).
2. Kernel phase: each of the seven kernels against its plain PyTorch version
   on the card.  ``l2_topk``: L2 and IP, k in {1, 100, 1024}, ragged and
   all-invalid segments.  ``merge_topk``: duplicate, negative and >int32
   pks, inf/NaN/-0.0 scores, pools wider than one launch, and each of the
   kernel's regimes (a warp per query, a warp per chunk then one over the
   lists, a block per query) at M from 1 to 8,192 with every pk repeated
   or every candidate dead (bit-exact).
   ``kmeans_assign``: N in {1, 700, 2,048, 100,000} x C in {1, 8, 16, 17,
   128, 129, 256, 1,000} x D in {16, 19, 768}, through every score path C
   and D allow (``small_c=``), duplicate centroids on both sides of a
   centroid-tile edge (earliest wins), and rows near their centroids held
   to float64.
   ``sq_encode``: bit-exact, with exact .5 boundaries and a constant
   column, d % 4 != 0, a view one float off the 16-byte grid, d above
   4,096 and n * d above 2^31.  ``sq_decode``: bit-exact, d % 4 == 0 and odd d, one row, a
   misaligned view, n * d above 2^31.  ``sq_l2_topk``: L2/IP, k in {1, 100, 1024}, nq in {1, 100},
   ragged and all-invalid.  ``pq_adc_topk``: nq in {1, 3, 4, 5, 8, 100}
   (ragged query groups) x m in {8, 20, 48} x ksub in {16, 256}, uint8 and
   int32 codes, aligned and offset views, masks, k in {1, 100, 1024}, a
   table of exactly one block's shared memory; bit-exact scores.  Scores are held to
   ``repro_torch.testing.SCORE_TOL``, set from the measured float32 error.
   The redesigned scans also: both score paths at nq 1..300, rows of d
   16,000 and 10,001 bit-exact on exact data, and the tensor-core scores
   against the CPU model ``testing.scan_scores_tf32`` (``model_tie``, on
   nonnegative and on signed rows).
3. FLAT path at VectorDBBench's Performance768D1M scale (1M x 768, top-100;
   synthetic data from --seed): an L2 and a cosine collection, each as
   seven 131,072-row sealed segments written to and loaded from the binlog
   (three FLAT-indexed through ``load_index``) plus 82,496 rows ingested as
   INSERT log entries into a growing segment (interim index off); 1% of pks
   deleted; two QueryNodes and a global ``merge_topk``, checked against an
   exact brute-force top-k over the visible rows (plain torch).
4. Indexed path at the same scale on a seeded Gaussian mixture: seven
   sealed segments built by the port's ``IndexNode`` from
   ``index_build_task`` messages (IVF-FLAT x2, IVF-SQ x2, IVF-PQ, SQ, PQ;
   Milvus's IVF defaults nlist 128 / nprobe 8, PQ m 48), loaded by two
   QueryNodes from the object store; 82,496 WAL rows with the system's
   default ``slice_rows`` = 2,048, so 40 interim IVF-FLAT slice indexes are
   built; 1% deletes.  Every answer must equal an oracle computed here in
   plain torch from the loaded index state (probe by a full sort of the
   centroid distances, score the probed rows, sort stably, merge); an
   IVF-FLAT built twice from one seed must save the same bytes.  Recall@100
   against exact brute force is printed, not gated.
5. Index-family path, on the indexed path's mixture rows and deletes: a
   bucket index (the reference's defaults: 96-row target, 128-row buckets,
   replicas 2, nprobe 8, SQ payload) over one full 131,072-row sealed
   segment and HNSW (m 16, ef_construction 100, ef_search 64) over a
   1,024-row slice (its graph build is the reference's host numpy code),
   built by the port's ``IndexNode``, loaded by one ``QueryNode`` and
   searched at nq 1 and 100 pinned after the deletes.  The bucket answers
   must equal the float64 oracle over the loaded index (probe by a full
   sort of the centre distances, score the probed slots, each row's best,
   a stable sort); every HNSW score must be its row's float64 distance;
   no deleted pk may appear.  Prints build seconds and launches, request
   latencies, launches per request, recall@100 and profiled requests.
6. Facade path: the port's ``ManuSystem`` at the same scale (2 shards,
   2 loggers, 1 data node, 1 index node, 2 query nodes, 131,072-row seals):
   an IVF-SQ collection (nlist 128, nprobe 8) with an INT ordinal, 1M
   mixture rows inserted through the proxy in 8,192-row batches, flush
   (eight IVF-SQ builds, placed on the two nodes by the query coordinator),
   16,384 streamed rows, 1% deletes; requests at nq 1 and 100 under
   STRONG / BOUNDED / EVENTUAL, the filters ``ordinal >= 10000`` and
   ``ordinal >= 990000``, hydrated ``ordinal`` and time travel.  Every
   answer must equal the float64 oracle over what the two query nodes hold
   at its pin (``repro_torch.testing.system_oracle``).  Prints ingest
   rows/s, the flush time, each build, request latencies and two profiled
   requests with the host split.
7. Maintenance path, on the facade's system after its requests: a
   time-travel checkpoint, a retention delete of the 65,536 oldest
   ordinals (~25% of each shard's first segment, as a collection TTL
   deletes) and a flush that seals the 16,384 streamed rows into two
   fragments; ``compact()`` must plan one task per shard (that segment and
   the shard's fragment), purge exactly the deleted rows of its sources,
   rebuild IVF-SQ on each target and swap; a STRONG nq=100 read pinned
   before the swap repeated after it bit for bit; STRONG requests at nq 1
   and 100 before and after, each held to the oracle at its pin;
   ``gc()`` must reap the fragments and keep the checkpointed sources, and
   the query nodes must drop every retired handle; ``restore_collection``
   at the checkpoint, searched at nq=100, held to an exact top-k in plain
   torch; ``kill_query_node`` + ``recover_failures()`` and then
   ``restart()``, each answering as before the kill bit for bit.  Prints
   the compaction, rebuild, GC, restore and recovery seconds, the request
   medians, launches per request, profiled requests and device memory
   around the restart.
8. Embedder path (``examples/serve_embedder.py``'s flow): yi-9b at its
   published widths (48 layers, d_model 4,096, 8.8 B bf16 parameters drawn
   from --seed on the card) as the port's ``Embedder`` (mean-pooled,
   L2-normalized final hidden states) feeding a threaded ``ManuSystem``
   (2 query nodes, 4,096-row seals; an IP collection of d 4,096 under
   IVF-FLAT, nlist 128 / nprobe 8): 8,192 documents of 128 tokens embedded
   32 at a time and inserted, flush; then a stream of fresh 32-token
   documents large enough that every shard seals a segment, and 20 request
   batches (8 fresh documents inserted, 16 queries of 32 tokens embedded
   and searched at staleness 200 ms, top 5) and 20 at nq 100, served while
   those segments seal and build their indexes.  Every embedding must be
   finite and unit-norm and equal, within EMBED_BATCH_TOL, to the same
   document's embedded alone; no BOUNDED answer may name a pk never
   inserted; request batches must be served while an index builds; after
   ``wait_idle()`` STRONG answers must equal a cooperative system's fed
   the same embeddings in the same order; ``stop_threads()`` must leave no
   thread.  Prints the model's init time, embed tokens/s and
   TFLOP/s beside the bf16 peak, ingest rows/s, the flush time, request
   medians split into embed and search, peak device memory, profiles and
   topic-match@1 (not gated); ``l2_topk`` at d 4,096 is checked and timed
   at every shape the path launched it at.
9. Serve path (``repro_torch.launch.serve``'s ``prefill`` / ``decode_step``):
   each of the ten configurations at its published widths, depth cut to
   one effective period (2 layers where the period is one layer; jamba's
   8: 7 SSM, 1 attention, 4 MoE FFNs of 16 experts, 4 dense MLPs) and
   minicpm3-4b whole (62 MLA layers), random weights from --seed drawn on
   the card, one model at a time.  Teacher-forced: B=4, an 8-token prompt
   (after 256 patch embeddings for paligemma), 16 decode steps fed fixed
   tokens, each held to one prefill over the whole sequence within the
   reference's 0.15 (greedy tokens equal outside near-ties); MoE at its
   published capacity factor, with the slots the full prefill drops and the
   tokens routed otherwise counted from the router and their rows left out
   (every row left out fails).  Serving-sized: jamba and minicpm3-4b at
   B=8, a 1,024-token prefill and 64 greedy steps (prefill tokens/s and
   TFLOP/s beside the bf16 peak, decode median ms/step and tokens/s,
   launches and idle share of a profiled step, MoE drops).  The ten
   reduced configurations on the card against the CPU (one seeded model
   moved over, prefill + 8 steps: logits within ``testing.logit_atol``),
   and ``serve.main(--local)`` in process for each.  Prints peak device
   memory per configuration.  No kernel of the seven is on this path.
10. Train path (``repro_torch.train`` / ``launch.steps.build_local_train_cell``):
   yi-9b at its published widths, depth cut to 8 of 48 layers (1.91 B
   parameters drawn from --seed; bf16 parameters, float32 AdamW moments),
   12 steps of ``synthetic_lm_batches`` at B=8 x 1,024 with remat: every
   step's loss (the last must be below the first), seconds, tokens/s and
   share of the bf16 peak (6 x matmul weights x tokens + attention, the
   recompute apart), a profiled step, peak device memory.  At 2 layers,
   full width: two micro-batches against one on one batch (the float32
   accumulated gradients within ``testing.GRAD_RTOL`` of the full batch's,
   global relative L2; the reference's bounds: loss rtol 1e-3, grad norm
   rtol 1e-2, parameters rtol 2e-2 / atol 2e-3); a run crashed at step 3
   of 6 and resumed from the object store (its own final checkpoint not
   written), held to the spread of two uninterrupted runs, the
   checkpoint's bytes and save / restore seconds printed.  One step of the reduced configuration on the card
   against the CPU (``testing.compare_train_step``), and
   ``launch.train.main(--local)``.  No kernel of the seven is on this path.
11. Distributed path (``repro_torch.distributed``) on an NCCL process group
   of world size 1: the search over 1M x 768 rows at nq 1 and 100, k=100,
   through ``l2_topk`` and ``merge_topk`` (its launches count toward the
   kernel line), equal to ``ops.topk_scan`` on the same rows and held to
   the plain version; GQA (yi-9b) and MLA (minicpm3-4b) flash decode at one
   period and full width through ``decode_step``'s hooks, 16 steps against
   the dense decode within FLASH_DECODE_ATOL, beside two controls of the
   dense decode against itself (positions summed in reverse; rows 0-1 in a
   batch of 2); the expert-parallel MoE block (qwen3-moe-30b-a3b) and a
   prefill under ``act_sharding.policy`` against the dense ones.
12. Sharded-cells path (``repro_torch.launch.steps`` on a (1, 1) mesh over
   an NCCL group of world 1): the train phase's cell (yi-9b x8, full
   width, B=8 x 1,024) for 3 steps of the sharded ``build_train_cell``
   beside 3 of the one-device one from the same weights and batches
   (losses within ``testing.LOSS_ATOL``; the step-1 gradients each
   step's AdamW took, and the parameters after it, within
   ``testing.GRAD_RTOL``; s/step of each); the dry-run's estimate of that
   cell on a fake (1, 1) world (meta tensors, on the CPU) beside the
   card's ``max_memory_allocated`` for the sharded steps and
   ``train_flops``, each ratio held to DRYRUN_MEMORY_RATIO /
   DRYRUN_FLOPS_RATIO; the prefill and decode cells on yi-9b,
   minicpm3-4b, jamba and qwen3-moe-30b-a3b (one period, full width)
   against the plain ``prefill`` / ``decode_step`` within
   ``testing.logit_atol``, decode ms/step of each; the expert-parallel MoE
   block's gradients against the dense block's within
   ``testing.GRAD_RTOL``.  Then the examples path: ``examples/
   torch_quickstart.py``, ``torch_elastic_failover.py`` and
   ``torch_serve_embedder.py`` on the card, each with its wall time and its
   own check (``l2_topk``, ``merge_topk`` and ``kmeans_assign`` launches
   counted toward the kernel line).
13. Dropless MoE phase (``moe.expert_mlp``, DeepSeek-V2-Lite's routed
   experts, a ``torch._grouped_mm`` a projection) at the
   ``dsv2lite-rag-ingest-512`` cell's micro-batch: 98,304 slots of d
   2,048 over 64 experts of 1,408, under a random router's load, every
   slot on one expert, and every other expert empty, each held to a
   per-expert loop within two bf16 ulps of its largest output, three
   grouped products a call, its device kernels counted (the same count
   under every load the profiler recorded) and run with every readback
   refused; timed beside the loop, the three grouped
   products alone and the bound; then one whole dropless layer at that
   width, its grouped products counted and every readback refused.
14. Each path runs with every launch counter at 0 and fails unless each of
   its kernels was launched; ``kmeans_assign``'s launches are also counted
   per (N, C, D), ``merge_topk``'s per (nq, M, k) and ``sq_decode``'s per
   (n, d), each adding up to the wrapper's count, and the three kernels are
   timed at every shape the paths launched (device time of calls queued
   behind a sleep kernel), beside their plain versions, their bounds and an
   empty kernel's time, with the sum of launches x (time - bound) (of the
   bucket build's many small split shapes only the largest are timed).
   ``sq_encode`` is timed the same way at a segment (131,072 x 768) and a
   bucket payload (262,144 x 768).  Prints
   phase and build times, request
   latencies, profiled requests, one JSON line of kernel measurements, the
   card's name and power limit, and as the last line
   ``{"ok": true, "device": {...}}``.  Any failure exits non-zero.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import gc
import json
import statistics
import subprocess
import sys
import threading
import time
import traceback
import weakref
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

N_ROWS, DIM, K = 1_000_000, 768, 100
SEG_ROWS, N_SEALED = 131_072, 7
FLAT_SEGMENTS = (0, 1, 4)
NODE_A, NODE_B = (0, 1, 2, 3), (4, 5, 6)
DELETE_FRAC = 0.01
INSERT_BATCH = 8_192
# H100 SXM peaks at 700 W (NVIDIA data sheet): HBM3, f32 outside the tensor
# cores, and dense TF32 on them.  The exact scans reach float32 accuracy on
# the tensor cores in three TF32 products (3xTF32), so their bound counts
# 3 x 2*nq*N*D TF32 operations; the f32 bound of earlier runs is printed
# beside it.
PEAK_BYTES_S, PEAK_F32_FLOPS, PEAK_TF32_FLOPS = 3.35e12, 67e12, 495e12
# The redesigned scans' kernel-phase grid: nq across the small-nq path's
# threshold and the 128-query tensor-core tile, d with and without 16-byte
# rows, segments across the select's chunk of SELECT_CHUNK rows with one row
# repeated at TIE_ROWS (both sides of every chunk edge).
SCAN_NQ = (1, 4, 5, 7, 8, 9, 16, 17, 100, 128, 129, 300)
SCAN_D = (768, 96, 100, 19)
SELECT_CHUNK = 16384
# Rows wider than the small-nq path's shared-memory staging (and, for SQ,
# a row of scale / vmin): 16-byte and odd widths.
WIDE_D = (16_000, 10_001)
TIE_ROWS = (3, SELECT_CHUNK - 2, SELECT_CHUNK - 1, SELECT_CHUNK, SELECT_CHUNK + 1,
            2 * SELECT_CHUNK + 7, 3 * SELECT_CHUNK + 4)
# merge_topk's kernel-phase widths: around the warp's 32 columns and the
# one-warp limit (256), the main path's pools (400, 716, 1,700, 4,800),
# the chunk sizes' edges (1,024, 1,025) and the widest launch.
MERGE_WIDTHS = (1, 31, 32, 33, 256, 257, 400, 716, 800, 1024, 1025, 1700, 4800, 8192)
# Log timestamps: sealed rows, WAL inserts, deletes, and the two pins.
TS_SEALED, TS_GROW, TS_DELETE = 1_000, 2_000, 3_000
TS_BEFORE, TS_AFTER = 2_500, 3_500
# Indexed path: segment -> (index kind, build params).  nlist 128 / nprobe 8
# are Milvus's documented IVF defaults; m 48 divides 768.
IVF_PARAMS = {"nlist": 128, "nprobe": 8}
INDEXED_SEGMENTS = {
    0: ("ivf_flat", IVF_PARAMS),
    1: ("ivf_flat", IVF_PARAMS),
    2: ("ivf_sq", IVF_PARAMS),
    3: ("ivf_sq", IVF_PARAMS),
    4: ("ivf_pq", {**IVF_PARAMS, "m": 48, "ksub": 256}),
    5: ("sq", {}),
    6: ("pq", {"m": 48, "ksub": 256}),
}
# The indexed collection's Gaussian mixture: N_CENTERS unit-normal centers,
# each row a center plus NOISE * unit-normal noise.
N_CENTERS, NOISE = 1_024, 0.5
SLICE_ROWS = 2_048  # the system's default (src/repro/core/query_node.py:38)
KMEANS_SAMPLE = 100_000  # rows an IVF build's Lloyd steps run on (index/kmeans.py)
# kmeans_assign's kernel-phase grid: rows (the 128-row tile, the slice
# builds, a Lloyd step's sample) x centroids (the byte-bound path's sizes,
# the 128-centroid tile and several tiles) x D (with and without 16-byte
# rows, the PQ subspaces' 16).
ASSIGN_ROWS = (1, 700, SLICE_ROWS, KMEANS_SAMPLE)
ASSIGN_CENTROIDS = (1, 8, 16, 17, 128, 129, 256, 1_000)
ASSIGN_D = (16, 19, DIM)
# pq_adc_topk's kernel-phase grid: query groups full and ragged, m with
# 16-byte, 4-byte and single-code loads, tables of 16 and 256 entries.
PQ_NQ, PQ_M, PQ_KSUB = (1, 3, 4, 5, 8, 100), (8, 20, 48), (16, 256)
# sq_decode's kernel phase: a row count with n * DIM above 2^31; and the
# rows per call of an IVF-SQ index's first search (index/ivf.py _CHUNK).
DECODE_ROWS_64BIT = 2_800_000
DECODE_CHUNK_ROWS = 65_536
# Facade path: the ManuSystem deployment (2 shards, 2 loggers, 1 data node,
# 1 index node, 2 query nodes, 131,072-row seals, the default slice size),
# the rows streamed after the flush, and the sealed segments that makes.
FACADE_CONFIG = dict(num_shards=2, num_loggers=2, num_data_nodes=1, num_index_nodes=1,
                     num_query_nodes=2, seal_rows=SEG_ROWS, slice_rows=SLICE_ROWS)
FACADE_STREAM = 16_384
FACADE_SEGMENTS = 8  # per shard: 3 x 131,072 rows and the flushed remainder
FACADE_KERNELS = ("l2_topk", "merge_topk", "kmeans_assign", "sq_encode", "sq_decode")
# Maintenance path: the oldest ordinals a retention delete removes (a
# collection TTL's delete: ~25% of each shard's first sealed segment), and
# the kernels the path must launch (rebuilds, first searches, the restore).
RETENTION_DELETE = 65_536
MAINTENANCE_KERNELS = FACADE_KERNELS
# Index-family path: the reference's defaults for the bucket index (on one
# full sealed segment: its payload holds every row twice, 262,144 x 768
# codes) and for HNSW, whose graph build is the reference's host numpy
# code (~37 ms per inserted row at d 768 on the chip machine's host), so it
# runs on an HNSW_ROWS slice: 1,024 rows, ~38 s of build where 4,096 took
# 151 s of the script's 1,200 s limit.  Collection -> (index kind, build
# params, rows).
BUCKET_PARAMS = {"target_bucket_rows": 96, "replicas": 2, "nprobe_buckets": 8, "compress": True}
HNSW_PARAMS = {"m": 16, "ef_construction": 100, "ef_search": 64}
HNSW_ROWS = 1_024
FAMILY = {"vdb_bucket": ("bucket", BUCKET_PARAMS, SEG_ROWS), "vdb_hnsw": ("hnsw", HNSW_PARAMS, HNSW_ROWS)}
FAMILY_KERNELS = ("l2_topk", "merge_topk", "kmeans_assign", "sq_encode", "sq_l2_topk")
# The bucket build's hierarchical k-means splits every cluster above 128
# rows, each split a kmeans_assign shape of its own (about a hundred): every
# shape is checked and timed, and those under ASSIGN_LOG_WORK (N x C x D)
# are logged as one summary line.
ASSIGN_LOG_WORK = 10**7
# sq_encode's timed shapes: a sealed segment (an SQ / IVF-SQ build) and a
# bucket index's payload over one (replicas = 2).
ENCODE_ROWS = (SEG_ROWS, 2 * SEG_ROWS)
KERNEL_NAMES = (
    "l2_topk", "merge_topk", "kmeans_assign", "sq_encode", "sq_decode", "sq_l2_topk", "pq_adc_topk",
)
# Embedder cell: examples/serve_embedder.py's flow at yi-9b's published
# widths (arXiv:2403.04652; all 48 layers, d_model 4,096, 32 / 4 heads,
# d_ff 11,008, vocabulary 64,000; 8.8 B bf16 parameters drawn from --seed on
# the card).  EMBED_DOCS topic-biased documents of EMBED_DOC_TOKENS tokens
# embedded EMBED_BATCH at a time and inserted EMBED_INGEST_CHUNK at a time
# into a threaded ManuSystem (2 query nodes, 4,096-row seals) holding an IP
# collection of d 4,096 under IVF-FLAT at Milvus's defaults; then a stream
# of fresh documents of EMBED_QUERY_TOKENS tokens (the example's document
# length; embedded EMBED_STREAM_BATCH at a time, as many tokens per forward
# as the corpus) just large enough that every shard's growing segment
# reaches seal_rows, so seals and index builds run while EMBED_REQUESTS
# request batches of EMBED_FRESH fresh documents inserted and EMBED_NQ
# queries of EMBED_QUERY_TOKENS tokens searched at EMBED_STALENESS_MS, and
# EMBED_BIG_REQUESTS more at nq EMBED_BIG_NQ, are served; top EMBED_K, the
# example's limit.
EMBED_ARCH = "yi-9b"
EMBED_DOCS, EMBED_DOC_TOKENS, EMBED_QUERY_TOKENS, EMBED_TOPICS = 8_192, 128, 32, 16
EMBED_BATCH, EMBED_INGEST_CHUNK, EMBED_STREAM_BATCH = 32, 1_024, 128
EMBED_REQUESTS, EMBED_NQ, EMBED_FRESH = 20, 16, 8
EMBED_BIG_REQUESTS, EMBED_BIG_NQ = 20, 100
EMBED_STALENESS_MS, EMBED_K = 200.0, 5
EMBED_CONFIG = dict(num_query_nodes=2, seal_rows=4_096)
EMBED_KERNELS = ("l2_topk", "merge_topk", "kmeans_assign")
# An embedding is unit-norm within EMBED_NORM_TOL (float32 normalization of
# 4,096 components), and a document's embedding in a batch of EMBED_BATCH is
# within EMBED_BATCH_TOL (L2) of its embedding alone: the two batches run
# other matmul tilings, whose bf16 roundings differ through 48 layers.
EMBED_NORM_TOL, EMBED_BATCH_TOL = 1e-4, 0.05
# Serve path (``repro_torch.launch.serve``'s prefill / decode_step at the
# published widths).  Teacher-forced check at one effective period (2
# layers where the period is one layer; jamba's 8-slot period: 7 SSM, 1
# attention, 4 MoE): B=4, an 8-token prompt (after 256 patch embeddings
# for paligemma), SERVE_STEPS decode steps fed fixed tokens, each held to
# one prefill over the whole sequence within testing.DECODE_ATOL.
# SERVE_FULL_DEPTH runs whole as well: the same decode against prefill
# measured beside two prefills of the same rows in batches of 2 and 4 (the
# card's rounding noise at that depth), greedy tokens checked.
# Serving-sized run (SERVE_LOAD_ARCHS, jamba at one period, minicpm3-4b
# whole): B=8, a 1,024-token prefill, 64 greedy steps.
SERVE_ARCHS = ("yi-9b", "qwen3-32b", "minicpm3-4b", "qwen1.5-4b", "paligemma-3b", "qwen3-moe-30b-a3b",
               "deepseek-moe-16b", "mamba2-370m", "musicgen-medium", "jamba-v0.1-52b")
SERVE_FULL_DEPTH = ("minicpm3-4b",)
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS = 4, 8, 16
# MoE configurations also run a window capacity cannot bind: 8 positions,
# so no expert's 8 rows overflow (a token's k experts are distinct).
SERVE_WINDOW_PROMPT, SERVE_WINDOW_STEPS = 2, 6
SERVE_LOAD_ARCHS = ("jamba-v0.1-52b", "minicpm3-4b")
SERVE_LOAD_BATCH, SERVE_LOAD_PROMPT, SERVE_LOAD_STEPS = 8, 1_024, 64
SERVE_CPU_STEPS, SERVE_LOCAL_TOKENS = 8, 16
# Train path (repro_torch.train / launch.steps): yi-9b at its published
# widths, depth cut to TRAIN_LAYERS of 48, synthetic_lm_batches at
# TRAIN_BATCH x TRAIN_SEQ, TRAIN_STEPS steps of build_local_train_cell with remat
# and its default AdamW (the reference's: lr 3e-4 after 100 warm-up steps;
# train.loop's lr 3e-3 over 20, set for the reduced models, took yi-9b's
# loss from 11.8 to 26 in one step at full width); the micro-batch and
# resume checks at TRAIN_CHECK_LAYERS layers, full width; the card against
# the CPU on the reduced configuration.
TRAIN_ARCH, TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "yi-9b", 8, 8, 1_024, 12
TRAIN_CHECK_LAYERS, TRAIN_RESUME_STEPS, TRAIN_CRASH_AT = 2, 6, 3
TRAIN_LOCAL_STEPS = 6
# A resumed run's losses may differ from an uninterrupted run's by what two
# uninterrupted runs differ by (the embedding backward adds with atomics):
# held to RESUME_SPREADS times that spread, and never below RESUME_FLOOR.
RESUME_SPREADS, RESUME_FLOOR = 4.0, 1e-4
# Distributed path (repro_torch.distributed) on an NCCL group of world 1:
# the search over the FLAT cell's 1M x 768 base at DIST_NQ, k = K; flash
# decode through decode_step's hooks on DIST_DECODE_ARCHS (one period, full
# width; DIST_DECODE_STEPS teacher-forced steps against the dense decode);
# the expert-parallel MoE block on DIST_MOE_ARCH (one period, full width).
DIST_NQ, DIST_REPS = (1, 100), {1: 20, 100: 10}
DIST_DECODE_ARCHS, DIST_DECODE_STEPS = ("yi-9b", "minicpm3-4b"), 16
# Flash decode's logits against the dense decode's: bf16 activations round
# apart once the float32 attention sums in another order.  Set from the
# card's readings beside two controls of the dense decode alone (its
# positions summed in reverse; rows 0-1 decoded in a batch of 2), which
# are measured in every run (readings in PERF.md, section 6).
FLASH_DECODE_ATOL = 0.05
DIST_MOE_ARCH, DIST_MOE_TOKENS = "qwen3-moe-30b-a3b", 256
# Sharded-cells path (repro_torch.launch.steps on a (1, 1) mesh over an NCCL
# group of world 1): the train phase's cell (TRAIN_ARCH x TRAIN_LAYERS, full
# width, TRAIN_BATCH x TRAIN_SEQ) for SHARDED_TRAIN_STEPS steps beside the
# one-device cell from the same weights and batches; the dry-run's cost
# pass for that cell on a fake (1, 1) world beside the card's peak memory
# and train_flops, each ratio held to its bound below; the prefill and
# decode cells on SHARDED_SERVE_ARCHS (one period, full width) against the
# plain prefill / decode_step; expert-parallel training on DIST_MOE_ARCH.
SHARDED_TRAIN_STEPS = 3
SHARDED_SERVE_ARCHS = ("yi-9b", "minicpm3-4b", "jamba-v0.1-52b", "qwen3-moe-30b-a3b")
SHARDED_DECODE_STEPS = 8
# The dry-run's estimates over the card's readings for the same cell, held
# to bounds set from the first reading (PERF.md section 6).  Memory: the
# estimate's live meta storages against max_memory_allocated over the
# sharded steps less what earlier paths still hold (the allocator rounds
# every block up to 512 bytes); first read 0.9723 (NVIDIA H100 80GB HBM3,
# 700 W), the bound lets the allocator's share move by a few percent.
# FLOPs: FlopCounterMode over the step's matmuls against train_flops' count
# from the shapes (6 per weight and token, a whole forward recomputed),
# which is larger than what the eager step runs; both sides are shape
# arithmetic, so the ratio is fixed by the configuration (0.9474 at yi-9b
# x8, B=8 x 1,024; 0.9643 at reduced widths on the CPU) and the bound
# catches a change in either count.
DRYRUN_MEMORY_RATIO = (0.90, 1.05)
DRYRUN_FLOPS_RATIO = (0.93, 0.96)
# Examples (examples/torch_*.py) run in this process on the card, each
# through its main(["--device", "cuda"]); each must return 0.
EXAMPLES = ("torch_quickstart", "torch_elastic_failover", "torch_serve_embedder")
# Dense bf16 peak of one H100 SXM at 700 W (NVIDIA data sheet).
PEAK_BF16_FLOPS = 989e12
# DeepSeek-V2-Lite's routed experts at the dsv2lite-rag-ingest-512 cell's
# micro-batch (32 documents of 512 tokens, 6 of 64 experts a token).
MOE_TOKENS, MOE_D, MOE_F, MOE_EXPERTS, MOE_TOP_K = 16_384, 2_048, 1_408, 64, 6
MOE_LOADS = ("router", "one_expert", "half_empty")
# Matmul kernels by name in a profile: cuBLAS / cuBLASLt / CUTLASS.
GEMM_NAMES = ("gemm", "nvjet", "xmma", "cutlass", "cublas")


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean device time per call of ``fn`` over ``reps`` calls queued behind
    a sleep kernel: the stream is held while the host enqueues them, so the
    calls run back to back and the host time between launches does not
    count -- the measure for calls whose kernels are shorter than their
    launch overhead.  CUDA events around the queued calls.  The hold is
    set from one call's host time; where the host took longer to enqueue
    than the hold lasted (a longer host stall, or a launch queue that
    filled up behind the held stream and blocked the host), the
    measurement is repeated with a longer hold and half the calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    hold_s = min(2.0, 1e-3 + 2 * reps * (time.perf_counter() - t))  # > the enqueue time
    for _ in range(4):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(hold_s * 2e9))  # cycles at up to 2 GHz
        t = time.perf_counter()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        enqueue_s = time.perf_counter() - t
        end.synchronize()
        if enqueue_s <= hold_s:
            return start.elapsed_time(end) / reps
        hold_s = min(4.0, 2 * enqueue_s)
        reps = max(1, reps // 2)
    raise AssertionError(f"device_ms: the host took {enqueue_s:.4f} s to enqueue, longer "
                         f"than the {hold_s:.4f} s hold")


def profile_request(torch, fn, label: str, stats: dict | None = None):
    """One warm request under torch.profiler: wall time, device busy time
    (sum of kernel self times; one stream, so no overlap), kernel launches
    and host-device syncs, the kernels and host ops that take the most.
    Returns the profiled call's result; fills ``stats`` (wall_ms, busy_ms,
    idle_share, launches) where given."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    from torch.autograd import DeviceType

    events = prof.key_averages()
    launches = sum(e.count for e in events if "LaunchKernel" in e.key)
    syncs = sum(e.count for e in events if "Synchronize" in e.key)

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # Kernel records only: a PyTorch op's record carries its kernels' device
    # time too, so summing every record counts a torch op's kernels twice.
    kernels = [e for e in events if getattr(e, "device_type", None) == DeviceType.CUDA]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    if stats is not None:
        stats.update(wall_ms=wall_ms, busy_ms=busy_ms, launches=launches,
                     idle_share=max(0.0, 1 - busy_ms / wall_ms) if busy_ms else None)
    top_dev = sorted(kernels, key=dev_us, reverse=True)[:6]
    top_cpu = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)[:6]
    if busy_ms == 0:
        log(f"profile {label}: wall {wall_ms:.3f} ms, the profiler recorded no device time")
        return result
    gemm_ms = sum(dev_us(e) for e in kernels if any(g in e.key.lower() for g in GEMM_NAMES)) / 1e3
    log(f"profile {label}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
        f"(idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}); {launches} kernel launches, "
        f"{syncs} host-device syncs; matmul kernels {gemm_ms:.3f} ms "
        f"({gemm_ms / busy_ms:.3f} of busy)")
    log("  device: " + "; ".join(f"{e.key[:60]} x{e.count} {dev_us(e) / 1e3:.3f} ms" for e in top_dev))
    log("  host: " + "; ".join(
        f"{e.key[:40]} x{e.count} {e.self_cpu_time_total / 1e3:.3f} ms" for e in top_cpu
    ))
    return result


def kernel_phase(torch, l2_mod, merge_mod, ops, assert_scan_close, tol, dev, gen) -> dict:
    """Every kernel against its plain version; returns max |err| per kernel.
    Scores are held to ``tol[metric]`` (the measured float32 error, see
    ``repro_torch.testing.SCORE_TOL``); merges must be bit-exact."""
    err = {"l2_topk": 0.0, "merge_topk": 0.0}
    sizes = [0, 1, 700, SEG_ROWS, 5_000, N_ROWS - N_SEALED * SEG_ROWS]
    bases = [torch.randn((n, DIM), generator=gen, device=dev) for n in sizes]
    valids = [
        None,
        torch.ones(1, dtype=torch.bool, device=dev),
        torch.rand(700, generator=gen, device=dev) > 0.3,
        torch.rand(SEG_ROWS, generator=gen, device=dev) > 0.01,
        torch.zeros(5_000, dtype=torch.bool, device=dev),  # all invalid
        None,
    ]
    for nq in (1, 100):
        q = torch.randn((nq, DIM), generator=gen, device=dev)
        for metric in ("l2", "ip"):
            for k in (1, 100, 1024):
                got = l2_mod.l2_topk(q, bases, valids, k, metric)
                want = l2_mod.l2_topk_plain(q, bases, valids, k, metric)
                torch.cuda.synchronize()
                assert_scan_close(got, want, q, bases, valids, k, metric, *tol[metric])
                fin = torch.isfinite(want[0])
                e = (got[0][fin] - want[0][fin]).abs().max().item() if fin.any() else 0.0
                err["l2_topk"] = max(err["l2_topk"], e)
    # (k, pool width): the main path's node (4 units) and global (2 nodes)
    # merges at k=100, the extremes, and pools wider than one launch takes,
    # which ops.merge_topk merges in chunks.
    wide = 2 * merge_mod.MAX_M + 300
    cases = ((1, 8), (100, 200), (100, 400), (100, 800), (1024, merge_mod.MAX_M), (100, wide), (1024, wide))
    for k, m in cases:
        s = torch.randn((100, m), generator=gen, device=dev)
        s[:, ::5] = torch.round(s[:, ::5])
        s[:, 3::11] = -0.0
        s[:, 5::13] = float("inf")
        s[:, 6::17] = float("nan")
        s[:, 8::19] = float("-inf")
        p = torch.randint(-2, max(2, m // 3), (100, m), generator=gen, device=dev)
        p[:, ::23] += 2**40
        merge = merge_mod.merge_topk if m <= merge_mod.MAX_M else ops.merge_topk
        for metric in ("l2", "ip"):
            gv, gp = merge(s, p, k, metric)
            wv, wp = merge_mod.merge_topk_plain(s, p, k, metric)
            torch.cuda.synchronize()
            if not torch.equal(gp, wp) or not torch.equal(gv, wv):
                raise AssertionError(f"merge_topk differs from its plain version (k={k}, M={m}, {metric})")
            fin = torch.isfinite(wv)
            e = (gv[fin] - wv[fin]).abs().max().item() if fin.any() else 0.0
            err["merge_topk"] = max(err["merge_topk"], e)
    n_regimes = merge_regime_cases(torch, merge_mod, gen, dev)
    log(f"kernel phase: l2_topk 24 cases agree (rtol, atol: l2 {tol['l2']}, ip {tol['ip']}), "
        f"merge_topk {2 * len(cases) + n_regimes} cases bit-exact (widths up to {wide}); max |err| {err}")
    return err


def merge_regime_cases(torch, merge_mod, gen, dev) -> int:
    """merge_topk bit-exact against its plain version in each regime of the
    kernel: one warp per query (M <= 256, several per block: nq = 33
    fills no block evenly), a warp per chunk then one over the chunks' lists
    (every wider pool on the main path) and the block kernel (k = 1024 on
    pools above 1,024 columns); pools with mixed candidates (ties, -0.0,
    inf / NaN scores, pk < 0, pks past int32), with every pk repeated
    (twice, the later copy scoring the same or 1 apart) and with every
    candidate dead, at k = 1, 100 and 1024 (above the survivors where pks
    repeat or die), both metrics.  Returns the number of cases."""
    n = 0
    nq = 33
    for m in MERGE_WIDTHS:
        for kind in ("mixed", "repeated", "dead"):
            s = torch.randn((nq, m), generator=gen, device=dev)
            s[:, ::5] = torch.round(s[:, ::5])
            p = torch.randint(0, max(1, m // 3), (nq, m), generator=gen, device=dev)
            if kind == "mixed":
                s[:, 3::11] = -0.0
                s[:, 5::13] = float("inf")
                s[:, 6::17] = float("nan")
                p[:, 7::9] = -1
                p[:, ::23] += 2**40
            elif kind == "repeated":  # column c + h repeats column c's pk
                h = (m + 1) // 2
                p[:, :h] = torch.randperm(h, generator=gen, device=dev)
                p[:, h:] = p[:, :m - h]
                s[:, h:] = s[:, :m - h] + torch.rand((nq, m - h), generator=gen, device=dev).round()
            else:
                p[:, ::2] = -1
                s[:, 1::2] = float("nan")
            for k in (1, 100, 1024):
                for metric in ("l2", "ip"):
                    gv, gp = merge_mod.merge_topk(s, p, k, metric)
                    wv, wp = merge_mod.merge_topk_plain(s, p, k, metric)
                    torch.cuda.synchronize()
                    if not (torch.equal(gp, wp) and torch.equal(gv.view(torch.int32), wv.view(torch.int32))):
                        raise AssertionError(f"merge_topk differs from its plain version (nq={nq}, M={m}, "
                                             f"k={k}, {kind}, {metric})")
                    n += 1
    return n


def scan_bound(nq: int, n_bytes: float, n: int, d: int, f32_ops: float) -> dict:
    """The exact scans' bound: the bytes over the memory rate against the
    3xTF32 product over the TF32 rate; and the f32 bound of earlier runs
    (``f32_ops``, the product and the norms, over the f32 rate)."""
    t_b = n_bytes / PEAK_BYTES_S
    t_o = 3 * 2 * nq * n * d / PEAK_TF32_FLOPS
    return {"bound_ms": max(t_b, t_o) * 1e3, "bound_by": "bytes" if t_b >= t_o else "operations",
            "bound_f32_ms": max(t_b, f32_ops / PEAK_F32_FLOPS) * 1e3}


def path_crossover(torch, label: str, scan, d: int, gen, dev) -> dict:
    """Both score paths of one scan at nq 4 and 8, in one run:
    ``scan(q, small_q)`` with small_q 8 (the byte-bound path) and 0 (the
    tensor cores).  The kernels' default thresholds (``kSmallQ``: 4 for
    f32 rows, 8 for SQ codes) should sit where the faster path changes."""
    out = {}
    for nq in (4, 8):
        q = torch.randn((nq, d), generator=gen, device=dev)
        small = cuda_ms(torch, lambda: scan(q, 8), 20)
        tc = cuda_ms(torch, lambda: scan(q, 0), 20)
        out[nq] = {"small_ms": small, "tensor_core_ms": tc,
                   "faster": "small" if small < tc else "tensor_core"}
    log(f"{label} score paths at nq 4 / 8: " + json.dumps(out))
    return out


def wide_rows_phase(torch, l2_mod, sq_mod, gen, dev) -> int:
    """The scans at WIDE_D, where the small-nq path reads the queries (and
    SQ's scale / vmin) from global memory and the tensor-core path carries
    SQ's per-column state through its ring: small integers (SQ: codes 0..7
    with vmin 0, vmax 255, so scale is 1), whose products and sums float32
    holds exactly, so scores and ids must equal the plain versions' bit for
    bit.  Returns the number of cases."""
    n_cases = 0
    for d in WIDE_D:
        bases = [torch.randint(-2, 3, (n, d), generator=gen, device=dev).float() for n in (700, 3000)]
        valids = [None, torch.rand(3000, generator=gen, device=dev) > 0.2]
        codes = torch.randint(0, 8, (3000, d), generator=gen, device=dev, dtype=torch.uint8)
        lo, hi = torch.zeros(d, device=dev), torch.full((d,), 255.0, device=dev)
        for nq, small_q in ((1, None), (4, None), (8, 8), (8, None), (100, None)):
            q = torch.randint(-2, 3, (nq, d), generator=gen, device=dev).float()
            for metric in ("l2", "ip"):
                for label, got, want in (
                    ("l2_topk", l2_mod.l2_topk(q, bases, valids, K, metric, small_q=small_q),
                     l2_mod.l2_topk_plain(q, bases, valids, K, metric)),
                    ("sq_l2_topk", sq_mod.sq_l2_topk(q, codes, lo, hi, valids[1], K, metric,
                                                     small_q=small_q),
                     sq_mod.sq_l2_topk_plain(q, codes, lo, hi, valids[1], K, metric)),
                ):
                    torch.cuda.synchronize()
                    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                        raise AssertionError(f"{label} d={d} nq={nq} small_q={small_q} {metric}: "
                                             "differs from its plain version on exact data")
                    n_cases += 1
    log(f"wide rows: l2_topk and sq_l2_topk at d {WIDE_D}, nq 1 / 4 / 8 (both paths) / 100, "
        f"{n_cases} cases bit-exact on exact data")
    return n_cases


def model_tie_phase(testing, dev) -> dict:
    """The tensor-core score pass of both exact scans against the CPU model
    ``testing.scan_scores_tf32`` (``testing.model_tie``, nq 16 and 100, on
    nonnegative rows and on centred rows whose partial sums cancel): fails
    below ``testing.MODEL_TIE``'s share of bit-exact scores or past its
    ulps."""
    tie = {f"{kname} nq={nq}{' signed' if signed else ''}": testing.model_tie(kname, nq, dev, signed)
           for kname in ("l2_topk", "sq_l2_topk") for nq in (16, 100) for signed in (False, True)}
    log("tensor-core scores vs the 3xTF32 model (share bit-exact, largest ulps): " + json.dumps(tie))
    share, ulps = testing.MODEL_TIE
    for key, per in tie.items():
        for metric, (exact, far) in per.items():
            if exact < share or far > ulps:
                raise AssertionError(f"{key} {metric}: {exact:.4f} of the scores bit-exact, "
                                     f"{far:.2f} ulps at most, against {testing.MODEL_TIE}")
    return tie


def tensor_core_counts(_build) -> dict:
    """HMMA / HGMMA instructions in the built libraries of the tensor-core
    score pass's users (``cuobjdump -sass``), where the toolkit has
    cuobjdump."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = {}
    for name in ("l2_topk", "sq_codec", "kmeans_assign"):
        try:
            sass = subprocess.run([tool, "-sass", str(_build._lib_path(name))], capture_output=True,
                                  text=True, timeout=120).stdout
        except (OSError, subprocess.SubprocessError) as exc:
            out[name] = f"not measured ({exc.__class__.__name__})"
            continue
        out[name] = {op: sum(1 for ln in sass.splitlines() if f"{op}." in ln) for op in ("HMMA", "HGMMA")}
    return out


def scan_redesign_phase(torch, l2_mod, sq_mod, pq_mod, testing, dev, gen) -> dict:
    """The three scans over the redesigned score pass and two-stage select:
    every (nq, d, metric) of SCAN_NQ x SCAN_D x (L2, IP) at k 1, 100, 1024
    (nq 5..8 also through each score path at k 100) against the plain
    versions within ``SCORE_TOL``, segments of 0, 1, 700
    (all invalid), C - 1, C, C + 1 and 3C + 5 rows with ties planted across
    the chunk edges (the lowest rows must lead where the kernel scored them
    equal); ``pq_adc_topk`` bit-exact with exact ties across chunk edges;
    and the scans on the mixture data (norms ~960) against float64.
    Returns the largest error per kernel and metric."""
    err = {}

    def note(key, got, want):
        fin = torch.isfinite(want)
        if fin.any():
            err[key] = max(err.get(key, 0.0), (got[fin].double() - want[fin].double()).abs().max().item())

    def runs(nq):  # (k, small_q): nq 5..8 also through each path by name
        return ((1024, None), (100, None), (1, None)) + (((100, 8), (100, 0)) if 4 < nq <= 8 else ())

    C = SELECT_CHUNK
    ties = list(TIE_ROWS)
    n_l2 = n_sq = n_pq = 0
    for d in SCAN_D:
        sizes = (0, 1, 700, C - 1, C, C + 1, 3 * C + 5)
        bases = [torch.randn((n, d), generator=gen, device=dev) for n in sizes]
        # a row of a quarter of the usual norm: query 0 = that row sits at L2
        # distance ~0 without the float32 rounding of norms near d
        bases[-1][ties] = 0.25 * bases[-1][ties[0]]
        valids = [None, None, torch.zeros(700, dtype=torch.bool, device=dev)] + [
            torch.rand(n, generator=gen, device=dev) > 0.2 for n in sizes[3:]
        ]
        valids[-1][ties] = True
        for nq in SCAN_NQ:
            q = torch.randn((nq, d), generator=gen, device=dev)
            q[0] = bases[-1][ties[0]]  # L2 distance ~0: the tied rows lead query 0
            for metric in ("l2", "ip"):
                equal = None
                for k, small_q in runs(nq):
                    got = l2_mod.l2_topk(q, bases, valids, k, metric, small_q=small_q)
                    want = l2_mod.l2_topk_plain(q, bases, valids, k, metric)
                    torch.cuda.synchronize()
                    testing.assert_scan_close(got, want, q, bases, valids, k, metric,
                                              *testing.SCORE_TOL[metric])
                    note(f"l2_topk {metric} vs plain", got[0], want[0])
                    if metric == "l2":
                        blk = slice((len(bases) - 1) * k, len(bases) * k)
                        if equal is None:
                            equal = torch.unique(got[0][0, blk][:len(ties)]).numel() == 1
                        testing.assert_ties_by_row(got[0][0, blk], got[1][0, blk], ties, equal)
                    n_l2 += 1
        for n in (0, 1, C - 1, C + 1, 3 * C + 5):
            x = torch.randn((n, d), generator=gen, device=dev)
            lo = x.min(0).values if n else torch.zeros(d, device=dev)
            hi = x.max(0).values if n else torch.ones(d, device=dev)
            codes = sq_mod.sq_encode(x, lo, hi)
            tied = [r for r in ties if r < n]
            if tied:  # the code nearest the column centres: a row of small norm
                codes[tied] = sq_mod.sq_encode(((lo + hi) / 2)[None, :], lo, hi)
            decoded = sq_mod.sq_decode_plain(codes, lo, hi)
            valid = torch.rand(n, generator=gen, device=dev) > 0.2
            valid[tied] = True
            for nq in SCAN_NQ:
                q = torch.randn((nq, d), generator=gen, device=dev)
                if tied:
                    q[0] = decoded[tied[0]]
                for metric in ("l2", "ip"):
                    equal = None
                    for k, small_q in runs(nq):
                        got = sq_mod.sq_l2_topk(q, codes, lo, hi, valid, k, metric, small_q=small_q)
                        want = sq_mod.sq_l2_topk_plain(q, codes, lo, hi, valid, k, metric)
                        torch.cuda.synchronize()
                        testing.assert_scan_close(got, want, q, [decoded], [valid], k, metric,
                                                  *testing.SCORE_TOL[metric])
                        note(f"sq_l2_topk {metric} vs plain", got[0], want[0])
                        if tied and metric == "l2":
                            if equal is None:
                                equal = torch.unique(got[0][0, :len(tied)]).numel() == 1
                            testing.assert_ties_by_row(got[0][0], got[1][0], tied, equal)
                        n_sq += 1
    for n in (C - 1, C + 1, 3 * C + 5, SEG_ROWS):
        codes = torch.randint(0, 256, (n, 48), generator=gen, device=dev, dtype=torch.uint8)
        tied = [r for r in ties if r < n]
        codes[tied] = codes[tied[0]].clone()
        valid = torch.rand(n, generator=gen, device=dev) > 0.1
        for nq in (1, 7, 100):
            luts = torch.randn((nq, 48, 256), generator=gen, device=dev)
            for k in (1, 100, 1024):
                got = pq_mod.pq_adc_topk(luts, codes, k, valid)
                want = pq_mod.pq_adc_topk_plain(luts, codes, k, valid)
                torch.cuda.synchronize()
                if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                    raise AssertionError(f"pq_adc_topk differs from its plain version (n={n}, k={k})")
                n_pq += 1

    # Against float64 on the mixture data the chip cells use (|x|^2 ~ 960,
    # same-center L2 distances ~ 384), both score-pass routes.
    centers = torch.randn((N_CENTERS, DIM), generator=gen, device=dev)
    x = mixture(torch, gen, dev, SEG_ROWS, centers)
    lo, hi = x.min(0).values, x.max(0).values
    codes = sq_mod.sq_encode(x, lo, hi)
    decoded = sq_mod.sq_decode_plain(codes, lo, hi).double()
    x64 = x.double()
    for nq in (1, 100):
        q = mixture(torch, gen, dev, nq, centers)
        q64 = q.double()
        for metric in ("l2", "ip"):
            for kname, fn, base in (
                ("l2_topk", lambda: l2_mod.l2_topk(q, [x], [None], K, metric), x64),
                ("sq_l2_topk", lambda: sq_mod.sq_l2_topk(q, codes, lo, hi, None, K, metric), decoded),
            ):
                got_v, got_i = fn()
                qx = (q64[:, None, :] * base[got_i]).sum(-1)
                exact = qx if metric == "ip" else (
                    (q64 * q64).sum(1)[:, None] - 2.0 * qx + (base[got_i] ** 2).sum(-1))
                rtol, atol = testing.SCORE_TOL[metric]
                e = (got_v.double() - exact).abs()
                if bool((e > atol + rtol * exact.abs()).any()):
                    raise AssertionError(f"{kname} {metric} nq={nq}: a score misses float64 by "
                                         f"{e.max().item():.3g}")
                key = f"{kname} {metric} vs float64 (mixture)"
                err[key] = max(err.get(key, 0.0), e.max().item())
    del x, x64, codes, decoded
    log(f"scan redesign phase: l2_topk {n_l2} cases, sq_l2_topk {n_sq} cases agree with their plain "
        f"versions (SCORE_TOL; ties across chunk edges in row order), pq_adc_topk {n_pq} cases "
        f"bit-exact; largest |err| " + json.dumps({k: float(f"{v:.3g}") for k, v in err.items()}))
    return err


def tf32_control(torch, q, x, want_s, largest: bool, rtol: float, atol: float) -> float:
    """The exact check's teeth: the same top-k from a TF32 product must fall
    outside the tolerance.  Returns the TF32 product's largest score error."""
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        qx = q @ x.T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    if largest:
        scores = qx
    else:
        scores = ((q * q).sum(1, keepdim=True) - 2.0 * qx) + (x * x).sum(1)[None, :]
    tf_s = torch.topk(scores, want_s.shape[1], dim=1, largest=largest).values
    e = (tf_s - want_s).abs()
    if not bool((e > atol + rtol * want_s.abs()).any()):
        raise AssertionError(
            f"a TF32 product passes the score tolerance (rtol={rtol}, atol={atol}, "
            f"max |err| {e.max().item():.3g}): the check cannot tell it from float32"
        )
    return e.max().item()


def build_collection(torch, store, gen, dev, name: str, metric):
    """Seeded 1M x 768 rows on the card: 7 sealed segments written to the
    binlog (3 with FLAT indexes) and the tail kept for the WAL."""
    from repro_torch.core.binlog import index_key, write_segment_binlog
    from repro_torch.core.segment import segment_from_columns
    from repro_torch.index.flat import FlatIndex

    x = torch.randn((N_ROWS, DIM), generator=gen, device=dev)
    pks = torch.arange(N_ROWS, dtype=torch.int64, device=dev)
    for s in range(N_SEALED):
        lo, hi = s * SEG_ROWS, (s + 1) * SEG_ROWS
        seg = segment_from_columns(
            {"pk": pks[lo:hi], "vector": x[lo:hi],
             "ts": torch.full((SEG_ROWS,), TS_SEALED, dtype=torch.int64, device=dev)},
            segment_id=s, collection=name, device=dev,
        )
        write_segment_binlog(store, seg)
        if s in FLAT_SEGMENTS:
            idx = FlatIndex(metric, device=dev)
            idx.build(x[lo:hi])
            store.put(index_key(name, s, "vector", "flat"), idx.save())
            del idx
        del seg
    return x


def index_kernel_phase(torch, km_mod, sq_mod, pq_mod, testing, dev, gen) -> dict:
    """The four index kernels against their plain versions; returns max
    |err| per kernel.  Assignments must agree except at distance near-ties
    and their distances within ``SCORE_TOL``; SQ codes and PQ table sums
    must be bit-exact."""
    err = {"kmeans_assign": 0.0, "sq_encode": 0.0, "sq_decode": 0.0, "sq_l2_topk": 0.0,
           "pq_adc_topk": 0.0}
    tol = testing.SCORE_TOL
    n_assign = 0
    near_err = {}
    largest = km_mod.SMALL_C_MAX

    def assign_paths(c, d):  # small_c forcing each path (c, d) can take, and the default
        return ((0, c) if c <= largest or d <= km_mod.NARROW_D else (0,)) + (None,)

    for d in ASSIGN_D:
        xs = {n: torch.randn((n, d), generator=gen, device=dev) for n in ASSIGN_ROWS}
        for c in ASSIGN_CENTROIDS:
            cent = torch.randn((c, d), generator=gen, device=dev)
            for x in xs.values():
                want = km_mod.kmeans_assign_plain(x, cent)
                for small_c in assign_paths(c, d):
                    got = km_mod.kmeans_assign(x, cent, small_c=small_c)
                    torch.cuda.synchronize()
                    testing.assert_assign_close(got, want, x, cent, *tol["l2"])
                    err["kmeans_assign"] = max(err["kmeans_assign"], (got[1] - want[1]).abs().max().item())
                    n_assign += 1
        # Each centroid twice, the copy c / 2 later: across 128-centroid tile
        # edges on the tensor-core path (at 256 centroid 127's copy also sits
        # right after the edge), across the narrow-row path's 256-centroid
        # chunk (300), within one tile on the byte-bound path.  Every row's
        # nearest centroid has a copy, which ties exactly; the earliest must
        # win.
        x = xs[ASSIGN_ROWS[-1]]
        for c in (largest, 256, 300):
            base = torch.randn((c // 2, d), generator=gen, device=dev)
            cent = torch.cat([base, base])
            if c == 256:
                cent[128] = cent[127]
            want = km_mod.kmeans_assign_plain(x, cent)
            for small_c in assign_paths(c, d):
                got = km_mod.kmeans_assign(x, cent, small_c=small_c)
                torch.cuda.synchronize()
                if not bool((got[0] < c // 2).all()):
                    raise AssertionError(f"kmeans_assign (C={c}, d={d}, small_c={small_c}): a later "
                                         "copy of a centroid won a tie")
                testing.assert_assign_close(got, want, x, cent, *tol["l2"])
                n_assign += 1
        # Rows 0.1 sigma from their centroid: d2 ~ 0.01 d against norms ~ d,
        # where the expansion cancels and two float32 versions may differ by
        # both their errors, so the kernel is held to float64 here (the plain
        # version's error printed beside it).
        for c in (largest, 256):
            cent = torch.randn((c, d), generator=gen, device=dev)
            pick = torch.randint(0, c, (ASSIGN_ROWS[-1],), generator=gen, device=dev)
            x = cent[pick] + 0.1 * torch.randn((ASSIGN_ROWS[-1], d), generator=gen, device=dev)
            for small_c in assign_paths(c, d):
                got = km_mod.kmeans_assign(x, cent, small_c=small_c)
                torch.cuda.synchronize()
                key = "kmeans_assign near rows vs float64"
                near_err[key] = max(near_err.get(key, 0.0), testing.assign_error_float64(
                    got, x, cent, *tol["l2"]))
                n_assign += 1
            plain = km_mod.kmeans_assign_plain(x, cent)
            x64, c64 = x.double(), cent.double()[plain[0]]
            exact = ((x64 - c64) ** 2).sum(1)
            key = "kmeans_assign_plain near rows vs float64"
            near_err[key] = max(near_err.get(key, 0.0), (plain[1].double() - exact).abs().max().item())
            del x64, c64
        del xs

    x = torch.randn((SEG_ROWS, DIM), generator=gen, device=dev)
    vmin, vmax = x.min(0).values, x.max(0).values
    vmin[0], vmax[0] = 0.0, 255.0  # scale exactly 1: column 0 sits on .5 boundaries
    x[:, 0] = torch.arange(SEG_ROWS, device=dev).remainder(256).float() + 0.5
    x[:, 1] = 0.25  # a constant column, vmin == vmax
    vmin[1] = vmax[1] = 0.25
    codes = sq_mod.sq_encode(x, vmin, vmax)
    if not torch.equal(codes, sq_mod.sq_encode_plain(x, vmin, vmax)):
        raise AssertionError("sq_encode differs from its plain version")
    even = torch.arange(SEG_ROWS, device=dev).remainder(256)
    if not torch.equal(codes[:, 0].long(), (even + even.remainder(2)).clamp(max=255)):
        raise AssertionError("sq_encode does not round .5 to even")
    # sq_encode, bit-exact off the 4-element path: d % 4 != 0, a view one
    # float off the 16-byte grid, d above the staged 4,096 (and 4,096
    # itself), one element; then n * d above 2^31 (64-bit indexing),
    # compared in row chunks (the plain version is row by row).
    n_enc = 1
    for n, d, off in ((700, 19, 0), (257, DIM, 1), (257, DIM, 4), (3, 4_100, 0), (5, 10_001, 0),
                      (2, 4_096, 0), (1, 1, 0)):
        xe = torch.randn((n, d), generator=gen, device=dev)
        if off:
            xe = offset_view(torch, xe, off)
        lo, hi = xe.min(0).values, xe.max(0).values
        if not torch.equal(sq_mod.sq_encode(xe, lo, hi), sq_mod.sq_encode_plain(xe, lo, hi)):
            raise AssertionError(f"sq_encode differs from its plain version (n={n}, d={d}, "
                                 f"{4 * off} bytes off)")
        n_enc += 1
    del x, codes, xe

    # sq_decode, bit-exact: the 4-code path (d % 4 == 0, d = 100 too), the
    # scalar path (odd d, d above the staged 4,096, a misaligned view), one
    # row, row counts no grid step divides, and n * d above 2^31 (64-bit
    # indexing).
    n_dec = 0
    for n, d in ((SEG_ROWS, DIM), (1, DIM), (1, 1), (700, 19), (1_001, DIM), (513, 48), (999, 100),
                 (3, 4_100), (DECODE_CHUNK_ROWS, DIM), (DECODE_ROWS_64BIT, DIM)):
        c = torch.randint(0, 256, (n, d), generator=gen, device=dev, dtype=torch.uint8)
        lo = torch.randn(d, generator=gen, device=dev)
        hi = lo + 4 * torch.rand(d, generator=gen, device=dev)
        hi[0] = lo[0]  # a constant column
        got = sq_mod.sq_decode(c, lo, hi)
        want = sq_mod.sq_decode_plain(c, lo, hi)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"sq_decode differs from its plain version (n={n}, d={d})")
        del c, got, want
        n_dec += 1
    for off in (3, 4):  # contiguous views 3 and 4 bytes off the 16-byte grid
        flat = torch.randint(0, 256, (off + 257 * DIM,), generator=gen, device=dev, dtype=torch.uint8)
        c = flat[off:].view(257, DIM)
        lo, hi = torch.zeros(DIM, device=dev), torch.ones(DIM, device=dev)
        if not torch.equal(sq_mod.sq_decode(c, lo, hi), sq_mod.sq_decode_plain(c, lo, hi)):
            raise AssertionError(f"sq_decode differs from its plain version on a view {off} bytes off")
        n_dec += 1
    torch.cuda.empty_cache()
    xe = torch.randn((DECODE_ROWS_64BIT, DIM), generator=gen, device=dev)
    lo, hi = xe.min(0).values, xe.max(0).values
    codes = sq_mod.sq_encode(xe, lo, hi)
    for r0 in range(0, DECODE_ROWS_64BIT, 2 * SEG_ROWS):
        if not torch.equal(codes[r0:r0 + 2 * SEG_ROWS],
                           sq_mod.sq_encode_plain(xe[r0:r0 + 2 * SEG_ROWS], lo, hi)):
            raise AssertionError(f"sq_encode differs from its plain version at rows {r0}+ of "
                                 f"{DECODE_ROWS_64BIT} x {DIM}")
    n_enc += 1
    del xe, codes
    torch.cuda.empty_cache()

    n_sq = 0
    for n, frac in ((700, 0.3), (SEG_ROWS, 0.01), (5_000, 1.0)):
        xs = torch.randn((n, DIM), generator=gen, device=dev)
        lo, hi = xs.min(0).values, xs.max(0).values
        c = sq_mod.sq_encode(xs, lo, hi)
        decoded = sq_mod.sq_decode_plain(c, lo, hi)
        valid = torch.rand(n, generator=gen, device=dev) >= frac  # 5,000 rows: all invalid
        for nq in (1, 100):
            q = torch.randn((nq, DIM), generator=gen, device=dev)
            for metric in ("l2", "ip"):
                for k in (1, 100, 1024):
                    got = sq_mod.sq_l2_topk(q, c, lo, hi, valid, k, metric)
                    want = sq_mod.sq_l2_topk_plain(q, c, lo, hi, valid, k, metric)
                    torch.cuda.synchronize()
                    testing.assert_scan_close(got, want, q, [decoded], [valid], k, metric, *tol[metric])
                    fin = torch.isfinite(want[0])
                    if fin.any():
                        e = (got[0][fin] - want[0][fin]).abs().max().item()
                        err["sq_l2_topk"] = max(err["sq_l2_topk"], e)
                    n_sq += 1

    n_pq = 0
    valid = torch.rand(SEG_ROWS, generator=gen, device=dev) > 0.1
    for m in PQ_M:
        for ksub in PQ_KSUB:
            c = torch.randint(0, ksub, (SEG_ROWS, m), generator=gen, device=dev, dtype=torch.int32)
            c[:64] = c[0].clone()  # exact ties
            for nq in PQ_NQ:
                luts = torch.randn((nq, m, ksub), generator=gen, device=dev)
                ks = (1, 100, 1024) if nq in (1, 100) and ksub == 256 else (K,)
                for k in ks:
                    for codes in (c.to(torch.uint8), c):
                        want = pq_mod.pq_adc_topk_plain(luts, codes, k, valid)
                        views = [(luts, codes)]
                        if k == K:  # offset views: narrower table and code loads
                            views.append((offset_view(torch, luts, 1), offset_view(torch, codes, 1)))
                        for lt, ct in views:
                            got = pq_mod.pq_adc_topk(lt, ct, k, valid)
                            torch.cuda.synchronize()
                            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                                raise AssertionError(
                                    f"pq_adc_topk differs from its plain version (nq={nq}, m={m}, "
                                    f"ksub={ksub}, k={k}, {ct.dtype}, offsets {lt.data_ptr() % 16} / "
                                    f"{ct.data_ptr() % 16})")
                            n_pq += 1
    # A table of exactly one block's shared memory: one query per block.
    m = pq_mod.MAX_LUT_BYTES // (4 * 256)
    luts = torch.randn((5, m, 256), generator=gen, device=dev)
    c = torch.randint(0, 256, (3000, m), generator=gen, device=dev, dtype=torch.int32)
    for codes in (c.to(torch.uint8), c):
        got = pq_mod.pq_adc_topk(luts, codes, K)
        want = pq_mod.pq_adc_topk_plain(luts, codes, K)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"pq_adc_topk differs from its plain version at a {m} x 256 table")
        n_pq += 1
    log(f"kernel phase: kmeans_assign {n_assign} cases agree, every score path (rtol, atol "
        f"{tol['l2']}, near-ties exempt, earliest copy wins across tile edges; rows near their "
        f"centroids within it of float64, largest |err| {json.dumps(near_err)}); sq_encode {n_enc} cases "
        f"bit-exact (.5 boundaries, constant column, odd d, misaligned view, d > 4,096, n * d up to "
        f"{DECODE_ROWS_64BIT * DIM}); sq_decode {n_dec} cases bit-exact (n * d up to "
        f"{DECODE_ROWS_64BIT * DIM}); sq_l2_topk {n_sq} cases agree; pq_adc_topk {n_pq} cases "
        f"bit-exact; max |err| {err}")
    return err


class Ticks:
    """The coord channel's timestamp oracle: increasing integers that sit
    between the build tasks and the deletes on the log."""

    def __init__(self, start: int):
        self.ts = start

    def next(self) -> int:
        self.ts += 1
        return self.ts


def offset_view(torch, t, elems: int):
    """``t``'s values in a contiguous view ``elems`` elements past an
    aligned allocation."""
    flat = torch.empty(t.numel() + elems, dtype=t.dtype, device=t.device)
    view = flat[elems:].view(t.shape)
    view.copy_(t)
    return view


def mixture(torch, gen, dev, n: int, centers):
    """Seeded Gaussian-mixture rows: a random center plus noise."""
    pick = torch.randint(0, len(centers), (n,), generator=gen, device=dev)
    return centers[pick] + NOISE * torch.randn((n, centers.shape[1]), generator=gen, device=dev)


def recall_at(got_i, exact_i) -> float:
    """Share of each query's exact top-k ids that the answer holds."""
    return (got_i[:, :, None] == exact_i[:, None, :]).any(2).float().mean().item()


def check_against_oracle(torch, testing, label, got, nodes, name, q, pin, deleted, passes,
                         rtol, atol):
    """``got`` against ``testing.system_oracle`` over what ``nodes`` hold,
    with no deleted pk returned.  Returns (near-tie swaps, the answer's
    largest score error against float64 per unit kind, overall)."""
    oracle = testing.system_oracle(nodes, name, q, K, pin, deleted, passes)
    if deleted is not None and torch.isin(got[1], deleted).any():
        raise AssertionError(f"{label}: a deleted pk was returned")
    swaps = testing.assert_oracle_answer(label, got, oracle, rtol, atol)
    all_pks, all_scores = oracle["all_pks"], oracle["all_scores"]
    col_of_pk = torch.full((int(all_pks.max()) + 1,), -1, dtype=torch.int64, device=all_pks.device)
    col_of_pk[all_pks] = torch.arange(len(all_pks), device=all_pks.device)
    qi, slot = torch.nonzero(got[1] >= 0, as_tuple=True)
    cols = col_of_pk[got[1][qi, slot]]
    err = (got[0][qi, slot].double() - all_scores[qi, cols]).abs()
    unit = torch.searchsorted(oracle["bounds"].to(cols.device), cols, right=True) - 1
    by_kind = {}
    for u, kind in enumerate(oracle["kinds"]):
        e = err[unit == u]
        if e.numel():
            by_kind[kind] = max(by_kind.get(kind, 0.0), e.max().item())
    return swaps, by_kind, (err.max().item() if err.numel() else 0.0)


def indexed_path(torch, mods, gen, dev, phases, counts):
    """Index builds on the IndexNode, two QueryNodes loading them, interim
    slice indexes over the WAL tail, requests pinned before and after 1%
    deletes.  Every launch counter starts at 0 with the builds."""
    wal, Metric, GuaranteeTs, AnnsQuery, NodeSearchRequest = (
        mods["wal"], mods["Metric"], mods["GuaranteeTs"], mods["AnnsQuery"], mods["NodeSearchRequest"]
    )
    from repro_torch.core.binlog import write_segment_binlog
    from repro_torch.core.index_node import IndexNode
    from repro_torch.core.meta_store import MetaStore
    from repro_torch.core.object_store import MemoryObjectStore
    from repro_torch.core.query_node import QueryNode
    from repro_torch.core.segment import segment_from_columns

    name = "vdb_ivf"
    t0 = time.perf_counter()
    store = MemoryObjectStore()
    centers = torch.randn((N_CENTERS, DIM), generator=gen, device=dev)
    x = mixture(torch, gen, dev, N_ROWS, centers)
    queries = {nq: mixture(torch, gen, dev, nq, centers) for nq in (1, 100)}
    pks = torch.arange(N_ROWS, dtype=torch.int64, device=dev)
    for s in range(N_SEALED):
        lo, hi = s * SEG_ROWS, (s + 1) * SEG_ROWS
        seg = segment_from_columns(
            {"pk": pks[lo:hi], "vector": x[lo:hi],
             "ts": torch.full((SEG_ROWS,), TS_SEALED, dtype=torch.int64, device=dev)},
            segment_id=s, collection=name, device=dev,
        )
        write_segment_binlog(store, seg)
        del seg
    torch.cuda.synchronize()
    phases["ivf_data_and_binlog_s"] = time.perf_counter() - t0

    # ---- the path: builds, loads, WAL ingest with slice indexes, requests
    counts.reset()
    t0 = time.perf_counter()
    broker = wal.LogBroker()
    broker.create_channel("coord")
    ticks = Ticks(TS_SEALED + 100)
    inode = IndexNode("in-1", broker, store, MetaStore(), ticks, device=dev)
    builds = {}
    for s, (kind, params) in INDEXED_SEGMENTS.items():
        broker.publish("coord", wal.LogEntry(ticks.next(), wal.EntryType.COORD, {
            "msg": "index_build_task", "collection": name, "segment_id": s,
            "index_kind": kind, "metric": "l2", "params": params,
        }))
        before = counts.read()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if not inode.step():
            raise AssertionError(f"the index node did not build segment {s}")
        torch.cuda.synchronize()
        after = counts.read()
        builds[s] = {
            "kind": kind, "s": time.perf_counter() - t1,
            "launches": {k: after[k] - before[k] for k in after if after[k] > before[k]},
        }
        log(f"build segment {s} {kind} {params}: {builds[s]['s']:.3f} s, launches {builds[s]['launches']}")
    phases["ivf_index_builds_s"] = time.perf_counter() - t0
    built = [e.payload for e in broker.read("coord", 0) if e.payload.get("msg") == "index_built"]
    if len(built) != N_SEALED or inode.metrics.counter_value(
        "index_builds_total", labels={"kind": "ivf_flat"}
    ) != 2:
        raise AssertionError("the index node did not announce every build")

    t0 = time.perf_counter()
    nodes = {
        nid: QueryNode(nid, broker, store, slice_rows=SLICE_ROWS, device=dev)
        for nid in ("qn-c", "qn-d")
    }
    for p in built:
        node = nodes["qn-c" if p["segment_id"] in NODE_A else "qn-d"]
        node.load_sealed(p["collection"], p["segment_id"])
        node.load_index(p["collection"], p["segment_id"], p["index_kind"], p["index_key"])
    torch.cuda.synchronize()
    phases["ivf_load_indexes_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    tail = N_SEALED * SEG_ROWS
    ch = wal.dml_channel(name, 0)
    broker.create_channel(ch)
    nodes["qn-d"].subscribe(ch)
    x_tail = x[tail:].cpu().numpy()
    for j, lo in enumerate(range(0, len(x_tail), INSERT_BATCH)):
        hi = min(lo + INSERT_BATCH, len(x_tail))
        broker.publish(ch, wal.LogEntry(TS_GROW + j, wal.EntryType.INSERT, {
            "collection": name, "segment_id": N_SEALED, "shard": 0,
            "pk": np.arange(tail + lo, tail + hi), "vector": x_tail[lo:hi],
        }))
    for node in nodes.values():
        node.step()
    torch.cuda.synchronize()
    phases["ivf_ingest_and_slice_indexes_s"] = time.perf_counter() - t0
    grow = nodes["qn-d"].growing[(name, N_SEALED)]
    n_slices = (N_ROWS - tail) // SLICE_ROWS
    if grow.num_rows != N_ROWS - tail or sorted(grow.slice_indexes) != list(range(n_slices)):
        raise AssertionError("the growing segment did not take every insert or build every slice index")
    doomed = torch.randperm(N_ROWS, generator=gen, device=dev)[: int(N_ROWS * DELETE_FRAC)]
    pk = doomed.cpu().numpy()
    broker.publish(ch, wal.LogEntry(TS_DELETE, wal.EntryType.DELETE, {"collection": name, "pk": pk}))
    broker.publish("coord", wal.LogEntry(TS_DELETE, wal.EntryType.COORD,
                                         {"msg": "tombstones", "collection": name, "pk": pk}))
    for node in nodes.values():
        node.step()

    def request(q, ts):
        parts = [
            node.search_request(NodeSearchRequest(
                collection=name, k=K, metric=Metric.L2,
                guarantee=GuaranteeTs(query_ts=ts, staleness_ms=float("inf")),
                anns=[AnnsQuery("vector", q)],
            ))[0]
            for node in nodes.values()
        ]
        return mods["ops"].merge_topk(torch.cat([p[0] for p in parts], 1),
                                      torch.cat([p[1] for p in parts], 1), K, metric="l2")

    reps = {1: 20, 100: 5}
    latency, results = {}, {}
    t0 = time.perf_counter()
    for nq, q in queries.items():
        for pin, ts in (("before", TS_BEFORE), ("after", TS_AFTER)):
            times = []
            for _ in range(reps[nq] + 1):  # first call is the warm-up
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                out = request(q, ts)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t1) * 1e3)
            latency[f"{name} nq={nq} {pin}"] = times
            results[(nq, pin)] = out
    phases["ivf_requests_s"] = time.perf_counter() - t0
    launches = counts.read()
    # IVF builds on the tensor cores, slices byte-bound, PQ subspaces narrow rows
    shapes = counts.read_shapes(launches, "indexed", ("tensor_cores", "byte_bound", "narrow_rows"))
    n_requests = sum(reps[nq] + 1 for nq in queries) * 2
    log(f"indexed path launches: {launches} ({n_requests} requests, {N_SEALED} builds, "
        f"{n_slices} slice indexes)")
    for kname, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{kname} was not launched on the indexed path")
    return {
        "name": name, "x": x, "queries": queries, "nodes": nodes, "store": store,
        "built": built, "builds": builds, "doomed": doomed, "request": request,
        "latency": latency, "results": results, "launches": launches,
        "shapes": shapes, "n_requests": n_requests,
    }


def check_indexed(torch, run, testing, dev, phases) -> None:
    """Every indexed answer against the oracle; recall@100 per kind against
    exact brute force; an IVF-FLAT built twice from one seed."""
    from repro_torch.core.binlog import read_binlog_column
    from repro_torch.index.ivf import IVFFlatIndex

    t0 = time.perf_counter()
    rtol, atol = testing.SCORE_TOL["l2"]
    name, x, nodes = run["name"], run["x"], run["nodes"]
    handles = {}
    for node in nodes.values():
        for (coll, sid), h in node.sealed.items():
            if coll == name:
                handles[sid] = h
    grow = nodes["qn-d"].growing[(name, N_SEALED)]
    for (nq, pin), got in run["results"].items():
        q = run["queries"][nq]
        deleted = run["doomed"] if pin == "after" else None
        label = f"{name} nq={nq} {pin}"
        swaps, by_kind, max_err = check_against_oracle(
            torch, testing, label, got, list(nodes.values()), name, q,
            TS_AFTER if pin == "after" else TS_BEFORE, deleted, None, rtol, atol,
        )
        exact = torch.topk(
            torch.where(
                torch.isin(torch.arange(N_ROWS, device=dev), run["doomed"])[None, :] & (pin == "after"),
                float("inf"), testing.l2_scores(q, x),
            ), K, dim=1, largest=False,
        ).indices
        recall = recall_at(got[1], exact)
        log(f"check {label}: equals the oracle (rtol={rtol}, atol={atol}; max |err| "
            f"{max_err:.3g} against float64; {swaps} near-tie swaps); "
            f"recall@{K} vs exact brute force {recall:.4f}; answer score error by kind "
            + json.dumps({k: float(f"{v:.3g}") for k, v in by_kind.items()}))
    phases["ivf_verify_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    q = run["queries"][100]
    per_kind = {}
    for sid, h in sorted(handles.items()):
        xs = x[sid * SEG_ROWS:(sid + 1) * SEG_ROWS]
        exact = torch.topk(testing.l2_scores(q, xs), K, dim=1, largest=False).indices
        _s, got_i = h.index.search(q, K)
        per_kind.setdefault(h.index.KIND, []).append(recall_at(got_i, exact))
    slice_recall = []
    for s_idx, idx in sorted(grow.slice_indexes.items())[:8]:
        lo, hi = grow.slice_bounds(s_idx)
        exact = torch.topk(testing.l2_scores(q, grow.vectors()[lo:hi]), K, dim=1, largest=False).indices
        _s, got_i = idx.search(q, K)
        slice_recall.append(recall_at(got_i, exact))
    per_kind["interim ivf_flat (first 8 slices)"] = slice_recall
    log("recall@100 per index kind (nq=100, each index alone vs exact brute force over its rows): "
        + "; ".join(f"{k} {[round(r, 4) for r in v]}" for k, v in per_kind.items()))

    seg0 = torch.from_numpy(read_binlog_column(run["store"], name, 0, "vector")).to(dev)
    again = IVFFlatIndex(nlist=IVF_PARAMS["nlist"], nprobe=IVF_PARAMS["nprobe"], device=dev)
    again.build(seg0)
    key = next(p["index_key"] for p in run["built"] if p["segment_id"] == 0)
    if again.save() != run["store"].get(key):
        raise AssertionError("segment 0's IVF-FLAT built twice from one seed saved different bytes")
    log("determinism: segment 0's IVF-FLAT rebuilt from the binlog saves the index node's bytes exactly")
    phases["ivf_recall_and_rebuild_s"] = time.perf_counter() - t0


def index_kernel_times(torch, run, sq_mod, pq_mod, dev, gen, card) -> dict:
    """``sq_encode``, ``sq_l2_topk`` and ``pq_adc_topk`` at the indexed
    path's shapes: kernel, plain version and (where one PyTorch call
    computes the same function) the library call, with the bound from this
    run's shapes (``kmeans_assign`` is timed per shape by
    ``assign_shape_times``)."""
    from repro_torch import testing

    handles = {}
    for node in run["nodes"].values():
        for (coll, sid), h in node.sealed.items():
            if coll == run["name"]:
                handles[sid] = h
    x = run["x"]
    out = {}

    def bound(n_bytes, n_ops):
        t_b, t_o = n_bytes / PEAK_BYTES_S, n_ops / PEAK_F32_FLOPS
        return {"bound_ms": max(t_b, t_o) * 1e3, "bound_by": "bytes" if t_b >= t_o else "operations"}

    # sq_encode: a sealed segment's SQ build (segment 5, 131,072 x 768) and
    # a bucket index's payload (segments 5 and 6, 262,144 x 768).
    for rows in ENCODE_ROWS:
        xe = x[5 * SEG_ROWS:5 * SEG_ROWS + rows].contiguous()
        lo, hi = xe.min(0).values, xe.max(0).values
        out["sq_encode" if rows == SEG_ROWS else f"sq_encode N={rows}"] = {
            "ms": device_ms(torch, lambda: sq_mod.sq_encode(xe, lo, hi), 20),
            "event_ms": cuda_ms(torch, lambda: sq_mod.sq_encode(xe, lo, hi), 20),
            "plain_ms": device_ms(torch, lambda: sq_mod.sq_encode_plain(xe, lo, hi), 10),
            "library_ms": None,
            # 4 bytes in and 1 out per element, vmin / vmax read once; a
            # subtract, a divide, a round and a clamp per element
            **bound(5 * rows * DIM + 8 * DIM, 4 * rows * DIM),
            "shape": f"N={rows} D={DIM}",
        }
        del xe
    sqi = handles[5].index
    decoded = sq_mod.sq_decode_plain(sqi.codes, sqi.vmin, sqi.vmax)
    valid = torch.ones(SEG_ROWS, dtype=torch.bool, device=dev)
    pqi = handles[6].index
    m, ksub = pqi.codebooks.shape[0], pqi.codebooks.shape[1]
    for nq, q in run["queries"].items():
        reps = 20 if nq == 1 else 10
        out[f"sq_l2_topk nq={nq}"] = {
            "ms": cuda_ms(torch, lambda: sq_mod.sq_l2_topk(q, sqi.codes, sqi.vmin, sqi.vmax, valid, K), reps),
            "plain_ms": cuda_ms(
                torch, lambda: sq_mod.sq_l2_topk_plain(q, sqi.codes, sqi.vmin, sqi.vmax, valid, K), reps
            ),
            "library_ms": cuda_ms(torch, lambda: torch.topk(q @ decoded.T, K, dim=1), reps),
            **scan_bound(nq, 4 * nq * DIM + SEG_ROWS * DIM + 8 * DIM + SEG_ROWS + 12 * nq * K,
                         SEG_ROWS, DIM, 2 * nq * SEG_ROWS * DIM + 4 * SEG_ROWS * DIM + 2 * nq * DIM),
            "shape": f"nq={nq} N={SEG_ROWS} D={DIM} uint8 k={K}",
        }
        luts = testing.lut_tables(q, pqi.codebooks).contiguous()
        codes = pqi.codes
        lookups = nq * SEG_ROWS * m
        terms = {  # least time per term, seconds
            "bytes": (4 * nq * m * ksub + SEG_ROWS * m * codes.element_size() + SEG_ROWS
                      + 12 * nq * K) / PEAK_BYTES_S,
            "f32 adds": lookups / PEAK_F32_FLOPS,
            # shared memory serves 32 four-byte entries per clock per SM
            "lookups": lookups / (card["sms"] * 32 * card["sm_clock_hz"]),
        }
        term = max(terms, key=terms.get)
        out[f"pq_adc_topk nq={nq}"] = {
            "ms": cuda_ms(torch, lambda: pq_mod.pq_adc_topk(luts, codes, K, valid), reps),
            "device_ms": device_ms(torch, lambda: pq_mod.pq_adc_topk(luts, codes, K, valid), reps),
            "plain_ms": cuda_ms(torch, lambda: pq_mod.pq_adc_topk_plain(luts, codes, K, valid), reps),
            "library_ms": None,
            "bound_ms": terms[term] * 1e3, "bound_by": "bytes" if term == "bytes" else "operations",
            "bound_term": term, "terms_ms": {t: v * 1e3 for t, v in terms.items()},
            "query_group": pq_mod.query_group(nq, m, ksub),
            "shape": f"nq={nq} N={SEG_ROWS} M={m} KSUB={ksub} {codes.dtype} codes k={K}",
        }
    for kname, row in out.items():
        log(f"{kname}: " + json.dumps(row))
    path_crossover(torch, f"sq_l2_topk over {SEG_ROWS} x {DIM} uint8",
                   lambda q, sq: sq_mod.sq_l2_topk(q, sqi.codes, sqi.vmin, sqi.vmax, valid, K,
                                                   small_q=sq),
                   DIM, gen, dev)
    return out


def index_family_path(torch, mods, run, gen, dev, phases, counts) -> dict:
    """The rest of the index family on the indexed path's mixture rows: a
    bucket index over one full sealed segment and HNSW over an HNSW_ROWS
    slice (``FAMILY``), built by the port's ``IndexNode`` from
    ``index_build_task`` messages, loaded by one ``QueryNode`` and searched
    at nq 1 and 100, pinned after the indexed path's 1% deletes.  Every
    launch counter starts at 0 with the builds."""
    wal, Metric, GuaranteeTs, AnnsQuery, NodeSearchRequest = (
        mods["wal"], mods["Metric"], mods["GuaranteeTs"], mods["AnnsQuery"], mods["NodeSearchRequest"]
    )
    from repro_torch.core.binlog import write_segment_binlog
    from repro_torch.core.index_node import IndexNode
    from repro_torch.core.meta_store import MetaStore
    from repro_torch.core.object_store import MemoryObjectStore
    from repro_torch.core.query_node import QueryNode
    from repro_torch.core.segment import segment_from_columns

    t0 = time.perf_counter()
    store = MemoryObjectStore()
    x = run["x"]
    for name, (_kind, _params, rows) in FAMILY.items():
        seg = segment_from_columns(
            {"pk": torch.arange(rows, dtype=torch.int64, device=dev), "vector": x[:rows],
             "ts": torch.full((rows,), TS_SEALED, dtype=torch.int64, device=dev)},
            segment_id=0, collection=name, device=dev,
        )
        write_segment_binlog(store, seg)
        del seg
    torch.cuda.synchronize()
    phases["family_data_and_binlog_s"] = time.perf_counter() - t0

    counts.reset()
    t0 = time.perf_counter()
    broker = wal.LogBroker()
    broker.create_channel("coord")
    ticks = Ticks(TS_SEALED + 100)
    inode = IndexNode("in-f", broker, store, MetaStore(), ticks, device=dev)
    builds = {}
    for name, (kind, params, rows) in FAMILY.items():
        broker.publish("coord", wal.LogEntry(ticks.next(), wal.EntryType.COORD, {
            "msg": "index_build_task", "collection": name, "segment_id": 0,
            "index_kind": kind, "metric": "l2", "params": params,
        }))
        before = counts.read()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if not inode.step():
            raise AssertionError(f"the index node did not build {name}")
        torch.cuda.synchronize()
        after = counts.read()
        builds[name] = {
            "kind": kind, "rows": rows, "s": time.perf_counter() - t1,
            "launches": {k: after[k] - before[k] for k in after if after[k] > before[k]},
        }
        log(f"build {name} {kind} {params} over {rows} x {DIM}: {builds[name]['s']:.3f} s, "
            f"launches {builds[name]['launches']}")
    phases["family_index_builds_s"] = time.perf_counter() - t0
    built = [e.payload for e in broker.read("coord", 0) if e.payload.get("msg") == "index_built"]
    if sorted(p["collection"] for p in built) != sorted(FAMILY):
        raise AssertionError("the index node did not announce every index-family build")

    t0 = time.perf_counter()
    node = QueryNode("qn-f", broker, store, slice_rows=SLICE_ROWS, device=dev)
    for p in built:
        node.load_sealed(p["collection"], p["segment_id"])
        node.load_index(p["collection"], p["segment_id"], p["index_kind"], p["index_key"])
    torch.cuda.synchronize()
    phases["family_load_indexes_s"] = time.perf_counter() - t0
    for name, (kind, _params, rows) in FAMILY.items():
        h = node.sealed[(name, 0)]
        if h.index is None or h.index.KIND != kind or h.index.num_rows != rows:
            raise AssertionError(f"{name}: the query node did not load its {kind} index")
    pk = run["doomed"].cpu().numpy()
    for name in FAMILY:
        broker.publish("coord", wal.LogEntry(TS_DELETE, wal.EntryType.COORD,
                                             {"msg": "tombstones", "collection": name, "pk": pk}))
    node.step()

    def request(name, q):
        return node.search_request(NodeSearchRequest(
            collection=name, k=K, metric=Metric.L2,
            guarantee=GuaranteeTs(query_ts=TS_AFTER, staleness_ms=float("inf")),
            anns=[AnnsQuery("vector", q)],
        ))[0]

    reps = {1: 10, 100: 3}
    latency, results, per_request = {}, {}, {}
    t0 = time.perf_counter()
    for name in FAMILY:
        for nq, q in run["queries"].items():
            times = []
            for _ in range(reps[nq] + 1):  # first call is the warm-up
                before = counts.read()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                out = request(name, q)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t1) * 1e3)
            after = counts.read()
            per_request[f"{name} nq={nq}"] = {k: after[k] - before[k] for k in after if after[k] > before[k]}
            latency[f"{name} nq={nq} after"] = times
            results[(name, nq)] = out
    phases["family_requests_s"] = time.perf_counter() - t0
    launches = counts.read()
    # first-level clusterings on the tensor cores, splits byte-bound
    shapes = counts.read_shapes(launches, "index-family", ("tensor_cores", "byte_bound"))
    log(f"index-family path launches: {launches}; per request (the last of each): "
        + json.dumps(per_request))
    for kname in FAMILY_KERNELS:
        if launches[kname] <= 0:
            raise AssertionError(f"{kname} was not launched on the index-family path")
    return {
        "x": x, "queries": run["queries"], "doomed": run["doomed"], "node": node,
        "request": request, "builds": builds, "latency": latency, "results": results,
        "launches": launches, "shapes": shapes,
    }


def check_family(torch, fam, testing, dev, phases) -> None:
    """The bucket answers against the float64 oracle over the loaded index
    (``testing.system_oracle``: probe by a full sort of the centre
    distances, score every probed slot, each row's best, a stable sort);
    each HNSW score against the float64 distance of its row; no deleted pk
    in either; recall@100 against exact brute force over the visible rows,
    printed, not gated."""
    t0 = time.perf_counter()
    rtol, atol = testing.SCORE_TOL["l2"]
    x, doomed = fam["x"], fam["doomed"]
    for (name, nq), got in fam["results"].items():
        q = fam["queries"][nq]
        kind, _params, rows = FAMILY[name]
        label = f"{name} nq={nq} after"
        if got[0].shape != (nq, K) or got[1].dtype != torch.int64:
            raise AssertionError(f"{label}: malformed result")
        if torch.isin(got[1], doomed).any():
            raise AssertionError(f"{label}: a deleted pk was returned")
        dead = torch.isin(torch.arange(rows, device=dev), doomed)
        exact = torch.topk(torch.where(dead[None, :], float("inf"), testing.l2_scores(q, x[:rows])),
                           K, dim=1, largest=False).indices
        recall = recall_at(got[1], exact)
        if kind == "bucket":
            swaps, _by_kind, max_err = check_against_oracle(
                torch, testing, label, got, [fam["node"]], name, q, TS_AFTER, doomed, None, rtol, atol)
            msg = f"equals the oracle (rtol={rtol}, atol={atol}; {swaps} near-tie swaps)"
        else:
            qi, slot = torch.nonzero(got[1] >= 0, as_tuple=True)
            want = ((x[got[1][qi, slot]].double() - q[qi].double()) ** 2).sum(1)
            torch.testing.assert_close(got[0][qi, slot].double(), want, rtol=rtol, atol=atol)
            max_err = (got[0][qi, slot].double() - want).abs().max().item()
            msg = (f"every score is its row's float64 distance (rtol={rtol}, atol={atol}); "
                   f"{int((got[1] < 0).sum())} empty slots after the post-filter")
        log(f"check {label}: {msg}; max |err| {max_err:.3g} against float64; "
            f"recall@{K} vs exact brute force {recall:.4f}")
    phases["family_verify_s"] = time.perf_counter() - t0


def bucket_scan_time(torch, fam, q, sq_mod, ops, testing) -> dict:
    """``sq_l2_topk`` as a bucket search launches it: one query against its
    probed buckets of the loaded index, one segmented launch, held to the
    plain version on the same inputs (``testing.assert_scan_close``: pks
    exact except at near-ties, scores within ``SCORE_TOL``) and timed
    (device time of queued calls beside the plain version and the bytes
    bound)."""
    idx = fam["node"].sealed[("vdb_bucket", 0)].index
    nprobe = BUCKET_PARAMS["nprobe_buckets"]
    probes = ops.topk_scan(q, idx.centers, nprobe)[1][0].tolist()
    off = idx.bucket_offsets.tolist()
    segs = [idx.storage[off[b]:off[b + 1]] for b in probes]
    valids = [None] * len(segs)
    rows = sum(len(c) for c in segs)
    got = sq_mod.sq_l2_topk_segmented(q, segs, idx.vmin, idx.vmax, valids, K)
    want = sq_mod.sq_l2_topk_plain_segmented(q, segs, idx.vmin, idx.vmax, valids, K)
    torch.cuda.synchronize()
    decoded = [sq_mod.sq_decode_plain(c, idx.vmin, idx.vmax) for c in segs]
    testing.assert_scan_close(got, want, q, decoded, valids, K, "l2", *testing.SCORE_TOL["l2"])
    live = torch.isfinite(want[0])
    row = {
        "launches": fam["launches"]["sq_l2_topk"],
        "max_abs_err": (got[0][live] - want[0][live]).abs().max().item(),
        "ms": device_ms(torch, lambda: sq_mod.sq_l2_topk_segmented(q, segs, idx.vmin, idx.vmax,
                                                                   valids, K), 50),
        "plain_ms": device_ms(torch, lambda: sq_mod.sq_l2_topk_plain_segmented(
            q, segs, idx.vmin, idx.vmax, valids, K), 20),
        # the codes and vmin / vmax read once, the block of k slots per
        # bucket written once
        "bound_ms": (rows * DIM + 8 * DIM + 4 * DIM + 12 * nprobe * K) / PEAK_BYTES_S * 1e3,
        "bound_by": "bytes", "library_ms": None,
        "shape": f"nq=1, {nprobe} buckets, {rows} x {DIM} uint8 codes, k={K}",
    }
    log("sq_l2_topk at a bucket query, equal to the plain version "
        f"(rtol, atol {testing.SCORE_TOL['l2']}; pks exact except at near-ties): " + json.dumps(row))
    return row


def facade_path(torch, gen, dev, phases, counts, testing) -> dict:
    """The port's ManuSystem end to end at VectorDBBench Performance768D1M
    scale: 1M seeded rows inserted through the proxy in 8,192-row batches
    into an IVF-SQ collection (2 shards, 2 loggers, 1 data node, 1 index
    node, 2 query nodes), flush, 16,384 streamed rows, 1% deletes; requests
    at nq 1 and 100 under STRONG / BOUNDED / EVENTUAL, two ordinal filters,
    output-field hydration and time travel, each answer held to the float64
    oracle over what the two query nodes hold at the request's pin.  Every
    launch counter starts at 0 with the system."""
    from repro_torch.core import (
        ConsistencyLevel, FieldSchema, FieldType, InsertRequest, ManuConfig, ManuSystem, Metric,
        SearchRequest,
    )

    name = "vdb_facade"
    rtol, atol = testing.SCORE_TOL["l2"]
    t0 = time.perf_counter()
    centers = torch.randn((N_CENTERS, DIM), generator=gen, device=dev)
    n_total = N_ROWS + FACADE_STREAM
    x = mixture(torch, gen, dev, n_total, centers)
    x_host = x.cpu().numpy()
    queries = {nq: mixture(torch, gen, dev, nq, centers) for nq in (1, 100)}
    torch.cuda.synchronize()
    phases["facade_data_s"] = time.perf_counter() - t0

    counts.reset()
    manu = ManuSystem(ManuConfig(**FACADE_CONFIG), device=dev)
    pump = {"s": 0.0, "calls": 0}
    step = manu.pump

    def timed_pump(rounds: int = 1) -> bool:  # host time of the cooperative pump
        t = time.perf_counter()
        try:
            return step(rounds)
        finally:
            pump["s"] += time.perf_counter() - t
            pump["calls"] += 1

    manu.pump = timed_pump
    builds = []
    inode = manu.index_nodes[0]
    try_build = inode._try_build

    def timed_build(task: dict) -> bool:
        torch.cuda.synchronize()
        t = time.perf_counter()
        done = try_build(task)
        torch.cuda.synchronize()
        if done:
            builds.append((task["segment_id"], task["index_kind"], time.perf_counter() - t))
            log(f"facade build segment {task['segment_id']} {task['index_kind']}: {builds[-1][2]:.3f} s")
        return done

    inode._try_build = timed_build
    coll = manu.create_collection(name, dim=DIM, metric=Metric.L2,
                                  extra_fields=[FieldSchema("ordinal", FieldType.INT)])
    coll.create_index("vector", "ivf_sq", IVF_PARAMS)

    t0 = time.perf_counter()
    for lo in range(0, N_ROWS, INSERT_BATCH):
        hi = min(lo + INSERT_BATCH, N_ROWS)
        res = coll.insert(InsertRequest({"vector": x_host[lo:hi], "ordinal": np.arange(lo, hi)}))
        if not np.array_equal(res.pks, np.arange(lo, hi)):
            raise AssertionError("auto-assigned pks are not the insert ordinals")
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    phases["facade_ingest_s"] = ingest_s
    log(f"facade ingest: {N_ROWS} rows in {ingest_s:.3f} s through the proxy "
        f"({N_ROWS / ingest_s:.1f} rows/s; {len(builds)} IVF-SQ builds inline; "
        f"pump {pump['s']:.3f} s over {pump['calls']} calls)")

    t0 = time.perf_counter()
    coll.flush()
    torch.cuda.synchronize()
    flush_s = time.perf_counter() - t0
    phases["facade_flush_s"] = flush_s
    sealed = manu.data_coord.sealed_segments(name)
    nodes = list(manu.query_nodes.values())
    held = {sid: h for node in nodes for (c, sid), h in node.sealed.items() if c == name}
    if len(sealed) != FACADE_SEGMENTS or sorted(held) != sealed or any(
        h.index is None or h.index.KIND != "ivf_sq" for h in held.values()
    ):
        raise AssertionError(f"flush left {sealed} sealed, {sorted(held)} loaded with an IVF-SQ index")
    if sum(h.segment.num_rows for h in held.values()) != N_ROWS or any(
        c == name for node in nodes for (c, _sid) in node.growing
    ):
        raise AssertionError("the sealed segments do not hold every inserted row exactly once")
    log(f"facade flush: {flush_s:.3f} s from flush() to every index loaded; {len(sealed)} sealed "
        f"segments ({sorted(h.segment.num_rows for h in held.values())} rows) on "
        + ", ".join(f"{n.node_id} {n.held_segments(name)}" for n in nodes))

    t0 = time.perf_counter()
    for lo in range(N_ROWS, n_total, INSERT_BATCH):
        hi = min(lo + INSERT_BATCH, n_total)
        stream = coll.insert(InsertRequest({"vector": x_host[lo:hi], "ordinal": np.arange(lo, hi)}))
    tt_pin = stream.watermark_ts
    doomed = torch.randperm(n_total, generator=gen, device=dev)[: int(n_total * DELETE_FRAC)]
    deleted = coll.delete(doomed.cpu().numpy())
    torch.cuda.synchronize()
    phases["facade_stream_and_delete_s"] = time.perf_counter() - t0
    entities = coll.num_entities()
    live = 0
    for node in nodes:
        for seg in [h.segment for (c, _s), h in node.sealed.items() if c == name] + [
            g for (c, _s), g in node.growing.items() if c == name
        ]:
            live += int((~torch.isin(seg.pks(), doomed)).sum())
    if entities != n_total or live != n_total - len(doomed):
        raise AssertionError(f"num_entities {entities}, live rows {live}")
    log(f"facade entities: num_entities {entities} (deleted rows count until compaction, as in "
        f"the reference); {live} live rows = {n_total} - {len(doomed)} deleted (delete LSN {deleted})")

    kinds = {
        "STRONG": dict(consistency=ConsistencyLevel.STRONG),
        "BOUNDED": dict(consistency=ConsistencyLevel.BOUNDED),
        "EVENTUAL": dict(consistency=ConsistencyLevel.EVENTUAL),
        "filter ordinal >= 10000": dict(consistency=ConsistencyLevel.STRONG, filter="ordinal >= 10000"),
        "filter ordinal >= 990000": dict(consistency=ConsistencyLevel.STRONG, filter="ordinal >= 990000"),
        "output_fields": dict(consistency=ConsistencyLevel.STRONG, output_fields=("ordinal",)),
        "time_travel": dict(time_travel_ts=tt_pin),
    }
    floors = {"filter ordinal >= 10000": 10_000, "filter ordinal >= 990000": 990_000}
    reps = {1: 10, 100: 3}
    latency, results = {}, {}
    t0 = time.perf_counter()
    for nq, q in queries.items():
        for kind, kw in kinds.items():
            times, first = [], None
            for _ in range(reps[nq] + 1):  # the first call is reported apart
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                res = coll.search(SearchRequest.single(q, k=K, **kw))
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t1) * 1e3)
                if first is None:
                    first = res
                elif not torch.equal(res.pks, first.pks):
                    raise AssertionError(f"facade {kind} nq={nq}: a repeated request changed its answer")
            latency[f"{name} {kind} nq={nq}"] = times
            results[(kind, nq)] = first
    phases["facade_requests_s"] = time.perf_counter() - t0
    launches = counts.read()
    shapes = counts.read_shapes(launches, "facade", ("tensor_cores", "byte_bound"))
    log(f"facade path launches: {launches}")
    for kname in FACADE_KERNELS:
        if launches[kname] <= 0:
            raise AssertionError(f"{kname} was not launched on the facade path")

    t0 = time.perf_counter()
    exact = {}
    for nq, q in queries.items():
        s = testing.l2_scores(q, x)
        s[:, doomed] = float("inf")
        exact[nq] = torch.topk(s, K, dim=1, largest=False).indices
        del s
    for (kind, nq), got in results.items():
        q = queries[nq]
        label = f"facade {kind} nq={nq}"
        if got.scores.shape != (nq, K) or got.scores.device != q.device:
            raise AssertionError(f"{label}: malformed result")
        travel = kind == "time_travel"
        lo = floors.get(kind)
        passes = None if lo is None else (
            lambda seg, lo=lo: torch.from_numpy(np.asarray(seg.extra("ordinal")) >= lo)
        )
        swaps, by_kind, max_err = check_against_oracle(
            torch, testing, label, (got.scores, got.pks), nodes, name, q, got.query_ts,
            None if travel else doomed, passes, rtol, atol,
        )
        note = ""
        if travel:
            back = int(torch.isin(got.pks, doomed).sum())
            note = f"; {back} deleted pks answer again"
        if kind == "STRONG":
            streamed = int((got.pks >= N_ROWS).sum())
            if nq == 100 and streamed == 0:
                raise AssertionError(f"{label}: no streamed row in the answer")
            note = f"; {streamed} streamed rows in the answer; recall@{K} vs exact brute force " \
                   f"{recall_at(got.pks, exact[nq]):.4f}"
        if lo is not None and bool(((got.pks >= 0) & (got.pks < lo)).any()):
            raise AssertionError(f"{label}: a pk outside the filter was returned")
        if kind == "output_fields":
            livep = got.pks >= 0
            if not np.array_equal(got.fields["ordinal"][livep.cpu().numpy()], got.pks[livep].cpu().numpy()):
                raise AssertionError(f"{label}: hydrated ordinals differ from the inserted ones")
            note = "; hydrated ordinals equal the inserted ones"
        log(f"check {label}: equals the oracle at its pin (rtol={rtol}, atol={atol}; max |err| "
            f"{max_err:.3g} against float64; {swaps} near-tie swaps){note}; score error by kind "
            + json.dumps({k: float(f"{v:.3g}") for k, v in by_kind.items()}))
    phases["facade_verify_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    for nq in (1, 100):
        pumped = []

        def traced(nq=nq):
            before = pump["s"]
            res = coll.search(SearchRequest.single(
                queries[nq], k=K, consistency=ConsistencyLevel.STRONG, trace=True))
            pumped.append(pump["s"] - before)
            return res

        res = profile_request(torch, traced, f"{name} STRONG nq={nq}")
        split = {}
        for span in res.trace.walk():
            if span is not res.trace.root:
                split[span.name] = split.get(span.name, 0.0) + span.duration_us / 1e3
        log(f"  host split (ms): consistency-wait pump {pumped[-1] * 1e3:.3f}; trace spans "
            f"(root {res.trace.root.duration_us / 1e3:.3f}) "
            + ", ".join(f"{k} {v:.3f}" for k, v in sorted(split.items())))
    phases["facade_profile_s"] = time.perf_counter() - t0
    return {"manu": manu, "coll": coll, "name": name, "latency": latency, "launches": launches,
            "shapes": shapes, "builds": builds, "x": x, "queries": queries, "doomed": doomed,
            "pump": pump}


def timed_requests(torch, coll, q, kw: dict, reps: int):
    """``reps`` + 1 requests (the first reported apart); their host times
    (ms) and the first answer, which every repeat must equal."""
    from repro_torch.core import SearchRequest

    times, first = [], None
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = coll.search(SearchRequest.single(q, k=K, **kw))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        if first is None:
            first = res
        elif not torch.equal(res.pks, first.pks):
            raise AssertionError("a repeated request changed its answer")
    return times, first


def maintenance_path(torch, fac, gen, dev, phases, counts, testing) -> dict:
    """Maintenance and recovery on the facade's ManuSystem (1M rows): a
    time-travel checkpoint, a retention delete of the oldest 65,536
    ordinals (~25% of each shard's first segment, as a collection TTL
    issues it) and a flush that seals the 16,384 streamed rows into two
    fragments; ``compact()`` under the reference's policy (Milvus's
    ``dataCoord.compaction.single.ratio.threshold`` 0.2 and
    ``dataCoord.segment.smallProportion`` 0.5) must plan one task per shard
    (that segment and the shard's fragment), rewrite them into one
    seal-size target each, rebuild IVF-SQ on it and swap; a STRONG read
    pinned before the swap is repeated after it bit for bit; requests at
    nq 1 and 100 before and after, each held to the float64 oracle at its
    pin; ``gc()`` reaps the retired fragments and keeps the sources the
    checkpoint references; the collection restored at the checkpoint is
    held to an exact top-k in plain torch; a query node is killed and
    recovered, then the whole system restarted, each answering as before
    the kill bit for bit.  Every launch counter starts at 0 with the
    phase."""
    from repro_torch.core import ConsistencyLevel, SearchRequest

    manu, coll, name = fac["manu"], fac["coll"], fac["name"]
    x, queries, doomed, builds = fac["x"], fac["queries"], fac["doomed"], fac["builds"]
    rtol, atol = testing.SCORE_TOL["l2"]
    n_total = x.shape[0]
    strong = dict(consistency=ConsistencyLevel.STRONG)
    reps = {1: 10, 100: 3}
    out = {"latency": {}}
    counts.reset()
    mark = {"t": time.perf_counter(), "launches": counts.read()}

    def step_done(label: str) -> None:
        """Logs the step's seconds and launches since the last step."""
        now = counts.read()
        delta = {k: now[k] - mark["launches"][k] for k in now}
        phases[f"maint_{label}_s"] = time.perf_counter() - mark["t"]
        log(f"maintenance step {label}: {phases[f'maint_{label}_s']:.3f} s; launches {delta}")
        mark.update(t=time.perf_counter(), launches=now)

    def nodes():
        return [n for n in manu.query_nodes.values() if n.alive]

    def live_handles():
        return {sid: h for node in nodes() for (c, sid), h in node.sealed.items()
                if c == name and h.retired_at_ts is None}

    def segment_shard(sid: int) -> int:
        return int(manu.meta.get(f"segment/{name}/{sid}")["shard"])

    def requests(label: str, deleted) -> None:
        """The timed requests at nq 1 and 100, each first answer held to
        the oracle at its pin, and one profiled request per nq."""
        for nq, q in queries.items():
            before = counts.read()
            times, res = timed_requests(torch, coll, q, strong, reps[nq])
            after = counts.read()
            per = {k: (after[k] - before[k]) / (reps[nq] + 1) for k in after if after[k] > before[k]}
            out["latency"][f"{name} maintenance {label} STRONG nq={nq}"] = times
            swaps, by_kind, max_err = check_against_oracle(
                torch, testing, f"{label} nq={nq}", (res.scores, res.pks), nodes(), name, q,
                res.query_ts, deleted, None, rtol, atol)
            log(f"check maintenance {label} STRONG nq={nq}: equals the oracle at its pin (max |err| "
                f"{max_err:.3g} against float64; {swaps} near-tie swaps); median "
                f"{statistics.median(times[1:]):.3f} ms over {reps[nq]}; kernel launches per "
                f"request {per}; score error by kind "
                + json.dumps({k: float(f"{v:.3g}") for k, v in by_kind.items()}))
            profile_request(torch, lambda q=q: coll.search(SearchRequest.single(q, k=K, **strong)),
                            f"{name} maintenance {label} STRONG nq={nq}")

    # ---- 1. checkpoint, retention delete, flush
    ckpt_ts = manu.tso.last_issued()
    manu.checkpoint_collection(name)
    ckpt_sids = set(manu.data_coord.sealed_segments(name))
    oldest = torch.arange(RETENTION_DELETE, device=dev)
    coll.delete(oldest.cpu().numpy())
    deleted = torch.unique(torch.cat([doomed, oldest]))
    sealed_before = set(manu.data_coord.sealed_segments(name))
    coll.flush()
    fragments = sorted(set(manu.data_coord.sealed_segments(name)) - sealed_before)
    held = live_handles()
    if len(fragments) != 2 or any(held[s].segment.num_rows >= SEG_ROWS // 2 for s in fragments):
        raise AssertionError(f"flush sealed {fragments}, not two fragments")
    first = {}
    for sid in sorted(sealed_before):
        first.setdefault(segment_shard(sid), sid)
    expected = {segment_shard(f): sorted([first[segment_shard(f)], f]) for f in fragments}
    sources = [s for srcs in expected.values() for s in srcs]
    purge = sum(int(torch.isin(held[s].segment.pks(), deleted).sum()) for s in sources)
    for shard, (seg_id, _frag) in sorted(expected.items()):
        seg = held[seg_id].segment
        frac = float(torch.isin(seg.pks(), deleted).float().mean())
        log(f"maintenance: shard {shard} segment {seg_id} ({seg.num_rows} rows) {frac:.4f} deleted; "
            f"fragment {_frag} ({held[_frag].segment.num_rows} rows)")
    del seg
    entities_before = coll.num_entities()
    step_done("checkpoint_delete_flush")

    pinned = coll.search(SearchRequest.single(queries[100], k=K, **strong))
    requests("before compaction", deleted)
    step_done("requests_before")

    # ---- 2. compact
    n_builds = len(builds)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = coll.compact()
    torch.cuda.synchronize()
    compact_s = time.perf_counter() - t0
    tasks = [e.detail for e in manu.events(kind="compaction_task")]
    planned = {t["shard"]: sorted(t["sources"]) for t in tasks}
    if report["tasks"] != 2 or planned != expected or report["rows_purged"] != purge:
        raise AssertionError(f"compact() {report}, planned {planned}; expected {expected}, "
                             f"{purge} rows purged")
    done = [e.detail for e in manu.events(kind="compaction_done")]
    targets = sorted(t for d in done for t in d["targets"])
    held = live_handles()
    if any(s in held for s in sources) or any(
        t not in held or held[t].index is None or held[t].index.KIND != "ivf_sq" for t in targets
    ):
        raise AssertionError(f"after the swap the nodes serve {sorted(held)}; targets {targets}")
    entities_after = coll.num_entities()
    live_rows = sum(h.segment.num_rows for h in held.values())
    if entities_after != live_rows or entities_after != entities_before - purge:
        raise AssertionError(f"num_entities {entities_before} -> {entities_after}, live segment "
                             f"rows {live_rows}, {purge} purged")
    rebuilds = builds[n_builds:]
    log(f"maintenance compact: {compact_s:.3f} s from compact() to every target's index loaded; "
        f"{report}; tasks {planned} -> targets {targets} "
        f"({[held[t].segment.num_rows for t in targets]} rows); rebuilds "
        + ", ".join(f"segment {sid} {kind} {sec:.3f} s" for sid, kind, sec in rebuilds)
        + f"; num_entities {entities_before} -> {entities_after} (the rows of the live segments; "
        f"{n_total - len(deleted)} rows are not deleted)")
    step_done("compact")

    # ---- 3. the pinned read through the swap
    replay = coll.search(SearchRequest.single(queries[100], k=K, time_travel_ts=pinned.query_ts))
    if not (torch.equal(replay.pks, pinned.pks) and torch.equal(replay.scores, pinned.scores)):
        raise AssertionError("the read pinned before the swap changed after it")
    log(f"check maintenance pinned read: the STRONG nq=100 answer pinned at {pinned.query_ts} "
        "is bit-identical after the swap (retired sources serve it)")
    step_done("pinned_read")

    # ---- 4. requests after the swap
    requests("after compaction", deleted)
    step_done("requests_after")

    # ---- 5. gc
    torch.cuda.synchronize()
    mem = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    reaped = coll.gc()
    gc_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.synchronize()
    freed = mem - torch.cuda.memory_allocated()
    for sid in sources:
        objs = [m.key for p in (f"binlog/{name}/{sid}/", f"index/{name}/{sid}/")
                for m in manu.store.list(p)]
        if (sid in ckpt_sids) != bool(objs):
            raise AssertionError(f"segment {sid}: objects {objs[:3]} after gc, checkpoint "
                                 f"references it: {sid in ckpt_sids}")
    if any(h.retired_at_ts is not None or (c == name and sid in sources)
           for node in nodes() for (c, sid), h in node.sealed.items()):
        raise AssertionError("a query node still holds a retired handle after gc")
    log(f"maintenance gc: {gc_s:.3f} s; reaped segments {[s for _c, s in reaped['segments']]}, "
        f"{reaped['objects']} objects, {reaped['bytes']} bytes; {reaped['protected']} protected by "
        f"the checkpoint; the query nodes dropped every retired handle ({freed} bytes of device "
        "memory freed)")
    step_done("gc")

    # ---- 6. restore at the checkpoint
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored = manu.restore_collection(name, ckpt_ts)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    q = queries[100]
    search_times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = restored.search(q, K)
        torch.cuda.synchronize()
        search_times.append((time.perf_counter() - t1) * 1e3)
    scores = testing.l2_scores(q.double(), x.double())  # exact: float64
    scores[:, doomed] = float("inf")  # deleted before the checkpoint
    want = torch.topk(scores, K, dim=1, largest=False)
    del scores
    testing.assert_topk_near_tie(got, (want.values.float(), want.indices), rtol, atol)
    n_restored = restored.num_rows()
    if n_restored != n_total - len(doomed):
        raise AssertionError(f"restored {n_restored} rows, {n_total - len(doomed)} live at the checkpoint")
    log(f"maintenance restore: {restore_s:.3f} s for {n_restored} rows at the checkpoint "
        f"({len(restored.segments)} segments); RestoredCollection.search nq=100 k={K}: median "
        f"{statistics.median(search_times[1:]):.3f} ms (first {search_times[0]:.3f}); equals the "
        f"exact float64 top-k (rtol={rtol}, atol={atol}; max |err| "
        f"{(got[0].double() - want.values).abs().max().item():.3g})")
    del restored, got, want
    gc.collect()
    step_done("restore")

    # ---- 7. kill / recover, then restart
    q = queries[100]
    base = coll.search(SearchRequest.single(q, k=K, **strong))
    torch.cuda.synchronize()
    mem_before, victim = torch.cuda.memory_allocated(), sorted(manu.query_nodes)[-1]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    manu.kill_query_node(victim)
    dead = manu.recover_failures()
    torch.cuda.synchronize()
    recover_s = time.perf_counter() - t0
    res = coll.search(SearchRequest.single(q, k=K, **strong))
    if dead != [victim] or not (torch.equal(res.pks, base.pks) and torch.equal(res.scores, base.scores)):
        raise AssertionError(f"recover_failures {dead}: the answer differs from the pre-kill one")
    log(f"maintenance recover_failures: {recover_s:.3f} s to re-place {victim}'s segments and "
        f"channels; the STRONG nq=100 answer equals the pre-kill one bit for bit; device memory "
        f"{mem_before} -> {torch.cuda.memory_allocated()} bytes allocated (peak "
        f"{torch.cuda.max_memory_allocated()})")
    step_done("kill_recover")

    # The old processes must go with the restart: nothing but the system
    # may hold them (handles kept here would pin their device memory).
    del held, res
    old = [weakref.ref(n) for n in [*manu.query_nodes.values(), *manu.index_nodes]]
    torch.cuda.synchronize()
    mem_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    restart = manu.restart()
    torch.cuda.synchronize()
    restart_s = time.perf_counter() - t0
    coll = manu.collections[name]
    res = coll.search(SearchRequest.single(q, k=K, **strong))
    gc.collect()
    torch.cuda.synchronize()
    mem_after, peak = torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated()
    if not (torch.equal(res.pks, base.pks) and torch.equal(res.scores, base.scores)):
        raise AssertionError("after restart() the answer differs from the pre-kill one")
    if any(ref() is not None for ref in old):
        raise AssertionError("an old query or index node outlived restart() (its device memory with it)")
    log(f"maintenance restart: {restart_s:.3f} s to rebuild every process from the stores and the "
        f"log ({ {k: v for k, v in restart.items() if isinstance(v, int)} }); the STRONG nq=100 "
        f"answer equals the pre-kill one bit for bit; every old query and index node was freed; "
        f"device memory {mem_before} -> {mem_after} bytes allocated, max_memory_allocated {peak} "
        "during the restart (the checkpoint-protected retired sources are reloaded and re-retired)")
    step_done("restart")

    launches = counts.read()
    out["launches"] = launches
    out["shapes"] = counts.read_shapes(launches, "maintenance", ())
    log(f"maintenance path launches: {launches}")
    for kname in MAINTENANCE_KERNELS:
        if launches[kname] <= 0:
            raise AssertionError(f"{kname} was not launched on the maintenance path")
    return out


def synth_docs(rng, n: int, seq_len: int, vocab: int, n_topics: int = EMBED_TOPICS):
    """``examples/serve_embedder.py``'s topic-biased documents: each draws
    its tokens uniformly from its topic's slice of the vocabulary, so
    documents of one topic share a token distribution."""
    topics = rng.integers(0, n_topics, n)
    lo, hi = (topics * vocab) // n_topics, ((topics + 1) * vocab) // n_topics
    return rng.integers(lo[:, None], hi[:, None], (n, seq_len)), topics


def embed_flops(cfg, seq_len: int) -> float:
    """Operations of one sequence's forward to the final norm: the
    projections and the MLP (2 per weight per token) and the causal
    attention products (QK and PV over the (S + 1) / 2 keys a token sees
    on average)."""
    per_token = 2 * cfg.num_layers * (2 * cfg.d_model * (cfg.q_dim + cfg.kv_dim) + 3 * cfg.d_model * cfg.d_ff)
    attention = cfg.num_layers * 2 * 2 * cfg.q_dim * (seq_len + 1) / 2
    return seq_len * (per_token + attention)


def embedder_path(torch, gen, dev, phases, counts, testing, seed: int) -> dict:
    """The embedding serving path of ``examples/serve_embedder.py`` at
    yi-9b's published widths: the port's dense decoder as an ``Embedder``
    feeding a threaded ``ManuSystem`` through ``ManuCollection.insert /
    flush / search``.  Checks every embedding finite and unit-norm, batch
    invariance, that no BOUNDED answer names a pk never inserted, that the
    threaded system's STRONG answers after ``wait_idle()`` equal a
    cooperative system's fed the same embeddings in the same order, and
    that ``stop_threads()`` leaves no thread.  Every launch counter starts
    at 0 with the threaded system and is read when it stops."""
    from repro_torch.configs import get_arch
    from repro_torch.core import ConsistencyLevel, InsertRequest, ManuConfig, ManuSystem, Metric, SearchRequest
    from repro_torch.core.log import shards_of_pks
    from repro_torch.models import model as M
    from repro_torch.models.embedder import Embedder

    cfg = get_arch(EMBED_ARCH)
    name = "docs"
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = M.init_params(cfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    phases["embed_model_init_s"] = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    # ModelConfig.num_params counts every weight but the final norm's
    if n_params != cfg.num_params() + cfg.d_model or len(model.layers) != cfg.num_layers:
        raise AssertionError(f"{cfg.name}: {n_params} parameters in {len(model.layers)} layers")
    log(f"embedder model {cfg.name}: {n_params / 1e9:.3f} B bf16 parameters, {cfg.num_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.num_heads} / {cfg.num_kv_heads} heads, d_ff {cfg.d_ff}, vocabulary "
        f"{cfg.vocab_size}; init {phases['embed_model_init_s']:.3f} s on the card, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    emb = Embedder(cfg, model, max_batch=EMBED_BATCH)
    rng = np.random.default_rng(seed)
    docs, topics = synth_docs(rng, EMBED_DOCS, EMBED_DOC_TOKENS, cfg.vocab_size)

    counts.reset()
    manu = ManuSystem(ManuConfig(**EMBED_CONFIG, threaded=True, manual_clock=False), device=dev)
    # Host seconds of the pump thread's seal, build and load steps, for
    # where the time from flush() to every index loaded goes.
    spent = collections.defaultdict(float)

    def timed(obj, attr, label):
        call = getattr(obj, attr)

        def run(*args, **kwargs):
            t = time.perf_counter()
            try:
                return call(*args, **kwargs)
            finally:
                spent[label] += time.perf_counter() - t

        setattr(obj, attr, run)

    for dn in manu.data_nodes:
        timed(dn, "_flush_sealed", "data node seal + binlog")
    for ix in manu.index_nodes:
        timed(ix, "_try_build", "index builds")
    for qn in manu.query_nodes.values():
        timed(qn, "load_sealed", "segment loads")
        timed(qn, "load_index", "index loads")
    try:
        coll = manu.create_collection(name, dim=cfg.d_model, metric=Metric.IP)
        coll.create_index("vector", "ivf_flat", IVF_PARAMS)
        chunks, all_topics = [], [topics]
        embed_s = insert_s = 0.0
        for lo in range(0, EMBED_DOCS, EMBED_INGEST_CHUNK):
            hi = min(lo + EMBED_INGEST_CHUNK, EMBED_DOCS)
            torch.cuda.synchronize()
            t = time.perf_counter()
            rows = emb.embed(docs[lo:hi])
            torch.cuda.synchronize()
            embed_s += time.perf_counter() - t
            t = time.perf_counter()
            res = coll.insert(InsertRequest({"vector": rows}))
            insert_s += time.perf_counter() - t
            if not np.array_equal(res.pks, np.arange(lo, hi)):
                raise AssertionError("auto-assigned pks are not the insertion order")
            chunks.append(rows)
        flops = EMBED_DOCS * embed_flops(cfg, EMBED_DOC_TOKENS)
        tokens = EMBED_DOCS * EMBED_DOC_TOKENS
        phases["embed_corpus_s"], phases["embed_ingest_s"] = embed_s, insert_s
        log(f"embedder corpus: {EMBED_DOCS} documents x {EMBED_DOC_TOKENS} tokens in {embed_s:.3f} s "
            f"({tokens / embed_s:.1f} tokens/s, {flops / embed_s / 1e12:.1f} TFLOP/s = "
            f"{flops / embed_s / PEAK_BF16_FLOPS:.3f} of the {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s dense "
            f"bf16 peak; {flops / tokens / 1e9:.2f} GFLOP per token); ingest {EMBED_DOCS / insert_s:.1f} "
            f"rows/s through the proxy ({insert_s:.3f} s, the pump thread stepping beside it)")

        t = time.perf_counter()
        coll.flush()
        nodes = list(manu.query_nodes.values())
        deadline = time.time() + 120.0
        while True:
            manu.wait_idle(timeout_s=max(1.0, deadline - time.time()))  # raises a thread's failure
            held = {sid: h for node in nodes for (c, sid), h in node.sealed.items() if c == name}
            sealed = manu.data_coord.sealed_segments(name)
            if (sorted(held) == sealed and all(h.index is not None and h.index.KIND == "ivf_flat"
                                               for h in held.values())
                    and sum(h.segment.num_rows for h in held.values()) == EMBED_DOCS):
                break
            if time.time() > deadline:
                raise AssertionError(manu._diagnostic_dump(
                    f"flush left {sealed} sealed, {sorted(held)} loaded with an index"))
            time.sleep(0.01)
        torch.cuda.synchronize()
        phases["embed_flush_s"] = time.perf_counter() - t
        log(f"embedder flush: {phases['embed_flush_s']:.3f} s from flush() to every index loaded; "
            f"{len(sealed)} sealed segments ({sorted(h.segment.num_rows for h in held.values())} rows) on "
            + ", ".join(f"{n.node_id} {n.held_segments(name)}" for n in nodes)
            + "; pump-thread host seconds since the start: "
            + json.dumps({k: round(v, 3) for k, v in spent.items()}))

        corpus = torch.cat(chunks)
        norms = torch.linalg.vector_norm(corpus, dim=1)
        if not torch.isfinite(corpus).all() or (norms - 1).abs().max().item() > EMBED_NORM_TOL:
            raise AssertionError(f"corpus embeddings: finite {bool(torch.isfinite(corpus).all())}, "
                                 f"largest | |e| - 1 | {(norms - 1).abs().max().item():.3g}")
        alone = Embedder(cfg, model, max_batch=1).embed(docs[:EMBED_BATCH])
        batch_err = torch.linalg.vector_norm(alone - corpus[:EMBED_BATCH], dim=1).max().item()
        if batch_err > EMBED_BATCH_TOL:
            raise AssertionError(f"a document's embedding alone differs from its batch's by {batch_err:.3g}")
        log(f"check embeddings: {len(corpus)} finite, unit norm within {EMBED_NORM_TOL} (largest "
            f"{(norms - 1).abs().max().item():.3g}); the first {EMBED_BATCH} embedded one at a time within "
            f"{EMBED_BATCH_TOL} (L2) of their batch's: largest {batch_err:.3g}")

        # The stream: the fewest fresh documents that bring every shard's
        # growing segment to seal_rows, inserted as serving starts.
        inserted = EMBED_DOCS
        seal_rows, n_shards = manu.config.seal_rows, coll.info.num_shards
        per_shard = np.cumsum(np.eye(n_shards, dtype=np.int64)[
            shards_of_pks(np.arange(inserted, inserted + 4 * seal_rows * n_shards), n_shards)], axis=0)
        n_stream = int(np.argmax((per_shard >= seal_rows).all(axis=1))) + 1
        stream, stream_topics = synth_docs(rng, n_stream, EMBED_QUERY_TOKENS, cfg.vocab_size)
        torch.cuda.synchronize()
        t = time.perf_counter()
        stream_rows = Embedder(cfg, model, max_batch=EMBED_STREAM_BATCH).embed(stream)
        torch.cuda.synchronize()
        phases["embed_stream_s"] = time.perf_counter() - t
        sealed_before = len(manu.data_coord.sealed_segments(name))
        spent_builds_before = spent["index builds"]
        for lo in range(0, n_stream, EMBED_INGEST_CHUNK):
            rows = stream_rows[lo:lo + EMBED_INGEST_CHUNK]
            res = coll.insert(InsertRequest({"vector": rows}))
            if not np.array_equal(res.pks, np.arange(inserted, inserted + len(rows))):
                raise AssertionError("auto-assigned pks are not the insertion order")
            chunks.append(rows)
            inserted += len(rows)
        all_topics.append(stream_topics)
        log(f"embedder stream: {n_stream} fresh documents x {EMBED_QUERY_TOKENS} tokens embedded in "
            f"{phases['embed_stream_s']:.3f} s ({n_stream * EMBED_QUERY_TOKENS / phases['embed_stream_s']:.1f} "
            f"tokens/s) and inserted, {seal_rows} rows or more for each of the {n_shards} shards")

        latency = {f"embedder nq={nq} {part}": [] for nq in (EMBED_NQ, EMBED_BIG_NQ)
                   for part in ("embed", "search", "batch")}
        during_build = []  # search ms of the batches served while an index built
        hits = served = 0
        last_q = {}
        t0 = time.perf_counter()
        for nq, n_batches in ((EMBED_NQ, EMBED_REQUESTS), (EMBED_BIG_NQ, EMBED_BIG_REQUESTS)):
            for _ in range(n_batches):
                fresh, fresh_topics = synth_docs(rng, EMBED_FRESH, EMBED_DOC_TOKENS, cfg.vocab_size)
                rows = emb.embed(fresh)
                res = coll.insert(InsertRequest({"vector": rows}))
                if not np.array_equal(res.pks, np.arange(inserted, inserted + EMBED_FRESH)):
                    raise AssertionError("auto-assigned pks are not the insertion order")
                chunks.append(rows)
                all_topics.append(fresh_topics)
                inserted += EMBED_FRESH
                q_toks, q_topics = synth_docs(rng, nq, EMBED_QUERY_TOKENS, cfg.vocab_size)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                q = emb.embed(q_toks)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                building = bool(manu.index_coord.pending_tasks)
                res = coll.search(SearchRequest.single(q, k=EMBED_K, staleness_ms=EMBED_STALENESS_MS))
                torch.cuda.synchronize()
                t3 = time.perf_counter()
                if building and manu.index_coord.pending_tasks:
                    during_build.append((t3 - t2) * 1e3)
                for part, ms in (("embed", t2 - t1), ("search", t3 - t2), ("batch", t3 - t1)):
                    latency[f"embedder nq={nq} {part}"].append(ms * 1e3)
                live = res.pks[res.pks >= 0]
                if res.pks.shape != (nq, EMBED_K) or bool((live >= inserted).any()):
                    raise AssertionError("a BOUNDED answer names a pk that was never inserted")
                top = res.pks[:, 0].cpu().numpy()
                known = np.concatenate(all_topics)
                hits += int(sum(t >= 0 and known[t] == qt for t, qt in zip(top, q_topics)))
                served += nq
                last_q[nq] = q
        phases["embed_requests_s"] = time.perf_counter() - t0
        log(f"embedder requests: {EMBED_REQUESTS} batches of {EMBED_NQ} and {EMBED_BIG_REQUESTS} of "
            f"{EMBED_BIG_NQ} queries at staleness {EMBED_STALENESS_MS} ms, each after {EMBED_FRESH} fresh "
            f"documents; every answer names inserted pks only; topic-match@1 {hits / served:.4f} "
            f"(printed, not gated)")
        if not during_build:
            raise AssertionError("no request batch was served while an index built")

        t = time.perf_counter()
        manu.wait_idle()
        n_seals = len(manu.data_coord.sealed_segments(name)) - sealed_before
        if n_seals < n_shards:
            raise AssertionError(f"the stream sealed {n_seals} segments, not one per shard")
        log(f"embedder requests during index builds: {len(during_build)} batches answered while the build "
            f"thread built (search median {statistics.median(during_build):.3f} ms, max "
            f"{max(during_build):.3f} ms); the stream sealed {n_seals} segments, whose builds took "
            f"{spent['index builds'] - spent_builds_before:.3f} s of build-thread host time")
        strong = {nq: coll.search(SearchRequest.single(q, k=EMBED_K, consistency=ConsistencyLevel.STRONG))
                  for nq, q in last_q.items()}
        torch.cuda.synchronize()
        phases["embed_strong_s"] = time.perf_counter() - t
        for nq in (EMBED_NQ,):
            def one_batch(nq=nq):
                q_toks, _ = synth_docs(np.random.default_rng(seed + 1), nq, EMBED_QUERY_TOKENS, cfg.vocab_size)
                return coll.search(SearchRequest.single(emb.embed(q_toks), k=EMBED_K,
                                                        staleness_ms=EMBED_STALENESS_MS))
            profile_request(torch, one_batch, f"embedder request batch nq={nq} (embed + search)")
        profile_request(torch, lambda: emb.embed(docs[:EMBED_BATCH]),
                        f"embedder corpus micro-batch ({EMBED_BATCH} x {EMBED_DOC_TOKENS} tokens)")
        launches = counts.read()
        shapes = counts.read_shapes(launches, "embedder", ("tensor_cores",))
        log(f"embedder path launches: {launches}")
        for kname in EMBED_KERNELS:
            if launches[kname] <= 0:
                raise AssertionError(f"{kname} was not launched on the embedder path")
    finally:
        manu.stop_threads()
    left = [t.name for t in threading.enumerate() if t.name.startswith("manu-") and t.is_alive()]
    if left or manu._threads:
        raise AssertionError(f"threads left after stop_threads(): {left}")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"embedder: stop_threads() left no thread; peak device memory {peak_gib:.2f} GiB")

    # The same embeddings in the same order through a cooperative system.
    t = time.perf_counter()
    coop = ManuSystem(ManuConfig(**EMBED_CONFIG), device=dev)
    ccoll = coop.create_collection(name, dim=cfg.d_model, metric=Metric.IP)
    ccoll.create_index("vector", "ivf_flat", IVF_PARAMS)
    n_corpus = EMBED_DOCS // EMBED_INGEST_CHUNK
    for i, rows in enumerate(chunks):
        ccoll.insert(InsertRequest({"vector": rows}))
        if i == n_corpus - 1:
            ccoll.flush()
    x = torch.cat(chunks)
    rtol, atol = testing.SCORE_TOL["ip"]
    for nq, got in strong.items():
        want = ccoll.search(SearchRequest.single(last_q[nq], k=EMBED_K, consistency=ConsistencyLevel.STRONG))
        label = f"embedder STRONG nq={nq}"
        if got.pks.shape != want.pks.shape or not torch.equal(got.pks >= 0, want.pks >= 0):
            raise AssertionError(f"{label}: the threaded answer's shape or empty slots differ")
        live = want.pks >= 0
        torch.testing.assert_close(got.scores[live], want.scores[live], rtol=rtol, atol=atol)
        diff = (got.pks != want.pks) & live
        if diff.any():  # near-ties only: the swapped pk scores (float64) as the slot
            qi, slot = torch.nonzero(diff, as_tuple=True)
            exact = (last_q[nq][qi].double() * x[got.pks[qi, slot]].double()).sum(1)
            torch.testing.assert_close(exact, want.scores[qi, slot].double(), rtol=rtol, atol=atol)
        exact_top = torch.topk(last_q[nq] @ x.T, EMBED_K, dim=1).indices
        log(f"check {label}: the threaded system's answer after wait_idle() equals the cooperative "
            f"system's (rtol={rtol}, atol={atol}; {int(diff.sum())} near-tie swaps; max |err| "
            f"{(got.scores[live] - want.scores[live]).abs().max().item():.3g}); recall@{EMBED_K} vs "
            f"exact IP {recall_at(got.pks, exact_top):.4f}")
    del coop, ccoll
    phases["embed_cooperative_s"] = time.perf_counter() - t
    for key in ("embed", "search", "batch"):
        for nq in (EMBED_NQ, EMBED_BIG_NQ):
            v = latency[f"embedder nq={nq} {key}"]
            log(f"embedder nq={nq} {key} median {statistics.median(v):.3f} ms over {len(v)} "
                f"(min {min(v):.3f}, max {max(v):.3f})")
    return {"latency": {k: v for k, v in latency.items() if k.endswith("batch")}, "launches": launches,
            "shapes": shapes, "model": model, "peak_gib": peak_gib}


def serve_depth(cfg, full: bool = False) -> int:
    """Layers the serve phase keeps: every one with ``full``, else one
    effective period (two layers where the period is one layer)."""
    from repro_torch.models import model as M

    if full:
        return cfg.num_layers
    period = len(M.effective_pattern(cfg))
    return period if period > 1 else 2


def token_flops(cfg, context: float) -> float:
    """Operations of one token through every layer, counted from the
    shapes (2 per weight it meets; MoE: the router and its top-k and shared
    experts only), attending to ``context`` positions: QK and PV over the
    heads (MLA: decompressed nope + rope keys, v_head_dim values); SSD:
    C.B and the weighted inputs over the chunk's positions up to
    ``context``, and the state read and update.  The LM head apart."""
    from repro_torch.models import model as M

    d = cfg.d_model
    total = 0.0
    for kind, is_moe in M.layer_kinds(cfg):
        if kind == "attn" and cfg.attn_type == "mla":
            qr, h, r = cfg.q_lora_rank or d, cfg.num_heads, cfg.kv_lora_rank
            qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
            total += 2 * (d * qr + qr * h * qk + d * (r + cfg.qk_rope_head_dim)
                          + r * h * (cfg.qk_nope_head_dim + cfg.v_head_dim) + h * cfg.v_head_dim * d)
            total += 2 * h * (qk + cfg.v_head_dim) * context
        elif kind == "attn":
            total += 2 * (d * (cfg.q_dim + 2 * cfg.kv_dim) + cfg.q_dim * d) + 2 * 2 * cfg.q_dim * context
        else:
            di, n, h, hd = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
            total += 2 * (d * (2 * di + 2 * n + h) + di * d) + 2 * cfg.ssm_conv * (di + 2 * n)
            total += 2 * min(cfg.ssm_chunk, context) * (n + h * hd) + 4 * h * hd * n
        if is_moe:
            total += 2 * d * cfg.moe_num_experts + 6 * d * cfg.moe_d_ff * (cfg.moe_top_k + cfg.moe_num_shared)
        elif cfg.d_ff > 0:
            total += 6 * d * cfg.d_ff
    return total


def serve_model(torch, name: str, dev, seed: int, full: bool = False):
    """``name`` at its published widths, cut to ``serve_depth`` layers,
    drawn on the card from ``seed``."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import model as M

    base = get_arch(name)
    cfg = dataclasses.replace(base, num_layers=serve_depth(base, full))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model = M.init_params(cfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    kinds = collections.Counter(("moe " if moe else "") + kind for kind, moe in M.layer_kinds(cfg))
    n_params = sum(p.numel() for p in model.parameters())
    log(f"serve model {name}: {cfg.num_layers} of {base.num_layers} layers ({dict(kinds)}; depth cut, "
        f"widths as published: d_model {cfg.d_model}, heads {cfg.num_heads} / {cfg.num_kv_heads}, d_ff "
        f"{cfg.d_ff}, experts {cfg.moe_num_experts} x {cfg.moe_d_ff} top {cfg.moe_top_k}, SSM state "
        f"{cfg.ssm_state} / d_inner {cfg.ssm_d_inner if cfg.ssm_state else 0}, vocabulary {cfg.vocab_size}); "
        f"{n_params / 1e9:.3f} B parameters, {torch.cuda.memory_allocated() / 2**30:.2f} GiB, init {init_s:.3f} s")
    return cfg, model


def serve_check(torch, testing, M, cfg, model, tally, gen, dev, gated: bool = True,
                prompt: int = SERVE_PROMPT, steps: int = SERVE_STEPS) -> dict:
    """Teacher-forced: prefill ``prompt`` tokens, then ``steps`` decode
    steps fed fixed tokens; the prefill's last logits and each step's
    against one prefill over the whole sequence.  MoE, read from the
    router: a position is left out from a row's first token whose slot the
    full prefill dropped, or whose experts differ between the two passes (a
    near-tie in the router that their bf16 roundings break apart); the
    positions before it are computed as with no drop (slots take buffer
    rows in token order, attention and SSM are causal).  ``gated``: the
    positions kept within ``DECODE_ATOL`` (``testing.assert_logits_close``).
    Otherwise (a whole deep model) the difference is measured beside a
    control, the first two rows prefilled alone against the same rows in
    the batch of four, and only finite logits and greedy tokens equal
    outside near-ties are checked."""
    b, s = SERVE_BATCH, prompt
    tokens = torch.randint(0, cfg.vocab_size, (b, s + steps), generator=gen, device=dev)
    prefix = None
    if cfg.frontend == "vlm_stub":
        prefix = torch.randn((b, cfg.num_prefix_embeddings, cfg.d_model), generator=gen, device=dev)
    p = 0 if prefix is None else prefix.shape[1]
    n_moe = sum(moe for _kind, moe in M.layer_kinds(cfg))
    label = f"serve {cfg.name} x{cfg.num_layers} decode vs prefill ({s} + {steps})"
    with torch.no_grad():
        tally["drops"].clear()
        tally["routes"].clear()
        cache = M.init_cache(cfg, b, p + s + steps, device=dev)
        first, cache = M.prefill(cfg, model, tokens[:, :s], cache, prefix, last_only=True)
        got = [first]
        for i in range(steps):
            logits, cache = M.decode_step(cfg, model, cache, tokens[:, s + i:s + i + 1])
            got.append(logits)
        incremental = sum(int(d.sum()) for d in tally["drops"])
        # per MoE layer, the experts of every position: the prompt's call, then one per step
        inc_routes = [torch.cat(tally["routes"][j::n_moe], 1) for j in range(n_moe)]
        tally["drops"].clear()
        tally["routes"].clear()
        full, _ = M.prefill(cfg, model, tokens, M.init_cache(cfg, b, p + s + steps, device=dev), prefix)
        dropped = torch.zeros((b, p + s + steps), dtype=torch.bool, device=dev)
        rerouted = torch.zeros_like(dropped)
        for j in range(n_moe):
            dropped |= tally["drops"][j]
            rerouted |= (tally["routes"][j] != inc_routes[j]).any(-1)
        first_bad = torch.where((dropped | rerouted).any(1), (dropped | rerouted).int().argmax(1),
                                p + s + steps).cpu()
        got = torch.cat(got, 1).cpu()
        want = full[:, p + s - 1:].cpu()
        keep = (p + s - 1 + torch.arange(steps + 1))[None, :] < first_bad[:, None]  # [B, steps + 1]
        if not keep[:, 1:].any():
            raise AssertionError(f"{label}: every decode position follows a dropped or rerouted token "
                                 f"(first per row {first_bad.tolist()})")
        control = None
        if gated:
            ties = testing.assert_logits_close(label, got[keep], want[keep], testing.DECODE_ATOL)
        else:
            pair, _ = M.prefill(cfg, model, tokens[:2], M.init_cache(cfg, 2, p + s + steps, device=dev),
                                None if prefix is None else prefix[:2])
            control = (pair - full[:2]).abs().max().item()
            if not torch.isfinite(got).all():
                raise AssertionError(f"{label}: non-finite logits")
            bad, ties = testing.greedy_mismatches(got[keep], want[keep], testing.DECODE_ATOL)
            if bad:
                raise AssertionError(f"{label}: {bad} greedy tokens differ outside the near-ties")
        err = (got - want).abs().amax(-1)  # [B, steps + 1]
    out = {"layers": cfg.num_layers, "gated": gated, "prompt": s, "steps": steps,
           "max_abs_err": err[keep].max().item(), "near_ties": ties, "positions_kept": int(keep.sum()),
           "decode_positions_kept": int(keep[:, 1:].sum()), "max_abs_err_per_step": err.amax(0).tolist(),
           "control_prefill_b2_vs_b4": control, "first_left_out_per_row": (first_bad - p).tolist(),
           "full_prefill_drops": int(dropped.sum()), "rerouted_tokens": int(rerouted.sum()),
           "incremental_drops": incremental, "max_abs_logit": want.abs().max().item()}
    log(f"{'check' if gated else 'measure'} {label}: prefill of {p + s} positions ({p} patches) + {steps} decode "
        f"steps against one prefill of {p + s + steps}: max |err| {out['max_abs_err']:.4g} over "
        f"{out['positions_kept']} of {keep.numel()} positions ({out['decode_positions_kept']} decoded; "
        f"{'bound' if gated else 'not gated at this depth; the reference bound'} {testing.DECODE_ATOL}; all "
        f"positions per step {[round(e, 3) for e in out['max_abs_err_per_step']]}; max |logit| "
        f"{out['max_abs_logit']:.3g}"
        + ("" if gated else f"; control: rows 0-1 prefilled alone vs in the batch of 4 differ by {control:.4g}")
        + f"), greedy tokens equal outside {ties} near-ties; MoE at capacity factor {cfg.moe_capacity_factor}: "
        f"tokens with a slot dropped by the full prefill {out['full_prefill_drops']}, by prefill + decode "
        f"{incremental}, tokens routed otherwise {out['rerouted_tokens']}; first token left out per row "
        f"{out['first_left_out_per_row']} (of {s + steps})")
    return out


def serve_load(torch, M, cfg, model, tally, gen, dev) -> dict:
    """Serving-sized: B=SERVE_LOAD_BATCH, a SERVE_LOAD_PROMPT-token prefill
    (last position's logits only), then SERVE_LOAD_STEPS greedy decode
    steps, each timed by the host clock around a synchronized call; one
    more step profiled; MoE drops of the prefill counted in a second,
    untimed prefill."""
    b, s, steps = SERVE_LOAD_BATCH, SERVE_LOAD_PROMPT, SERVE_LOAD_STEPS
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev)
    with torch.no_grad():
        M.prefill(cfg, model, tokens[:, :16], M.init_cache(cfg, b, 16, device=dev), last_only=True)  # warm-up
        cache = M.init_cache(cfg, b, s + steps + 2, device=dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = M.prefill(cfg, model, tokens, cache, last_only=True)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t
        tok = logits[:, -1:].argmax(-1)
        times = []
        for _ in range(steps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, cache = M.decode_step(cfg, model, cache, tok)
            tok = logits.argmax(-1)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        if not torch.isfinite(logits).all():
            raise AssertionError(f"{cfg.name}: non-finite decode logits")
        stats = {}
        profile_request(torch, lambda: M.decode_step(cfg, model, cache, tok), f"serve {cfg.name} decode step "
                        f"(B={b}, position {s + steps})", stats)
        tally["on"] = True
        tally["drops"].clear()
        tally["slots_dropped"] = 0
        M.prefill(cfg, model, tokens, M.init_cache(cfg, b, s, device=dev), last_only=True)
        tally["on"] = False
        drops = tally["slots_dropped"]
        tally["routes"].clear()
    flops = b * s * token_flops(cfg, (s + 1) / 2) + b * 2 * cfg.d_model * cfg.vocab_size
    med = statistics.median(times)
    slots = b * s * cfg.moe_top_k * sum(moe for _k, moe in M.layer_kinds(cfg))
    out = {"prefill_s": prefill_s, "prefill_tokens_per_s": b * s / prefill_s,
           "prefill_tflops": flops / prefill_s / 1e12, "prefill_peak_share": flops / prefill_s / PEAK_BF16_FLOPS,
           "decode_median_ms": med * 1e3, "decode_min_ms": min(times) * 1e3, "decode_max_ms": max(times) * 1e3,
           "decode_tokens_per_s": b / med, "decode_step_launches": stats.get("launches"),
           "decode_step_idle_share": stats.get("idle_share"), "moe_drops": drops, "moe_slots": slots}
    log(f"serve load {cfg.name}: B={b}, prefill of {s} tokens {prefill_s:.4f} s ({out['prefill_tokens_per_s']:.1f} "
        f"tokens/s, {out['prefill_tflops']:.2f} TFLOP/s = {out['prefill_peak_share']:.4f} of the "
        f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s dense bf16 peak; {flops / (b * s) / 1e9:.3f} GFLOP per token); "
        f"{steps} greedy decode steps: median {out['decode_median_ms']:.3f} ms/step (min "
        f"{out['decode_min_ms']:.3f}, max {out['decode_max_ms']:.3f}), {out['decode_tokens_per_s']:.1f} tokens/s; "
        f"launches per decode step {out['decode_step_launches']}, idle share {out['decode_step_idle_share']}; "
        f"MoE slots dropped by the prefill at capacity factor {cfg.moe_capacity_factor}: {drops} of {slots}")
    return out


def serve_path(torch, dev, phases, counts, testing, seed: int) -> None:
    """The model-serving path (``repro_torch.launch.serve``): each of the
    ten configurations at its published widths through ``prefill`` /
    ``decode_step`` on the card, teacher-forced against one prefill at one
    effective period (``serve_check``), SERVE_FULL_DEPTH also whole
    (measured beside the card's noise); jamba (one period) and minicpm3-4b
    (whole) at serving size (``serve_load``); the ten reduced
    configurations on the card against the CPU
    (``testing.compare_decode``); ``serve.main(--local)`` for each.  MoE
    drops and routes are read from ``moe.route`` by wrapping
    ``models.model.moe_block``."""
    import copy

    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_mod

    counts.reset()
    t0 = time.perf_counter()
    tally = {"on": True, "drops": [], "routes": [], "slots_dropped": 0}
    moe_block = M.moe_block

    def counted_moe_block(cfg, p, x, probe=None):
        if tally["on"]:
            _gate, experts, _pos, kept = moe_mod.route(cfg, p, x)
            b, s = x.shape[:2]
            tally["drops"].append((~kept).reshape(b, s, -1).any(-1))  # [B, S]: a token lost a slot
            tally["slots_dropped"] += int((~kept).sum())
            tally["routes"].append(experts.reshape(b, s, -1).sort(-1).values)
        return moe_block(cfg, p, x, probe)

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 20)
    summary = {}
    M.moe_block = counted_moe_block
    try:
        for name in SERVE_ARCHS:
            t = time.perf_counter()
            cfg, model = serve_model(torch, name, dev, seed)
            tally["on"] = True
            summary[name] = serve_check(torch, testing, M, cfg, model, tally, gen, dev)
            if cfg.moe_num_experts:
                summary[name]["window"] = serve_check(torch, testing, M, cfg, model, tally, gen, dev,
                                                      prompt=SERVE_WINDOW_PROMPT, steps=SERVE_WINDOW_STEPS)
            if name in SERVE_FULL_DEPTH:
                del model
                cfg, model = serve_model(torch, name, dev, seed, full=True)
                summary[name]["full_depth"] = serve_check(torch, testing, M, cfg, model, tally, gen, dev,
                                                          gated=False)
            tally["on"] = False
            if name in SERVE_LOAD_ARCHS:
                summary[name]["load"] = serve_load(torch, M, cfg, model, tally, gen, dev)
            summary[name]["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            summary[name]["seconds"] = time.perf_counter() - t
            log(f"serve {name}: peak device memory {summary[name]['peak_gib']:.2f} GiB (the last model built), "
                f"{summary[name]['seconds']:.2f} s")
            del model
    finally:
        M.moe_block = moe_block
    gc.collect()
    torch.cuda.empty_cache()
    phases["serve_full_width_s"] = time.perf_counter() - t0

    t = time.perf_counter()
    for name in SERVE_ARCHS:
        cfg = get_arch(name).reduced()
        cpu_model = M.init_params(cfg, seed=seed, device="cpu")
        gen_cpu = torch.Generator().manual_seed(seed + 21)
        tokens = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT), generator=gen_cpu)
        prefix = None
        if cfg.frontend == "vlm_stub":
            prefix = torch.randn((SERVE_BATCH, cfg.num_prefix_embeddings, cfg.d_model), generator=gen_cpu)
        res = testing.compare_decode(cfg, cpu_model, copy.deepcopy(cpu_model).to(dev), tokens, prefix,
                                     SERVE_CPU_STEPS, testing.logit_atol(cfg))
        summary[name]["card_vs_cpu"] = {k: res[k] for k in ("max_abs_err", "near_ties")}
        log(f"check serve {name} reduced, card against CPU: prefill + {SERVE_CPU_STEPS} decode steps, max |err| "
            f"{res['max_abs_err']:.4g} (bound {testing.logit_atol(cfg):.3g}), greedy tokens equal outside "
            f"{res['near_ties']} near-ties")
    phases["serve_card_vs_cpu_s"] = time.perf_counter() - t

    t = time.perf_counter()
    for name in SERVE_ARCHS:
        seq = serve.main(["--arch", name, "--local", "--tokens", str(SERVE_LOCAL_TOKENS)])
        if seq.shape != (4, SERVE_LOCAL_TOKENS) or not ((seq >= 0) & (seq < get_arch(name).vocab_size)).all():
            raise AssertionError(f"serve --local {name}: tokens {seq.shape}")
    phases["serve_local_s"] = time.perf_counter() - t
    launches = counts.read()
    log(f"serve path launches of the seven kernels: {launches} (no TPU kernel is on this path)")
    log("serve summary: " + json.dumps(summary))


def train_flops(cfg, batch: int, seq: int) -> dict:
    """Operations of one training step, counted from the shapes: 6 per
    matmul weight and token (forward, and the two backward products), the
    LM head included; attention's QK and PV over the full square the plain
    flash attention computes (4 S^2 q_dim per sequence and layer forward,
    twice that backward).  ``recompute`` adds what remat runs again: each
    layer's forward and the loss chunks' head products."""
    d, tokens = cfg.d_model, batch * seq
    layer = d * (cfg.q_dim + 2 * cfg.kv_dim) + cfg.q_dim * d + 3 * d * cfg.d_ff
    attn = 4 * batch * seq * seq * cfg.q_dim * cfg.num_layers
    model = 6 * (layer * cfg.num_layers + d * cfg.vocab_size) * tokens + 3 * attn
    recompute = 2 * (layer * cfg.num_layers + d * cfg.vocab_size) * tokens + attn
    return {"model": model, "with_recompute": model + recompute,
            "matmul_params": layer * cfg.num_layers + d * cfg.vocab_size}


class SimulatedCrash(Exception):
    """Raised by the resume check's ``on_step`` to stop a run mid-way."""


def train_path(torch, dev, phases, counts, testing, seed: int) -> dict:
    """The training path (``repro_torch.train.loop`` / ``launch.steps``):
    TRAIN_ARCH at its published widths and TRAIN_LAYERS layers for
    TRAIN_STEPS steps (loss, seconds, tokens/s and TFLOP/s per step, a
    profiled step, peak memory; the loss must fall); at TRAIN_CHECK_LAYERS
    layers the micro-batch check (two against one: the accumulated
    gradients within ``testing.GRAD_RTOL``, the grad norm, loss and update
    within the reference's bounds) and the resume check (crash at TRAIN_CRASH_AT of TRAIN_RESUME_STEPS and
    resume from the store, held to two uninterrupted runs' spread, save
    and restore timed with their bytes); the card against the CPU on the
    reduced configuration (``testing.compare_train_step``);
    ``launch.train.main(--local)`` on the card.  None of the seven kernels
    is on this path."""
    import copy
    import dataclasses
    import shutil

    from repro_torch.configs import get_arch
    from repro_torch.core.object_store import MemoryObjectStore
    from repro_torch.launch import train as train_launcher
    from repro_torch.launch.steps import accumulate_grads, build_local_train_cell
    from repro_torch.models import model as M
    from repro_torch.train import loop
    from repro_torch.train.checkpoint import committed_steps
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state

    counts.reset()
    t0 = time.perf_counter()
    base = get_arch(TRAIN_ARCH)
    adamw = AdamWConfig()
    out: dict = {}

    # ------------------------------------------- full width, TRAIN_LAYERS
    cfg = dataclasses.replace(base, num_layers=TRAIN_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = M.init_params(cfg, seed=seed, device=dev)
    opt = init_opt_state(dict(model.named_parameters()))
    n_params = sum(p.numel() for p in model.parameters())
    state_gib = torch.cuda.memory_allocated() / 2**30
    tc = loop.TrainConfig(batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, seed=seed)
    batches = loop.synthetic_lm_batches(cfg, tc, dev)
    step = build_local_train_cell(cfg, adamw, remat=True)
    flops = train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    losses, norms, times = [], [], []
    for i in range(TRAIN_STEPS):
        batch = next(batches)
        torch.cuda.synchronize()
        t = time.perf_counter()
        model, opt, metrics = step(model, opt, batch)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        losses.append(loss)
        norms.append(float(metrics["grad_norm"]))
        log(f"train {TRAIN_ARCH} x{TRAIN_LAYERS} step {i}: loss {loss:.5f}, grad norm {norms[-1]:.4f}, "
            f"{times[-1]:.4f} s, {tokens / times[-1]:.1f} tokens/s, "
            f"{flops['model'] / times[-1] / PEAK_BF16_FLOPS:.4f} of the bf16 peak")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train {TRAIN_ARCH}: the loss did not fall: {losses}")
    stats: dict = {}
    batch = next(batches)
    profile_request(torch, lambda: step(model, opt, batch),
                    f"train {TRAIN_ARCH} x{TRAIN_LAYERS} step (B={TRAIN_BATCH}, S={TRAIN_SEQ})", stats)
    med = statistics.median(times[2:])
    out["full_width"] = {
        "layers": TRAIN_LAYERS, "params": n_params, "state_gib_before_steps": state_gib,
        "losses": losses, "grad_norms": norms, "step_s": times, "median_step_s": med,
        "tokens_per_s": tokens / med, "model_tflops": flops["model"] / med / 1e12,
        "peak_share": flops["model"] / med / PEAK_BF16_FLOPS,
        "peak_share_with_recompute": flops["with_recompute"] / med / PEAK_BF16_FLOPS,
        "profiled_step": stats, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    log(f"train {TRAIN_ARCH} x{TRAIN_LAYERS} of {base.num_layers} layers (depth cut; widths as published: "
        f"d_model {cfg.d_model}, heads {cfg.num_heads} / {cfg.num_kv_heads}, d_ff {cfg.d_ff}, vocabulary "
        f"{cfg.vocab_size}): {n_params / 1e9:.3f} B parameters, {state_gib:.2f} GiB of bf16 parameters and "
        f"float32 moments; B={TRAIN_BATCH} x S={TRAIN_SEQ}, remat, {adamw}; loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
        f"median step {med:.4f} s over steps 2-{TRAIN_STEPS - 1}, {tokens / med:.1f} tokens/s, "
        f"{flops['model'] / med / 1e12:.2f} TFLOP/s = {flops['model'] / med / PEAK_BF16_FLOPS:.4f} of the "
        f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16 peak counting 6 x {flops['matmul_params'] / 1e9:.3f} B "
        f"matmul weights x tokens + attention, the recompute not counted "
        f"({flops['with_recompute'] / med / PEAK_BF16_FLOPS:.4f} with it); peak device memory "
        f"{out['full_width']['peak_gib']:.2f} GiB")
    del model, opt, step, batches, batch
    gc.collect()
    torch.cuda.empty_cache()
    phases["train_full_width_s"] = time.perf_counter() - t0

    # ------------------------------- micro-batching at TRAIN_CHECK_LAYERS
    t = time.perf_counter()
    cfg2 = dataclasses.replace(base, num_layers=TRAIN_CHECK_LAYERS)
    model = M.init_params(cfg2, seed=seed, device=dev)
    batch = next(loop.synthetic_lm_batches(cfg2, loop.TrainConfig(batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                                                                    seed=seed + 1), dev))
    # The gradients themselves: the update alone cannot show a wrong
    # accumulation (Adam's first step is lr * sign(g), far under atol).
    full_g = accumulate_grads(cfg2, copy.deepcopy(model), batch)[1]
    split_g = accumulate_grads(cfg2, copy.deepcopy(model), batch, microbatches=2)[1]
    grad_rel = testing.grad_rel_l2(split_g, full_g)
    leaf_rel = sorted(((testing.grad_rel_l2({k: g}, {k: full_g[k]}), k) for k, g in split_g.items()), reverse=True)
    del split_g
    half_g = accumulate_grads(cfg2, copy.deepcopy(model), {k: v[:TRAIN_BATCH // 2] for k, v in batch.items()})[1]
    half_rel = testing.grad_rel_l2(half_g, full_g)  # what a partial accumulation would read
    del full_g, half_g
    if not grad_rel <= testing.GRAD_RTOL or not half_rel > 3 * testing.GRAD_RTOL:
        raise AssertionError(f"micro-batching: gradients {grad_rel:.4g} from the full batch's (one half's: "
                             f"{half_rel:.4g}), bound {testing.GRAD_RTOL}")
    runs = []
    for mb in (1, 2):
        m = copy.deepcopy(model)
        m, _opt, metrics = build_local_train_cell(cfg2, adamw, microbatches=mb)(
            m, init_opt_state(dict(m.named_parameters())), batch)
        runs.append((m, float(metrics["loss"]), float(metrics["grad_norm"])))
        del _opt
    (full, loss1, norm1), (split, loss2, norm2) = runs
    if not abs(loss2 - loss1) <= 1e-3 * abs(loss1) or not abs(norm2 - norm1) <= 1e-2 * abs(norm1):
        raise AssertionError(f"micro-batching: loss {loss2} against {loss1}, grad norm {norm2} against {norm1}")
    worst = 0.0
    for (name, a), b in zip(full.named_parameters(), split.parameters()):
        torch.testing.assert_close(b.float(), a.float(), rtol=2e-2, atol=2e-3, msg=name)
        worst = max(worst, (a.float() - b.float()).abs().max().item())
    out["microbatch"] = {"loss_1": loss1, "loss_2": loss2, "grad_norm_1": norm1, "grad_norm_2": norm2,
                         "grad_rel_l2": grad_rel, "half_batch_grad_rel_l2": half_rel,
                         "worst_leaves_rel_l2": {k: v for v, k in leaf_rel[:4]},
                         "max_param_abs_diff": worst}
    log(f"check train microbatches {TRAIN_ARCH} x{TRAIN_CHECK_LAYERS}: 2 micro-batches against 1 on one "
        f"B={TRAIN_BATCH} x S={TRAIN_SEQ} batch: float32 accumulated gradients {grad_rel:.4g} from the full "
        f"batch's (global relative L2, bound {testing.GRAD_RTOL}; one half's gradients alone read "
        f"{half_rel:.4g}; the leaves furthest apart: "
        f"{', '.join(f'{k} {v:.3g}' for v, k in leaf_rel[:4])}); loss {loss2:.6f} vs {loss1:.6f} (rtol 1e-3), grad norm {norm2:.5f} vs {norm1:.5f} "
        f"(rtol 1e-2), parameters after the update within rtol 2e-2 / atol 2e-3 (max |diff| {worst:.3g})")
    del model, full, split, runs, batch
    gc.collect()
    torch.cuda.empty_cache()
    phases["train_microbatch_s"] = time.perf_counter() - t

    # ------------------------------------ resume at TRAIN_CHECK_LAYERS
    t = time.perf_counter()
    io_s = {"save": [], "restore": []}
    save, restore = loop.save_checkpoint, loop.restore_latest

    def timed(key, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            result = fn(*args, **kwargs)
            io_s[key].append(time.perf_counter() - t1)
            return result
        return run

    def crash(step_i, _loss):
        if step_i >= TRAIN_CRASH_AT:
            raise SimulatedCrash

    rtc = loop.TrainConfig(steps=TRAIN_RESUME_STEPS, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                           checkpoint_every=TRAIN_CRASH_AT, log_every=10**9, run_name="resume", seed=seed)
    run_s = {}
    try:
        # two uninterrupted runs, their checkpoints not written (nothing
        # reads them; a 2-layer checkpoint is ~10 GB)
        loop.save_checkpoint = lambda *args, **kwargs: ""
        control = []
        for i in range(2):
            t1 = time.perf_counter()
            _m, _o, losses = loop.train(cfg2, MemoryObjectStore(), rtc, adamw, device=dev)
            run_s[f"control {i}"] = time.perf_counter() - t1
            control.append(losses)
            del _m, _o
            gc.collect()
        loop.save_checkpoint, loop.restore_latest = timed("save", save), timed("restore", restore)
        store = MemoryObjectStore()
        t1 = time.perf_counter()
        try:
            loop.train(cfg2, store, rtc, adamw, on_step=crash, device=dev)
            raise AssertionError("the resume check's run did not crash")
        except SimulatedCrash:
            pass
        run_s["crashed"] = time.perf_counter() - t1
        gc.collect()
        torch.cuda.empty_cache()
        if committed_steps(store, "resume") != [TRAIN_CRASH_AT]:
            raise AssertionError(f"committed after the crash: {committed_steps(store, 'resume')}")
        ckpt_bytes = sum(meta.size for meta in store.list("ckpt/"))
        # the resumed run's own final checkpoint is not written: the crashed
        # run's save is the one read back (a 2-layer save takes ~31 s)
        loop.save_checkpoint = lambda *args, **kwargs: ""
        t1 = time.perf_counter()
        _m, _o, resumed = loop.train(cfg2, store, rtc, adamw, device=dev)
        run_s["resumed"] = time.perf_counter() - t1
        del _m, _o
    finally:
        loop.save_checkpoint, loop.restore_latest = save, restore
    spread = max(abs(a - b) for a, b in zip(control[0], control[1]))
    bound = max(RESUME_SPREADS * spread, RESUME_FLOOR)
    diff = max(abs(a - b) for a, b in zip(resumed, control[0][TRAIN_CRASH_AT:]))
    if len(resumed) != TRAIN_RESUME_STEPS - TRAIN_CRASH_AT or not diff <= bound:
        raise AssertionError(f"resume: losses {resumed} against {control}")
    out["resume"] = {"control": control, "resumed": resumed, "control_spread": spread, "max_diff": diff,
                     "bound": bound, "checkpoint_bytes": ckpt_bytes, "save_s": io_s["save"],
                     "restore_s": io_s["restore"], "run_s": run_s}
    log(f"check train resume {TRAIN_ARCH} x{TRAIN_CHECK_LAYERS}: crashed at step {TRAIN_CRASH_AT} of "
        f"{TRAIN_RESUME_STEPS}, resumed from the store: losses {[round(v, 6) for v in resumed]} against two "
        f"uninterrupted runs {[[round(v, 6) for v in c[TRAIN_CRASH_AT:]] for c in control]} (their spread "
        f"{spread:.3g} over all steps; max |diff| {diff:.3g}, bound {bound:.3g}); a checkpoint is "
        f"{ckpt_bytes / 1e9:.3f} GB of .npy (bf16 parameters widened to float32, float32 moments); save "
        f"{[round(v, 3) for v in io_s['save']]} s, restore {[round(v, 3) for v in io_s['restore']]} s; "
        f"each run's seconds {json.dumps({k: round(v, 3) for k, v in run_s.items()})}")
    del store
    gc.collect()
    torch.cuda.empty_cache()
    phases["train_resume_s"] = time.perf_counter() - t

    # ------------------------------------------- card against CPU, reduced
    t = time.perf_counter()
    small = base.reduced()
    cpu_model = M.init_params(small, seed=seed, device="cpu")
    cpu_batch = next(loop.synthetic_lm_batches(small, loop.TrainConfig(batch=4, seq_len=64, seed=seed), "cpu"))
    res = testing.compare_train_step(small, cpu_model, copy.deepcopy(cpu_model).to(dev), cpu_batch, adamw)
    out["card_vs_cpu"] = res
    log(f"check train {TRAIN_ARCH} reduced, card against CPU, one step: loss {res['device']['loss']:.6f} vs "
        f"{res['cpu']['loss']:.6f} (|diff| {res['loss_abs_err']:.3g}, bound {testing.loss_atol(small):.3g}), "
        f"grad norm {res['device']['grad_norm']:.6f} vs {res['cpu']['grad_norm']:.6f} (relative "
        f"{res['grad_norm_rel_err']:.3g}, bound {testing.GRAD_RTOL})")
    ckpt_dir = ROOT / "build" / "train_local_ckpts"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    try:
        local = train_launcher.main(["--arch", TRAIN_ARCH, "--local", "--steps", str(TRAIN_LOCAL_STEPS),
                                     "--ckpt-dir", str(ckpt_dir)])
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    if len(local) != TRAIN_LOCAL_STEPS or not all(np.isfinite(local)):
        raise AssertionError(f"train --local: losses {local}")
    phases["train_card_vs_cpu_s"] = time.perf_counter() - t
    out["launches"] = counts.read()
    log(f"train path launches of the seven kernels: {out['launches']} (no TPU kernel is on this path)")
    phases["train_s"] = time.perf_counter() - t0
    log("train summary: " + json.dumps(out))
    return out


def flash_attention_check(torch, cfg, hooks: dict, gen, dev) -> float:
    """The flash impl against the dense one on float32 inputs at ``cfg``'s
    attention shapes (B=SERVE_BATCH, a cache of SERVE_PROMPT +
    DIST_DECODE_STEPS positions, the new token at its middle): outputs
    within rtol = atol = 2e-4, caches equal.  Returns the max |err|."""
    from repro_torch.models import model as M

    b, s = SERVE_BATCH, SERVE_PROMPT + DIST_DECODE_STEPS
    pos = s // 2

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    if cfg.attn_type == "mla":
        r, rope = cfg.kv_lora_rank, cfg.qk_rope_head_dim
        args = (rand(b, 1, cfg.num_heads, r), rand(b, 1, cfg.num_heads, rope), rand(b, 1, r + rope))
        cache = rand(b, s, r + rope)
        scale_dim = cfg.qk_nope_head_dim + rope
        want, want_c = M.dense_mla_decode_attn(*args, cache.clone(), pos, r, scale_dim)
        got, got_c = hooks["mla_attn_impl"](*args, cache.clone(), pos, r, scale_dim)
        caches = [(got_c, want_c)]
    else:
        h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        args = (rand(b, 1, h, hd), rand(b, 1, kvh, hd), rand(b, 1, kvh, hd))
        kc, vc = rand(b, s, kvh, hd), rand(b, s, kvh, hd)
        want, want_k, want_v = M.dense_gqa_decode_attn(*args, kc.clone(), vc.clone(), pos)
        got, got_k, got_v = hooks["gqa_attn_impl"](*args, kc.clone(), vc.clone(), pos)
        caches = [(got_k, want_k), (got_v, want_v)]
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    for a, b_ in caches:
        torch.testing.assert_close(a, b_, rtol=0, atol=0)
    return (got - want).abs().max().item()


def reordered_decode_hooks(torch) -> dict:
    """A control for flash decode: ``decode_step`` hooks that compute the
    dense decode's attention with the cache's positions up to ``pos``
    summed in reverse order: the same math, another float32 order."""
    import math

    def gqa(q, k_new, v_new, k_cache, v_cache, pos: int):
        k_cache[:, pos:pos + 1] = k_new
        v_cache[:, pos:pos + 1] = v_new
        b, _one, h, hd = q.shape
        kvh = k_cache.shape[2]
        k, v = k_cache[:, :pos + 1].flip(1).float(), v_cache[:, :pos + 1].flip(1).float()
        q5 = q.reshape(b, 1, kvh, h // kvh, hd).float()
        w = torch.softmax(torch.einsum("bqkgd,bskd->bkgqs", q5, k) / math.sqrt(hd), dim=-1)
        out = torch.einsum("bkgqs,bskd->bqkgd", w, v)
        return out.reshape(b, 1, h, hd).to(q.dtype), k_cache, v_cache

    def mla(q_c, q_rope, payload, c_cache, pos: int, r: int, scale_dim: int):
        c_cache[:, pos:pos + 1] = payload
        c = c_cache[:, :pos + 1].flip(1).float()
        scores = (torch.einsum("bqhr,bsr->bhqs", q_c.float(), c[..., :r])
                  + torch.einsum("bqhn,bsn->bhqs", q_rope.float(), c[..., r:])) / math.sqrt(scale_dim)
        ctx = torch.einsum("bhqs,bsr->bqhr", torch.softmax(scores, dim=-1), c[..., :r])
        return ctx.to(q_c.dtype), c_cache

    return {"gqa_attn_impl": gqa, "mla_attn_impl": mla}


def distributed_path(torch, dev, gen, phases, counts, testing, seed: int) -> dict:
    """The distributed layer (``repro_torch.distributed``) on an NCCL
    process group of world size 1 (NCCL puts one rank on a card): the
    search over 1M x 768 rows at DIST_NQ, k = K, through ``l2_topk`` and
    ``merge_topk`` (its launches counted), held to ``ops.topk_scan`` on the
    same rows exactly and to the plain version within SCORE_TOL (ids exact
    outside near-ties); GQA and MLA flash decode against the dense decode
    on one layer's float32 inputs at the model's shapes within 2e-4 (the
    reference's bound, ``tests/test_distributed.py:42,78``), then through
    ``decode_step``'s hooks for DIST_DECODE_STEPS steps within
    FLASH_DECODE_ATOL, beside two controls of the dense decode against
    itself (``reordered_decode_hooks``; rows 0-1 in a batch of 2); the
    expert-parallel MoE block against the dense one within 2e-2 (the
    reference's bound) and a prefill under the policy within
    ``testing.logit_atol``."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.distributed import act_sharding
    from repro_torch.distributed.decode_attn import make_gqa_flash_decode, make_mla_flash_decode
    from repro_torch.distributed.search import make_distributed_search
    from repro_torch.kernels import l2_topk as l2_mod
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_mod

    t0 = time.perf_counter()
    rendezvous = ROOT / "build" / "dist_rendezvous"
    rendezvous.parent.mkdir(parents=True, exist_ok=True)
    rendezvous.unlink(missing_ok=True)
    dist.init_process_group("nccl", store=dist.FileStore(str(rendezvous), 1), rank=0, world_size=1)
    out: dict = {"latency": {}}
    try:
        # ---------------------------------------------------------- search
        x = torch.randn((N_ROWS, DIM), generator=gen, device=dev)
        valid = torch.ones(N_ROWS, dtype=torch.int32, device=dev)
        queries = {nq: torch.randn((nq, DIM), generator=gen, device=dev) for nq in DIST_NQ}
        search = make_distributed_search(None, K, "l2")
        results = {}
        counts.reset()
        for nq, q in queries.items():
            times = []
            for _ in range(DIST_REPS[nq] + 1):  # the first call is the warm-up
                torch.cuda.synchronize()
                t = time.perf_counter()
                results[nq] = search(q, x, valid)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
            out["latency"][f"distributed search nq={nq}"] = times
        launches = counts.read()
        out["launches"] = launches
        out["shapes"] = counts.read_shapes(launches, "distributed", ())
        log(f"distributed path launches: {launches}")
        for kname in ("l2_topk", "merge_topk"):
            if launches[kname] <= 0:
                raise AssertionError(f"{kname} was not launched on the distributed path")
        out["max_abs_err"] = 0.0
        rtol, atol = testing.SCORE_TOL["l2"]
        for nq, q in queries.items():
            got = results[nq]
            single = ops.topk_scan(q, x, K, "l2", valid=valid.bool())
            if not (torch.equal(got[0], single[0]) and torch.equal(got[1], single[1])):
                raise AssertionError(f"distributed search nq={nq}: differs from the single-rank scan")
            plain = l2_mod.l2_topk_plain(q, [x], [valid.bool()], K, "l2")
            testing.assert_topk_near_tie(got, plain, rtol, atol)
            err = (got[0] - plain[0]).abs().max().item()
            out["max_abs_err"] = max(out["max_abs_err"], err)
            log(f"check distributed search nq={nq} over {N_ROWS} x {DIM}, k={K}, world 1: equal to "
                f"ops.topk_scan on the same rows; against the plain version max |err| {err:.3g} (rtol {rtol}, "
                f"atol {atol}), ids equal outside near-ties; median "
                f"{statistics.median(out['latency'][f'distributed search nq={nq}'][1:]):.3f} ms")
        del x, valid, queries, results
        gc.collect()
        torch.cuda.empty_cache()
        phases["distributed_search_s"] = time.perf_counter() - t0

        # ---------------------------------------------------- flash decode
        t = time.perf_counter()
        hooks = {"gqa_attn_impl": make_gqa_flash_decode(), "mla_attn_impl": make_mla_flash_decode()}
        reordered = reordered_decode_hooks(torch)
        b, s = SERVE_BATCH, SERVE_PROMPT
        for name in DIST_DECODE_ARCHS:
            cfg, model = serve_model(torch, name, dev, seed)
            attn_err = flash_attention_check(torch, cfg, hooks, gen, dev)
            tokens = torch.randint(0, cfg.vocab_size, (b, s + DIST_DECODE_STEPS), generator=gen, device=dev)
            # dense, flash, the reordered control; then rows 0-1 alone (dense)
            runs = [(b, {}), (b, hooks), (b, reordered), (2, {})]
            with torch.no_grad():
                caches = []
                for rows, _h in runs:
                    cache = M.init_cache(cfg, rows, s + DIST_DECODE_STEPS, device=dev)
                    M.prefill(cfg, model, tokens[:rows, :s], cache, last_only=True)
                    caches.append(cache)
                logits = [[] for _ in runs]
                for i in range(DIST_DECODE_STEPS):
                    for (rows, impls), cache, seq in zip(runs, caches, logits):
                        seq.append(M.decode_step(cfg, model, cache, tokens[:rows, s + i:s + i + 1], **impls)[0])
                want, got, reord, pair = (torch.cat(seq, 1) for seq in logits)
                ties = testing.assert_logits_close(f"flash decode {name}", got, want, FLASH_DECODE_ATOL)
                err = (got - want).abs().max().item()
                ctrl_order = (reord - want).abs().max().item()
                ctrl_batch = (pair - want[:2]).abs().max().item()
            out[f"flash_decode {name}"] = {"attention_max_abs_err": attn_err, "max_abs_err": err, "near_ties": ties,
                                           "control_reversed_order": ctrl_order, "control_batch_of_2": ctrl_batch}
            log(f"check flash decode {name} x{cfg.num_layers} ({cfg.attn_type}, world 1): one layer's attention "
                f"against the dense decode's on float32 inputs, max |err| {attn_err:.3g} (rtol = atol = 2e-4); "
                f"{DIST_DECODE_STEPS} decode steps through decode_step's hooks against the dense decode, max |err| "
                f"{err:.4g} (bound {FLASH_DECODE_ATOL}), greedy tokens equal outside {ties} near-ties at that "
                f"bound; controls, the dense decode against itself: positions summed in reverse {ctrl_order:.4g}, "
                f"rows 0-1 in a batch of 2 {ctrl_batch:.4g}")
            del model, caches
            gc.collect()
            torch.cuda.empty_cache()
        phases["distributed_decode_s"] = time.perf_counter() - t

        # ---------------------------------------------- expert-parallel MoE
        t = time.perf_counter()
        cfg, model = serve_model(torch, DIST_MOE_ARCH, dev, seed)
        layer = next(lay for lay in model.layers if lay.is_moe)
        tokens = torch.randint(0, cfg.vocab_size, (b, DIST_MOE_TOKENS // b), generator=gen, device=dev)
        with torch.no_grad():
            h = torch.randn((b, DIST_MOE_TOKENS // b, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)
            dense = moe_mod.moe_block(cfg, layer.moe, h)
            dense_logits, _ = M.prefill(cfg, model, tokens, M.init_cache(cfg, b, tokens.shape[1], device=dev))
            with act_sharding.policy(None):
                sharded = moe_mod.moe_block(cfg, layer.moe, h)
                sharded_logits, _ = M.prefill(cfg, model, tokens, M.init_cache(cfg, b, tokens.shape[1], device=dev))
        block_err = (sharded.float() - dense.float()).abs().max().item()
        torch.testing.assert_close(sharded.float(), dense.float(), rtol=2e-2, atol=2e-2)
        ties = testing.assert_logits_close(f"expert-parallel {DIST_MOE_ARCH}", sharded_logits, dense_logits,
                                           testing.logit_atol(cfg))
        logit_err = (sharded_logits - dense_logits).abs().max().item()
        out["expert_parallel"] = {"block_max_abs_err": block_err, "prefill_max_abs_err": logit_err,
                                  "near_ties": ties}
        log(f"check expert-parallel MoE {DIST_MOE_ARCH} x{cfg.num_layers} ({cfg.moe_num_experts} experts "
            f"over world 1): the block on {DIST_MOE_TOKENS} tokens against the dense block, max |err| "
            f"{block_err:.4g} (rtol = atol = 2e-2); a prefill under the policy against the dense one, max "
            f"|err| {logit_err:.4g} (bound {testing.logit_atol(cfg)}), {ties} near-ties")
        del model
        gc.collect()
        torch.cuda.empty_cache()
        phases["distributed_moe_s"] = time.perf_counter() - t
    finally:
        dist.destroy_process_group()
        rendezvous.unlink(missing_ok=True)
    phases["distributed_s"] = time.perf_counter() - t0
    return out


def sharded_cells_path(torch, dev, gen, phases, counts, testing, seed: int) -> dict:
    """The sharded cells (``repro_torch.launch.steps``) on a (1, 1) mesh
    over an NCCL group of world 1 (NCCL puts one rank on a card): the train
    cell beside the one-device one (losses within ``testing.LOSS_ATOL``;
    the gradients each step's AdamW took in step 1, and the parameters it
    left, within ``testing.GRAD_RTOL``; s/step of each), the
    dry-run's estimate of that cell beside the card's peak memory and
    ``train_flops`` (each ratio within its bound), the prefill and decode
    cells against the plain ``prefill`` / ``decode_step`` within
    ``testing.logit_atol`` (decode ms/step of each), and the
    expert-parallel MoE block's gradients against the dense block's within
    ``testing.GRAD_RTOL``.  None of the seven kernels is on this path."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.distributed import act_sharding
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.config import ShapeConfig
    from repro_torch.train import loop
    from repro_torch.train.optimizer import init_opt_state

    t0 = time.perf_counter()
    out: dict = {"latency": {}}
    cfg = dataclasses.replace(get_arch(TRAIN_ARCH), num_layers=TRAIN_LAYERS)
    shape = ShapeConfig(f"train_{TRAIN_BATCH}x{TRAIN_SEQ}", TRAIN_SEQ, TRAIN_BATCH, "train")

    # ------------------------------- the dry-run's estimate, meta tensors
    t = time.perf_counter()
    with dryrun.fake_world(1):
        fake_mesh = make_mesh((1, 1), ("data", "model"))
        est_memory = dryrun.depth_cost(cfg, shape, fake_mesh, {"remat": True}, cost=False)
        est_cost = dryrun.depth_cost(cfg, shape, fake_mesh, {"remat": True}, cost=True)
    phases["sharded_dryrun_s"] = time.perf_counter() - t

    counts.reset()
    rendezvous = ROOT / "build" / "sharded_rendezvous"
    rendezvous.parent.mkdir(parents=True, exist_ok=True)
    rendezvous.unlink(missing_ok=True)
    dist.init_process_group("nccl", store=dist.FileStore(str(rendezvous), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        # ------------------------------------------------------ train cell
        t = time.perf_counter()
        tc = loop.TrainConfig(batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, seed=seed)
        runs = {}
        for kind in ("one-device", "sharded"):
            gc.collect()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()  # what earlier paths still hold
            model = M.init_params(cfg, seed=seed, device=dev)
            batches = loop.synthetic_lm_batches(cfg, tc, dev)
            batch_list = [next(batches) for _ in range(SHARDED_TRAIN_STEPS)]
            if kind == "sharded":
                step, _specs, _structs, _donate = steps.build_train_cell(cfg, shape, mesh, return_grads=True)
                model = steps.shard_model(cfg, mesh, fsdp=True, full=model, copy=False)
            else:
                step = steps.build_local_train_cell(cfg, return_grads=True)
            opt = init_opt_state(dict(model.named_parameters()))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            losses, times = [], []
            for i, batch in enumerate(batch_list):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                model, opt, metrics = step(model, opt, batch)
                losses.append(float(metrics["loss"]))
                times.append(time.perf_counter() - t1)
                if i == 0:  # the gradients the step's update took, and the parameters it left
                    grads = {k: g.cpu() for k, g in metrics["grads"].items()}
                    after = {k: p.detach().cpu() for k, p in model.named_parameters()}
                del metrics
            runs[kind] = {"losses": losses, "s_per_step": times, "grads": grads, "params": after,
                          "peak_bytes": torch.cuda.max_memory_allocated() - base}
            log(f"sharded cells: train {TRAIN_ARCH} x{TRAIN_LAYERS} {kind} (B={TRAIN_BATCH} x {TRAIN_SEQ}, "
                f"mesh (1, 1)): losses {losses}, s/step {times}, max_memory_allocated over the steps, less "
                f"what earlier paths hold, {runs[kind]['peak_bytes']} bytes")
            del model, opt, batches, batch_list, grads, after
        one, sh = runs["one-device"], runs["sharded"]
        loss_err = max(abs(a - b) for a, b in zip(sh["losses"], one["losses"]))
        grad_err = testing.grad_rel_l2(sh["grads"], one["grads"])
        param_err = testing.grad_rel_l2(sh["params"], one["params"])
        if not (loss_err <= testing.LOSS_ATOL and grad_err <= testing.GRAD_RTOL and param_err <= testing.GRAD_RTOL):
            raise AssertionError(f"sharded train cell against the one-device cell: losses {sh['losses']} vs "
                                 f"{one['losses']}, step-1 gradients relative L2 {grad_err}, parameters after "
                                 f"step 1 {param_err}")
        flops = train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)["with_recompute"]
        mem_ratio = est_memory["peak_bytes"] / sh["peak_bytes"]
        flop_ratio = est_cost["flops"] / flops
        out["train"] = {"loss_max_abs_err": loss_err, "grad_rel_l2": grad_err, "param_rel_l2": param_err,
                        "s_per_step": {k: r["s_per_step"] for k, r in runs.items()},
                        "peak_bytes": {k: r["peak_bytes"] for k, r in runs.items()},
                        "dryrun_peak_bytes": est_memory["peak_bytes"], "dryrun_flops": est_cost["flops"],
                        "train_flops": flops, "memory_ratio": mem_ratio, "flops_ratio": flop_ratio}
        log(f"check sharded train cell {TRAIN_ARCH} x{TRAIN_LAYERS}: {SHARDED_TRAIN_STEPS} steps, losses "
            f"max |err| {loss_err:.3g} against the one-device cell (bound {testing.LOSS_ATOL}), step-1 gradients "
            f"(those each step's AdamW took) relative L2 {grad_err:.3g} and the parameters after step 1 "
            f"{param_err:.3g} (bound {testing.GRAD_RTOL}); median s/step sharded "
            f"{statistics.median(sh['s_per_step']):.4f}, one-device {statistics.median(one['s_per_step']):.4f}")
        log(f"dry-run tie {TRAIN_ARCH} x{TRAIN_LAYERS} (1, 1): estimated peak {est_memory['peak_bytes']} bytes "
            f"against max_memory_allocated {sh['peak_bytes']} (ratio {mem_ratio:.4f}, bound "
            f"{DRYRUN_MEMORY_RATIO}); estimated FLOPs {est_cost['flops']:.6g} against train_flops "
            f"{flops:.6g} (ratio {flop_ratio:.4f}, bound {DRYRUN_FLOPS_RATIO}); estimate "
            f"{phases['sharded_dryrun_s']:.2f} s on the CPU")
        if not (DRYRUN_MEMORY_RATIO[0] <= mem_ratio <= DRYRUN_MEMORY_RATIO[1]
                and DRYRUN_FLOPS_RATIO[0] <= flop_ratio <= DRYRUN_FLOPS_RATIO[1]):
            raise AssertionError(f"the dry-run's estimate is off the card's reading: memory ratio {mem_ratio}, "
                                 f"FLOPs ratio {flop_ratio}")
        del runs, one, sh
        phases["sharded_train_s"] = time.perf_counter() - t

        # ------------------------------------------ prefill / decode cells
        t = time.perf_counter()
        b, s = SERVE_BATCH, SERVE_PROMPT
        total = s + SHARDED_DECODE_STEPS
        for name in SHARDED_SERVE_ARCHS:
            scfg, model = serve_model(torch, name, dev, seed)
            bound = testing.logit_atol(scfg)
            prefill, p_specs, _s, _d = steps.build_prefill_cell(scfg, ShapeConfig("p", s, b, "prefill"), mesh)
            decode, d_specs, _s, _d = steps.build_decode_cell(scfg, ShapeConfig("d", total, b, "decode"), mesh)
            local = steps.shard_model(scfg, mesh, fsdp=False, full=model, copy=False)
            tokens = torch.randint(0, scfg.vocab_size, (b, total), generator=gen, device=dev)
            with torch.no_grad():
                want, _c = M.prefill(scfg, model, tokens[:, :s], M.init_cache(scfg, b, s, device=dev), last_only=True)
                got, _c = prefill(local, {"tokens": tokens[:, :s]}, steps.shard_cache(
                    scfg, mesh, M.init_cache(scfg, b, s, device=dev), b))
                prefill_err = (got - want).abs().max().item()
                dense = M.init_cache(scfg, b, total, device=dev)
                M.prefill(scfg, model, tokens[:, :s], dense)
                cell_cache = steps.shard_cache(scfg, mesh, dense, b)
                errs, ms = [], {"plain": [], "cell": []}
                for i in range(SHARDED_DECODE_STEPS):
                    tok = tokens[:, s + i:s + i + 1]
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    want = M.decode_step(scfg, model, dense, tok)[0]
                    torch.cuda.synchronize()
                    t2 = time.perf_counter()
                    got = decode(local, cell_cache, {"tokens": tok})[0]
                    torch.cuda.synchronize()
                    ms["plain"].append((t2 - t1) * 1e3)
                    ms["cell"].append((time.perf_counter() - t2) * 1e3)
                    errs.append((got - want).abs().max().item())
            decode_err = max(errs)
            if not (prefill_err <= bound and decode_err <= bound):
                raise AssertionError(f"sharded cells {name}: prefill max |err| {prefill_err}, decode {decode_err} "
                                     f"(bound {bound})")
            out[f"serve {name}"] = {"prefill_max_abs_err": prefill_err, "decode_max_abs_err": decode_err,
                                    "decode_ms": ms}
            out["latency"][f"sharded decode cell {name}"] = ms["cell"]
            out["latency"][f"plain decode_step {name}"] = ms["plain"]
            log(f"check sharded prefill / decode cells {name} x{scfg.num_layers} (mesh (1, 1)): prefill logits max "
                f"|err| {prefill_err:.4g}, {SHARDED_DECODE_STEPS} decode steps {decode_err:.4g} against the plain "
                f"prefill / decode_step (bound {bound}); decode ms/step median cell "
                f"{statistics.median(ms['cell'][1:]):.3f}, plain {statistics.median(ms['plain'][1:]):.3f}")
            del model, local, dense, cell_cache
            gc.collect()
            torch.cuda.empty_cache()
        phases["sharded_serve_s"] = time.perf_counter() - t

        # -------------------------------------- expert-parallel training
        t = time.perf_counter()
        mcfg, model = serve_model(torch, DIST_MOE_ARCH, dev, seed)
        layer = next(lay for lay in model.layers if lay.is_moe)
        p = layer.moe
        x = torch.randn((b, DIST_MOE_TOKENS // b, mcfg.d_model), generator=gen, device=dev).to(torch.bfloat16)
        w = torch.randn(x.shape, generator=gen, device=dev)
        p.requires_grad_(True)
        grads = []
        for scope in (act_sharding.policy(None), contextlib.nullcontext()):
            xg = x.clone().requires_grad_(True)
            with scope:
                y = moe_mod.moe_block(mcfg, p, xg)
            g = torch.autograd.grad((y.float() * w).sum(), [xg, *p.parameters()])
            grads.append({str(i): gi for i, gi in enumerate(g)})
        p.requires_grad_(False)
        ep_err = testing.grad_rel_l2(grads[0], grads[1])
        if not ep_err <= testing.GRAD_RTOL:
            raise AssertionError(f"expert-parallel MoE gradients against the dense block's: relative L2 {ep_err}")
        out["expert_parallel_grad_rel_l2"] = ep_err
        log(f"check expert-parallel training {DIST_MOE_ARCH} ({mcfg.moe_num_experts} experts, world 1): the "
            f"block's gradients (x and every parameter) on {DIST_MOE_TOKENS} tokens against the dense block's, "
            f"relative L2 {ep_err:.4g} (bound {testing.GRAD_RTOL})")
        del model, layer, p, grads
        gc.collect()
        torch.cuda.empty_cache()
        phases["sharded_moe_s"] = time.perf_counter() - t
    finally:
        dist.destroy_process_group()
        rendezvous.unlink(missing_ok=True)
    out["launches"] = counts.read()
    phases["sharded_s"] = time.perf_counter() - t0
    return out


def examples_path(torch, phases, counts) -> dict:
    """The port's examples (EXAMPLES) on the card, in this process, each
    through its ``main(["--device", "cuda"])``, which returns 0 only when
    its own check passed; their kernel launches counted, each with its wall
    time.  Their check lines go to the log."""
    import importlib.util
    import io

    counts.reset()
    t0 = time.perf_counter()
    out: dict = {"seconds": {}}
    for name in EXAMPLES:
        spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = mod.main(["--device", "cuda"])
        torch.cuda.synchronize()
        out["seconds"][name] = time.perf_counter() - t
        lines = [ln for ln in buf.getvalue().splitlines() if "check" in ln or "identical" in ln]
        log(f"example {name}: exit {rc}, {out['seconds'][name]:.2f} s; " + " | ".join(lines))
        if rc != 0:
            raise AssertionError(f"example {name} failed its check (exit {rc}):\n{buf.getvalue()[-4000:]}")
        gc.collect()
        torch.cuda.empty_cache()
    launches = counts.read()
    out["launches"] = launches
    out["shapes"] = counts.read_shapes(launches, "examples", ())
    log(f"examples path launches: {launches}")
    for kname in ("l2_topk", "merge_topk", "kmeans_assign"):
        if launches[kname] <= 0:
            raise AssertionError(f"{kname} was not launched on the examples path")
    phases["examples_s"] = time.perf_counter() - t0
    return out


def scan_shape_times(torch, l2_mod, testing, shapes: dict, gen, dev) -> dict:
    """``l2_topk`` at every (nq, rows per segment, D, k, metric) in
    ``shapes`` (the paths' launches at the widths in
    ``LaunchCounts.SCAN_SHAPE_D``), on unit
    rows of that shape: held to the plain version on the same inputs
    (``SCORE_TOL``), timed beside it (``device_ms``), with the bound and,
    for one segment, ``torch.topk`` of the product."""
    rows = {}
    for (nq, seg_rows, d, k, metric), launches in sorted(shapes.items()):
        q = torch.randn((nq, d), generator=gen, device=dev)
        q = q / torch.linalg.vector_norm(q, dim=1, keepdim=True)
        bases = [torch.randn((n, d), generator=gen, device=dev) for n in seg_rows]
        bases = [b / torch.linalg.vector_norm(b, dim=1, keepdim=True).clamp_min(1e-12) for b in bases]
        valids = [None] * len(bases)
        got = l2_mod.l2_topk(q, bases, valids, k, metric)
        want = l2_mod.l2_topk_plain(q, bases, valids, k, metric)
        torch.cuda.synchronize()
        testing.assert_scan_close(got, want, q, bases, valids, k, metric, *testing.SCORE_TOL[metric])
        n = sum(seg_rows)
        fin = torch.isfinite(want[0])
        row = {
            "launches": launches, "max_abs_err": (got[0][fin] - want[0][fin]).abs().max().item(),
            "ms": device_ms(torch, lambda: l2_mod.l2_topk(q, bases, valids, k, metric), 20),
            "plain_ms": device_ms(torch, lambda: l2_mod.l2_topk_plain(q, bases, valids, k, metric), 20),
            "library_ms": (device_ms(torch, lambda: torch.topk(q @ bases[0].T, min(k, n), dim=1), 20)
                           if len(bases) == 1 else None),
            **scan_bound(nq, 4 * nq * d + 4 * n * d + 12 * nq * len(bases) * k, n, d,
                         2 * nq * n * d + 2 * nq * d),
        }
        rows[(nq, seg_rows, d, k, metric)] = row
    if rows:
        loss = sum(r["launches"] * (r["ms"] - r["bound_ms"]) for r in rows.values())
        top = max(rows.items(), key=lambda kv: kv[1]["launches"] * kv[1]["ms"])
        log(f"l2_topk at {len(rows)} shapes of d {LaunchCounts.SCAN_SHAPE_D}: "
            f"{sum(r['launches'] for r in rows.values())} launches, each equal to the plain version "
            f"(largest |err| {max(r['max_abs_err'] for r in rows.values()):.3g}); ms "
            f"{min(r['ms'] for r in rows.values()):.6f}-{max(r['ms'] for r in rows.values()):.6f}; "
            f"sum of launches x (ms - bound_ms) {loss:.3f} ms; the largest launches x ms at "
            f"nq={top[0][0]} rows={list(top[0][1])[:4]}{'...' if len(top[0][1]) > 4 else ''}: "
            + json.dumps(top[1]))
    return rows


def assign_bound(n: int, c: int, d: int) -> dict:
    """kmeans_assign's bound: the rows and centroids read once and the
    assignment and distance written once against the 3xTF32 product
    (3 x 2 N C D over the TF32 rate); the f32 bound of earlier runs (the
    product, norms and d2 over the f32 rate) beside it."""
    return scan_bound(c, 4 * n * d + 4 * c * d + 12 * n, n, d,
                      2 * n * c * d + 2 * (n + c) * d + 3 * n * c)


def assign_shape_times(torch, km_mod, testing, shapes: dict, gen, dev) -> dict:
    """kmeans_assign at every (N, C, D) the paths launched it at, on seeded
    data of that shape: the kernel held to the plain version on the same
    inputs (``testing.assert_assign_close``, near-ties exempt), the
    kernel's and the plain version's device time (``device_ms``), the
    kernel's CUDA-event time, the bound, the score path the default
    threshold takes and the launches.  Logs each row (shapes under
    ASSIGN_LOG_WORK as one summary) and the sum of launches x
    (time - bound) over every shape.  At a width in
    ``LaunchCounts.SCAN_SHAPE_D`` (an embedder's) the rows and centroids are
    unit-norm, as an embedder's rows are."""
    rows = {}
    for (n, c, d), launches in sorted(shapes.items(), key=lambda kv: -kv[0][0] * kv[0][1] * kv[0][2]):
        x = torch.randn((n, d), generator=gen, device=dev)
        cent = torch.randn((c, d), generator=gen, device=dev)
        if d in LaunchCounts.SCAN_SHAPE_D:
            x = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
            cent = cent / torch.linalg.vector_norm(cent, dim=1, keepdim=True)
        got = km_mod.kmeans_assign(x, cent)
        want = km_mod.kmeans_assign_plain(x, cent)
        torch.cuda.synchronize()
        testing.assert_assign_close(got, want, x, cent, *testing.SCORE_TOL["l2"])
        reps = 10 if n * c * d > 10**9 else 50
        row = {
            "launches": launches,
            "path": ("tensor cores" if c > km_mod.default_small_c(d)
                     else "narrow rows" if d <= km_mod.NARROW_D else "byte-bound"),
            "max_abs_err": (got[1] - want[1]).abs().max().item(),
            "ms": device_ms(torch, lambda: km_mod.kmeans_assign(x, cent), reps),
            "event_ms": cuda_ms(torch, lambda: km_mod.kmeans_assign(x, cent), reps),
            "plain_ms": device_ms(torch, lambda: km_mod.kmeans_assign_plain(x, cent), reps),
            "library_ms": None, **assign_bound(n, c, d),
        }
        rows[(n, c, d)] = row
        if n * c * d >= ASSIGN_LOG_WORK:
            log(f"kmeans_assign N={n} C={c} D={d}: " + json.dumps(row))
    small = {s: r for s, r in rows.items() if s[0] * s[1] * s[2] < ASSIGN_LOG_WORK}
    if small:
        log(f"kmeans_assign at {len(small)} shapes under N x C x D = {ASSIGN_LOG_WORK} "
            f"(N {min(s[0] for s in small)}-{max(s[0] for s in small)}, C "
            f"{min(s[1] for s in small)}-{max(s[1] for s in small)}): each equals the plain version "
            f"(largest |err| {max(r['max_abs_err'] for r in small.values()):.3g}); "
            f"{sum(r['launches'] for r in small.values())} launches, ms "
            f"{min(r['ms'] for r in small.values()):.6f}-{max(r['ms'] for r in small.values()):.6f}, "
            f"sum of launches x (ms - bound_ms) "
            f"{sum(r['launches'] * (r['ms'] - r['bound_ms']) for r in small.values()):.3f} ms")
    loss = sum(r["launches"] * (r["ms"] - r["bound_ms"]) for r in rows.values())
    log(f"kmeans_assign: {sum(r['launches'] for r in rows.values())} launches over {len(rows)} "
        f"shapes, each equal to the plain version; sum of launches x (ms - bound_ms) {loss:.3f} ms")
    return rows


def assign_crossover(torch, km_mod, gen, dev) -> dict:
    """kmeans_assign's CUDA-core path (small_c = C: the byte-bound path on
    rows wider than NARROW_D floats, the narrow-row path on narrower ones)
    against the tensor cores (small_c = 0), device time: C 8, 16 and 32 on
    rows of the slice builds' 2,048 at d 768 down to 16, and C 8 to 256 on
    131,072 x 16 (a PQ subspace's rows).  The default rule (every C at
    d <= NARROW_D; else C <= ``kSmallC`` with d >= ``kRowFloatsPerC`` x C)
    should sit where the faster path changes."""
    out = {}
    shapes = [(SLICE_ROWS, c, d) for d in (DIM, 128, 64, 32, 16) for c in (8, 16, 32)]
    shapes += [(SEG_ROWS, c, 16) for c in (8, 16, 32, 256)]
    for n, c, d in shapes:
        x = torch.randn((n, d), generator=gen, device=dev)
        cent = torch.randn((c, d), generator=gen, device=dev)
        cores = device_ms(torch, lambda: km_mod.kmeans_assign(x, cent, small_c=c), 50)
        tc = device_ms(torch, lambda: km_mod.kmeans_assign(x, cent, small_c=0), 50)
        name = "narrow rows" if d <= km_mod.NARROW_D else "byte-bound"
        out[f"N={n} C={c} D={d}"] = {"cuda_core_ms": cores, "tensor_core_ms": tc,
                                     "faster": name if cores < tc else "tensor cores"}
    log("kmeans_assign score paths: " + json.dumps(out))
    return out


def expert_mlp_plain(torch, rows, offsets, w_gate, w_up, w_down, row_scale):
    """``moe.expert_mlp`` one expert at a time: float32 products of the bf16
    operands, each step rounded to bf16 where the grouped path rounds."""
    F = torch.nn.functional
    y = torch.empty((rows.shape[0], w_down.shape[2]), dtype=rows.dtype, device=rows.device)
    bounds = offsets.tolist()
    for e in range(w_gate.shape[0]):
        lo, hi = bounds[e], bounds[e + 1]
        if hi > lo:
            r = rows[lo:hi].float()
            h = F.silu((r @ w_gate[e].float()).bfloat16()) * (r @ w_up[e].float()).bfloat16()
            y[lo:hi] = ((h * row_scale[lo:hi, None].bfloat16()).float() @ w_down[e].float()).bfloat16()
    return y


def dropless_moe_phase(torch, dev, gen) -> dict:
    """The dropless MoE layer's expert products at the main path's shapes
    (module docstring, item 13): its row of the kernel line."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import moe as moe_mod
    from repro_torch.models.config import ModelConfig

    t, d, f, e = MOE_TOKENS * MOE_TOP_K, MOE_D, MOE_F, MOE_EXPERTS
    w_gate, w_up = ((torch.randn(e, d, f, device=dev, generator=gen) / d ** 0.5).bfloat16() for _ in range(2))
    w_down = (torch.randn(e, f, d, device=dev, generator=gen) / f ** 0.5).bfloat16()
    rows = torch.randn(t, d, device=dev, generator=gen).bfloat16()
    scale = torch.rand(t, device=dev, generator=gen)
    grouped = {"calls": 0}
    library = torch._grouped_mm

    def counted(a, b, **kw):
        grouped["calls"] += 1
        return library(a, b, **kw)

    def offsets_of(load):
        if load == "router":
            tokens = torch.randn(MOE_TOKENS, d, device=dev, generator=gen)
            router = torch.randn(d, e, device=dev, generator=gen) / d ** 0.5
            idx = torch.topk(torch.softmax(tokens @ router, -1), MOE_TOP_K, -1).indices.reshape(-1)
        elif load == "one_expert":
            idx = torch.full((t,), 13, device=dev)
        else:
            idx = torch.randint(0, e // 2, (t,), device=dev, generator=gen) * 2
        return torch.searchsorted(torch.sort(idx).values, torch.arange(e + 1, device=dev))

    def run(offsets):
        return moe_mod.expert_mlp(rows, offsets, w_gate, w_up, w_down, scale)

    def kernels_of(offsets) -> collections.Counter:
        # torch.profiler drops a window's kernel records now and then in a
        # long process (``device_ms``): up to three tries, else none
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                run(offsets)
                torch.cuda.synchronize()
            names = collections.Counter(ev.name for ev in prof.events() if ev.device_type == DeviceType.CUDA)
            if names:
                break
        return names

    max_err, kernel_counts = 0.0, {}
    torch._grouped_mm = counted
    try:
        for load in MOE_LOADS:
            offsets = offsets_of(load)
            run(offsets)
            torch.cuda.synchronize()
            grouped["calls"] = 0
            torch.cuda.set_sync_debug_mode("error")
            try:
                y = run(offsets)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            grouped_calls = grouped["calls"]
            names = kernels_of(offsets)
            kernel_counts[load] = sum(names.values())
            want = expert_mlp_plain(torch, rows, offsets, w_gate, w_up, w_down, scale)
            err = float((y.float() - want.float()).abs().max())
            top = float(want.float().abs().max())
            counts = offsets[1:] - offsets[:-1]
            log(f"dropless moe {load}: slots an expert max {int(counts.max())} min {int(counts.min())}; "
                f"|y - plain| max {err:.3e} (|y| max {top:.3e}); {grouped_calls} grouped products, "
                f"{kernel_counts[load]} kernels: " + "; ".join(f"{n[:90]} x{c}" for n, c in names.items()))
            assert grouped_calls == 3, f"dropless moe {load}: {grouped_calls} grouped products, not 3"
            assert err <= 2 * 2**-7 * top, f"dropless moe {load}: |y - plain| {err} over two bf16 ulps of {top}"
            max_err = max(max_err, err)
        recorded = {n for n in kernel_counts.values() if n}
        assert len(recorded) == 1, f"dropless moe: kernels per call vary with the load: {kernel_counts}"

        offsets = offsets_of("router")
        ends = offsets[1:].to(torch.int32)
        h = rows[:, :f].contiguous()
        ms = cuda_ms(torch, lambda: run(offsets), 20)
        library_ms = cuda_ms(torch, lambda: (library(rows, w_gate, offs=ends), library(rows, w_up, offs=ends),
                                             library(h, w_down, offs=ends)), 20)
        plain_ms = cuda_ms(torch, lambda: expert_mlp_plain(torch, rows, offsets, w_gate, w_up, w_down, scale), 3, 1)
        bound_ms = 3 * 2 * t * d * f / PEAK_BF16_FLOPS * 1e3

        # one whole layer at DeepSeek-V2-Lite's width
        port = json.loads((ROOT / "bench" / "configs" / "dsv2lite-embed-rag.json").read_text())["port_model"]
        cfg = ModelConfig(name="dsv2lite-smoke", **dict(port, num_layers=2))
        layer = moe_mod.MoE(cfg, gen, dev)
        x = torch.randn(32, 512, d, device=dev, generator=gen).bfloat16()
        with torch.no_grad():
            warm = moe_mod.moe_block(cfg, layer, x)
            torch.cuda.synchronize()
            grouped["calls"] = 0
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = moe_mod.moe_block(cfg, layer, x)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            layer_products = grouped["calls"]
            layer_ms = cuda_ms(torch, lambda: moe_mod.moe_block(cfg, layer, x), 10)
    finally:
        torch._grouped_mm = library
    assert layer_products == 3 and torch.equal(out, warm), \
        f"dropless moe: one layer made {layer_products} grouped products or changed its output"
    row = {"name": "expert_mlp", "route": "library (torch._grouped_mm)", "source": "src/repro_torch/models/moe.py",
           "replaces": None, "grouped_products_per_layer": 3, "kernels_per_call": recorded.pop(),
           "max_abs_err": max_err,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "operations",
           "library_ms": library_ms}
    log(f"dropless moe at {t} slots: expert_mlp {ms:.4f} ms ({bound_ms / ms:.3f} of its bound {bound_ms:.4f} ms), "
        f"the three grouped products alone {library_ms:.4f} ms, the per-expert loop {plain_ms:.3f} ms; one "
        f"layer of 32 x 512 tokens {layer_ms:.3f} ms, 3 grouped products, no readback")
    return row


def card_info(torch) -> dict:
    """SM count and the largest SM clock (``nvidia-smi``), for the shared
    memory lookup rate."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    mhz = float(smi.stdout.strip().splitlines()[0].split()[0])
    return {"sms": torch.cuda.get_device_properties(0).multi_processor_count,
            "sm_clock_hz": mhz * 1e6}


def merge_pool(torch, gen, dev, nq: int, m: int, k: int):
    """A seeded pool with the main path's structure: ceil(M / k)
    concatenated partials of k columns, each sorted ascending, pks drawn
    from 2M values (so pks repeat across partials), the last 5% of each
    partial dead (+inf, pk -1) as a partial's missing slots are."""
    s = torch.randn((nq, m), generator=gen, device=dev).abs()
    p = torch.randint(0, 2 * m, (nq, m), generator=gen, device=dev)
    for lo in range(0, m, k):
        hi = min(lo + k, m)
        s[:, lo:hi] = torch.sort(s[:, lo:hi], dim=1).values
        dead = hi - max(1, (hi - lo) // 20)
        s[:, dead:hi] = float("inf")
        p[:, dead:hi] = -1
    return s, p


def empty_kernel_ms(torch) -> float:
    """Device time per launch of a kernel that does nothing
    (``torch.cuda._sleep(0)``), queued as ``device_ms`` queues the kernels:
    the floor under a launch-bound kernel."""
    return device_ms(torch, lambda: torch.cuda._sleep(0), 200)


def merge_shape_times(torch, merge_mod, shapes: dict, gen, dev, floor_ms: float) -> dict:
    """merge_topk at every (nq, M, k) the paths launched it at, on a
    ``merge_pool`` of that shape: device time of the kernel and of the
    plain version (``device_ms``), the kernel's CUDA-event time, the bytes
    bound (12 bytes per candidate read and per slot written) and the
    empty-kernel floor.  Logs each row and the sum of launches x (time -
    bound) over the shapes."""
    rows = {}
    for (nq, m, k), launches in sorted(shapes.items(), key=lambda kv: -kv[1]):
        s, p = merge_pool(torch, gen, dev, nq, m, k)
        row = {
            "launches": launches,
            "ms": device_ms(torch, lambda: merge_mod.merge_topk(s, p, k, "l2"), 100),
            "event_ms": cuda_ms(torch, lambda: merge_mod.merge_topk(s, p, k, "l2"), 100),
            "plain_ms": device_ms(torch, lambda: merge_mod.merge_topk_plain(s, p, k, "l2"), 5),
            "bound_ms": 12 * nq * (m + k) / PEAK_BYTES_S * 1e3, "bound_by": "bytes",
            "floor_ms": floor_ms, "library_ms": None,
        }
        rows[(nq, m, k)] = row
        log(f"merge_topk nq={nq} M={m} k={k}: " + json.dumps(row))
    loss = sum(r["launches"] * (r["ms"] - r["bound_ms"]) for r in rows.values())
    log(f"merge_topk: {sum(r['launches'] for r in rows.values())} launches over {len(rows)} shapes; "
        f"sum of launches x (ms - bound_ms) {loss:.3f} ms; empty-kernel floor {floor_ms:.5f} ms")
    return rows


def decode_shape_times(torch, sq_mod, shapes: dict, gen, dev) -> dict:
    """sq_decode at every (n, d) the paths launched it at (``_decoded_norms``
    decodes 65,536-row chunks), on seeded codes of that shape: device time
    of the kernel, the plain version and ``torch.addcmul`` of the same
    function (``device_ms``), the kernel's CUDA-event time and the bytes
    bound (1 byte in and 4 out per element, vmin and vmax read once)."""
    rows = {}
    for (n, d), launches in sorted(shapes.items(), key=lambda kv: -kv[1]):
        codes = torch.randint(0, 256, (n, d), generator=gen, device=dev, dtype=torch.uint8)
        vmin = torch.randn(d, generator=gen, device=dev)
        vmax = vmin + 4 * torch.rand(d, generator=gen, device=dev)
        scale = sq_mod.sq_scale(vmin, vmax)
        t_b, t_o = (5 * n * d + 8 * d) / PEAK_BYTES_S, 2 * n * d / PEAK_F32_FLOPS
        row = {
            "launches": launches,
            "ms": device_ms(torch, lambda: sq_mod.sq_decode(codes, vmin, vmax), 50),
            "event_ms": cuda_ms(torch, lambda: sq_mod.sq_decode(codes, vmin, vmax), 50),
            "plain_ms": device_ms(torch, lambda: sq_mod.sq_decode_plain(codes, vmin, vmax), 20),
            "library_ms": device_ms(
                torch, lambda: torch.addcmul(vmin[None, :], codes.float(), scale[None, :]), 20),
            "bound_ms": max(t_b, t_o) * 1e3, "bound_by": "bytes" if t_b >= t_o else "operations",
        }
        rows[(n, d)] = row
        log(f"sq_decode N={n} D={d} uint8: " + json.dumps(row))
    return rows


class LaunchCounts:
    """The kernel wrappers' launch counters, set to 0 before a path runs
    and read after it; and ``shapes``, the launches of four kernels per
    call shape, counted by wrapping the op through which the port calls
    each (the wrappers' own counters are unchanged): ``kmeans_assign`` per
    (N, C, D) (``ops.kmeans_assign``), ``merge_topk`` per (nq, M, k) (one
    launch of ``ops.merge_topk``, which chunks pools wider than the kernel
    takes), ``sq_decode`` per (n, d) (``ops.sq_decode``) and ``l2_topk``
    per (nq, rows per segment, D, k, metric) (``ops.l2_topk``).  A shape is
    counted by the launches the calling thread made inside the op
    (``_build.thread_launches``), so a threaded system's pump and build
    threads launching beside it add nothing to it; each kernel's shapes
    must add up to its launches: a launch that bypassed the op shows."""

    SHAPED = {"kmeans_assign": "kmeans_assign", "merge_topk": "_merge_topk", "sq_decode": "sq_decode",
              "l2_topk": "l2_topk"}
    # The widths at which scan_shape_times times l2_topk per shape: an
    # embedder's (the other widths' scans are timed in their own phases).
    SCAN_SHAPE_D = (4_096,)

    def __init__(self, wrappers: dict, ops, build):
        self.wrappers = wrappers
        self.shapes = {kname: collections.Counter() for kname in self.SHAPED}
        for kname, attr in self.SHAPED.items():
            setattr(ops, attr, self._counted(kname, getattr(ops, attr), build.thread_launches))

    def _counted(self, kname: str, op, thread_launches):
        wrapper, counter = self.wrappers[kname], self.shapes[kname]

        def shape_of(args):
            if kname == "kmeans_assign":  # (x, centroids)
                return (args[0].shape[0], args[1].shape[0], args[0].shape[1])
            if kname == "merge_topk":  # (scores, pks, k, ...)
                return (args[0].shape[0], args[0].shape[1], args[2])
            if kname == "l2_topk":  # (queries, bases, valids, k, metric)
                return (args[0].shape[0], tuple(b.shape[0] for b in args[1]), args[0].shape[1],
                        args[3], args[4])
            return tuple(args[0].shape)  # sq_decode: (codes, vmin, vmax)

        def counted(*args, **kwargs):
            before = thread_launches(wrapper)
            out = op(*args, **kwargs)
            made = thread_launches(wrapper) - before
            if made:
                counter[shape_of(args)] += made
            return out

        return counted

    def reset(self) -> None:
        for fn in self.wrappers.values():
            fn.launches = 0
        assign = self.wrappers["kmeans_assign"]
        assign.path_launches = dict.fromkeys(assign.path_launches, 0)
        for counter in self.shapes.values():
            counter.clear()

    def read_shapes(self, launches: dict, label: str, paths_taken) -> dict:
        """The shapes counted since the reset, per kernel, each adding up to
        the kernel's launches; logs them with ``kmeans_assign``'s launches
        per score path, of which the path must have taken each in
        ``paths_taken``."""
        for kname, counter in self.shapes.items():
            if sum(counter.values()) != launches[kname]:
                raise AssertionError(f"{label} path: {kname} launched {launches[kname]} times, "
                                     f"{sum(counter.values())} of them through the op")
            if kname == "l2_topk":  # one shape per segment-row tuple: summed per width
                per_d = collections.Counter()
                for shape, n in counter.items():
                    per_d[shape[2]] += n
                log(f"{label} path: l2_topk launches over {len(counter)} shapes, per width "
                    + json.dumps({str(d): n for d, n in sorted(per_d.items())}))
                continue
            log(f"{label} path: {kname} launches per shape "
                + json.dumps({str(k): v for k, v in sorted(counter.items())}))
        paths = self.wrappers["kmeans_assign"].path_launches
        log(f"{label} path: kmeans_assign launches per score path {paths}")
        if any(paths[p] <= 0 for p in paths_taken):
            raise AssertionError(f"kmeans_assign did not take each of {paths_taken} on the {label} path")
        return {kname: counter.copy() for kname, counter in self.shapes.items()}

    def read(self) -> dict:
        return {name: fn.launches for name, fn in self.wrappers.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from the root of a checkout (src/repro_torch missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.core import log as wal
    from repro_torch.core.collection import Metric
    from repro_torch.core.consistency import GuaranteeTs
    from repro_torch.core.object_store import MemoryObjectStore
    from repro_torch.core.query_node import QueryNode
    from repro_torch.core.request import AnnsQuery, NodeSearchRequest
    from repro_torch import testing
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import kmeans_assign as km_mod
    from repro_torch.kernels import l2_topk as l2_mod
    from repro_torch.kernels import merge_topk as merge_mod
    from repro_torch.kernels import pq_adc as pq_mod
    from repro_torch.kernels import sq_codec as sq_mod
    from repro_torch.testing import SCORE_TOL, assert_scan_close

    counts = LaunchCounts({
        "l2_topk": l2_mod.l2_topk, "merge_topk": merge_mod.merge_topk,
        "kmeans_assign": km_mod.kmeans_assign, "sq_encode": sq_mod.sq_encode,
        "sq_decode": sq_mod.sq_decode, "sq_l2_topk": sq_mod.sq_l2_topk,
        "pq_adc_topk": pq_mod.pq_adc_topk,
    }, ops, _build)
    card = card_info(torch)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    phases: dict[str, float] = {}

    t0 = time.perf_counter()
    for name, text in _build.build_all().items():
        log(f"nvcc {name}: " + " | ".join(
            ln.strip() for ln in text.splitlines() if "registers" in ln or "spill" in ln
        ))
    phases["build_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    max_err = kernel_phase(torch, l2_mod, merge_mod, ops, assert_scan_close, SCORE_TOL, dev, gen)
    max_err.update(index_kernel_phase(torch, km_mod, sq_mod, pq_mod, testing, dev, gen))
    scan_err = scan_redesign_phase(torch, l2_mod, sq_mod, pq_mod, testing, dev, gen)
    wide_rows_phase(torch, l2_mod, sq_mod, gen, dev)
    model_tie_phase(testing, dev)
    for kname in ("l2_topk", "sq_l2_topk"):
        max_err[kname] = max([max_err[kname]] + [v for k, v in scan_err.items()
                                                 if k.startswith(kname + " ") and "plain" in k])
    log("tensor-core instructions in the built libraries (cuobjdump -sass): "
        + json.dumps(tensor_core_counts(_build)))
    phases["kernel_phase_s"] = time.perf_counter() - t0

    # ---------------------------------------------------------- main path
    t0 = time.perf_counter()
    store = MemoryObjectStore()
    colls = {"vdb_l2": Metric.L2, "vdb_cosine": Metric.COSINE}
    data = {name: build_collection(torch, store, gen, dev, name, m) for name, m in colls.items()}
    torch.cuda.synchronize()
    phases["data_and_binlog_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    broker = wal.LogBroker()
    broker.create_channel("coord")
    nodes = {
        # slice_rows above any growing segment: the interim index is off here
        nid: QueryNode(nid, broker, store, slice_rows=N_ROWS, device=dev)
        for nid in ("qn-a", "qn-b")
    }
    for name in colls:
        for nid, sids in (("qn-a", NODE_A), ("qn-b", NODE_B)):
            for s in sids:
                nodes[nid].load_sealed(name, s)
                if s in FLAT_SEGMENTS:
                    nodes[nid].load_index(name, s, "flat", f"index/{name}/{s}/vector/flat")
    torch.cuda.synchronize()
    phases["load_sealed_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    tail = N_SEALED * SEG_ROWS
    deleted = {}
    for name in colls:
        ch = wal.dml_channel(name, 0)
        broker.create_channel(ch)
        nodes["qn-b"].subscribe(ch)
        x_tail = data[name][tail:].cpu().numpy()
        for j, lo in enumerate(range(0, len(x_tail), INSERT_BATCH)):
            hi = min(lo + INSERT_BATCH, len(x_tail))
            broker.publish(ch, wal.LogEntry(TS_GROW + j, wal.EntryType.INSERT, {
                "collection": name, "segment_id": N_SEALED, "shard": 0,
                "pk": np.arange(tail + lo, tail + hi), "vector": x_tail[lo:hi],
            }))
    for node in nodes.values():
        node.step()
    for i, name in enumerate(colls):
        doomed = torch.randperm(N_ROWS, generator=gen, device=dev)[: int(N_ROWS * DELETE_FRAC)]
        deleted[name] = doomed
        pk = doomed.cpu().numpy()
        broker.publish(wal.dml_channel(name, 0),
                       wal.LogEntry(TS_DELETE + i, wal.EntryType.DELETE, {"collection": name, "pk": pk}))
        broker.publish("coord", wal.LogEntry(TS_DELETE + i, wal.EntryType.COORD,
                                             {"msg": "tombstones", "collection": name, "pk": pk}))
    for node in nodes.values():
        node.step()
    torch.cuda.synchronize()
    phases["ingest_and_delete_s"] = time.perf_counter() - t0
    if sum(seg.num_rows for seg in nodes["qn-b"].growing.values()) != 2 * (N_ROWS - tail):
        raise AssertionError("the growing segments did not take every WAL insert")

    def request(name, metric, q, ts):
        mstr = "l2" if metric is Metric.L2 else "ip"
        parts = [
            node.search_request(NodeSearchRequest(
                collection=name, k=K, metric=metric,
                guarantee=GuaranteeTs(query_ts=ts, staleness_ms=float("inf")),
                anns=[AnnsQuery("vector", q)],
            ))[0]
            for node in nodes.values()
        ]
        return ops.merge_topk(torch.cat([p[0] for p in parts], 1),
                              torch.cat([p[1] for p in parts], 1), K, metric=mstr)

    queries = {nq: torch.randn((nq, DIM), generator=gen, device=dev) for nq in (1, 100)}
    reps = {1: 20, 100: 5}
    latency: dict[str, list[float]] = {}
    results = {}
    counts.reset()
    t0 = time.perf_counter()
    for name, metric in colls.items():
        for nq, q in queries.items():
            for pin, ts in (("before", TS_BEFORE), ("after", TS_AFTER)):
                times = []
                for _ in range(reps[nq] + 1):  # first call is the warm-up
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    out = request(name, metric, q, ts)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t1) * 1e3)
                latency[f"{name} nq={nq} {pin}"] = times
                results[(name, nq, pin)] = out
    phases["requests_s"] = time.perf_counter() - t0
    flat_launches = counts.read()
    flat_shapes = counts.read_shapes(flat_launches, "FLAT", ())
    log(f"FLAT path launches: {flat_launches}")
    for kname in ("l2_topk", "merge_topk"):
        if flat_launches[kname] <= 0:
            raise AssertionError(f"{kname} was not launched on the FLAT path")

    # ------------------------------------------------ exact-answer check
    t0 = time.perf_counter()
    for name, metric in colls.items():
        x = data[name]
        cosine = metric is Metric.COSINE
        rtol, atol = SCORE_TOL["cosine" if cosine else "l2"]
        if cosine:
            x = x / torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp_min(1e-12)
        x_norm = (x * x).sum(1)
        for (rname, nq, pin), (got_s, got_p) in results.items():
            if rname != name:
                continue
            q = queries[nq]
            if cosine:
                q = q / torch.linalg.vector_norm(q, dim=1, keepdim=True).clamp_min(1e-12)
                scores = q @ x.T
            else:
                scores = ((q * q).sum(1, keepdim=True) - 2.0 * (q @ x.T)) + x_norm[None, :]
            if pin == "after":
                scores[:, deleted[name]] = float("-inf") if cosine else float("inf")
            want_s, want_p = torch.topk(scores, K, dim=1, largest=cosine)
            if got_s.shape != (nq, K) or got_p.dtype != torch.int64 or not torch.isfinite(got_s).all():
                raise AssertionError(f"{name} nq={nq} {pin}: malformed result")
            if pin == "after" and torch.isin(got_p, deleted[name]).any():
                raise AssertionError(f"{name}: a deleted pk was returned")
            torch.testing.assert_close(got_s, want_s, rtol=rtol, atol=atol)
            diff = got_p != want_p
            if diff.any():
                qi, slot = torch.nonzero(diff, as_tuple=True)
                torch.testing.assert_close(
                    scores[qi, got_p[qi, slot]], want_s[qi, slot], rtol=rtol, atol=atol
                )
            msg = (f"check {name} nq={nq} {pin}: ok (rtol={rtol}, atol={atol}; max |err| "
                   f"{(got_s - want_s).abs().max().item():.3g}; {int(diff.sum())} near-tie swaps)")
            del scores
            if nq == 100 and pin == "before":  # every row visible: the TF32 control
                msg += f"; TF32 product fails it, max |err| {tf32_control(torch, q, x, want_s, cosine, rtol, atol):.3g}"
            log(msg)
        del x, x_norm
    phases["verify_s"] = time.perf_counter() - t0

    # ------------------------------------- where one request's time goes
    t0 = time.perf_counter()
    for nq, pin, ts in ((1, "before", TS_BEFORE), (1, "after", TS_AFTER), (100, "after", TS_AFTER)):
        profile_request(torch, lambda: request("vdb_l2", Metric.L2, queries[nq], ts),
                        f"vdb_l2 nq={nq} {pin}")
    phases["profile_s"] = time.perf_counter() - t0

    # ------------------------------------------------------- indexed path
    mods = {"wal": wal, "Metric": Metric, "GuaranteeTs": GuaranteeTs, "AnnsQuery": AnnsQuery,
            "NodeSearchRequest": NodeSearchRequest, "ops": ops}
    run = indexed_path(torch, mods, gen, dev, phases, counts)
    check_indexed(torch, run, testing, dev, phases)
    t0 = time.perf_counter()
    for nq in (1, 100):
        profile_request(torch, lambda: run["request"](run["queries"][nq], TS_AFTER),
                        f"{run['name']} nq={nq} after")
    phases["ivf_profile_s"] = time.perf_counter() - t0

    # ------------------------------------------- kernel times at path shapes
    t0 = time.perf_counter()
    x = data["vdb_l2"]
    bases = [x[s * SEG_ROWS:(s + 1) * SEG_ROWS] for s in range(N_SEALED)] + [x[tail:]]
    valids = [torch.ones(b.shape[0], dtype=torch.bool, device=dev) for b in bases]
    kt = {}
    # nq 4 / 8 / 16 on each side of the small-nq path's threshold
    scan_queries = {**queries, **{nq: torch.randn((nq, DIM), generator=gen, device=dev) for nq in (4, 8, 16)}}
    for nq, q in sorted(scan_queries.items()):
        reps_k = 20 if nq < 100 else 10
        kt[nq] = {
            "ms": cuda_ms(torch, lambda: l2_mod.l2_topk(q, bases, valids, K, "l2"), reps_k),
            "plain_ms": cuda_ms(torch, lambda: l2_mod.l2_topk_plain(q, bases, valids, K, "l2"), reps_k),
            "library_ms": cuda_ms(
                torch, lambda: torch.topk(q @ x.T, K, dim=1), reps_k
            ),
        }
        kt[nq].update(scan_bound(nq, 4 * nq * DIM + 4 * N_ROWS * DIM + N_ROWS + 12 * nq * len(bases) * K,
                                 N_ROWS, DIM, 2 * nq * N_ROWS * DIM + 2 * N_ROWS * DIM + 2 * nq * DIM))
        log(f"l2_topk nq={nq} over {N_ROWS} x {DIM}, k={K}: " + json.dumps(kt[nq]))
    path_crossover(torch, f"l2_topk over {N_ROWS} x {DIM}",
                   lambda q, sq: l2_mod.l2_topk(q, bases, valids, K, "l2", small_q=sq), DIM, gen, dev)
    it = index_kernel_times(torch, run, sq_mod, pq_mod, dev, gen, card)
    phases["kernel_timing_s"] = time.perf_counter() - t0
    per = {k: n / run["n_requests"] for k, n in run["launches"].items()}
    log(f"indexed path launches per request (builds and slice indexes included): {per}")
    ivf_latency, ivf_launches, ivf_shapes = run["latency"], run["launches"], run["shapes"]
    del data, nodes, broker, store, bases, valids, x, results
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------------------------- index-family path
    fam = index_family_path(torch, mods, run, gen, dev, phases, counts)
    check_family(torch, fam, testing, dev, phases)
    t0 = time.perf_counter()
    for name in FAMILY:
        for nq in (1, 100):
            profile_request(torch, lambda: fam["request"](name, run["queries"][nq]),
                            f"{name} nq={nq} after")
    phases["family_profile_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    bucket_scan = bucket_scan_time(torch, fam, run["queries"][1], sq_mod, ops, testing)
    max_err["sq_l2_topk"] = max(max_err["sq_l2_topk"], bucket_scan["max_abs_err"])
    phases["kernel_timing_s"] += time.perf_counter() - t0
    fam_latency, fam_launches, fam_shapes = fam["latency"], fam["launches"], fam["shapes"]
    # The earlier paths' tables, stores and nodes go before the facade's.
    del run, fam
    gc.collect()
    torch.cuda.empty_cache()

    # ---------------------------------------------------- facade path
    fac = facade_path(torch, gen, dev, phases, counts, testing)
    # ----------------------------------------------- maintenance path
    maint = maintenance_path(torch, fac, gen, dev, phases, counts, testing)
    del fac["manu"], fac["coll"], fac["x"]
    gc.collect()
    torch.cuda.empty_cache()
    # ------------------------------------------------------ embedder path
    emb = embedder_path(torch, gen, dev, phases, counts, testing, args.seed)
    del emb["model"]
    gc.collect()
    torch.cuda.empty_cache()
    # ------------------------------------------------------ dropless MoE
    t0 = time.perf_counter()
    moe_row = dropless_moe_phase(torch, dev, gen)
    phases["dropless_moe_s"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    # --------------------------------------------------------- serve path
    serve_path(torch, dev, phases, counts, testing, args.seed)
    # --------------------------------------------------------- train path
    train_path(torch, dev, phases, counts, testing, args.seed)
    # --------------------------------------------------- distributed path
    dpath = distributed_path(torch, dev, gen, phases, counts, testing, args.seed)
    max_err["l2_topk"] = max(max_err["l2_topk"], dpath["max_abs_err"])
    # ------------------------------------------------ sharded cells path
    cells = sharded_cells_path(torch, dev, gen, phases, counts, testing, args.seed)
    # ------------------------------------------------------ examples path
    examples = examples_path(torch, phases, counts)
    t0 = time.perf_counter()
    # merge_topk, sq_decode and kmeans_assign at every shape the paths
    # launched them at (FLAT builds none and decodes none)
    shapes = {kname: sum((src[kname] for src in (flat_shapes, ivf_shapes, fam_shapes, fac["shapes"],
                                                 maint["shapes"], emb["shapes"], dpath["shapes"],
                                                 examples["shapes"])),
                         collections.Counter())
              for kname in LaunchCounts.SHAPED}
    floor_ms = empty_kernel_ms(torch)
    merge_rows = merge_shape_times(torch, merge_mod, shapes["merge_topk"], gen, dev, floor_ms)
    mt = max(merge_rows.values(), key=lambda r: r["launches"])  # the most launched shape
    decode_rows = decode_shape_times(torch, sq_mod, shapes["sq_decode"], gen, dev)
    it["sq_decode"] = decode_rows[(DECODE_CHUNK_ROWS, DIM)]
    assign_rows = assign_shape_times(torch, km_mod, testing, shapes["kmeans_assign"], gen, dev)
    scan_rows = scan_shape_times(torch, l2_mod, testing, {
        shape: n for shape, n in shapes["l2_topk"].items() if shape[2] in LaunchCounts.SCAN_SHAPE_D}, gen, dev)
    max_err["l2_topk"] = max([max_err["l2_topk"]] + [r["max_abs_err"] for r in scan_rows.values()])
    max_err["kmeans_assign"] = max([max_err["kmeans_assign"]]
                                   + [r["max_abs_err"] for r in assign_rows.values()])
    it["kmeans_assign"] = assign_rows[(KMEANS_SAMPLE, IVF_PARAMS["nlist"], DIM)]
    assign_crossover(torch, km_mod, gen, dev)
    phases["kernel_timing_s"] += time.perf_counter() - t0

    for key, times in {**latency, **ivf_latency, **fam_latency, **fac["latency"],
                       **maint["latency"], **emb["latency"], **dpath["latency"], **cells["latency"]}.items():
        steady = times[1:]
        log(f"request {key}: first {times[0]:.3f} ms, median {statistics.median(steady):.3f} ms "
            f"over {len(steady)} (min {min(steady):.3f}, max {max(steady):.3f})")
    log("phases: " + json.dumps({k: round(v, 3) for k, v in phases.items()}))

    launches = {k: flat_launches[k] + ivf_launches[k] + fam_launches[k] + fac["launches"][k]
                + maint["launches"][k] + emb["launches"][k] + dpath["launches"][k] + cells["launches"][k]
                + examples["launches"][k] for k in KERNEL_NAMES}

    def index_row(kname, key, replaces, source):
        row = it[key]
        return {
            "name": kname, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": replaces, "launches": launches[kname], "max_abs_err": max_err[kname],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        }

    kernels = [
        {
            "name": "l2_topk", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/l2_topk.cu",
            "replaces": "src/repro/kernels/l2_topk.py:91",
            "launches": launches["l2_topk"], "max_abs_err": max_err["l2_topk"],
            "ms": kt[100]["ms"], "plain_ms": kt[100]["plain_ms"], "bound_ms": kt[100]["bound_ms"],
            "bound_by": kt[100]["bound_by"], "library_ms": kt[100]["library_ms"],
        },
        {
            "name": "merge_topk", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/merge_topk.cu",
            "replaces": "src/repro/kernels/merge_topk.py:77",
            "launches": launches["merge_topk"], "max_abs_err": max_err["merge_topk"],
            "ms": mt["ms"], "plain_ms": mt["plain_ms"], "bound_ms": mt["bound_ms"],
            "bound_by": mt["bound_by"], "library_ms": None,
        },
        index_row("kmeans_assign", "kmeans_assign", "src/repro/kernels/kmeans_assign.py:67",
                  "kmeans_assign.cu"),
        index_row("sq_encode", "sq_encode", "src/repro/kernels/sq_codec.py:49", "sq_codec.cu"),
        index_row("sq_decode", "sq_decode", "src/repro/kernels/sq_codec.py:70", "sq_codec.cu"),
        index_row("sq_l2_topk", "sq_l2_topk nq=100", "src/repro/kernels/sq_codec.py:145",
                  "sq_codec.cu"),
        index_row("pq_adc_topk", "pq_adc_topk nq=100", "src/repro/kernels/pq_adc.py:84",
                  "pq_adc.cu"),
    ]
    loss_rows = list(kernels)
    kernels.append(moe_row)
    # Where the main path loses most to the bounds: launches x (time - bound)
    # per kernel, kmeans_assign summed over its shapes.
    loss = {row["name"]: row["launches"] * (row["ms"] - row["bound_ms"]) for row in loss_rows}
    for kname, rows in (("kmeans_assign", assign_rows), ("merge_topk", merge_rows),
                        ("sq_decode", decode_rows)):
        loss[kname] = sum(r["launches"] * (r["ms"] - r["bound_ms"]) for r in rows.values())
    # l2_topk: the d 4,096 launches at their own shapes, the rest at nq=100
    # over 1M rows
    wide = sum(r["launches"] for r in scan_rows.values())
    loss["l2_topk"] = ((launches["l2_topk"] - wide) * (kt[100]["ms"] - kt[100]["bound_ms"])
                       + sum(r["launches"] * (r["ms"] - r["bound_ms"]) for r in scan_rows.values()))
    # sq_l2_topk: the indexed path's launches at its segment (taken at
    # nq=100), the bucket searches' at a bucket query's probed buckets
    sq_row = it["sq_l2_topk nq=100"]
    loss["sq_l2_topk"] = (ivf_launches["sq_l2_topk"] * (sq_row["ms"] - sq_row["bound_ms"])
                          + fam_launches["sq_l2_topk"] * (bucket_scan["ms"] - bucket_scan["bound_ms"]))
    log("launches x (ms - bound_ms) per kernel: "
        + json.dumps(dict(sorted(loss.items(), key=lambda kv: -kv[1]))))
    print(json.dumps({"kernels": kernels}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: no output", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # report the failing phase and exit non-zero, no result line
        traceback.print_exc()
        sys.exit(1)
