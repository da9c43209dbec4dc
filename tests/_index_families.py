"""The index families a query node's planner can meet, for the tests that
plan and scan a unit with no visible row (``test_torch_planner.py`` against
the reference node, ``test_torch_trace.py`` on each device's kernels).

family -> (the plan class its unit lands in, the index kind and parameters
built over it, or None for a brute scan).  A growing slice's index is the
temporary one the node builds over the slice."""

FAMILIES = {
    "flat_brute": ("brute_sealed", None),
    "flat_indexed": ("indexed", ("flat", {})),
    "ivf_flat": ("indexed", ("ivf_flat", {"nlist": 4, "nprobe": 2})),
    "ivf_sq8": ("indexed", ("ivf_sq", {"nlist": 4, "nprobe": 2})),
    "ivf_pq": ("indexed", ("ivf_pq", {"nlist": 4, "nprobe": 2, "m": 4, "ksub": 16})),
    "hnsw": ("indexed", ("hnsw", {"m": 8, "ef_construction": 40, "ef_search": 32})),
    "bucket": ("indexed", ("bucket", {"target_bucket_rows": 48, "replicas": 2,
                                      "nprobe_buckets": 3})),
    "growing_slice": ("growing_slice", ("ivf_flat", {"nlist": 16, "nprobe": 4})),
    "growing_tail": ("brute_tail", None),
}
GROWING = ("growing_slice", "brute_tail")
