"""The port's distributed layer on gloo, at world 2 and 4, on the CPU.

Each rank is a subprocess (``tests/_torch_dist_worker.py``) joined through
a ``FileStore`` under the test's ``tmp_path`` (no port to collide under
``pytest -n``), each given a timeout.  Held:

- distributed search over 999 x 24 rows (the uneven, padded path), k=10,
  L2 and IP: the same answer on every rank, ids equal to a float64 brute
  force outside near-ties and to the reference's ``distributed_search_host``
  on one device, scores within ``testing.SCORE_TOL``;
- GQA and MLA flash decode against the dense decode on the reference
  test's shapes (``tests/test_distributed.py:42,78``), float32, at rtol =
  atol = 2e-4 (the reference's bound), each rank's cache slice equal to the
  dense cache's;
- both through ``decode_step`` for 16 steps on reduced yi-9b and
  minicpm3-4b (bf16): logits within 2e-2 of the dense decode's;
- the expert-parallel MoE block against the dense one
  (``tests/test_distributed.py:150``; qwen3-moe-30b-a3b and, with shared
  experts, deepseek-moe-16b): within 2e-2 (the reference's bound); and it
  trains: its gradients within ``testing.GRAD_RTOL`` of the dense block's
  (a backward that summed the replicated gradients over the ranks would
  give world times them).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (the reference's import order)
from repro.distributed.search import distributed_search_host as ref_search  # noqa: E402
from repro_torch.testing import GRAD_RTOL, SCORE_TOL  # noqa: E402

HERE = os.path.dirname(__file__)
SRC = os.path.join(HERE, "..", "src")
WORKER = os.path.join(HERE, "_torch_dist_worker.py")
WORLDS = (2, 4)
RANK_TIMEOUT_S = 150


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def ranks(request, tmp_path_factory):
    """Every rank's saved results, for one world size."""
    world = request.param
    tmp = tmp_path_factory.mktemp(f"gloo{world}")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(world), str(tmp / "rendezvous"), str(tmp)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {world} exited {p.returncode}:\n{log}"
    return world, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_distributed_search_matches_bruteforce_and_reference(ranks, metric):
    world, outs = ranks
    rng = np.random.default_rng(0)
    base = rng.standard_normal((999, 24)).astype(np.float32)
    q = rng.standard_normal((4, 24)).astype(np.float32)
    got_s, got_i = outs[0][f"search_{metric}_s"], outs[0][f"search_{metric}_i"]
    for out in outs[1:]:  # every rank holds the same answer
        np.testing.assert_array_equal(out[f"search_{metric}_i"], got_i)
        np.testing.assert_array_equal(out[f"search_{metric}_s"], got_s)
    qd, xd = q.astype(np.float64), base.astype(np.float64)
    exact = ((qd * qd).sum(1, keepdims=True) - 2 * qd @ xd.T + (xd * xd).sum(1)) if metric == "l2" else qd @ xd.T
    order = np.argsort(exact if metric == "l2" else -exact, axis=1, kind="stable")[:, :10]
    want_s = np.take_along_axis(exact, order, 1)
    rtol, atol = SCORE_TOL[metric]
    np.testing.assert_allclose(got_s, want_s, rtol=rtol, atol=atol)
    # ids exact outside near-ties: a differing id scores within the tolerance
    diff = got_i != order
    np.testing.assert_allclose(np.take_along_axis(exact, got_i, 1)[diff], want_s[diff], rtol=rtol, atol=atol)
    ref_s, ref_i = ref_search(q, base, 10, metric)
    np.testing.assert_allclose(got_s, ref_s, rtol=rtol, atol=atol)
    np.testing.assert_array_equal(np.sort(got_i, 1), np.sort(ref_i, 1))


@pytest.mark.parametrize("case", ["gqa17", "gqa0", "gqa31", "mla9", "mla31"])
def test_flash_decode_matches_dense(ranks, case):
    _world, outs = ranks
    for out in outs:
        got, want = out[case]
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
        got_c, want_c = out[case + "_cache"]
        np.testing.assert_array_equal(got_c, want_c)


@pytest.mark.parametrize("name", ["yi-9b", "minicpm3-4b"])
def test_flash_decode_through_decode_step(ranks, name):
    _world, outs = ranks
    for out in outs:
        got, want = out[f"decode_{name}"]
        assert np.isfinite(got).all() and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "deepseek-moe-16b"])
def test_expert_parallel_moe_matches_dense(ranks, name):
    _world, outs = ranks
    for out in outs:
        got, want, dense_in_scope = out[f"moe_{name}"]
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
        np.testing.assert_array_equal(dense_in_scope, want)  # moe_impl="dense" keeps the dense block


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "deepseek-moe-16b"])
def test_expert_parallel_moe_trains(ranks, name):
    """The expert-parallel block's gradients (x, router, shared experts as
    each rank has them; the experts' summed over the ranks) equal the dense
    block's within ``testing.GRAD_RTOL``: a backward that summed the
    replicated gradients over the ranks would give world times them."""
    world, outs = ranks
    for out in outs:
        got, want = out[f"moe_{name}_grads"]
        assert np.isfinite(got).all()
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= GRAD_RTOL, (world, rel)
