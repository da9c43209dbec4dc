"""The port's sharded cells (``repro_torch.launch.steps``) on gloo, on the
CPU: world 4 as a (2, 2) mesh and world 2 as (2, 1) and (1, 2).

Each rank is a subprocess (``tests/_torch_cells_worker.py``) joined through
a ``FileStore`` under the test's ``tmp_path``.  The reference's own sharded
step does not run under the installed jax (``tests/test_distributed.py::
test_small_mesh_train_step_executes``), so the cells are held to the
reference's unsharded numbers and to the port's one-device step:

- the train cell on the reference test's reduced yi-9b (seq 32, batch 4;
  ``tests/test_distributed.py:124-126``) with the reference's weights
  carried across: the first loss within ``testing.LOSS_ATOL`` of the
  port's one-device step and of the reference's ``lm_loss``, the
  gradients the first step's AdamW took (the ranks' shards put together)
  within ``testing.GRAD_RTOL`` of those the one-device step's took, the
  gradient norm within it too, the parameters and moments that update
  left equal to the whole AdamW update on those gradients, the
  parameters within ``testing.GRAD_RTOL`` of the one-device step's, and
  ``loss2 < loss1`` (the reference's assertion); the same with
  ``microbatches=2`` on the batch with every label kept, and at one
  microbatch on a batch whose data ranks hold different numbers of
  ignored labels (the loss is the global mean, not the mean of the ranks'
  means).  Micro-batching takes the mean of the micro-batches' means, as
  the reference does, and a rank's micro-batch is a slice of its own
  rows: with ignored labels spread unevenly, those means are over other
  groups of rows than the one-device step's contiguous slices, so that
  case is not compared;
- the same cell's gradients with remat on and the backward run on another
  thread than the forward's policy, against the one-device gradients;
- the prefill and decode cells on reduced yi-9b, minicpm3-4b (MLA), jamba
  (SSM + MoE) and qwen3-moe-30b-a3b (expert parallel): logits within
  ``testing.logit_atol`` of the unsharded ``prefill`` / ``decode_step``,
  decode through flash decode wherever ``model`` > 1, and each rank's
  cache shard its slice of the unsharded cache, within 4 bf16 rounding
  steps of the slice's largest magnitude (the tensor-parallel sums round
  the activations apart, and the caches hold them; reduced jamba's 8
  layers four times that, ``DEPTH_SCALE``).
"""

import copy
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core  # noqa: E402,F401  (the reference's import order)
from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch import testing  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.distributed import partition  # noqa: E402
from repro_torch.launch.steps import accumulate_grads, build_local_train_cell  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig, adamw_update, init_opt_state  # noqa: E402

HERE = os.path.dirname(__file__)
sys.path.insert(0, HERE)
from _torch_cells_worker import SERVE_ARCHS, TRAIN_CFG  # noqa: E402
from _torch_model_refs import DEPTH_SCALE, numpy_tree  # noqa: E402

SRC = os.path.join(HERE, "..", "src")
WORKER = os.path.join(HERE, "_torch_cells_worker.py")
MESHES = ("2x2", "2x1", "1x2")
RANK_TIMEOUT_S = 240
BATCH, SEQ = 4, 32
#: Cache shards against the unsharded cache: 4 bf16 rounding steps of the
#: slice's largest magnitude.
CACHE_ULPS = 4 * 2.0**-8


def _inputs():
    """The carried weights, the batch and the reference's losses."""
    cfg = REF_ARCHS["yi-9b"].reduced(**TRAIN_CFG)
    params = RM.init_params(cfg, jax.random.key(0))
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, 256, (BATCH, SEQ))
    labels = {"plain": rng.integers(0, 256, (BATCH, SEQ))}
    masked = np.roll(tokens, -1, 1)
    masked[:, -1] = -100
    masked[0, :20] = -100  # data rank 0 holds 20 more ignored labels than data rank 1
    labels["masked"] = masked
    model = params_from_jax(get_arch("yi-9b").reduced(**TRAIN_CFG), numpy_tree(params), device="cpu")
    ref = {name: float(RM.lm_loss(cfg, params, jnp.asarray(tokens, jnp.int32), jnp.asarray(lab, jnp.int32)))
           for name, lab in labels.items()}
    return model, tokens, labels, ref


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    model, tokens, labels, ref = _inputs()
    path = tmp_path_factory.mktemp("cells_in") / "inputs.npz"
    arrays = {f"param/{k}": p.detach().float().numpy() for k, p in model.named_parameters()}
    arrays.update(tokens=tokens, **{f"labels_{k}": v for k, v in labels.items()})
    np.savez(path, **arrays)
    return {"path": path, "model": model, "tokens": tokens, "labels": labels, "ref": ref}


@pytest.fixture(scope="module", params=MESHES)
def ranks(request, inputs, tmp_path_factory):
    """Every rank's saved results, for one mesh."""
    mesh = request.param
    world = int(mesh[0]) * int(mesh[2])
    tmp = tmp_path_factory.mktemp(f"cells{mesh}")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(world), str(tmp / "rendezvous"), str(tmp),
                               mesh, str(inputs["path"])],
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
        assert p.returncode == 0, f"rank {r} of {mesh} exited {p.returncode}:\n{log}"
    return mesh, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]


_ONE_DEVICE = {}


def _one_device(inputs, name: str, mb: int):
    """The port's one-device step on the full model: (the two losses, the
    first step's grad norm, the gradients its AdamW took, the parameters
    it left)."""
    key = (name, mb)
    if key not in _ONE_DEVICE:
        model = copy.deepcopy(inputs["model"])
        step = build_local_train_cell(model.cfg, microbatches=mb, return_grads=True)
        opt = init_opt_state(dict(model.named_parameters()))
        losses = []
        for i in range(2):
            model, opt, metrics = step(model, opt, _batch(inputs, name))
            losses.append(float(metrics["loss"]))
            if i == 0:
                first = (float(metrics["grad_norm"]), metrics["grads"],
                         {k: p.detach().clone() for k, p in model.named_parameters()})
        _ONE_DEVICE[key] = (losses, *first)
    return _ONE_DEVICE[key]


def _batch(inputs, name: str) -> dict:
    return {"tokens": torch.from_numpy(inputs["tokens"]), "labels": torch.from_numpy(inputs["labels"][name])}


def _assemble(outs, mesh_name: str, key: str, like: dict) -> dict:
    """The whole gradients from the ranks' shards (each rank's block at its
    mesh coordinates; replicated blocks must agree)."""
    data, model = int(mesh_name[0]), int(mesh_name[2])
    mesh = {"data": data, "model": model}
    specs = partition.param_specs(None, mesh, like, fsdp=True)
    out = {}
    for name, p in like.items():
        full = torch.full(p.shape, float("nan"))
        for o in outs:
            coords = {"data": int(o["coords"][0]), "model": int(o["coords"][1])}
            block = torch.from_numpy(o[f"{key}/{name}"])
            sl = partition.local_slices(p.shape, specs[name], coords, mesh)
            prev = full[sl]
            if not torch.isnan(prev).any():
                torch.testing.assert_close(block, prev, rtol=0, atol=0)  # replicas agree exactly
            full[sl] = block
        assert not torch.isnan(full).any(), name
        out[name] = full
    return out


@pytest.mark.parametrize("labels", ["plain", "masked"])
def test_sharded_train_matches_one_device_and_reference(ranks, inputs, labels):
    mesh, outs = ranks
    like = dict(inputs["model"].named_parameters())
    for mb in (1, 2) if labels == "plain" else (1,):
        key = f"{labels}_mb{mb}"
        losses = outs[0][f"loss_{key}"]
        for o in outs[1:]:  # every rank reports the same loss and norm
            np.testing.assert_array_equal(o[f"loss_{key}"], losses)
            np.testing.assert_array_equal(o[f"grad_norm_{key}"], outs[0][f"grad_norm_{key}"])
        want, want_norm, want_grads, want_params = _one_device(inputs, labels, mb)
        assert abs(losses[0] - want[0]) <= testing.LOSS_ATOL, (mesh, mb, losses, want)
        if mb == 1:
            assert abs(losses[0] - inputs["ref"][labels]) <= testing.LOSS_ATOL, (losses[0], inputs["ref"][labels])
        assert losses[1] < losses[0], (mesh, mb, losses)  # the reference's assertion
        norm = float(outs[0][f"grad_norm_{key}"])
        assert abs(norm - want_norm) <= testing.GRAD_RTOL * want_norm, (norm, want_norm)
        # the gradients the step's AdamW took (summed, clipped), against the one-device step's
        grads = _assemble(outs, mesh, f"grad_{key}", like)
        assert testing.grad_rel_l2(grads, want_grads) <= testing.GRAD_RTOL, mesh
        # what AdamW left on the shards: the whole update on those gradients, exactly
        params = {k: p.detach().clone() for k, p in inputs["model"].named_parameters()}
        opt = adamw_update(AdamWConfig(), params, grads, init_opt_state(params))[1]
        for part, want_part in (("param", params), ("m", opt["m"]), ("v", opt["v"])):
            got = _assemble(outs, mesh, f"{part}_{key}", like)
            for k, w in want_part.items():
                torch.testing.assert_close(got[k], w.float(), rtol=0, atol=0, msg=f"{mesh} {key} {part} {k}")
        got_params = _assemble(outs, mesh, f"param_{key}", like)
        assert testing.grad_rel_l2(got_params, want_params) <= testing.GRAD_RTOL, mesh


def test_sharded_backward_on_another_thread(ranks, inputs):
    """The remat recompute runs in the forward's policy when the backward
    runs on another thread (a CUDA backward runs on the autograd engine's
    thread): the gradients match the one-device ones."""
    mesh, outs = ranks
    like = dict(inputs["model"].named_parameters())
    _loss, want = accumulate_grads(inputs["model"].cfg, copy.deepcopy(inputs["model"]), _batch(inputs, "plain"))
    got = _assemble(outs, mesh, "grad_threaded", like)
    assert testing.grad_rel_l2(got, want) <= testing.GRAD_RTOL, mesh


@pytest.mark.parametrize("name", SERVE_ARCHS)
def test_prefill_and_decode_cells_match_unsharded(ranks, name):
    mesh, outs = ranks
    cfg = get_arch(name).reduced()
    bound = testing.logit_atol(cfg)
    for o in outs:
        for kind in ("prefill", "decode"):
            got, want = o[f"{kind}_{name}"]
            assert np.isfinite(got).all() and got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=0, atol=bound)
            for err, mag in o[f"{kind}_{name}_cache_err"]:
                assert 0 <= err <= CACHE_ULPS * DEPTH_SCALE.get(name, 1.0) * max(mag, 1.0), (kind, err, mag)
        assert bool(o[f"decode_{name}_flash"]) == (mesh[2] != "1")
