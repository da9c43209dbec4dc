"""The port's training path on the CPU against the reference.

- ``lm_loss`` for all ten configurations on weights carried across by
  ``params_from_jax`` (labels with ignored positions, chunks smaller than
  the sequence): within ``testing.loss_atol``; its gradients against
  ``jax.grad`` for yi-9b, minicpm3-4b (MLA), qwen3-moe-30b-a3b (MoE) and
  mamba2-370m (SSD): the global relative L2 difference within
  ``testing.GRAD_RTOL``, each leaf within 0.1 of its largest magnitude.
- ``remat`` recomputes each period in the backward pass, with the same
  gradients, and serving builds no graph.
- ``adamw_update`` / ``clip_by_global_norm`` against the reference's on the
  same tensors, and mirrors of ``tests/test_train.py:29,39``.
- Checkpoints: round trip, atomicity and prune (``:50``); a checkpoint the
  reference wrote restored here, and one written here restored there.
- ``train``: resume (``:72``); the reference's ``train`` and the port's,
  resumed from one reference checkpoint at step 0, on the same batches;
  micro-batch accumulation against the port's own full batch (the
  reference's test of it fails); the ``launch/train.py --local`` launcher.
"""

import copy
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core  # noqa: E402,F401  (the reference's import order)
from _torch_model_refs import ALL, DEPTH_SCALE, carried, inputs, j, numpy_tree, t  # noqa: E402
from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.core.object_store import MemoryObjectStore as RefStore  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.train import checkpoint as ref_ckpt  # noqa: E402
from repro.train import loop as ref_loop  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro_torch import testing  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.core.object_store import MemoryObjectStore  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.launch.steps import accumulate_grads, build_local_train_cell  # noqa: E402
from repro_torch.models import model as PM  # noqa: E402
from repro_torch.models.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.loop import TrainConfig, synthetic_lm_batches, train  # noqa: E402
from repro_torch.train.optimizer import (  # noqa: E402
    AdamWConfig,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    init_opt_state,
)

TINY = dict(num_layers=2, d_model=32, num_heads=2, num_kv_heads=2, head_dim=8, d_ff=64, vocab_size=64)
GRAD_ARCHS = ("yi-9b", "minicpm3-4b", "qwen3-moe-30b-a3b", "mamba2-370m")


def _labels(tok, seed: int = 3):
    """Next-token labels, -100 at the end and at a fifth of the positions."""
    lab = np.roll(tok, -1, 1).astype(np.int32)
    lab[:, -1] = -100
    lab[np.random.default_rng(seed).random(lab.shape) < 0.2] = -100
    return lab


def _leaves(tree: dict, prefix: str = ""):
    for key, leaf in tree.items():
        if isinstance(leaf, dict):
            yield from _leaves(leaf, f"{prefix}{key}/")
        else:
            yield prefix + key, np.asarray(leaf, np.float64)


# ------------------------------------------------------------------ loss --
@pytest.mark.parametrize("name", ALL)
def test_lm_loss_matches_reference(name):
    cfg, params, model = carried(name)
    tok, prefix = inputs(cfg, 2, 12)
    lab = _labels(tok)
    want = float(RM.lm_loss(cfg, params, j(tok), j(lab), j(prefix), remat=False, seq_chunk=5))
    got = PM.lm_loss(model.cfg, model, t(tok).long(), t(lab).long(), t(prefix), seq_chunk=5)
    assert got.dtype == torch.float32 and got.shape == () and torch.isfinite(got)
    assert abs(float(got) - want) <= DEPTH_SCALE.get(name, 1.0) * testing.LOSS_ATOL


@pytest.mark.parametrize("name", GRAD_ARCHS)
def test_lm_loss_gradients_match_jax_grad(name):
    cfg, params, model = carried(name)
    tok, prefix = inputs(cfg, 2, 12)
    lab = _labels(tok)
    want = jax.grad(lambda p: RM.lm_loss(cfg, p, j(tok), j(lab), j(prefix), seq_chunk=5))(params)
    model.requires_grad_(True)
    named = dict(model.named_parameters())
    loss = PM.lm_loss(model.cfg, model, t(tok).long(), t(lab).long(), t(prefix), seq_chunk=5)
    got = params_to_jax(model.cfg, dict(zip(named, torch.autograd.grad(loss, list(named.values())))))
    got_leaves, want_leaves = dict(_leaves(got)), dict(_leaves(want))
    assert got_leaves.keys() == want_leaves.keys()
    num = sum(((got_leaves[k] - w) ** 2).sum() for k, w in want_leaves.items())
    den = sum((w ** 2).sum() for w in want_leaves.values())
    assert np.sqrt(num / den) <= testing.GRAD_RTOL
    for key, w in want_leaves.items():
        assert np.abs(got_leaves[key] - w).max() <= 0.1 * np.abs(w).max(), key


def test_remat_recomputes_each_period_with_the_same_gradients():
    cfg = ARCHS["jamba-v0.1-52b"].reduced(num_layers=16)  # two 8-layer periods
    model = PM.init_params(cfg, seed=0, device="cpu").requires_grad_(True)
    calls = []
    for layer in model.layers:
        layer.register_forward_hook(lambda *_: calls.append(1))
    tok = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8)))
    used = [p for name, p in model.named_parameters() if name != "lm_head"]
    grads = {}
    for remat in (False, True):
        calls.clear()
        loss = PM.hidden_states(cfg, model, tok, remat=remat).float().square().mean()
        forward_calls = len(calls)
        grads[remat] = torch.autograd.grad(loss, used)
        # each of the two periods runs again in the backward pass; the
        # recompute stops once it holds every saved tensor, which may be
        # before a period's last layer returns
        recomputed = len(calls) - forward_calls
        assert forward_calls == 16 and (recomputed >= 2 * 7 if remat else recomputed == 0)
    for a, b in zip(grads[False], grads[True]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    calls.clear()
    with torch.no_grad():  # serving: no graph, no recompute
        out = PM.hidden_states(cfg, model, tok, remat=True)
    assert out.grad_fn is None and len(calls) == 16


# ------------------------------------------------------------- optimizer --
def _opt_tensors(seed: int):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((16, 8)).astype(np.float32),
              "router": rng.standard_normal((8, 4)).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) * 3 for k, v in params.items()}
             for _ in range(3)]
    return params, grads


def test_adamw_update_and_clip_match_reference():
    cfg = AdamWConfig(lr=1e-2, warmup_steps=4)
    params, grads = _opt_tensors(0)
    dtypes = {"w": (jnp.bfloat16, torch.bfloat16), "router": (jnp.float32, torch.float32)}
    ref_p = {k: jnp.asarray(v, dtypes[k][0]) for k, v in params.items()}
    p = {k: torch.from_numpy(v).to(dtypes[k][1]) for k, v in params.items()}
    ref_o, o = ref_opt.init_opt_state(ref_p), init_opt_state(p)
    for g in grads:
        ref_g, ref_norm = ref_opt.clip_by_global_norm({k: jnp.asarray(v, dtypes[k][0]) for k, v in g.items()},
                                                      cfg.grad_clip)
        tg, norm = clip_by_global_norm({k: torch.from_numpy(v).to(dtypes[k][1]) for k, v in g.items()},
                                       cfg.grad_clip)
        np.testing.assert_allclose(float(norm), float(ref_norm), rtol=1e-6)
        for k in g:
            np.testing.assert_allclose(tg[k].float().numpy(), np.asarray(ref_g[k], np.float32), rtol=2**-8)
        ref_p, ref_o = ref_opt.adamw_update(cfg, ref_p, ref_g, ref_o)
        adamw_update(cfg, p, tg, o)
    assert o["step"] == int(ref_o["step"]) == 3
    for k in params:
        np.testing.assert_allclose(o["m"][k].numpy(), np.asarray(ref_o["m"][k]), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(o["v"][k].numpy(), np.asarray(ref_o["v"][k]), rtol=1e-5, atol=1e-7)
        # bf16 parameters within one bf16 ulp, float32 ones within float32 rounding
        rtol = 2**-8 if dtypes[k][1] is torch.bfloat16 else 1e-6
        np.testing.assert_allclose(p[k].float().numpy(), np.asarray(ref_p[k], np.float32), rtol=rtol, atol=1e-7)
        assert p[k].dtype is dtypes[k][1]


def test_adamw_converges_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = init_opt_state(params)
    cfg = AdamWConfig(lr=0.2, weight_decay=0.0, warmup_steps=1)
    for _ in range(200):
        w = params["w"].detach().requires_grad_(True)
        (grad,) = torch.autograd.grad((w ** 2).sum(), [w])
        adamw_update(cfg, params, {"w": grad}, opt)
    assert float(params["w"].abs().max()) < 1e-2


def test_grad_clip():
    g = {"a": torch.full((10,), 100.0)}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert float(norm) > 1.0
    np.testing.assert_allclose(float(global_norm(clipped)), 1.0, rtol=1e-5)
    g2 = {"a": torch.full((4,), 0.01)}
    same, _ = clip_by_global_norm(g2, 1.0)  # below the threshold: untouched
    torch.testing.assert_close(same["a"], g2["a"], rtol=0, atol=0)


# ----------------------------------------------------------- checkpoints --
def _tiny_state(seed: int = 0):
    cfg = ARCHS["yi-9b"].reduced(**TINY)
    model = PM.init_params(cfg, seed=seed, device="cpu")
    params = dict(model.named_parameters())
    return cfg, params, init_opt_state(params)


def _equal_trees(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


def test_checkpoint_roundtrip_and_atomicity():
    store = MemoryObjectStore()
    cfg, params, opt = _tiny_state()
    ckpt.save_checkpoint(cfg, store, "run", 10, params, opt, extra={"note": "x"})
    ckpt.save_checkpoint(cfg, store, "run", 20, params, opt)
    assert ckpt.committed_steps(store, "run") == [10, 20]
    step, p2, o2, extra = ckpt.restore_latest(cfg, store, "run", params, opt)
    assert step == 20 and extra == {}
    _equal_trees(params, p2)
    _equal_trees(opt["m"], o2["m"])
    assert all(p2[k].dtype == params[k].dtype for k in params)
    # a partial checkpoint (no manifest) is invisible
    store.put("ckpt/run/0000000030/params/embed", b"garbage")
    assert ckpt.committed_steps(store, "run") == [10, 20]
    ckpt.prune_checkpoints(store, "run", keep=1)
    assert ckpt.committed_steps(store, "run") == [20]


def _one_ref_step(cfg, params):
    """The reference's state after one AdamW step on a seeded gradient: m, v
    and step all non-trivial."""
    opt = ref_opt.init_opt_state(params)
    rng = np.random.default_rng(5)
    grads = jax.tree_util.tree_map(lambda p: jnp.asarray(rng.standard_normal(p.shape), p.dtype), params)
    return ref_opt.adamw_update(ref_opt.AdamWConfig(), params, grads, opt)


@pytest.mark.parametrize("name", ["yi-9b", "jamba-v0.1-52b"])
def test_reference_checkpoint_restores_in_port(name):
    cfg, params, model = carried(name, num_layers=2 * len(RM.effective_pattern(REF_ARCHS[name].reduced())))
    params, opt = _one_ref_step(cfg, params)
    ref_store = RefStore()
    ref_ckpt.save_checkpoint(ref_store, "run", 7, params, opt)
    store = MemoryObjectStore()
    for meta in ref_store.list("ckpt/"):
        store.put(meta.key, ref_store.get(meta.key))
    like = dict(model.named_parameters())
    step, got_p, got_o, _ = ckpt.restore_latest(model.cfg, store, "run", like, init_opt_state(like))
    assert step == 7 and got_o["step"] == 1
    want = dict(params_from_jax(model.cfg, numpy_tree(params), device="cpu").named_parameters())
    _equal_trees(got_p, {k: v.detach() for k, v in want.items()})
    for group in ("m", "v"):
        ref_tree = numpy_tree(opt[group])
        got_tree = params_to_jax(model.cfg, got_o[group])
        for (ka, a), (kb, b) in zip(sorted(_leaves(got_tree)), sorted(_leaves(ref_tree))):
            assert ka == kb
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["yi-9b", "jamba-v0.1-52b"])
def test_port_checkpoint_restores_in_reference(name):
    ref_cfg = REF_ARCHS[name].reduced()
    ref_cfg = REF_ARCHS[name].reduced(num_layers=2 * len(RM.effective_pattern(ref_cfg)))
    cfg = ARCHS[name].reduced(num_layers=ref_cfg.num_layers)
    model = PM.init_params(cfg, seed=1, device="cpu")
    params = dict(model.named_parameters())
    opt = init_opt_state(params)
    rng = np.random.default_rng(5)
    grads = {k: torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)).to(p.dtype)
             for k, p in params.items()}
    adamw_update(AdamWConfig(), params, grads, opt)
    store = MemoryObjectStore()
    ckpt.save_checkpoint(cfg, store, "run", 3, params, opt)
    ref_store = RefStore()
    for meta in store.list("ckpt/"):
        ref_store.put(meta.key, store.get(meta.key))
    like = RM.init_params(ref_cfg, jax.random.key(0))
    step, ref_p, ref_o, _ = ref_ckpt.restore_latest(ref_store, "run", like, ref_opt.init_opt_state(like))
    assert step == 3 and int(ref_o["step"]) == 1
    for tree, got in ((ref_p, params), (ref_o["m"], opt["m"]), (ref_o["v"], opt["v"])):
        for (ka, a), (kb, b) in zip(sorted(_leaves(params_to_jax(cfg, got))), sorted(_leaves(numpy_tree(tree)))):
            assert ka == kb
            np.testing.assert_array_equal(a, b)
    # the manifests name the same objects with the same dtypes and shapes
    ref_store2 = RefStore()
    ref_ckpt.save_checkpoint(ref_store2, "run", 3, ref_p, ref_o)
    port_m, ref_m = (json.loads(s.get("ckpt/run/0000000003/MANIFEST")) for s in (store, ref_store2))
    assert port_m["leaves"] == ref_m["leaves"]


# ------------------------------------------------------------------ train --
def test_synthetic_batches_are_the_references():
    cfg = ARCHS["yi-9b"].reduced(**TINY)
    tc = TrainConfig(batch=3, seq_len=16, seed=4)
    ref = ref_loop.synthetic_lm_batches(REF_ARCHS["yi-9b"].reduced(**TINY), ref_loop.TrainConfig(
        batch=3, seq_len=16, seed=4))
    port = synthetic_lm_batches(cfg, tc, device="cpu")
    for _ in range(3):
        a, b = next(port), next(ref)
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(a[key].numpy(), np.asarray(b[key]))


def test_train_resume_is_seamless():
    cfg = ARCHS["yi-9b"].reduced(**TINY)
    tc = TrainConfig(steps=6, batch=2, seq_len=16, checkpoint_every=3, log_every=100, run_name="resume-test")
    _m, _o, losses_full = train(cfg, MemoryObjectStore(), tc, device="cpu")
    store2 = MemoryObjectStore()
    tc3 = TrainConfig(steps=3, batch=2, seq_len=16, checkpoint_every=3, log_every=100, run_name="resume-test")
    train(cfg, store2, tc3, device="cpu")
    _m, _o, losses_res = train(cfg, store2, tc, device="cpu")  # resumes at step 3
    assert len(losses_res) == 3
    np.testing.assert_allclose(losses_full[3:], losses_res, rtol=2e-4, atol=2e-4)


def test_train_matches_reference_from_one_checkpoint():
    """Both packages' ``train`` resume from one reference checkpoint at step
    0 and run the same six batches: the loss histories agree within
    ``testing.LOSS_ATOL`` (the same bound as one ``lm_loss``: AdamW's
    normalized steps keep the two runs' parameters within bf16 rounding)."""
    ref_cfg = REF_ARCHS["yi-9b"].reduced(**TINY)
    cfg = ARCHS["yi-9b"].reduced(**TINY)
    params = RM.init_params(ref_cfg, jax.random.key(3))
    ref_store = RefStore()
    ref_ckpt.save_checkpoint(ref_store, "both", 0, params, ref_opt.init_opt_state(params))
    store = MemoryObjectStore()
    for meta in ref_store.list("ckpt/"):
        store.put(meta.key, ref_store.get(meta.key))
    kw = dict(steps=6, batch=2, seq_len=16, checkpoint_every=3, log_every=100, run_name="both")
    _p, _o, want = ref_loop.train(ref_cfg, ref_store, ref_loop.TrainConfig(**kw))
    _m, _o, got = train(cfg, store, TrainConfig(**kw), device="cpu")
    assert len(got) == len(want) == 6
    np.testing.assert_allclose(got, want, rtol=0, atol=testing.LOSS_ATOL)


def test_microbatch_accumulation_matches_full_batch():
    """Two micro-batches against one full batch, the reference's bounds
    (``tests/test_train.py:72-102``): loss rtol 1e-3, grad norm rtol 1e-2,
    parameters rtol 2e-2 and atol 2e-3; and the accumulated float32
    gradients themselves within ``testing.GRAD_RTOL`` (global relative
    L2) of the full batch's, which a rescaled or partial accumulation
    misses by far (the update alone cannot show it: Adam's first step is
    lr * sign(g))."""
    cfg = ARCHS["yi-9b"].reduced(**TINY)
    model = PM.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(rng.integers(0, 64, (4, 16))),
             "labels": torch.from_numpy(rng.integers(0, 64, (4, 16)))}
    grads = [accumulate_grads(cfg, copy.deepcopy(model), batch, microbatches=mb)[1] for mb in (1, 2)]
    assert testing.grad_rel_l2(grads[1], grads[0]) <= testing.GRAD_RTOL
    half = accumulate_grads(cfg, copy.deepcopy(model), {k: v[:2] for k, v in batch.items()})[1]
    assert testing.grad_rel_l2(half, grads[0]) > 10 * testing.GRAD_RTOL  # the check can fail
    outs = []
    for mb in (1, 2):
        m = copy.deepcopy(model)
        m, _o, metrics = build_local_train_cell(cfg, microbatches=mb)(m, init_opt_state(dict(m.named_parameters())),
                                                                 batch)
        outs.append((m, float(metrics["loss"]), float(metrics["grad_norm"])))
    np.testing.assert_allclose(outs[0][1], outs[1][1], rtol=1e-3)
    np.testing.assert_allclose(outs[0][2], outs[1][2], rtol=1e-2)
    for a, b in zip(outs[0][0].parameters(), outs[1][0].parameters()):
        np.testing.assert_allclose(a.detach().float().numpy(), b.detach().float().numpy(), rtol=2e-2, atol=2e-3)
    with pytest.raises(ValueError, match="microbatches"):
        build_local_train_cell(cfg, microbatches=3)(model, init_opt_state(dict(model.named_parameters())), batch)


def test_launch_train_local(tmp_path, capsys):
    argv = ["--arch", "qwen3-moe-30b-a3b", "--local", "--steps", "3", "--ckpt-dir", str(tmp_path)]
    losses = train_launcher.main(argv + ["--device", "cpu"])
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert train_launcher.main(argv + ["--device", "cpu"]) == []  # resumed at its last step
    assert "already trained" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_launcher.main(argv)
    # --dry-run runs the cell that --shape and --multi-pod name
    for flags, mesh in (([], "16x16"), (["--multi-pod"], "2x16x16")):
        res = train_launcher.main(["--arch", "paligemma-3b", "--shape", "decode_32k", "--dry-run"] + flags)
        assert (res["arch"], res["shape"], res["mesh"], res["kind"]) == ("paligemma-3b", "decode_32k", mesh, "decode")
        assert res["ok"] and res["memory"]["peak_bytes_per_device"] > 0
        assert f"paligemma-3b x decode_32k [{mesh}]" in capsys.readouterr().out


def test_checkpoint_objects_are_npy_with_the_manifest_last():
    store = MemoryObjectStore()
    order = []
    put = store.put
    store.put = lambda key, data: (order.append(key), put(key, data))[1]
    cfg, params, opt = _tiny_state()
    ckpt.save_checkpoint(cfg, store, "run", 1, params, opt)
    leaves = len(dict(_leaves(params_to_jax(cfg, params))))  # layers stacked per slot
    assert order[-1] == "ckpt/run/0000000001/MANIFEST" and len(order) == 3 * leaves + 2
    arr = np.load(io.BytesIO(store.get("ckpt/run/0000000001/params/layers/slot0/attn/w_q")))
    assert arr.dtype == np.float32 and arr.shape == (2, 32, 16)
