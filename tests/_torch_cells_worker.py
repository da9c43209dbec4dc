"""One rank of the sharded-cell CPU checks (not a test module).

    python tests/_torch_cells_worker.py RANK WORLD RENDEZVOUS_FILE OUT_DIR DATAxMODEL INPUTS_NPZ

Joins a gloo process group through a ``FileStore`` at ``RENDEZVOUS_FILE``,
builds the (DATA, MODEL) mesh, and runs ``repro_torch.launch.steps``'s
cells on this rank's shards of what ``INPUTS_NPZ`` holds (the model's
``state_dict`` as float32 arrays under ``param/<name>``, and the batches),
saving what it got to ``OUT_DIR/rank<RANK>.npz``
(``tests/test_torch_sharded_cells.py`` reads them):

- the train cell (FSDP + tensor parallel) for two steps on each batch,
  and with ``microbatches=2`` on the batch with every label kept: the
  losses, the gradient norm, and this rank's shards of what the first
  step's AdamW took (the gradients) and left (the parameters, the
  moments);
- the cell's gradients with the backward (and every remat recompute) on
  another thread than the forward's policy;
- the prefill and decode cells on the serving configurations: this rank's
  logits beside the unsharded ones, and each cache shard's largest
  difference from its slice of the unsharded cache.
"""

import sys
import threading
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_arch
from repro_torch.distributed import act_sharding, partition
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model as M
from repro_torch.models.config import ShapeConfig
from repro_torch.train.optimizer import init_opt_state

#: The reference test's reduced yi-9b (``tests/test_distributed.py:124-126``).
TRAIN_CFG = dict(num_heads=4, num_kv_heads=2, d_model=64, head_dim=16, d_ff=128, vocab_size=256)
SERVE_ARCHS = ("yi-9b", "minicpm3-4b", "jamba-v0.1-52b", "qwen3-moe-30b-a3b")
SERVE_BATCH, PROMPT, DECODE_STEPS = 4, 8, 4


def train(out: dict, mesh, inputs: dict) -> None:
    cfg = get_arch("yi-9b").reduced(**TRAIN_CFG)
    full = M.Transformer(cfg, device="meta")
    full.load_state_dict({k: torch.from_numpy(inputs[f"param/{k}"]).to(p.dtype)
                          for k, p in full.named_parameters()}, assign=True, strict=True)
    b, s = inputs["tokens"].shape
    shape = ShapeConfig("tiny_train", s, b, "train")
    for name in ("plain", "masked"):
        batch = {"tokens": torch.from_numpy(inputs["tokens"]), "labels": torch.from_numpy(inputs[f"labels_{name}"])}
        for mb in (1, 2) if name == "plain" else (1,):
            step, specs, _structs, _donate = steps.build_train_cell(cfg, shape, mesh, microbatches=mb,
                                                                    return_grads=True)
            local = steps.shard_model(cfg, mesh, fsdp=True, full=full)
            opt = init_opt_state(dict(local.named_parameters()))
            local_batch = {k: steps.shard_tensor(v, specs[2][k], mesh) for k, v in batch.items()}
            losses = []
            for i in range(2):
                local, opt, metrics = step(local, opt, local_batch)
                losses.append(float(metrics["loss"]))
                if i == 0:  # the gradients step 1's AdamW took, and what it left (copies: step 2 writes in place)
                    key = f"{name}_mb{mb}"
                    for k, p in local.named_parameters():
                        for part, t in (("grad", metrics["grads"][k]), ("param", p), ("m", opt["m"][k]),
                                        ("v", opt["v"][k])):
                            out[f"{part}_{key}/{k}"] = np.array(t.detach().float().numpy())
            out[f"loss_{name}_mb{mb}"] = np.array(losses)
            out[f"grad_norm_{name}_mb{mb}"] = np.array(float(metrics["grad_norm"]))
    threaded_backward(out, cfg, shape, mesh, full, {"tokens": torch.from_numpy(inputs["tokens"]),
                                                    "labels": torch.from_numpy(inputs["labels_plain"])})


def threaded_backward(out: dict, cfg, shape, mesh, full, batch: dict) -> None:
    """The train cell's gradients (``accumulate_grads``, remat on) with the
    forward under the policy on this thread and the backward, and so every
    remat recompute, on another thread, as a CUDA backward runs on the
    autograd engine's own thread."""
    _step, specs, _structs, _donate = steps.build_train_cell(cfg, shape, mesh)
    local = steps.shard_model(cfg, mesh, fsdp=True, full=full).requires_grad_(True)
    named = dict(local.named_parameters())
    batch = {k: steps.shard_tensor(v, specs[2][k], mesh) for k, v in batch.items()}
    result: dict = {}

    def backward(loss):
        try:
            result["grads"] = torch.autograd.grad(loss, list(named.values()))
        except BaseException as e:  # noqa: BLE001 -- raised again on the caller's thread
            result["error"] = e

    with act_sharding.policy(mesh, steps.norm_batch_axes(specs[2]["tokens"])):
        loss = M.lm_loss(cfg, local, batch["tokens"], batch["labels"], remat=True)
        thread = threading.Thread(target=backward, args=(loss,))
        thread.start()
        thread.join()
        if "error" in result:
            raise result["error"]
        grads = steps.sum_replicated_grads(dict(zip(named, result["grads"])), specs[0])
    for k, g in grads.items():
        out[f"grad_threaded/{k}"] = g.float().numpy()


def serve(out: dict, mesh) -> None:
    coords = steps.mesh_coords(mesh)
    for name in SERVE_ARCHS:
        cfg = get_arch(name).reduced()
        full = M.init_params(cfg, seed=0, device="cpu")
        tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size,
                                                                    (SERVE_BATCH, PROMPT + DECODE_STEPS)))
        total = PROMPT + DECODE_STEPS
        prefill, p_specs, _structs, _donate = steps.build_prefill_cell(
            cfg, ShapeConfig("p", PROMPT, SERVE_BATCH, "prefill"), mesh)
        decode, d_specs, _structs, _donate = steps.build_decode_cell(
            cfg, ShapeConfig("d", total, SERVE_BATCH, "decode"), mesh)
        local = steps.shard_model(cfg, mesh, fsdp=False, full=full)
        with torch.no_grad():
            # prefill into a cache of the prompt's length
            dense = M.init_cache(cfg, SERVE_BATCH, PROMPT, device="cpu")
            want, dense = M.prefill(cfg, full, tokens[:, :PROMPT], dense, last_only=True)
            cache = steps.shard_cache(cfg, mesh, M.init_cache(cfg, SERVE_BATCH, PROMPT, device="cpu"), SERVE_BATCH)
            rows = partition.local_slices(tokens.shape, p_specs[1]["tokens"], coords, mesh)[0]
            got, cache = prefill(local, {"tokens": tokens[rows, :PROMPT]}, cache)
            out[f"prefill_{name}"] = np.stack([got.numpy(), want[rows].numpy()])
            out[f"prefill_{name}_cache_err"] = np.array(_cache_err(cache, dense, p_specs[2], coords, mesh))
            # decode against a cache of the prompt and the decoded tokens
            dense = M.init_cache(cfg, SERVE_BATCH, total, device="cpu")
            M.prefill(cfg, full, tokens[:, :PROMPT], dense)
            cache = {"length": dense["length"], "layers": [
                {k: steps.shard_tensor(v, d_specs[1]["layers"][i][k], mesh) for k, v in lc.items()}
                for i, lc in enumerate(dense["layers"])]}
            got, want = [], []
            for i in range(DECODE_STEPS):
                tok = tokens[:, PROMPT + i:PROMPT + i + 1]
                want.append(M.decode_step(cfg, full, dense, tok)[0][rows])
                got.append(decode(local, cache, {"tokens": tok[rows]})[0])
            out[f"decode_{name}"] = np.stack([torch.cat(got, 1).numpy(), torch.cat(want, 1).numpy()])
            out[f"decode_{name}_cache_err"] = np.array(_cache_err(cache, dense, d_specs[1], coords, mesh))
            out[f"decode_{name}_flash"] = np.array(partition.axis_size(mesh, "model") > 1)


def _cache_err(cache: dict, dense: dict, c_specs: dict, coords: dict, mesh) -> list[list[float]]:
    """Per layer and tensor, [the largest difference of this rank's cache
    shard from its slice of the unsharded cache, the slice's largest
    magnitude] ([-1, 0] where a shape differs)."""
    errs = []
    for lc, dc, specs in zip(cache["layers"], dense["layers"], c_specs["layers"]):
        for k, v in dc.items():
            want = v[partition.local_slices(v.shape, specs[k], coords, mesh)].float()
            if lc[k].shape != want.shape:
                errs.append([-1.0, 0.0])
            else:
                errs.append([(lc[k].float() - want).abs().max().item(), want.abs().max().item()])
    return errs


def main() -> None:
    rank, world, rendezvous, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    data, model = (int(n) for n in sys.argv[5].split("x"))
    inputs = dict(np.load(sys.argv[6]))
    store = dist.FileStore(rendezvous, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world, timeout=timedelta(seconds=60))
    try:
        mesh = make_mesh((data, model), ("data", "model"))
        out: dict = {"coords": np.array([steps.mesh_coords(mesh)["data"], steps.mesh_coords(mesh)["model"]])}
        train(out, mesh, inputs)
        serve(out, mesh)
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
