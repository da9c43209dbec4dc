"""One rank of the port's distributed CPU checks (not a test module).

    python tests/_torch_dist_worker.py RANK WORLD RENDEZVOUS_FILE OUT_DIR

Joins a gloo process group through a ``FileStore`` at ``RENDEZVOUS_FILE``,
runs every scenario on seeded inputs, and saves what rank ``RANK`` got to
``OUT_DIR/rank<RANK>.npz`` (``tests/test_torch_distributed.py`` reads
them): the distributed search over the whole base, GQA and MLA flash
decode beside the dense decode on the same inputs, both through
``decode_step`` for 16 steps on reduced yi-9b and minicpm3-4b, and the
expert-parallel MoE block beside the dense one, forward and backward.
"""

import contextlib
import sys
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_arch
from repro_torch.distributed import act_sharding
from repro_torch.distributed.decode_attn import make_gqa_flash_decode, make_mla_flash_decode
from repro_torch.distributed.search import distributed_search_host
from repro_torch.models import model as M
from repro_torch.models.moe import MoE, moe_block

SEARCH = dict(n=999, d=24, nq=4, k=10)
DECODE_STEPS = 16
PROMPT = 8


def search(out: dict) -> None:
    rng = np.random.default_rng(0)
    base = rng.standard_normal((SEARCH["n"], SEARCH["d"])).astype(np.float32)
    q = rng.standard_normal((SEARCH["nq"], SEARCH["d"])).astype(np.float32)
    for metric in ("l2", "ip"):
        out[f"search_{metric}_s"], out[f"search_{metric}_i"] = distributed_search_host(
            q, base, SEARCH["k"], metric, device="cpu")


def attn_kernels(out: dict, rank: int, world: int) -> None:
    """The reference test's shapes (``tests/test_distributed.py:42,78``),
    float32: the flash impls on this rank's slice against the dense ones on
    the whole cache."""
    rng = np.random.default_rng(0)
    b, s, h, kvh, hd = 4, 32, 8, 2, 16
    t = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))  # noqa: E731
    q, k_new, v_new, kc, vc = t(b, 1, h, hd), t(b, 1, kvh, hd), t(b, 1, kvh, hd), t(b, s, kvh, hd), t(b, s, kvh, hd)
    lo, hi = rank * s // world, (rank + 1) * s // world
    for pos in (17, 0, s - 1):
        want, want_k, want_v = M.dense_gqa_decode_attn(q, k_new, v_new, kc.clone(), vc.clone(), pos)
        got, got_k, got_v = make_gqa_flash_decode()(q, k_new, v_new, kc[:, lo:hi].clone(),
                                                     vc[:, lo:hi].clone(), pos)
        out[f"gqa{pos}"] = np.stack([got.numpy(), want.numpy()])
        out[f"gqa{pos}_cache"] = np.stack([np.concatenate([got_k, got_v]),
                                           np.concatenate([want_k[:, lo:hi], want_v[:, lo:hi]])])
    h, r, rope = 6, 16, 8
    q_c, q_rope, payload, cc = t(b, 1, h, r), t(b, 1, h, rope), t(b, 1, r + rope), t(b, s, r + rope)
    for pos in (9, s - 1):
        want, want_c = M.dense_mla_decode_attn(q_c, q_rope, payload, cc.clone(), pos, r, 24)
        got, got_c = make_mla_flash_decode()(q_c, q_rope, payload, cc[:, lo:hi].clone(), pos, r, 24)
        out[f"mla{pos}"] = np.stack([got.numpy(), want.numpy()])
        out[f"mla{pos}_cache"] = np.stack([got_c.numpy(), want_c[:, lo:hi].numpy()])


def decode_through_hooks(out: dict, rank: int, world: int) -> None:
    """Prefill, then DECODE_STEPS teacher-forced steps: dense, and with the
    flash impls over this rank's slice of every attention cache."""
    for name in ("yi-9b", "minicpm3-4b"):
        cfg = get_arch(name).reduced()
        model = M.init_params(cfg, seed=0, device="cpu")
        tokens = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (2, PROMPT + DECODE_STEPS)))
        total = PROMPT + DECODE_STEPS  # a multiple of every world size tested
        with torch.no_grad():
            dense = M.init_cache(cfg, 2, total, device="cpu")
            M.prefill(cfg, model, tokens[:, :PROMPT], dense)
            lo, hi = rank * total // world, (rank + 1) * total // world
            sharded = {"length": dense["length"],
                       "layers": [{k: v[:, lo:hi].clone() if k in ("k", "v", "c") else v.clone()
                                   for k, v in lc.items()} for lc in dense["layers"]]}
            hooks = dict(gqa_attn_impl=make_gqa_flash_decode(), mla_attn_impl=make_mla_flash_decode())
            got, want = [], []
            for i in range(DECODE_STEPS):
                tok = tokens[:, PROMPT + i:PROMPT + i + 1]
                want.append(M.decode_step(cfg, model, dense, tok)[0])
                got.append(M.decode_step(cfg, model, sharded, tok, **hooks)[0])
        out[f"decode_{name}"] = np.stack([torch.cat(got, 1).numpy(), torch.cat(want, 1).numpy()])


def expert_parallel(out: dict) -> None:
    """The reference test's set-up (``tests/test_distributed.py:150``): x
    [4, 16, D] through one MoE block, expert parallel against dense."""
    for name in ("qwen3-moe-30b-a3b", "deepseek-moe-16b"):
        cfg = get_arch(name).reduced()
        gen = torch.Generator().manual_seed(0)
        p = MoE(cfg, gen, "cpu")
        x = torch.randn((4, 16, cfg.d_model), generator=gen).to(torch.bfloat16)
        with torch.no_grad():
            dense = moe_block(cfg, p, x)
            with act_sharding.policy(None):
                sharded = moe_block(cfg, p, x)
            with act_sharding.policy(None, moe_impl="dense"):
                dense_in_scope = moe_block(cfg, p, x)
        out[f"moe_{name}"] = np.stack([sharded.float().numpy(), dense.float().numpy(),
                                       dense_in_scope.float().numpy()])
        out[f"moe_{name}_grads"] = expert_parallel_grads(cfg, p, x)


def expert_parallel_grads(cfg, p, x) -> np.ndarray:
    """[expert parallel, dense] gradients of one scalar of the block's
    output with respect to x and every parameter, flattened; the expert
    weights' gradients summed over the ranks (each rank's covers its own
    experts), the rest as each rank has them."""
    w = torch.randn(x.shape, generator=torch.Generator().manual_seed(3))
    params = dict(p.named_parameters())
    p.requires_grad_(True)
    rows = []
    for ep in (True, False):
        xg = x.clone().requires_grad_(True)
        with act_sharding.policy(None) if ep else contextlib.nullcontext():
            y = moe_block(cfg, p, xg)
        grads = torch.autograd.grad((y.float() * w).sum(), [xg, *params.values()])
        flat = []
        for name, g in zip(["x", *params], grads):
            g = g.float().contiguous()
            if ep and name in ("w_gate", "w_up", "w_down"):
                dist.all_reduce(g)
            flat.append(g.reshape(-1))
        rows.append(torch.cat(flat).numpy())
    p.requires_grad_(False)
    return np.stack(rows)


def main() -> None:
    rank, world, rendezvous, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    store = dist.FileStore(rendezvous, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world, timeout=timedelta(seconds=60))
    try:
        out: dict = {}
        search(out)
        attn_kernels(out, rank, world)
        decode_through_hooks(out, rank, world)
        expert_parallel(out)
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
