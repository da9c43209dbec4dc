"""Flash decode over a sequence-sharded cache; mirrors
``repro.distributed.decode_attn``.

Rank r of the group holds positions [r * S_local, (r + 1) * S_local) of
every attention cache.  For one new token at position ``pos``:

1. the rank that owns ``pos`` writes the token's k / v (or MLA payload)
   into its slice, in place; the others write nothing;
2. every rank computes its partial softmax over its slice, in float32:
   the running max ``m``, the denominator ``l`` and the weighted values
   ``o``;
3. the ranks ``all_gather`` their (o, m, l), and each combines them with
   the log-sum-exp rule: O(B * H * hd) bytes per layer and step, whatever
   the sequence length.

Both plug into ``models.model.decode_step``'s ``gqa_attn_impl`` /
``mla_attn_impl`` hooks, with the signatures of ``dense_gqa_decode_attn`` /
``dense_mla_decode_attn``; ``seq_shards`` tells ``decode_step`` the cache
holds 1 / world of the sequence.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from . import act_sharding


def _write_owned(cache: torch.Tensor, new: torch.Tensor, pos: int, rank: int, world: int) -> int:
    """Writes ``new`` at ``pos`` if this rank owns it; returns the slice's
    first global position."""
    s_local = cache.shape[1]
    if not 0 <= pos < s_local * world:
        raise ValueError(f"decode at position {pos} past a cache of {s_local * world} "
                         f"({world} shards of {s_local})")
    offset = rank * s_local
    if offset <= pos < offset + s_local:
        cache[:, pos - offset:pos - offset + 1] = new
    return offset


def _combine(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor, group, world: int) -> torch.Tensor:
    """Log-sum-exp combine of the ranks' partials o [B, H, D] (unnormalized),
    m, l [B, H]: sum_r o_r e^(m_r - M) / sum_r l_r e^(m_r - M)."""
    packed = torch.cat([o, m[..., None], l[..., None]], -1).contiguous()
    gathered = [torch.empty_like(packed) for _ in range(world)]
    act_sharding.record("model", "all-gather", packed)
    dist.all_gather(gathered, packed, group=group)
    g = torch.stack(gathered)  # [world, B, H, D + 2]
    g_o, g_m, g_l = g[..., :-2], g[..., -2], g[..., -1]
    scale = torch.exp(g_m - g_m.amax(0))
    l_tot = (g_l * scale).sum(0)
    o_tot = (g_o * scale[..., None]).sum(0)
    return o_tot / l_tot.clamp_min(1e-30)[..., None]


def make_gqa_flash_decode(group=None):
    """(q [B,1,H,hd], k_new, v_new [B,1,KVH,hd], k_cache, v_cache [B,S_local,
    KVH,hd], pos) -> (out [B,1,H,hd] in q's dtype, k_cache, v_cache)."""

    def impl(q, k_new, v_new, k_cache, v_cache, pos: int):
        rank, world = dist.get_rank(group), dist.get_world_size(group)
        offset = _write_owned(k_cache, k_new, pos, rank, world)
        _write_owned(v_cache, v_new, pos, rank, world)
        b, _one, h, hd = q.shape
        s_local, kvh = k_cache.shape[1], k_cache.shape[2]
        q5 = q.reshape(b, 1, kvh, h // kvh, hd).float()
        scores = torch.einsum("bqkgd,bskd->bkgqs", q5, k_cache.float()) / math.sqrt(hd)
        valid = torch.arange(s_local, device=q.device) + offset <= pos
        scores = scores.masked_fill(~valid, -1e30)
        m = scores.amax(-1)  # [B,KVH,G,1]
        p = torch.exp(scores - m[..., None])
        o = torch.einsum("bkgqs,bskd->bkgqd", p, v_cache.float())
        out = _combine(o.reshape(b, h, hd), m.reshape(b, h), p.sum(-1).reshape(b, h), group, world)
        return out.reshape(b, 1, h, hd).to(q.dtype), k_cache, v_cache

    impl.seq_shards = dist.get_world_size(group)
    return impl


def make_mla_flash_decode(group=None):
    """(q_c [B,1,H,r], q_rope [B,1,H,rope], payload [B,1,r+rope], c_cache
    [B,S_local,r+rope], pos, r, scale_dim) -> (ctx [B,1,H,r] in q_c's dtype,
    c_cache): the read in the compressed space (the caller applies the
    absorbed value projection)."""

    def impl(q_c, q_rope, payload, c_cache, pos: int, r: int, scale_dim: int):
        rank, world = dist.get_rank(group), dist.get_world_size(group)
        offset = _write_owned(c_cache, payload, pos, rank, world)
        b, _one, h, _r = q_c.shape
        s_local = c_cache.shape[1]
        c_kv = c_cache[..., :r].float()
        k_rope = c_cache[..., r:].float()
        scores = (torch.einsum("bqhr,bsr->bhqs", q_c.float(), c_kv)
                  + torch.einsum("bqhn,bsn->bhqs", q_rope.float(), k_rope)) / math.sqrt(scale_dim)
        valid = torch.arange(s_local, device=q_c.device) + offset <= pos
        scores = scores.masked_fill(~valid, -1e30)
        m = scores.amax(-1)  # [B,H,1]
        p = torch.exp(scores - m[..., None])
        ctx = torch.einsum("bhqs,bsr->bhr", p, c_kv)
        out = _combine(ctx, m[..., 0], p.sum(-1)[..., 0], group, world)
        return out.reshape(b, 1, h, r).to(q_c.dtype), c_cache

    impl.seq_shards = dist.get_world_size(group)
    return impl
